"""Continuous-batching decode engine with a dense KV cache.

The engine owns ``max_batch`` decode slots backed by one cache
[L, max_batch, max_seq, KV, hd]. Per-slot control state (``pos``,
``budget``, ``last_tok``, ``active`` and the sampling params) lives on the
device, as in the reference's ``EngineState``:

  * a decode chunk runs ``decode_chunk`` steps for the whole pool: active
    masking, budget / max_seq / EOS stopping and sampling all happen on the
    device, the cache is written in place, and tokens collect in a device
    buffer. The host reads the buffer, the validity mask and the liveness
    once per chunk (one ``.cpu()``), not once per token;
  * admission prefills ``prompt[:-1]`` chunk by chunk into a zeroed batch-1
    slot cache at offsets 0, C, 2C, ... (fixed ``[1, C]`` chunks, the tail
    right-padded), then copies it into the slot. The last prompt token is
    the slot's first decode input, so the first new token comes out of the
    decode loop.

Admit and retire run on the host at chunk boundaries. Edges, as in the
reference: a prompt longer than ``max_seq`` keeps its last
``max(1, max_seq - max_new_tokens)`` tokens; a prompt that fills the cache
yields no tokens; ``max_new_tokens <= 0`` completes at admission.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ArchConfig
from repro_torch.models import api, kvcache
from repro_torch.serving.sampler import sample


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [len] int
    max_new_tokens: int = 32
    temperature: float = 0.0           # <= 0 -> greedy
    top_k: int = 0                     # 0 -> disabled
    top_p: float = 1.0                 # >= 1 -> disabled
    done: bool = False
    output: Optional[List[int]] = None


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 max_seq: int = 512, seed: int = 0, decode_chunk: int = 8,
                 prefill_chunk: int = 32, eos_id: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.decode_chunk = max(1, decode_chunk)
        self.prefill_chunk = max(1, min(prefill_chunk, max_seq))
        self.eos_id = eos_id
        self._seed = seed
        self.reset(seed=seed)

    # -- lifecycle ----------------------------------------------------------
    def reset(self, seed: Optional[int] = None):
        """Clear queue, slots, device state and counters."""
        seed = self._seed if seed is None else seed
        b, dev = self.max_batch, self.device
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * b
        self.caches = api.init_cache(self.cfg, b, self.max_seq,
                                     dtype=torch.float32, device=dev)
        zeros = lambda dtype: torch.zeros(b, dtype=dtype, device=dev)
        self.pos = zeros(torch.int64)        # next cache write position
        self.budget = zeros(torch.int64)     # remaining new tokens
        self.last_tok = zeros(torch.int64)   # next token to feed
        self.active = zeros(torch.bool)
        self.temperature = zeros(torch.float32)
        self.top_k = zeros(torch.int64)
        self.top_p = torch.ones(b, dtype=torch.float32, device=dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self._sampling = [False] * b         # host mirror: temperature > 0
        self.decode_syncs = 0
        self.decode_tokens = 0
        self.prefill_dispatches = 0
        self.prefill_tokens = 0
        self.prefill_s = 0.0
        self.peak_active_slots = 0
        self._chunk_s: List[float] = []

    # -- device programs ----------------------------------------------------
    def _prefill_chunk(self, slot_caches, tokens, offset: int):
        """Write one [1, C] prompt chunk into a batch-1 cache at ``offset``;
        the LM head is skipped (only the caches are kept)."""
        api.forward(self.params, {"tokens": tokens}, self.cfg,
                    caches=slot_caches, cache_pos=offset, head=False)

    def _decode_chunk(self, sampling: bool):
        """``decode_chunk`` steps for the whole pool, all on the device.
        Returns device tensors toks / valid [N, B]."""
        n, b, dev = self.decode_chunk, self.max_batch, self.device
        toks = torch.empty((n, b), dtype=torch.int64, device=dev)
        valid = torch.empty((n, b), dtype=torch.bool, device=dev)
        # a pool with no sampling slot takes the sampler's argmax shortcut
        kw = (dict(temperature=self.temperature, top_k=self.top_k,
                   top_p=self.top_p) if sampling else {})
        for step in range(n):
            logits, _, _ = api.forward(
                self.params, {"tokens": self.last_tok[:, None]}, self.cfg,
                caches=self.caches, cache_pos=self.pos)
            nxt = sample(self.gen, logits[:, -1], **kw)
            # emit iff live and the cache has room for this token
            can = self.active & (self.pos + 1 < self.max_seq)
            hit_cap = self.active & ~can
            self.budget = torch.where(
                can, self.budget - 1,
                torch.where(hit_cap, torch.zeros_like(self.budget),
                            self.budget))
            active = can & (self.budget > 0)
            if self.eos_id is not None:
                active &= nxt != self.eos_id
            self.active = active
            self.pos = self.pos + can.to(torch.int64)
            self.last_tok = torch.where(can, nxt, self.last_tok)
            toks[step] = nxt
            valid[step] = can
        return toks, valid

    # -- host loop (chunk boundaries only) ----------------------------------
    def submit(self, req: Request):
        req.output = []
        self.queue.append(req)

    def _truncate(self, req: Request) -> np.ndarray:
        prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if prompt.size > self.max_seq:
            prompt = prompt[-max(1, self.max_seq - req.max_new_tokens):]
        return prompt

    def _admit_one(self, i: int, req: Request):
        prompt = self._truncate(req)
        plen = int(prompt.size)
        c = self.prefill_chunk
        slot_caches = api.init_cache(self.cfg, 1, self.max_seq,
                                     dtype=torch.float32, device=self.device)
        t0 = time.perf_counter()
        for j in range(0, plen - 1, c):
            vl = min(c, plen - 1 - j)
            buf = np.zeros((1, c), np.int64)
            buf[0, :vl] = prompt[j:j + vl]
            self._prefill_chunk(slot_caches,
                                torch.from_numpy(buf).to(self.device), j)
            self.prefill_dispatches += 1
            self.prefill_tokens += vl
        kvcache.merge_batch(self.caches, slot_caches, i)
        self.prefill_s += time.perf_counter() - t0

        live = req.max_new_tokens > 0
        self.pos[i] = plen - 1
        self.budget[i] = req.max_new_tokens
        self.last_tok[i] = int(prompt[-1])
        self.active[i] = live
        self.temperature[i] = float(req.temperature)
        self.top_k[i] = int(req.top_k)
        self.top_p[i] = float(req.top_p)
        self._sampling[i] = req.temperature > 0
        if live:
            self.slots[i] = req
        else:
            req.done = True

    def _admit(self) -> int:
        n = 0
        while self.queue:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                break
            self._admit_one(free[0], self.queue.popleft())
            n += 1
        return n

    def step(self) -> bool:
        """One chunk cycle: admit, decode N tokens per slot, retire."""
        admitted = self._admit()
        occupied = [i for i, r in enumerate(self.slots) if r is not None]
        self.peak_active_slots = max(self.peak_active_slots, len(occupied))
        if not occupied:
            return admitted > 0
        sampling = any(self._sampling[i] for i in occupied)
        t0 = time.perf_counter()
        toks, valid = self._decode_chunk(sampling)
        n, b = toks.shape
        # THE once-per-chunk sync: tokens, validity and liveness in one copy
        host = torch.cat([toks.reshape(-1), valid.reshape(-1).to(torch.int64),
                          self.active.to(torch.int64)]).cpu().numpy()
        self._chunk_s.append(time.perf_counter() - t0)
        self.decode_syncs += 1
        toks = host[:n * b].reshape(n, b)
        valid = host[n * b:2 * n * b].reshape(n, b).astype(bool)
        alive = host[2 * n * b:].astype(bool)
        for step in range(n):
            for i in occupied:
                if valid[step, i]:
                    self.slots[i].output.append(int(toks[step, i]))
                    self.decode_tokens += 1
        for i in occupied:
            if not alive[i]:
                self.slots[i].done = True
                self.slots[i] = None  # refillable at the next boundary
        return True

    def run_to_completion(self, max_ticks: int = 10000) -> int:
        ticks = 0
        while any(s is not None for s in self.slots) or self.queue:
            if not self.step():
                break
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("serving did not converge")
        return ticks

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        chunk_s = np.asarray(self._chunk_s or [0.0])
        decode_s = float(chunk_s.sum())
        return {
            "decode_chunk": self.decode_chunk,
            "prefill_chunk": self.prefill_chunk,
            "decode_syncs": self.decode_syncs,
            "decode_tokens": self.decode_tokens,
            "host_syncs_per_token": (self.decode_syncs
                                     / max(1, self.decode_tokens)),
            "prefill_dispatches": self.prefill_dispatches,
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_s,
            "p50_chunk_ms": float(np.percentile(chunk_s, 50)) * 1e3,
            "p95_chunk_ms": float(np.percentile(chunk_s, 95)) * 1e3,
            # decode-only throughput: excludes prefill and admission
            "decode_tok_s": (self.decode_tokens / decode_s
                             if decode_s else 0.0),
            "peak_active_slots": self.peak_active_slots,
            "cache_bytes": sum(c.numel() * c.element_size()
                               for c in self.caches),
        }
