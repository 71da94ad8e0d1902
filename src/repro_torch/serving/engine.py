"""Continuous-batching decode engine over a dense or block-paged KV cache.

The engine owns ``max_batch`` decode slots backed by one dense cache
[L, max_batch, max_seq, KV, hd], or, with ``cache_block_size``, by a pool of
blocks [L, num_cache_blocks, block_size, KV, hd] and a page table
[max_batch, max_seq / block_size] on the device. Per-slot control state (``pos``,
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

Paged admission (the reference's ``_admit_one_paged``) reserves, all or
nothing, ``ceil(min(plen + max_new, max_seq) / bs)`` blocks, FIFO: a request
the pool cannot hold waits at the head of the queue (``admit_blocked``).
With ``prefix_cache`` (``serving/blockpool.py``), the leading prompt blocks
that end at or below ``plen - 1`` are shared read-only with earlier prompts
of the same prefix, the block ending exactly at ``plen`` is copied on write,
and only the unshared suffix is prefilled. Retirement drops the slot's
block refs and points its row at the null block. Page-table rows are
written at chunk boundaries with asynchronous copies, so the host never
waits for the card outside the one sync per decode chunk.
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
from repro_torch.serving import blockpool
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
                 prefill_chunk: int = 32, eos_id: Optional[int] = None,
                 cache_block_size: Optional[int] = None,
                 num_cache_blocks: Optional[int] = None,
                 prefix_cache: bool = False):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.decode_chunk = max(1, decode_chunk)
        self.prefill_chunk = max(1, min(prefill_chunk, max_seq))
        self.eos_id = eos_id
        self._seed = seed
        self.paged = cache_block_size is not None
        self.prefix_caching = bool(prefix_cache) and self.paged
        if self.paged:
            bs = int(cache_block_size)
            if bs < 1 or max_seq % bs != 0:
                raise ValueError(
                    f"cache_block_size={bs} must be >= 1 and divide "
                    f"max_seq={max_seq}: the gathered paged view must be "
                    f"exactly max_seq long for bit-exact parity with dense")
            self.cache_block_size = bs
            self.blocks_per_slot = max_seq // bs
            if num_cache_blocks is None:
                # dense-equivalent capacity plus the reserved null block
                num_cache_blocks = max_batch * self.blocks_per_slot + 1
            if num_cache_blocks < self.blocks_per_slot + 1:
                raise ValueError(
                    f"num_cache_blocks={num_cache_blocks} cannot hold even "
                    f"one max_seq={max_seq} request at block size {bs} "
                    f"(need >= {self.blocks_per_slot + 1} incl. null block)")
            self.num_cache_blocks = int(num_cache_blocks)
        self.reset(seed=seed)

    # -- lifecycle ----------------------------------------------------------
    def reset(self, seed: Optional[int] = None):
        """Clear queue, slots, device state and counters."""
        seed = self._seed if seed is None else seed
        b, dev = self.max_batch, self.device
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * b
        self.page_table = None
        if self.paged:
            self._alloc = blockpool.BlockAllocator(self.num_cache_blocks)
            self._prefix = (blockpool.PrefixCache(self._alloc)
                            if self.prefix_caching else None)
            # divergence entries whose last position is unwritten until the
            # origin slot's first decode chunk
            self._pending_keys: set = set()
            self._slot_blocks: List[List[int]] = [[] for _ in range(b)]
            # the pool: attn_cache with (num_blocks, block_size) in place of
            # (batch, seq)
            self.caches = api.init_cache(self.cfg, self.num_cache_blocks,
                                         self.cache_block_size,
                                         dtype=torch.float32, device=dev)
            self.page_table = torch.zeros((b, self.blocks_per_slot),
                                          dtype=torch.int64, device=dev)
        else:
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
        # prompt tokens served from shared blocks instead of prefilled
        self.prefill_tokens_reused = 0
        self.prefill_s = 0.0
        self.admit_attempts = 0
        self.admit_blocked = 0  # admissions deferred for lack of blocks
        self.peak_active_slots = 0
        self._chunk_s: List[float] = []

    # -- device programs ----------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without making the host wait for the
        stream: an asynchronous copy from pageable memory returns once the
        CUDA runtime has staged the bytes, so ``arr`` may be dropped at once."""
        return torch.from_numpy(arr).to(self.device, non_blocking=True)

    def _prefill(self, prompt: np.ndarray, start: int, caches,
                 page_row=None):
        """Prefill ``prompt[start:-1]`` in fixed [1, C] chunks (the tail
        right-padded) into ``caches`` at offsets start, start + C, ...; the
        LM head is skipped (only the caches are kept)."""
        plen, c = int(prompt.size), self.prefill_chunk
        t0 = time.perf_counter()
        for j in range(start, plen - 1, c):
            vl = min(c, plen - 1 - j)
            buf = np.zeros((1, c), np.int64)
            buf[0, :vl] = prompt[j:j + vl]
            api.forward(self.params, {"tokens": self._to_device(buf)},
                        self.cfg, caches=caches, cache_pos=j, head=False,
                        page_table=page_row)
            self.prefill_dispatches += 1
            self.prefill_tokens += vl
        self.prefill_s += time.perf_counter() - t0

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
                caches=self.caches, cache_pos=self.pos,
                page_table=self.page_table)
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
        """Dense admission: prefill ``prompt[:-1]`` into a zeroed batch-1
        cache, then copy it into slot ``i``."""
        prompt = self._truncate(req)
        slot_caches = api.init_cache(self.cfg, 1, self.max_seq,
                                     dtype=torch.float32, device=self.device)
        self._prefill(prompt, 0, slot_caches)
        kvcache.merge_batch(self.caches, slot_caches, i)
        self._set_slot(i, req, prompt)

    def _set_slot(self, i: int, req: Request, prompt: np.ndarray) -> bool:
        """Per-slot control state of an admitted request; returns whether it
        has anything to generate."""
        plen = int(prompt.size)
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
        return live

    def _set_page_row(self, i: int, row: List[int]):
        """Slot ``i``'s page-table row := ``row`` then null blocks, by an
        asynchronous copy (see ``_to_device``)."""
        row_arr = np.zeros(self.blocks_per_slot, np.int64)
        row_arr[:len(row)] = row
        self.page_table[i].copy_(torch.from_numpy(row_arr), non_blocking=True)

    def _release(self, i: int):
        """Drop slot ``i``'s block refs and point its row at the null block,
        so its frozen-position writes stop touching pool blocks."""
        for bid in self._slot_blocks[i]:
            self._alloc.decref(bid)
        self._slot_blocks[i] = []
        self.page_table[i].zero_()

    def _admit_one_paged(self, i: int, req: Request) -> bool:
        """Paged admission: reserve blocks, reuse shared-prefix blocks,
        prefill only the unshared suffix. Returns False, leaving the request
        queued and the engine untouched, when the pool cannot grant the
        reservation."""
        prompt = self._truncate(req)
        plen = int(prompt.size)
        bs = self.cache_block_size
        # every position the slot can touch: prefill writes 0..plen-2,
        # decode plen-1 onward, and a finished slot rewrites its frozen
        # position until the next chunk boundary
        cap = min(plen + max(0, req.max_new_tokens), self.max_seq)
        n_need = max(1, -(-cap // bs))

        # block j is shared read-only only below the first decode write:
        # (j+1)*bs <= plen-1
        shared: List[int] = []
        cow_src = None
        m_share = (plen - 1) // bs
        if self._prefix is not None:
            for j in range(min(m_share, n_need)):
                key = blockpool.chain_key(prompt[:(j + 1) * bs])
                bid = self._prefix.get(key)
                if bid is None or key in self._pending_keys:
                    break
                shared.append(bid)
            if len(shared) == m_share and (m_share + 1) * bs == plen:
                # the divergence block ends exactly at plen: decode rewrites
                # its last position, so it is reused by copy (a pending
                # entry will do: the copy's tail is rewritten before read)
                cow_src = self._prefix.get(blockpool.chain_key(prompt))
        m0 = len(shared)

        # pin the shared blocks before eviction can drop their entries and
        # hand them back out to this same allocation
        pinned = shared + ([cow_src] if cow_src is not None else [])
        for bid in pinned:
            self._alloc.incref(bid)
        n_priv = n_need - m0
        blocks = self._alloc.alloc(n_priv)
        if blocks is None and self._prefix is not None:
            self._prefix.evict_until(n_priv)
            blocks = self._alloc.alloc(n_priv)
        if blocks is None:
            for bid in pinned:
                self._alloc.decref(bid)
            return False

        row = shared + blocks
        self._slot_blocks[i] = list(row)
        self._set_page_row(i, row)
        start = m0 * bs
        if cow_src is not None:
            for leaf in self.caches:
                leaf[:, blocks[0]].copy_(leaf[:, cow_src])
            self._alloc.decref(cow_src)  # the private copy is taken
            start += bs
        self.prefill_tokens_reused += min(start, plen - 1)
        self._prefill(prompt, start, self.caches,
                      page_row=self.page_table[i:i + 1])
        live = self._set_slot(i, req, prompt)

        # register the freshly written shareable blocks
        if self._prefix is not None:
            for j in range(m0, min(m_share, n_need)):
                self._prefix.put(
                    blockpool.chain_key(prompt[:(j + 1) * bs]), row[j])
            if live and (m_share + 1) * bs == plen and m_share < len(row):
                # usable for COW at once; shared by reference only after
                # this slot's first decode chunk writes position plen-1
                key = blockpool.chain_key(prompt)
                self._prefix.put(key, row[m_share])
                self._pending_keys.add(key)
        if not live:
            # nothing to generate: give the reservation back now (blocks
            # the prefix cache registered keep its own ref)
            self._release(i)
        return True

    def _admit(self) -> int:
        """FIFO admission into free slots; a paged request the pool cannot
        hold yet blocks the queue until blocks free up."""
        n = 0
        while self.queue:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                break
            self.admit_attempts += 1
            if self.paged:
                if not self._admit_one_paged(free[0], self.queue[0]):
                    self.admit_blocked += 1
                    break
            else:
                self._admit_one(free[0], self.queue[0])
            self.queue.popleft()
            n += 1
        return n

    def step(self) -> bool:
        """One chunk cycle: admit, decode N tokens per slot, retire."""
        admitted = self._admit()
        occupied = [i for i, r in enumerate(self.slots) if r is not None]
        self.peak_active_slots = max(self.peak_active_slots, len(occupied))
        if not occupied:
            if self.paged and self.queue and admitted == 0:
                # no live slot can ever free blocks: the head request needs
                # more than the pool can ever grant
                raise RuntimeError(
                    f"request {self.queue[0].uid} needs more cache blocks "
                    f"than the pool can ever free (num_cache_blocks="
                    f"{self.num_cache_blocks}, block={self.cache_block_size})")
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
        if self.paged:
            # each pending divergence entry's origin slot has now written
            # the entry's last position: fully shareable from here on
            self._pending_keys.clear()
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
                if self.paged:
                    self._release(i)
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
        out = {
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
            "paged": self.paged,
            "cache_hbm_bytes": sum(c.numel() * c.element_size()
                                   for c in self.caches),
            "admit_attempts": self.admit_attempts,
            "admit_blocked": self.admit_blocked,
            "admission_blocked_rate": (self.admit_blocked
                                       / max(1, self.admit_attempts)),
            "prefill_tokens_reused": self.prefill_tokens_reused,
        }
        if self.paged:
            out["cache_block_size"] = self.cache_block_size
            out["num_cache_blocks"] = self.num_cache_blocks
            out["blocks_in_use"] = self._alloc.num_used
            if self._prefix is not None:
                out["prefix_cache"] = {
                    "entries": len(self._prefix),
                    "hits": self._prefix.hits,
                    "misses": self._prefix.misses,
                    "evictions": self._prefix.evictions,
                }
        return out
