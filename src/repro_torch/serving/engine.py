"""Continuous-batching decode engine over a dense or block-paged KV cache.

The engine owns ``max_batch`` decode slots backed by one dense cache
[L, max_batch, max_seq, KV, hd], or, with ``cache_block_size``, by a pool of
blocks [L, num_cache_blocks, block_size, KV, hd] and a page table
[max_batch, max_seq / block_size] on the device. The attention caches are
f32, or with ``kv_cache_dtype="int8"`` (the argument, else
``cfg.kv_cache_dtype``, as in the reference) the int8 cache: codes and one
f32 scale a (position, head), four leaves that are pooled, copied and
forked like any other (``kvcache.attn_cache``). The SSM and hybrid
families' caches, and the VLM's and whisper's, are trees (``kvcache``
module docstring): the engine finds each leaf's batch and sequence axes by
probing ``api.init_cache`` on the meta device, as the reference probes
with ``jax.eval_shape``. Leaves with no sequence axis (SSM conv and
recurrent state, the image and encoder cross K/V: O(1) in the sequence a
slot) are slot-resident: under the block-paged pool they stay [..,
max_batch, ..], only the attention KV is pooled, and prefix caching is
turned off with a warning (such state cannot fan out by block reference).
Self-speculation is refused there (cumulative state cannot rewind a
rejected draft). Beam search forks every leaf along its own batch axis.
As in the reference, a request carries tokens only: the VLM's and
whisper's slots attend to a zero cross K/V. Per-slot control state (``pos``,
``budget``, ``last_tok``, ``active`` and the sampling params) lives on the
device, as in the reference's ``EngineState``:

  * a decode chunk runs ``decode_chunk`` steps for the whole pool: active
    masking, budget / max_seq / EOS stopping and sampling all happen on the
    device, the cache is written in place, and tokens collect in a device
    buffer. The host reads the buffer, the validity mask and the liveness
    once per chunk (one ``.cpu()``), not once per token;
  * admission prefills ``prompt[:-1]`` chunk by chunk into a zeroed batch-1
    slot cache at offsets 0, C, 2C, ... (fixed ``[1, C]`` chunks, the tail
    right-padded, with its count of real tokens passed as ``token_valid``
    so SSM state ends at the last real token), then copies it into the
    slot, leaf by leaf: a retired request's state never reaches the next
    occupant of its slot. The last prompt token is
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

Telemetry (``repro_torch.obs``): the engine's metrics registry always
exists, and its bounded-reservoir histograms are the engine's storage of
decode-chunk and prefill-chunk latencies and slot occupancy (O(reservoir)
however long it serves). A ``tracer`` records the reference's span
taxonomy: ``admit`` and ``prefill_chunk`` spans, a ``prefix_hit`` instant,
one ``decode_chunk`` span a chunk, and an async ``request`` span from
admission to retirement. Timestamps are ``perf_counter_ns`` reads at points
the host already reaches: the decode chunk's span ends at its one sync; a
prefill chunk's covers the host's enqueue time, as prefill does not sync.
Telemetry adds no device round-trip; with no tracer each site costs one
check. ``tuning_cache`` activates the measured plans ``fusion="tuned"``
reads (``core.autotune``); ``pretune()`` fills it.

Mesh (``plan``, the reference's ``plan=``): the engine shards the params
(``distributed.sharding.shard_params``; a tree sharded already is kept)
and runs every forward and cache allocation under ``plan_scope``. Every
rank runs this host logic on the same inputs, so the queue, slots,
admissions, retirements, page table and prefix cache are global and
identical on every rank. Model axis: its forwards return whole logits
(the head's vocab blocks gathered), its caches hold its KV heads, its
generator has the same seed. Data axis (D ranks): slot s belongs to data
rank s // (B / D), where D divides ``max_batch`` (else every data rank
owns every slot: the batch replicated, as the reference's
``resolve_physical_spec`` replicates it). A rank's device state, its
dense cache rows and its decode forwards hold its own B / D slots; every
rank draws the whole batch's sampling noise from the one seed and keeps
its rows (``sampler.uniform``), so a slot samples what it samples on one
device. A decode chunk's tokens, validity, liveness (and beam parents,
scores and spec counters) are gathered over the data axis in one
collective before the chunk's one host read. A beam group's W slots are
placed inside one data shard, so its forks stay on its rank. The paged
pool holds every block on every data rank with the page table global, as
the reference's does: every data rank prefills each admission into its
own copy (a batch-1 prefill is replicated over data), so shared prefix
blocks are equal everywhere; a pending divergence block, whose last
position the origin slot's owner writes in its first decode chunk, is
copied from that rank to the others before its entry becomes shareable.
With the dense cache only the owner prefills. ``host_syncs_per_token``
counts the engine's own reads, as on one device; the collectives' calls,
bytes and host seconds (in all and by axis) are reported under
``stats()["mesh"]``.

Decoding modes (``serving/decoding.py``) are per-slot state: a request's
``decoding`` is ``greedy``/``sample``, ``beam:W`` (W slots of one group,
forked every step) or ``spec:draftNb`` (self-speculation: K tokens drafted
with the top N bit-planes of the same packed weights, verified by one
s = K + 1 forward). A pool of NORMAL slots runs ``_decode_chunk``; a pool
holding beam or spec slots runs ``_decode_general``, the reference's
``_decode_general_impl``. Both sync once per chunk. Beam members of a paged
pool share the prompt blocks below ``plen - 1`` by reference and own
private copies of the rest; a group retires when all its members are
done, its hypotheses ranked by ``rank_hypotheses``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import warnings
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import ArchConfig
from repro_torch.core import mpgemm as mp
from repro_torch.core.tree import tree_leaves, tree_map, tree_map_with_path
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (AxisPlan, for_batch,
                                              plan_scope, shard_params)
from repro_torch.models import api, kvcache
from repro_torch.models import quantized as qz
from repro_torch.obs import dispatch as dispatch_obs
from repro_torch.obs.metrics import MetricsRegistry, export_stats
from repro_torch.obs.trace import Tracer
from repro_torch.serving import blockpool, decoding
from repro_torch.serving.sampler import categorical, mask_logits, sample


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [len] int
    max_new_tokens: int = 32
    temperature: float = 0.0           # <= 0 -> greedy
    top_k: int = 0                     # 0 -> disabled
    top_p: float = 1.0                 # >= 1 -> disabled
    decoding: str = "greedy"           # greedy | sample | beam[:W] | spec
    done: bool = False
    output: Optional[List[int]] = None
    # beam mode: every hypothesis as (tokens, length-normalized score), best
    # first
    beams: Optional[List[Tuple[List[int], float]]] = None
    # spec mode: verify_steps / accepted_draft_tokens of this request
    spec_stats: Optional[Dict[str, int]] = None


def _in_plan(method):
    """Runs an engine method under the engine's ``plan_scope``."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        with plan_scope(self.plan):
            return method(self, *args, **kw)
    return run


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 max_seq: int = 512, seed: int = 0, decode_chunk: int = 8,
                 prefill_chunk: int = 32, eos_id: Optional[int] = None,
                 cache_block_size: Optional[int] = None,
                 num_cache_blocks: Optional[int] = None,
                 prefix_cache: bool = False, spec_k: int = 4,
                 spec_draft_planes: Optional[int] = None,
                 beam_length_alpha: float = 0.6,
                 tuning_cache: Optional[str] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 kv_cache_dtype: Optional[str] = None,
                 plan: Optional[AxisPlan] = None):
        self.cfg = cfg
        self.max_batch = max_batch
        # the data axis: D data ranks own B / D slots each where D divides
        # B, else every slot (the batch replicated over data). ``plan`` runs
        # the decode forwards, ``_slot_plan`` a batch-1 prefill (replicated)
        d = 1 if plan is None else plan.axis_size("batch")
        self._dp = d if max_batch % d == 0 else 1
        self.local_batch = max_batch // self._dp
        self._lo = (plan.rank_along("batch") * self.local_batch
                    if self._dp > 1 else 0)
        self.plan = for_batch(plan, max_batch)
        self._slot_plan = for_batch(plan, 1)
        # the whole batch's sampling noise, this rank's rows kept
        self._draw = (self._lo, max_batch) if self._dp > 1 else None
        # beam groups stay inside one of these contiguous slot blocks: the
        # data shards, or a data-axis control's row blocks
        self._shards = self._dp if plan is not None else (
            params.get("rows", 1) if max_batch % params.get("rows", 1) == 0
            else 1)
        if plan is not None and (plan.axis_size("model") > 1 or d > 1) \
                and cfg.family not in api.MESH_FAMILIES:
            raise ValueError(
                f"{cfg.arch_id}: the {cfg.family} family does not run "
                "under a mesh yet (only dense and MoE do): ROADMAP.md "
                "queue 1 item 9")
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._h_chunk_s = self.metrics.histogram(
            "engine_decode_chunk_seconds",
            help="wall seconds per decode-chunk dispatch (sync to sync)",
            unit="s")
        self._h_occupancy = self.metrics.histogram(
            "engine_slot_occupancy_ratio",
            help="occupied slots / max_batch, sampled once per chunk")
        self._h_prefill_s = self.metrics.histogram(
            "engine_prefill_chunk_seconds",
            help="wall seconds per prefill-chunk dispatch", unit="s")
        # the measured plans fusion="tuned" reads for every projection
        self.tuning_cache = None
        if tuning_cache is not None:
            from repro_torch.core import autotune
            self.tuning_cache = autotune.configure(tuning_cache)
        if plan is not None and plan.fsdp is not None:
            raise ValueError("serving takes a plan without FSDP "
                             "(launch.mesh.make_plan(mesh, fsdp=False)), as "
                             "the reference's serve does")
        if plan is not None:  # this rank's blocks
            params = shard_params(params, plan, cfg)
        self.device = params["embed"]["table"].device
        self.params = self._weight_store(cfg, params, spec_draft_planes)
        params = self.params
        # decoding modes: the spec draft is a plane-sliced view of the same
        # packed buffers (zero extra weight bytes, checked by identity)
        self.spec_k = max(1, int(spec_k))
        self.spec_draft_planes = spec_draft_planes
        self.beam_length_alpha = float(beam_length_alpha)
        self.draft_params = None
        self.draft_extra_hbm_bytes = 0
        if spec_draft_planes is not None:
            self.draft_params = qz.plane_sliced_params(params,
                                                       int(spec_draft_planes))
            self.draft_extra_hbm_bytes = qz.extra_hbm_bytes(
                self.draft_params, params)
        self.max_seq = max_seq
        self.decode_chunk = max(1, decode_chunk)
        self.prefill_chunk = max(1, min(prefill_chunk, max_seq))
        self.eos_id = eos_id
        self._seed = seed
        # the cache dtype, resolved as the reference resolves it: "int8"
        # (the argument, else cfg.kv_cache_dtype) is the int8 cache, any
        # other value an f32 one
        kv_dt = kv_cache_dtype or cfg.kv_cache_dtype
        self._cache_dtype = "int8" if kv_dt == "int8" else torch.float32
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
        # per-leaf batch and sequence axes of the cache tree, probed on the
        # meta device (shapes only): SSM leaves have no sequence axis
        def probe(batch, seq):
            with plan_scope(self.plan):
                return api.init_cache(cfg, batch, seq,
                                      dtype=self._cache_dtype, device="meta")
        self._slot_probe = probe(1, max_seq)
        self._axes = kvcache.batch_axes(self._slot_probe, probe(2, max_seq))
        seq_axes = kvcache.seq_axes(probe(1, 16), probe(1, 32))
        self._pooled = tree_map(lambda sax: sax >= 0, seq_axes)
        # every leaf positional: what self-speculation (it rewrites cache
        # positions), beam forks and prefix caching need
        pooled = tree_leaves(self._pooled)
        self._has_pooled, self._all_pooled = any(pooled), all(pooled)
        if self.paged:
            # a pooled leaf carries (batch, seq) adjacently, so
            # init_cache(cfg, num_blocks, block_size) is its pool
            def check(path, bax, sax):
                if sax >= 0 and sax != bax + 1:
                    raise ValueError(
                        f"cannot page cache leaf at {path!r}: sequence axis "
                        f"{sax} is not adjacent to batch axis {bax}")
            tree_map_with_path(check, self._axes, seq_axes)
            if self.prefix_caching and not self._all_pooled:
                warnings.warn(
                    "prefix caching needs every cache leaf paged; family="
                    f"{cfg.family!r} holds slot-resident state (SSM/cross "
                    "KV) that cannot fan out by block reference — disabled")
                self.prefix_caching = False
        self.reset(seed=seed)

    def _weight_store(self, cfg, params, spec_draft_planes):
        """The params the engine serves. As the reference's engine does, on
        the CPU under lut_xla with no ``quant["store"]`` and no
        self-speculation (whose draft slices the packed planes) the packed
        weights are expanded once into the offline-CW store, which lut_xla
        reads without rebuilding CW each step (same bits); ``store="cw"``
        asks for it anywhere, ``store="packed"`` keeps the planes. A tree
        holding CW weights serves only under lut_xla: other modes raise
        here, where the reference's kernels would fail inside a step."""
        quant = cfg.quant or {}
        mode = quant.get("mpgemm_mode", "lut_xla")
        store = quant.get("store")
        if quant and (store == "cw" or (
                store is None and mode == "lut_xla"
                and self.device.type == "cpu"
                and spec_draft_planes is None)):
            params = qz.to_cw_params(params)
        if mode != "lut_xla" and qz.has_cw(params):
            raise ValueError(f"{cfg.arch_id}: " + mp.cw_refusal(mode))
        return params

    # -- lifecycle ----------------------------------------------------------
    @_in_plan
    def reset(self, seed: Optional[int] = None):
        """Clear queue, slots, device state and counters."""
        seed = self._seed if seed is None else seed
        # host state: every slot; device state: this rank's slots
        nb, b, dev = self.max_batch, self.local_batch, self.device
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * nb
        self.page_table = self._local_pt = None
        if self.paged:
            self._alloc = blockpool.BlockAllocator(self.num_cache_blocks,
                                                   metrics=self.metrics)
            self._prefix = (blockpool.PrefixCache(self._alloc,
                                                  metrics=self.metrics)
                            if self.prefix_caching else None)
            # divergence entries whose last position is unwritten until the
            # origin slot's first decode chunk: key -> (block, origin slot)
            self._pending_keys: Dict[Any, Tuple[int, int]] = {}
            self._slot_blocks: List[List[int]] = [[] for _ in range(nb)]
            # pooled leaves: (num_blocks, block_size) in place of (batch,
            # seq); slot-resident leaves: dense [.., max_batch, ..]
            # leaves start at a fresh cache's constant value: zeros, the
            # int8 cache's scales ones
            kw = dict(dtype=self._cache_dtype, device="meta")
            pool = api.init_cache(self.cfg, self.num_cache_blocks,
                                  self.cache_block_size, **kw)
            dense = api.init_cache(self.cfg, b, self.max_seq, **kw)
            fill = tree_map(lambda c: c.reshape(-1)[0].item(), api.init_cache(
                self.cfg, 1, 1, dtype=self._cache_dtype, device="cpu"))
            self.caches = tree_map(
                lambda p, d, pooled, f: torch.full(
                    (p if pooled else d).shape, f, dtype=p.dtype, device=dev),
                pool, dense, self._pooled, fill)
            # global rows; this rank's forwards read its own (a view)
            self.page_table = torch.zeros((nb, self.blocks_per_slot),
                                          dtype=torch.int64, device=dev)
            self._local_pt = (self.page_table if self._dp == 1 else
                              self.page_table[self._lo:self._lo + b])
        else:
            self.caches = api.init_cache(self.cfg, b, self.max_seq,
                                         dtype=self._cache_dtype, device=dev)
        zeros = lambda dtype: torch.zeros(b, dtype=dtype, device=dev)
        self.pos = zeros(torch.int64)        # next cache write position
        self.budget = zeros(torch.int64)     # remaining new tokens
        self.last_tok = zeros(torch.int64)   # next token to feed
        self.active = zeros(torch.bool)
        self.temperature = zeros(torch.float32)
        self.top_k = zeros(torch.int64)
        self.top_p = torch.ones(b, dtype=torch.float32, device=dev)
        self.mode = zeros(torch.int64)       # decoding kind per slot
        self.beam_group = torch.full((b,), -1, dtype=torch.int64, device=dev)
        self.beam_score = zeros(torch.float32)  # cumulative log-prob
        self.spec_steps = zeros(torch.int64)    # verify rounds run
        self.spec_accepted = zeros(torch.int64)  # drafts accepted, emitted
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self._sampling = [False] * nb        # host mirror: temperature > 0
        # host mirrors of the decoding state
        self._slot_kind = [decoding.NORMAL] * nb
        self._beam_hist: List[List[int]] = [[] for _ in range(nb)]
        self._beam_groups: Dict[int, Dict[str, Any]] = {}  # leader -> group
        self.spec_verify_steps = 0      # totals of retired spec requests
        self.spec_accepted_tokens = 0
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
        self._h_chunk_s.reset()
        self._h_occupancy.reset()
        self._h_prefill_s.reset()

    # -- device programs ----------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without making the host wait for the
        stream: an asynchronous copy from pageable memory returns once the
        CUDA runtime has staged the bytes, so ``arr`` may be dropped at once."""
        return torch.from_numpy(arr).to(self.device, non_blocking=True)

    def _annotate(self, name: str):
        """The tracer's ``torch.profiler`` annotation of a span, or a
        no-op context without a tracer."""
        return (contextlib.nullcontext() if self.tracer is None
                else self.tracer.annotation(name))

    def _prefill(self, prompt: np.ndarray, start: int, caches,
                 page_row=None, *, uid: int = -1, slot: int = -1,
                 run: bool = True) -> Tuple[int, int]:
        """Prefill ``prompt[start:-1]`` in fixed [1, C] chunks (the tail
        right-padded) into ``caches`` at offsets start, start + C, ...; the
        LM head is skipped (only the caches are kept). Each chunk's host
        time (its enqueue: prefill does not sync) goes to the prefill
        histogram and, with a tracer, a ``prefill_chunk`` span of request
        ``uid`` in ``slot``. Returns the (start, end) ``perf_counter_ns``.
        A batch-1 prefill is replicated over the data axis
        (``_slot_plan``); ``run=False`` (a data rank that does not own the
        dense slot) counts the chunks without running them."""
        plen, c = int(prompt.size), self.prefill_chunk
        t0 = tc = time.perf_counter_ns()
        for j in range(start, plen - 1, c):
            vl = min(c, plen - 1 - j)
            self.prefill_dispatches += 1
            self.prefill_tokens += vl
            if not run:
                continue
            buf = np.zeros((1, c), np.int64)
            buf[0, :vl] = prompt[j:j + vl]
            # a right-padded tail: its real tokens, so SSM state ends there
            valid = (None if vl == c
                     else self._to_device(np.array([vl], np.int64)))
            with self._annotate("prefill_chunk"), \
                    plan_scope(self._slot_plan):
                api.forward(self.params, {"tokens": self._to_device(buf)},
                            self.cfg, caches=caches, cache_pos=j, head=False,
                            page_table=page_row, token_valid=valid)
            tn = time.perf_counter_ns()
            self._h_prefill_s.observe((tn - tc) / 1e9)
            if self.tracer is not None:
                self.tracer.complete("prefill_chunk", tc, tn, cat="prefill",
                                     uid=uid, slot=slot, offset=j, valid=vl)
            tc = tn
        t1 = time.perf_counter_ns()
        self.prefill_s += (t1 - t0) / 1e9
        return t0, t1

    @_in_plan
    def _decode_chunk(self, sampling: bool):
        """``decode_chunk`` steps for the whole pool (this rank's slots),
        all on the device. Returns device tensors toks / valid [N, B]."""
        n, b, dev = self.decode_chunk, self.local_batch, self.device
        toks = torch.empty((n, b), dtype=torch.int64, device=dev)
        valid = torch.empty((n, b), dtype=torch.bool, device=dev)
        # a pool with no sampling slot takes the sampler's argmax shortcut
        kw = (dict(temperature=self.temperature, top_k=self.top_k,
                   top_p=self.top_p) if sampling else {})
        for step in range(n):
            logits, _, _ = api.forward(
                self.params, {"tokens": self.last_tok[:, None]}, self.cfg,
                caches=self.caches, cache_pos=self.pos,
                page_table=self._local_pt)
            nxt = sample(self.gen, logits[:, -1], rows=self._draw, **kw)
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

    @_in_plan
    def _forward(self, params, tokens, cache_pos):
        """A per-slot forward over the pool's caches; logits [B, s, V]."""
        return api.forward(params, {"tokens": tokens}, self.cfg,
                           caches=self.caches, cache_pos=cache_pos,
                           page_table=self._local_pt)[0]

    def _copy_blocks(self, src: List[int], dst: List[int]):
        """Pool blocks ``src`` -> ``dst`` on every pooled leaf, along its
        block (batch) axis; slot-resident leaves are left as they are."""
        src_t, dst_t = (self._to_device(np.asarray(ids, np.int64))
                        for ids in (src, dst))
        tree_map(
            lambda c, ax, pooled: c.index_copy_(
                ax, dst_t, c.index_select(ax, src_t)) if pooled else None,
            self.caches, self._axes, self._pooled)

    def _beam_fork_caches(self, parent: torch.Tensor, do_copy: torch.Tensor):
        """Beam reassignment after a step's forward: slot b takes slot
        parent[b]'s cache, the parent's fresh position included, on every
        leaf along its own batch axis (the reference's
        ``_beam_fork_caches``). Dense, and a paged pool's slot-resident
        leaves (SSM state, cross K/V): a batch gather (identity rows for
        slots that keep their own). Pooled leaves: block content from the
        parent's row into the slot's row, and slots that do not fork write
        to the null block 0. Duplicate destinations are harmless: group
        members share the same prefix blocks (a block copied onto itself)
        and own every later block."""
        src = dst = None
        if self.paged:
            src = self._local_pt[parent].reshape(-1)
            dst = torch.where(do_copy[:, None], self._local_pt,
                              0).reshape(-1)

        def fork(c, ax, pooled):
            if self.paged and pooled:
                cm = c.movedim(ax, 0)  # a view: the assignment writes c
                cm[dst] = cm[src]
            else:
                c.copy_(c.index_select(ax, parent))
        tree_map(fork, self.caches, self._axes, self._pooled)

    def _decode_general(self, has_beam: bool, has_spec: bool,
                        sampling: bool):
        """``decode_chunk`` steps of a pool holding beam or spec slots (the
        reference's ``_decode_general_impl``), all on the device. Returns
        device tensors toks / valid [N, B, S_e] (S_e = spec_k + 1 when the
        pool holds spec slots, else 1) and the beam parent map [N, B] (as
        global slot indices).

        A spec slot's step: (1) draft K tokens one at a time with the
        plane-sliced view, writing provisional KV at pos .. pos+K-1; (2) one
        s = K+1 forward of the full model over [last_tok, d_0 .. d_{K-1}]
        rewrites pos .. pos+K; (3) accept the longest agreeing prefix (argmax
        agreement for greedy slots, so their tokens are plain greedy
        decoding's), emit it and the replacement or bonus token, and advance
        pos by the count emitted. Other slots ride along and emit at most
        their position-0 token; beam slots take theirs from
        ``beam_select``, and the caches fork to match. ``sampling`` (the
        host mirror: any slot samples) decides the sampler's and
        ``speculative_accept``'s greedy shortcut without a device sync."""
        n, b, dev = self.decode_chunk, self.local_batch, self.device
        k_spec = self.spec_k
        s_e = k_spec + 1 if has_spec else 1
        toks = torch.empty((n, b, s_e), dtype=torch.int64, device=dev)
        valid = torch.empty((n, b, s_e), dtype=torch.bool, device=dev)
        parents = torch.empty((n, b), dtype=torch.int64, device=dev)
        self_idx = torch.arange(b, device=dev)
        kw = (dict(temperature=self.temperature, top_k=self.top_k,
                   top_p=self.top_p) if sampling else {})
        for step in range(n):
            greedy = self.temperature <= 0.0
            is_spec = self.mode == decoding.SPEC
            if has_spec:
                # a draft past the cache runs at max_seq - 1 instead (an s = 1
                # write must stay in range). No emitted token reads that
                # position: token j is emitted only while pos + 1 + j <
                # max_seq, so its logits read positions below max_seq - 1,
                # and the verify burst rewrites max_seq - 1 before reading it
                last, dpos = self.last_tok, self.pos
                d_toks, q_logits = [], []
                for _ in range(k_spec):
                    dl = self._forward(
                        self.draft_params, last[:, None],
                        dpos.clamp(max=self.max_seq - 1))[:, -1]
                    d = torch.argmax(dl, dim=-1)
                    if sampling:
                        ml = mask_logits(dl, **kw)
                        d = torch.where(greedy, d, categorical(
                            self.gen, ml, self._draw))
                        q_logits.append(ml)
                    d_toks.append(d)
                    last, dpos = d, dpos + 1
                d_toks = torch.stack(d_toks, dim=1)            # [B, K]
                vlogits = self._forward(
                    self.params, torch.cat([self.last_tok[:, None], d_toks],
                                           dim=1), self.pos)   # [B, K+1, V]
                logits1 = vlogits[:, 0]  # the s = 1 forward's logits
                q = p = None
                if sampling:
                    q = torch.stack(q_logits, dim=1)
                    p = torch.stack([mask_logits(vlogits[:, j], **kw)
                                     for j in range(k_spec + 1)], dim=1)
                accept, repl, bonus = decoding.speculative_accept(
                    self.gen, d_toks, q, p, torch.argmax(vlogits, dim=-1),
                    greedy, sampling=sampling, rows=self._draw)
            else:
                logits1 = self._forward(self.params, self.last_tok[:, None],
                                        self.pos)[:, -1]

            # position-0 token per mode
            tok0 = sample(self.gen, logits1, rows=self._draw, **kw)
            parent, beam_score = self_idx, self.beam_score
            if has_beam:
                is_beam = self.mode == decoding.BEAM
                live_beam = is_beam & self.active
                parent, btok, beam_score = decoding.beam_select(
                    self.beam_score,
                    torch.log_softmax(logits1.to(torch.float32), dim=-1),
                    live_beam, self.beam_group)
                self._beam_fork_caches(parent, live_beam)
                tok0 = torch.where(is_beam, btok, tok0)

            # emission chain: token j is emitted while every earlier draft
            # was accepted, the slot is live, the cache has room, the budget
            # lasts and no EOS came before it
            cum = torch.ones(b, dtype=torch.bool, device=dev)
            prior_eos = torch.zeros_like(cum)
            n_emit = torch.zeros(b, dtype=torch.int64, device=dev)
            acc_emitted = torch.zeros_like(n_emit)
            for j in range(s_e):
                tok_j = tok0
                if has_spec:
                    tok_j = (torch.where(accept[:, j], d_toks[:, j], repl[:, j])
                             if j < k_spec else bonus)
                    if j == 0:
                        tok_j = torch.where(is_spec, tok_j, tok0)
                allow = (cum & self.active & (self.pos + 1 + j < self.max_seq)
                         & (self.budget > j) & ~prior_eos)
                if j > 0:
                    allow &= is_spec
                if self.eos_id is not None:
                    prior_eos = prior_eos | (allow & (tok_j == self.eos_id))
                toks[step, :, j] = tok_j
                valid[step, :, j] = allow
                n_emit = n_emit + allow.to(torch.int64)
                if has_spec and j < k_spec:
                    acc_emitted = acc_emitted + (
                        allow & accept[:, j] & is_spec).to(torch.int64)
                    cum = cum & accept[:, j]

            # slot state
            emitted = n_emit > 0
            last_emitted = torch.gather(
                toks[step], 1, (n_emit - 1).clamp(0, s_e - 1)[:, None])[:, 0]
            hit_cap = self.active & (self.pos + 1 >= self.max_seq)
            ran_spec = is_spec & self.active & emitted
            self.last_tok = torch.where(emitted, last_emitted, self.last_tok)
            self.pos = self.pos + n_emit
            self.budget = torch.where(hit_cap, torch.zeros_like(self.budget),
                                      self.budget - n_emit)
            self.active = (self.active & emitted & (self.budget > 0)
                           & ~prior_eos)
            self.beam_score = beam_score
            self.spec_steps = self.spec_steps + ran_spec.to(torch.int64)
            self.spec_accepted = self.spec_accepted + torch.where(
                ran_spec, acc_emitted, 0)
            parents[step] = parent + self._lo
        return toks, valid, parents

    # -- host loop (chunk boundaries only) ----------------------------------
    def submit(self, req: Request):
        # parse now, so a bad decoding string or an unservable mode fails
        # here and not at admission
        dm = decoding.parse(req.decoding)
        if dm.kind == decoding.SPEC:
            if self.draft_params is None:
                raise ValueError(
                    "spec decoding needs a draft view: construct the engine "
                    "with spec_draft_planes=<planes> (and packed weights)")
            if not self._all_pooled:
                raise ValueError(
                    f"self-speculative decoding unsupported for family "
                    f"{self.cfg.family!r}: its cache holds cumulative "
                    "(SSM/conv) state that cannot rewind rejected drafts")
        shard = self.max_batch // self._shards
        if dm.kind == decoding.BEAM and dm.beam_width > shard:
            raise ValueError(
                f"beam width {dm.beam_width} exceeds max_batch "
                f"{self.max_batch}" + (f" / {self._shards} data shards"
                                       if self._shards > 1 else "")
                + ": the W hypotheses are W pool slots of one shard")
        req.output = []
        self.queue.append(req)

    def _truncate(self, req: Request) -> np.ndarray:
        prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if prompt.size > self.max_seq:
            prompt = prompt[-max(1, self.max_seq - req.max_new_tokens):]
        return prompt

    def _local(self, i: int) -> Optional[int]:
        """Slot ``i``'s row in this rank's device state, None where another
        data rank owns it."""
        j = i - self._lo
        return j if 0 <= j < self.local_batch else None

    def _admit_one(self, i: int, req: Request):
        """Dense admission: prefill ``prompt[:-1]`` into a zeroed batch-1
        cache, then copy it into slot ``i`` leaf by leaf (on the data rank
        that owns the slot)."""
        prompt = self._truncate(req)
        j = self._local(i)
        slot_caches = None
        if j is not None:
            with plan_scope(self._slot_plan):
                slot_caches = api.init_cache(self.cfg, 1, self.max_seq,
                                             dtype=self._cache_dtype,
                                             device=self.device)
        with self._annotate("admit"):
            t0, t1 = self._prefill(prompt, 0, slot_caches, uid=req.uid,
                                   slot=i, run=j is not None)
        if self.tracer is not None:
            self.tracer.complete("admit", t0, t1, uid=req.uid, slot=i,
                                 prompt_len=int(prompt.size),
                                 mode=req.decoding, paged=False)
        if j is not None:
            kvcache.merge_batch(self.caches, slot_caches, j, self._axes)
        self._set_slot(i, req, prompt)

    def _set_slot(self, i: int, req: Request, prompt: np.ndarray, *,
                  leader: Optional[int] = None) -> bool:
        """Per-slot control state of an admitted request; returns whether it
        has anything to generate. A beam request's leader has group id i and
        score 0; a member (``leader`` given) gets the leader's id and score
        ``NEG``, so the first expansion fans the leader out to the full
        width."""
        plen = int(prompt.size)
        live = req.max_new_tokens > 0
        kind = decoding.parse(req.decoding).kind
        j = self._local(i)
        if j is not None:  # this rank's slot: its device state
            self.pos[j] = plen - 1
            self.budget[j] = req.max_new_tokens
            self.last_tok[j] = int(prompt[-1])
            self.active[j] = live
            self.temperature[j] = float(req.temperature)
            self.top_k[j] = int(req.top_k)
            self.top_p[j] = float(req.top_p)
            self.mode[j] = kind
            self.beam_group[j] = (-1 if kind != decoding.BEAM
                                  else i if leader is None else leader)
            self.beam_score[j] = 0.0 if leader is None else decoding.NEG
            self.spec_steps[j] = 0
            self.spec_accepted[j] = 0
        self._sampling[i] = req.temperature > 0
        self._slot_kind[i] = kind
        self._beam_hist[i] = []
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
        reservation. Slot-resident leaves (SSM state) are prefilled from a
        zeroed batch-1 view and copied into slot ``i``; a tree with no
        pooled leaf (falcon-mamba) reserves no block."""
        prompt = self._truncate(req)
        plen = int(prompt.size)
        bs = self.cache_block_size
        # every position the slot can touch: prefill writes 0..plen-2,
        # decode plen-1 onward, and a finished slot rewrites its frozen
        # position until the next chunk boundary
        cap = min(plen + max(0, req.max_new_tokens), self.max_seq)
        n_need = max(1, -(-cap // bs)) if self._has_pooled else 0

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
            self._copy_blocks([cow_src], blocks[:1])
            self._alloc.decref(cow_src)  # the private copy is taken
            start += bs
        self.prefill_tokens_reused += min(start, plen - 1)
        if self.tracer is not None and (m0 > 0 or cow_src is not None):
            self.tracer.instant("prefix_hit", cat="prefill", uid=req.uid,
                                slot=i, shared_blocks=m0,
                                cow=cow_src is not None,
                                tokens_reused=min(start, plen - 1))
        # pooled leaves: the pool itself; slot-resident ones: a zeroed
        # batch-1 view, copied into slot i after the prefill (a mesh's
        # families have none)
        view = tree_map(
            lambda c, z, pooled: c if pooled else torch.zeros(
                z.shape, dtype=z.dtype, device=self.device),
            self.caches, self._slot_probe, self._pooled)
        with self._annotate("admit"):
            t0, t1 = self._prefill(prompt, start, view,
                                   page_row=self.page_table[i:i + 1],
                                   uid=req.uid, slot=i)
        if not self._all_pooled:
            tree_map(
                lambda c, v, ax, pooled: None if pooled else c.narrow(
                    ax, i, 1).copy_(v),
                self.caches, view, self._axes, self._pooled)
        if self.tracer is not None:
            self.tracer.complete("admit", t0, t1, uid=req.uid, slot=i,
                                 prompt_len=plen, mode=req.decoding,
                                 paged=True, shared_blocks=m0,
                                 cow=cow_src is not None)
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
                self._pending_keys[key] = (row[m_share], i)
        if not live:
            # nothing to generate: give the reservation back now (blocks
            # the prefix cache registered keep its own ref)
            self._release(i)
        return True

    def _evict_slot(self, i: int):
        """Beam admission rollback: give back slot ``i``'s blocks and
        deactivate it."""
        if self.paged:
            self._release(i)
        if self._local(i) is not None:
            self.active[self._local(i)] = False
        self.slots[i] = None
        self._slot_kind[i] = decoding.NORMAL
        self._beam_hist[i] = []

    def _admit_beam(self, slots_w: List[int], req: Request) -> bool:
        """Admit a beam request into ``len(slots_w)`` slots: the leader
        through the ordinary admission (one prefill), the members as forks
        of it. Dense: the leader's cache row copied into each member's.
        Paged: the leader's blocks below ``plen - 1`` shared by reference
        (immutable for the group's life), the rest copied into private
        blocks, and the slot-resident leaves' rows copied. Returns False,
        the request left queued and every slot rolled back, when the pool
        cannot grant every member's blocks."""
        lead = slots_w[0]
        if self.paged:
            if not self._admit_one_paged(lead, req):
                return False
        else:
            self._admit_one(lead, req)
        prompt = self._truncate(req)
        stamped = [lead]
        for m in slots_w[1:]:
            if self.paged:
                lead_row = self._slot_blocks[lead]
                m_share = min((int(prompt.size) - 1) // self.cache_block_size,
                              len(lead_row))
                n_priv = len(lead_row) - m_share
                blocks = self._alloc.alloc(n_priv)
                if blocks is None and self._prefix is not None:
                    self._prefix.evict_until(n_priv)
                    blocks = self._alloc.alloc(n_priv)
                if blocks is None:
                    # the eviction above stops early only once the free list
                    # suffices, so a failed allocation has emptied any prefix
                    # cache: no entry the leader registered survives, its
                    # pending divergence entry (position plen-1 unwritten)
                    # included
                    for i in stamped:
                        self._evict_slot(i)
                    return False
                for bid in lead_row[:m_share]:
                    self._alloc.incref(bid)
                if blocks:
                    self._copy_blocks(lead_row[m_share:], blocks)
                # slot-resident leaves: the leader's row (the reference's
                # ``_fork_slot``)
                tree_map(
                    lambda c, ax, pooled: None if pooled else c.narrow(
                        ax, m, 1).copy_(c.narrow(ax, lead, 1)),
                    self.caches, self._axes, self._pooled)
                row = lead_row[:m_share] + blocks
                self._slot_blocks[m] = list(row)
                self._set_page_row(m, row)
            elif self._local(m) is not None:  # the group's data rank
                kvcache.merge_batch(
                    self.caches, kvcache.slice_batch(
                        self.caches, self._local(lead), self._axes),
                    self._local(m), self._axes)
            self._set_slot(m, req, prompt, leader=lead)
            stamped.append(m)
        self._beam_groups[lead] = {"req": req, "slots": list(slots_w),
                                   "live": set(slots_w), "finished": []}
        return True

    def _free_slots(self, width: int) -> Optional[List[int]]:
        """The first ``width`` free slots inside one shard (the first shard
        that has them: a beam group stays on one data rank), or None."""
        per = self.max_batch // self._shards
        for lo in range(0, self.max_batch, per):
            free = [i for i in range(lo, lo + per) if self.slots[i] is None]
            if len(free) >= width:
                return free
        return None

    def _admit(self) -> int:
        """FIFO admission into free slots; a request waits at the head of
        the queue until its width (beam: W slots) is free and, paged, until
        the pool can hold it."""
        n = 0
        while self.queue:
            req = self.queue[0]
            dm = decoding.parse(req.decoding)
            beam = dm.kind == decoding.BEAM and req.max_new_tokens > 0
            width = dm.beam_width if beam else 1
            free = self._free_slots(width)
            if free is None:
                break
            self.admit_attempts += 1
            if beam:
                ok = self._admit_beam(free[:width], req)
            elif self.paged:
                ok = self._admit_one_paged(free[0], req)
            else:
                self._admit_one(free[0], req)
                ok = True
            if not ok:
                self.admit_blocked += 1
                break
            self.queue.popleft()
            if self.tracer is not None:
                self.tracer.async_begin("request", id=req.uid,
                                        mode=req.decoding, width=width)
                if req.done:  # max_new_tokens <= 0: retires at admission
                    self.tracer.async_end("request", id=req.uid, tokens=0)
            n += 1
        return n

    @_in_plan
    def step(self) -> bool:
        """One chunk cycle: admit, decode N tokens per slot, retire."""
        admitted = self._admit()
        occupied = [i for i, r in enumerate(self.slots) if r is not None]
        occ = len(occupied)
        self.peak_active_slots = max(self.peak_active_slots, occ)
        if not occupied:
            if self.paged and self.queue and admitted == 0:
                # no live slot can ever free blocks: the head request needs
                # more than the pool can ever grant
                raise RuntimeError(
                    f"request {self.queue[0].uid} needs more cache blocks "
                    f"than the pool can ever free (num_cache_blocks="
                    f"{self.num_cache_blocks}, block={self.cache_block_size})")
            return admitted > 0
        self._h_occupancy.observe(occ / self.max_batch)
        sampling = any(self._sampling[i] for i in occupied)
        # a pool of NORMAL slots runs the one-token program; beam or spec
        # slots the general one
        has_beam = any(self._slot_kind[i] == decoding.BEAM for i in occupied)
        has_spec = any(self._slot_kind[i] == decoding.SPEC for i in occupied)
        t0 = time.perf_counter_ns()
        with self._annotate("decode_chunk"):
            toks, valid, parent, alive, scores, sst, sacc = self._run_chunk(
                has_beam, has_spec, sampling)
        t1 = time.perf_counter_ns()  # the timestamp the sync already earned
        self.decode_syncs += 1
        self._h_chunk_s.observe((t1 - t0) / 1e9)
        if self.tracer is not None:
            self.tracer.complete(
                "decode_chunk", t0, t1, cat="decode", steps=self.decode_chunk,
                active_slots=occ, occupancy=occ / self.max_batch,
                has_beam=has_beam, has_spec=has_spec)
        n = toks.shape[0]
        if self.paged:
            # each pending divergence entry's origin slot has now written
            # the entry's last position: fully shareable from here on (on
            # every data rank, once the owner's copy has reached them)
            if self._dp > 1 and self._pending_keys:
                self._share_blocks(self._pending_keys.values())
            self._pending_keys.clear()
        for step in range(n):
            if has_beam:
                # hypothesis histories fork as the caches do: read every
                # parent's history before committing any
                moved = {i: list(self._beam_hist[parent[step, i]])
                         for i in occupied
                         if self._slot_kind[i] == decoding.BEAM
                         and valid[step, i, 0]}
                for i, hist in moved.items():
                    hist.append(int(toks[step, i, 0]))
                    self._beam_hist[i] = hist
                    self.decode_tokens += 1
            for i in occupied:
                if self._slot_kind[i] == decoding.BEAM:
                    continue  # recorded above
                for j in range(toks.shape[2]):
                    if valid[step, i, j]:
                        self.slots[i].output.append(int(toks[step, i, j]))
                        self.decode_tokens += 1
        self._retire(occupied, alive, scores, sst, sacc)
        return True

    def _share_blocks(self, entries):
        """Each (block, origin slot) of ``entries``: the block as the data
        rank that owns the slot holds it, copied to every data rank's pool
        (one all-gather over the data axis a pooled leaf)."""
        entries = sorted(entries)
        per = self.local_batch
        ids = self._to_device(np.asarray([b for b, _ in entries], np.int64))
        owner = [slot // per for _, slot in entries]

        def share(c, ax, pooled):
            if not pooled:
                return
            got = collectives.all_gather(c.index_select(ax, ids)[None],
                                         dim=0, axis="data")
            c.index_copy_(ax, ids, torch.cat([
                got[o].narrow(ax, n, 1) for n, o in enumerate(owner)], ax))
        tree_map(share, self.caches, self._axes, self._pooled)

    def _host(self, parts, dtype):
        """THE once-per-chunk sync: ``parts`` [(device tensor, its slot
        axis)] as host arrays over every slot, one copy. Under a data
        split every rank's parts are gathered first, in one collective,
        and each part's shards joined along its slot axis."""
        flat = torch.cat([t.reshape(-1).to(dtype) for t, _ in parts])
        if self._dp > 1:
            flat = collectives.all_gather(flat[None], dim=0, axis="data")
        host = flat.cpu().numpy().reshape(self._dp, -1)
        sizes = np.cumsum([t.numel() for t, _ in parts])[:-1]
        shards = [np.split(h, sizes) for h in host]
        return [np.concatenate([sh[n].reshape(t.shape) for sh in shards],
                               axis=ax)
                for n, (t, ax) in enumerate(parts)]

    def _run_chunk(self, has_beam: bool, has_spec: bool, sampling: bool):
        """One decode chunk and THE sync that reads it back: host arrays
        toks / valid [N, B, S_e], the beam parents [N, B], liveness [B],
        and the beam scores and spec counters [B] (None for a pool of
        NORMAL slots)."""
        parent = scores = sst = sacc = None
        if not (has_beam or has_spec):
            toks, valid = self._decode_chunk(sampling)
            # tokens, validity and liveness in one copy
            toks, valid, alive = self._host(
                [(toks, 1), (valid, 1), (self.active, 0)], torch.int64)
            toks, valid = toks[..., None], valid[..., None].astype(bool)
        else:
            toks, valid, parent = self._decode_general(has_beam, has_spec,
                                                       sampling)
            # still one copy: the parent map, the beam scores and the spec
            # counters ride along (float64 holds them exactly)
            toks, valid, parent, alive, scores, sst, sacc = self._host(
                [(toks, 1), (valid, 1), (parent, 1), (self.active, 0),
                 (self.beam_score, 0), (self.spec_steps, 0),
                 (self.spec_accepted, 0)], torch.float64)
            toks, valid = toks.astype(np.int64), valid.astype(bool)
            parent = parent.astype(np.int64)
        return toks, valid, parent, alive.astype(bool), scores, sst, sacc

    def _retire(self, occupied: List[int], alive, scores, sst, sacc):
        """Retire the occupied slots the chunk left dead: a request's slot
        frees at once; a beam hypothesis freezes until its group is done,
        then the group ranks its hypotheses and frees its slots."""
        retired = []
        for i in occupied:
            if alive[i]:
                continue
            kind = self._slot_kind[i]
            if kind == decoding.BEAM:
                # freeze the finished hypothesis; the slot stays reserved
                # until every member of its group is done, so the group id
                # (the leader's slot) stays unambiguous
                g = next(g for g in self._beam_groups.values()
                         if i in g["slots"])
                if i in g["live"]:
                    g["live"].discard(i)
                    g["finished"].append((list(self._beam_hist[i]),
                                          float(scores[i])))
                continue
            req = self.slots[i]
            if kind == decoding.SPEC:
                vs, at = int(sst[i]), int(sacc[i])
                req.spec_stats = {"verify_steps": vs,
                                  "accepted_draft_tokens": at}
                self.spec_verify_steps += vs
                self.spec_accepted_tokens += at
            req.done = True
            if self.tracer is not None:
                self.tracer.async_end("request", id=req.uid,
                                      tokens=len(req.output or []))
            self.slots[i] = None  # refillable at the next boundary
            retired.append(i)
        # beam groups with no live hypothesis left: rank and retire together
        for lead in [ld for ld, g in self._beam_groups.items()
                     if not g["live"]]:
            g = self._beam_groups.pop(lead)
            hyps = g["finished"]
            norm = decoding.rank_hypotheses(
                [sc for _, sc in hyps], [len(t) for t, _ in hyps],
                self.beam_length_alpha)
            order = np.argsort(-norm, kind="stable")
            req = g["req"]
            req.beams = [(hyps[o][0], float(norm[o])) for o in order]
            req.output = list(req.beams[0][0]) if req.beams else []
            req.done = True
            if self.tracer is not None:
                self.tracer.async_end("request", id=req.uid,
                                      tokens=len(req.output),
                                      hypotheses=len(req.beams))
            for m in g["slots"]:
                self.slots[m] = None
                self._slot_kind[m] = decoding.NORMAL
                self._beam_hist[m] = []
                retired.append(m)
        if self.paged:
            for i in retired:
                self._release(i)

    def run_to_completion(self, max_ticks: int = 10000) -> int:
        ticks = 0
        while any(s is not None for s in self.slots) or self.queue:
            if not self.step():
                break
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("serving did not converge")
        return ticks

    # -- kernel autotuning -----------------------------------------------------
    @_in_plan
    def pretune(self, *, repeats: int = 2, max_candidates: int = 4,
                verbose: bool = False) -> int:
        """Measure-tune every mpGEMM shape this engine dispatches: each
        packed weight's shape at M = ``local_batch`` (a decode step: this
        data rank's slots) and M =
        ``prefill_chunk`` (a prefill chunk), missing from the tuning cache,
        which is then saved where it has a path. Only ``lut_pallas`` has
        kernel knobs: any other mode warns and returns 0. Returns the
        number of shapes tuned."""
        from repro_torch.core import autotune
        cache = (self.tuning_cache if self.tuning_cache is not None
                 else autotune.get_active())
        if cache is None:
            raise ValueError("pretune() needs a tuning cache: construct the "
                             "engine with tuning_cache=<path>")
        q = self.cfg.quant or {}
        if q.get("mpgemm_mode") != "lut_pallas":
            warnings.warn("pretune() is a no-op for mpgemm_mode="
                          f"{q.get('mpgemm_mode')!r} (no kernel knobs)")
            return 0
        n = autotune.pretune_params(
            self.params, [self.local_batch, self.prefill_chunk], cache=cache,
            table_quant=mp.resolve_table_quant(q.get("table_quant", "auto"),
                                               self.device),
            repeats=repeats, max_candidates=max_candidates, verbose=verbose)
        if cache.path is not None:
            cache.save()
        return n

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        # percentiles interpolate over the bounded-reservoir histogram
        h = self._h_chunk_s
        decode_s = h.total
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
            "p50_chunk_ms": h.percentile(0.50) * 1e3,
            "p95_chunk_ms": h.percentile(0.95) * 1e3,
            # decode-only throughput: excludes prefill and admission
            "decode_tok_s": (self.decode_tokens / decode_s
                             if decode_s else 0.0),
            "peak_active_slots": self.peak_active_slots,
            "slot_occupancy": self._h_occupancy.mean,
            "paged": self.paged,
            "mesh": self._mesh_stats(),
            "cache_hbm_bytes": sum(c.numel() * c.element_size()
                                   for c in tree_leaves(self.caches)),
            "admit_attempts": self.admit_attempts,
            "admit_blocked": self.admit_blocked,
            "admission_blocked_rate": (self.admit_blocked
                                       / max(1, self.admit_attempts)),
            "prefill_tokens_reused": self.prefill_tokens_reused,
        }
        if self.draft_params is not None:
            # retired totals plus the occupied spec slots' live counters
            # (a rare observability call: its sync is not the decode loop's)
            live = [i for i in range(self.max_batch)
                    if self.slots[i] is not None
                    and self._slot_kind[i] == decoding.SPEC]
            with plan_scope(self.plan):  # every slot's counters
                sst, sacc = self._host([(self.spec_steps, 0),
                                        (self.spec_accepted, 0)],
                                       torch.int64)
            vs = self.spec_verify_steps + int(sum(sst[i] for i in live))
            at = self.spec_accepted_tokens + int(sum(sacc[i] for i in live))
            out["spec"] = {
                "spec_k": self.spec_k,
                "draft_planes": int(self.spec_draft_planes),
                "draft_extra_hbm_bytes": int(self.draft_extra_hbm_bytes),
                "verify_steps": vs,
                "accepted_draft_tokens": at,
                # +1: the verify forward's own token (replacement or bonus)
                "mean_emitted_per_step": (at + vs) / max(1, vs),
                "mean_accepted_per_step": at / max(1, vs),
            }
        if self._beam_groups or decoding.BEAM in self._slot_kind:
            out["beam"] = {"active_groups": len(self._beam_groups),
                           "length_alpha": self.beam_length_alpha}
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
        if self.tuning_cache is not None:
            out["tuning_cache"] = self.tuning_cache.counters()
        rec = dispatch_obs.get_active()
        if rec is not None:
            s = rec.summary()
            out["dispatch"] = {k: s[k] for k in
                               ("decisions", "tuned", "heuristic", "forced")}
        return out

    def _mesh_stats(self) -> Optional[dict]:
        """None on one device (the reference's plan=None); under a mesh its
        shape, backend, this rank's coordinate and slots, and the
        collectives' counters of this process (``distributed.collectives``:
        calls, bytes, host seconds inside them; in all and by axis).
        Nothing is staged through host memory: every backend takes the
        card's tensors (the collectives module docstring)."""
        if self.plan is None:
            return None
        mesh = self.plan.mesh
        c = collectives.counters()
        return {"shape": mesh.sizes, "backend": mesh.backend,
                "rank": dict(zip(mesh.axis_names, mesh.coords)),
                "slots": [self._lo, self._lo + self.local_batch],
                "collective_calls": c["calls"],
                "collective_bytes": c["bytes"],
                "collective_s": c["seconds"],
                "collectives_by_axis": c["by_axis"],
                "host_staged_bytes": 0}

    def metrics_snapshot(self) -> dict:
        """JSON-able registry snapshot with ``stats()`` mirrored in as
        ``engine_*`` gauges."""
        export_stats(self.metrics, self.stats(), prefix="engine")
        return self.metrics.snapshot()

    def prometheus_text(self) -> str:
        """Prometheus text exposition of the same snapshot."""
        export_stats(self.metrics, self.stats(), prefix="engine")
        return self.metrics.prometheus_text()
