"""Wrappers around the CUDA kernels: padding to the kernels' tiles, the
closed-form per-row scale, the fusion decision, zero-point correction.

The zero-point correction (asymmetric weights) is a rank-1 update outside
the kernels, as in the reference. Padding is inert: padded rows get a row
scale of 1 and zero activations, padded K-groups have zero activations
(their decoded CW is nonzero at entry 0, but their table entries are 0),
and padded channels are sliced off.

The expert entries (``lut_mpgemm_experts``, ``fused_lut_mpgemm_experts``)
run E experts' mpGEMMs, x [E, C, K] against a stack of weights, in one
launch of a kernel's batched wrapper: each expert's C rows are padded with
zero rows to the tile's rows, Cp, and the E·Cp rows are laid out one
expert after the other. Tables and row scales are row by row, so they are
built in one launch over the E·Cp rows; a zero row gets the clamped row
scale and a zero table, as in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core import autotune
from repro_torch.core.lmma import (LMMADescriptor, TileSchedule,
                                   schedule_tiles, select_fusion)
from repro_torch.core.mpgemm import FUSION_MODES
from repro_torch.core.quantize import QuantizedWeight
from repro_torch.core.table import Table
from repro_torch.kernels import dequant_mpgemm as dequant_kernel
from repro_torch.kernels import fused_lut_mpgemm as fused_kernel
from repro_torch.kernels import lut_mpgemm as lut_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import table_precompute as tp_kernel
from repro_torch.obs import dispatch as dispatch_obs

__all__ = ["table_precompute", "lut_mpgemm", "fused_lut_mpgemm",
           "dequant_mpgemm", "lut_mpgemm_experts", "fused_lut_mpgemm_experts",
           "expert_table",
           "staged_operands", "pick_blocks", "auto_fusion",
           "resolve_dispatch", "kernel_plan", "plan_local_shape", "Plan",
           "FUSION_MODES"]


def _pad_to(x: torch.Tensor, mult: int, axis: int,
            value: float = 0.0) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis) + 1] = pad  # F.pad lists the last dim first
    return torch.nn.functional.pad(x, widths, value=value)


def pick_blocks(m, n, g, k_group, planes, max_bm=256, max_bn=512, max_bg=512):
    """LMMA tile (bm, bn, bg): scheduler-elongated, clamped, byte-aligned."""
    ts = schedule_tiles(LMMADescriptor(m=m, n=n, k=g * k_group,
                                       w_bits=planes, k_group=k_group))
    bm, bn, bg = min(ts.bm, max_bm), min(ts.bn, max_bn), min(ts.bg, max_bg)
    while (bg * planes * k_group) % 8:
        bg *= 2
    return bm, bn, bg


def _clamp_blocks(m, n, g, k_group, planes):
    """LMMA tile clamped to the problem and re-aligned to packed bytes."""
    bm, bn, bg = pick_blocks(m, n, g, k_group, planes)
    bm, bn, bg = min(bm, max(8, m)), min(bn, n), min(bg, g)
    while (bg * planes * k_group) % 8:
        bg *= 2
    return bm, bn, bg


@functools.lru_cache(maxsize=4096)
def auto_fusion(m, n, g, k_group, planes) -> str:
    """``fusion="auto"`` for one shape: does the fused working set of the
    clamped LMMA tile fit an H100 thread block's shared memory? Cached: the
    decision depends on these integers alone, and the scheduler's search
    would otherwise run on the host for every projection of every step."""
    bm, bn, bg = _clamp_blocks(m, n, g, k_group, planes)
    desc = LMMADescriptor(m=m, n=n, k=g * k_group, w_bits=planes,
                          k_group=k_group)
    return select_fusion(desc, TileSchedule(bm, bn, bg, 0, 0, 0, 0))


class Plan(NamedTuple):
    """One dispatch decision: the fusion, and the tile and split-K count S
    the kernel runs (None: the kernel's own plan), and where it came from:
    "tuned" (a cache hit), "heuristic" (``auto_fusion``) or "forced"."""

    fusion: str
    tile: Optional[int]
    splits: Optional[int]
    source: str


def plan_local_shape(m, n):
    """Per-shard (m, n) of a global (m, n) mpGEMM under the active plan
    (``distributed.sharding.plan_scope``), the reference's contract: m
    divided by the batch axes and n by the model axis where each divides,
    a dim that does not divide left global (the replicate fallback of
    ``resolve_physical_spec``). The port's wrappers already hold local
    tensors, so ``resolve_dispatch`` takes the local shape as it is and
    never calls this; it is for code that plans from global shapes."""
    from repro_torch.distributed.sharding import current_plan
    plan = current_plan()
    if plan is None:
        return m, n
    dp = plan.axis_size("batch")
    mp = plan.axis_size("model")
    if dp > 1 and m % dp == 0:
        m //= dp
    if mp > 1 and n % mp == 0:
        n //= mp
    return m, n


def resolve_dispatch(m, n, g, k_group, planes, *, fusion="auto",
                     table_quant: Optional[str] = "per_row",
                     experts: int = 0) -> Plan:
    """The dispatch decision for one shape, the single source the LUT
    wrappers follow. "fused"/"staged": forced, the kernels' own tile and S;
    "auto": ``auto_fusion``; "tuned": the active tuning cache's plan
    (``autotune.lookup_tuned``, memoized per shape), else "auto". Records
    the decision on the active ``obs.dispatch`` recorder, keyed by
    ``autotune.shape_key``, with the tile and S the kernel runs
    (``kernel_plan``); with none, that costs one check. (The CUDA
    kernels' tiles: ``lut_mpgemm.int_tile_for`` and
    ``fused_lut_mpgemm.int_tile`` on per_row tables, the staged one with
    rows padded; ``lut_mpgemm.f32_tile_for`` on None and per_group tables,
    shared by both kernels, rows as they are.)

    ``experts`` > 0: an expert call, m rows an expert of that many
    experts, one batched launch (``lut_mpgemm_experts``). The fusion is
    decided at (m, n, g) all the same; "tuned" runs as "auto", since the
    tuning cache holds 2-D shapes, whose tile and S do not fit the batched
    launch; the key gets an "e<E>." prefix.

    Under a mesh the shape is the rank's local one, as the wrappers hold
    it: nothing here divides it again (``plan_local_shape`` is for global
    shapes)."""
    if fusion not in FUSION_MODES:
        raise ValueError(f"fusion {fusion!r} not in {FUSION_MODES}")
    tuned = (autotune.lookup_tuned(m, n, g, k_group, planes,
                                   table_quant=table_quant)
             if fusion == "tuned" and not experts else None)
    if tuned is not None:
        plan = Plan(tuned.fusion, tuned.tile, tuned.splits, "tuned")
    elif fusion in ("auto", "tuned"):
        plan = Plan(auto_fusion(m, n, g, k_group, planes), None, None,
                    "heuristic")
    else:
        plan = Plan(fusion, None, None, "forced")
    if dispatch_obs.get_active() is not None:
        _, bm, bn, bg, s = kernel_plan(m, n, g, k_group, planes, table_quant,
                                       plan.fusion, plan.tile, plan.splits,
                                       experts=experts)
        key = autotune.shape_key(m, n, g, k_group, planes,
                                 table_quant=table_quant)
        dispatch_obs.record(
            "dispatch", f"e{experts}.{key}" if experts else key,
            plan.fusion, fusion, plan.source, (bm, bn, bg), s)
    return plan


def _up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def kernel_plan(m, n, g, k_group, planes, table_quant: Optional[str],
                fusion: str, tile: Optional[int] = None,
                splits: Optional[int] = None, *, experts: int = 0):
    """(config, BM, BN, bg, S) the kernel runs for an [m, G·K] × [n, G·K]
    mpGEMM, padded as this module pads it: per_row fused
    (``fused_lut_mpgemm.int_plan``), per_row staged (``lut_mpgemm.
    staged_plan``, rows padded) or the float tables' ``lut_mpgemm.
    f32_plan``; ``tile`` and ``splits`` as the wrappers take them. With
    ``experts`` > 0, the batched launch of an expert call of m rows an
    expert: the tile m rows take alone (``_expert_tile``), S planned over
    the experts' padded rows."""
    if experts:
        config, bm, bn, bg = _expert_tile(m, k_group, planes, table_quant,
                                          fusion == "fused")
        plan = (lut_kernel.f32_plan if table_quant != "per_row"
                else fused_kernel.int_plan if fusion == "fused"
                else functools.partial(lut_kernel.staged_plan, 1))
        _, s, _ = plan(experts * _up(max(m, 1), bm), _up(n, bn), _up(g, bg),
                       k_group, planes, config)
        return config, bm, bn, bg, s
    mp = m
    if table_quant != "per_row":
        _, _, bn, bg = lut_kernel.f32_tile_for(m, k_group, planes, tile)
        plan = lut_kernel.f32_plan
    elif fusion == "fused":
        _, _, bn, bg = fused_kernel.int_tile(m, k_group, planes, tile)
        plan = fused_kernel.int_plan
    else:
        _, bm, bn, bg = lut_kernel.int_tile_for(m, k_group, planes, tile=tile)
        plan, mp = functools.partial(lut_kernel.staged_plan, 1), _up(m, bm)
    (config, bm, bn, bg), s, _ = plan(mp, _up(n, bn), _up(g, bg), k_group,
                                      planes, tile, splits)
    return config, bm, bn, bg, s


def _check_not_plane_sliced(qw: QuantizedWeight, opname: str):
    """The kernels stride the packed stream by ``num_planes`` fields per
    group, so a plane-sliced view would decode the wrong bytes."""
    if qw.is_plane_sliced:
        raise NotImplementedError(
            f"{opname}: plane-sliced QuantizedWeight views (planes "
            f"[{qw.plane_start}:{qw.plane_start + qw.num_planes}] of "
            f"{qw.stored_planes} stored) are not supported by the kernels; "
            f"use mode='lut_xla' or 'dequant' for the draft view")


def _closed_form_row_scale(a: torch.Tensor, g: int, k_group: int):
    """[M, 1] per-row INT8 table scale from A alone (table.group_absmax),
    in plain torch ops: the plain version of ``table_precompute.row_scale``,
    with whose bits the staged and fused paths quantize."""
    return tp_kernel.row_scale_plain(a.reshape(a.shape[0], g * k_group),
                                     k_group)


def _pad_packed(qw: QuantizedWeight, gp: int, bn: int):
    """Packed codes padded to gp K-groups and bn channels, scale alongside
    (each expert's, for a stack of experts: [E, Np, bytes] and [E, Np])."""
    pkp = qw.packed
    pb_full = gp * qw.num_planes * qw.k_group // 8
    if pkp.shape[-1] < pb_full:
        pkp = torch.nn.functional.pad(pkp, (0, pb_full - pkp.shape[-1]))
    pkp = _pad_to(pkp, bn, pkp.dim() - 2)
    scale = qw.scale.to(torch.float32)
    wsp = _pad_to(scale, bn, scale.dim() - 1)
    return pkp.contiguous(), wsp.contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where it starts off a 16-byte boundary: the
    kernels copy rows of activations and tables in 16-byte pieces."""
    return t.clone() if t.data_ptr() % 16 else t


def _rowsum(x, qw):
    """Σ_k x (f32), needed only by the zero-point correction."""
    return None if qw.zero_prime is None else x.to(torch.float32).sum(-1)


def table_precompute(a: torch.Tensor, k_group: int = 4,
                     table_quant: Optional[str] = "per_row",
                     row_scale: Optional[torch.Tensor] = None) -> Table:
    """Kernel-backed independent precompute operator (§3.1.1): one launch,
    the per_row row scale included unless given (``row_scale`` [M, 1]: a
    row-parallel layer's whole-row scale on its K-range), and ``rowsum``'s
    sum."""
    m, k_total = a.shape
    g = k_total // k_group
    e = 1 << (k_group - 1)
    af = a.to(torch.float32).contiguous()
    values, scale = tp_kernel.table_precompute(
        af, k_group, table_quant,
        None if row_scale is None or table_quant != "per_row"
        else row_scale.to(torch.float32).reshape(m, 1).contiguous())
    rowsum = af.sum(-1)
    values = values.reshape(m, g, e)
    if table_quant is None:
        return Table(values, None, rowsum, k_group)
    return Table(values, scale.reshape(m, scale.shape[1], 1), rowsum, k_group)


def fused_lut_mpgemm(x: torch.Tensor, qw: QuantizedWeight, *,
                     table_quant: Optional[str] = "per_row",
                     tile: Optional[int] = None,
                     splits: Optional[int] = None,
                     row_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-kernel precompute→lookup mpGEMM (the table stays on chip);
    ``tile`` and ``splits`` replace the kernel's own plan (None keeps
    it). ``row_scale`` [M, 1] (per_row): the scale to quantize the table
    with, in place of the one launch that computes it from x (a
    row-parallel layer's whole-row scale on its K-range)."""
    _check_not_plane_sliced(qw, "fused_lut_mpgemm")
    m = x.shape[0]
    kg, planes = qw.k_group, qw.num_planes
    xp = x.to(torch.float32)
    # the kernel takes x's rows as they are
    if table_quant == "per_row":
        _, _, bn, bg = fused_kernel.int_tile(m, kg, planes, tile)
    else:
        _, _, bn, bg = lut_kernel.f32_tile_for(m, kg, planes, tile)
    xp = _aligned(_pad_to(xp, bg * kg, 1).contiguous())
    # padded groups are zeros: they leave the row scale's max as it is
    row_scale = _given_or_computed(row_scale, xp, kg, table_quant)
    pkp, wsp = _pad_packed(qw, xp.shape[1] // kg, bn)
    out = fused_kernel.fused_lut_mpgemm(
        xp, row_scale, pkp, wsp, k_group=kg, table_quant=table_quant,
        planes=planes, plane_scales=qw.plane_scales, tile=tile,
        splits=splits)[:m, :qw.n]
    return ref.zero_point_correction(out, qw, _rowsum(x, qw))


def _given_or_computed(row_scale, xp, k_group, table_quant):
    """The per_row row scale: the given one as the kernels take it
    (contiguous f32 [M, 1]), else one launch of the row-scale kernel on
    the padded x; None for float tables."""
    if table_quant != "per_row":
        return None
    if row_scale is None:
        return tp_kernel.row_scale(xp, k_group)
    return row_scale.to(torch.float32).reshape(xp.shape[0], 1).contiguous()


def staged_operands(table: Table, qw: QuantizedWeight,
                    tile: Optional[int] = None):
    """(tv, ts, packed, wscale) of the staged kernel, padded to its tile
    (``tile`` when given, else the kernel's own): the int path's
    (``lut_mpgemm.int_tile_for``) for a per_row INT8 table, rows padded
    too; the f32 paths' (``lut_mpgemm.f32_tile_for``) for None and
    per_group tables, rows as they are. Padded rows and groups get a scale
    of 1 and zero entries."""
    m, g, e = table.values.shape
    kg = qw.k_group
    per_row = (table.values.dtype == torch.int8 and table.scale is not None
               and table.scale.shape[1] == 1)
    if per_row:
        _, bm, bn, bg = lut_kernel.int_tile_for(m, kg, qw.num_planes,
                                                tile=tile)
    else:
        _, _, bn, bg = lut_kernel.f32_tile_for(m, kg, qw.num_planes, tile)
        bm = 1
    tv = _pad_to(_pad_to(table.values.reshape(m, g * e), bm, 0), bg * e, 1)
    gp = tv.shape[1] // e
    ts = None
    if table.scale is not None:
        ts = _pad_to(table.scale.reshape(m, -1), bm, 0, value=1.0)
        if ts.shape[1] != 1:  # per_group
            ts = _pad_to(ts, bg, 1, value=1.0)
        ts = ts.contiguous()
    return (_aligned(tv.contiguous()), ts) + _pad_packed(qw, gp, bn)


def lut_mpgemm(x: torch.Tensor, qw: QuantizedWeight, *,
               table_quant: Optional[str] = "per_row",
               table: Optional[Table] = None,
               fusion: str = "auto", tile: Optional[int] = None,
               splits: Optional[int] = None,
               row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LUT mpGEMM through the kernels. ``fusion`` picks the single fused
    kernel or the staged ``table_precompute`` + ``lut_mpgemm`` pair;
    "auto" asks the LMMA rule, "tuned" the tuning cache
    (``resolve_dispatch``). ``tile`` and ``splits`` replace the plan's. A
    supplied ``table`` (shared across consumers) always runs staged, with
    the plan's tile and S. ``row_scale`` [M, 1] (per_row): the table's
    given row scale, fused or staged."""
    _check_not_plane_sliced(qw, "lut_mpgemm")
    m = x.shape[0]
    g, kg, planes = qw.g, qw.k_group, qw.num_planes
    plan = resolve_dispatch(m, qw.n, g, kg, planes, fusion=fusion,
                        table_quant=table_quant)
    tile = plan.tile if tile is None else tile
    splits = plan.splits if splits is None else splits
    if table is None and plan.fusion == "fused":
        kw = {} if row_scale is None else {"row_scale": row_scale}
        return fused_lut_mpgemm(x, qw, table_quant=table_quant, tile=tile,
                                splits=splits, **kw)
    if table is None:
        table = (table_precompute(x, kg, table_quant) if row_scale is None
                 else table_precompute(x, kg, table_quant,
                                       row_scale=row_scale))
    out = lut_kernel.lut_mpgemm(
        *staged_operands(table, qw, tile), k_group=kg, planes=planes,
        plane_scales=qw.plane_scales, tile=tile, splits=splits)[:m, :qw.n]
    return ref.zero_point_correction(out, qw, table.rowsum)


def dequant_mpgemm(x: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """Dequantization-based mpGEMM through its kernel (the paper's baseline):
    ``x @ dequantize(qw).T`` in f32, the zero point applied outside."""
    _check_not_plane_sliced(qw, "dequant_mpgemm")
    m, kg = x.shape[0], qw.k_group
    # the kernel takes x's rows as they are
    _, _, bn, bg = dequant_kernel.tile_for(m, kg)
    xp = _aligned(_pad_to(x.to(torch.float32), bg * kg, 1).contiguous())
    pkp, wsp = _pad_packed(qw, xp.shape[1] // kg, bn)
    out = dequant_kernel.dequant_mpgemm(
        xp, pkp, wsp, k_group=kg, planes=qw.num_planes,
        plane_scales=qw.plane_scales)[:m, :qw.n]
    return ref.zero_point_correction(out, qw, _rowsum(x, qw))


def _expert_tile(c: int, k_group: int, planes: int, table_quant,
                 fused: bool):
    """(config, BM, BN, bg) of an expert call of C rows an expert, the one
    place that chooses it: the tile C rows take alone in the fused kernel
    (``fused_lut_mpgemm.int_tile``) or the staged one
    (``lut_mpgemm.int_tile_for``) on per_row tables, the f32 paths'
    (``lut_mpgemm.f32_tile_for``) on float tables. Each expert's rows are
    padded to its BM, Cp."""
    if table_quant != "per_row":
        return lut_kernel.f32_tile_for(c, k_group, planes)
    if fused:
        return fused_kernel.int_tile(c, k_group, planes)
    return lut_kernel.int_tile_for(c, k_group, planes)


def _experts_zero_point(out, qw: QuantizedWeight, rowsum):
    """``ref.zero_point_correction`` for [E, C, N] outputs of a stack of
    experts' weights (rowsum [E, C]); no-op for symmetric weights."""
    if qw.zero_prime is None:
        return out
    return out - rowsum[..., None] * (qw.scale * qw.zero_prime)[:, None, :]


def expert_table(x: torch.Tensor, k_group: int = 4,
                 table_quant: Optional[str] = "per_row") -> Table:
    """The table of x [E, C, K] that ``lut_mpgemm_experts`` shares between
    consumers, in the form the batched staged kernel takes: each expert's
    C rows padded with zero rows to the staged tile's, Cp, and the E·Cp
    rows built in one ``table_precompute`` launch (a zero row gets the
    clamped row scale and a zero table, as in the reference)."""
    e, c, k = x.shape
    # the tile's rows depend on C alone, not on the weights' planes
    _, bm, _, _ = _expert_tile(c, k_group, 1, table_quant, False)
    cp = _up(max(c, 1), bm)
    return table_precompute(_pad_to(x, cp, 1).reshape(e * cp, k), k_group,
                            table_quant)


def fused_lut_mpgemm_experts(x: torch.Tensor, qw: QuantizedWeight, *,
                             table_quant: Optional[str] = "per_row",
                             row_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """E experts' fused precompute→lookup mpGEMMs, x [E, C, K] against a
    stack of weights ([E, N, bytes]) -> f32 [E, C, N]: one row-scale
    launch over the padded rows (per_row; none where ``row_scale`` [E, C,
    1] is given) and one launch of ``fused_lut_mpgemm_batched``."""
    _check_not_plane_sliced(qw, "fused_lut_mpgemm_experts")
    e, c, _ = x.shape
    kg, planes = qw.k_group, qw.num_planes
    config, bm, bn, bg = _expert_tile(c, kg, planes, table_quant, True)
    cp = _up(max(c, 1), bm)
    xp = _pad_to(_pad_to(x.to(torch.float32), cp, 1), bg * kg, 2)
    xp = _aligned(xp.reshape(e * cp, -1).contiguous())
    if row_scale is not None:  # padded rows: the clamped scale of a zero row
        row_scale = _pad_to(row_scale.to(torch.float32).reshape(e, c, 1), cp,
                            1, value=1e-30 / 127.0).reshape(e * cp, 1)
    row_scale = _given_or_computed(row_scale, xp, kg, table_quant)
    pkp, wsp = _pad_packed(qw, xp.shape[1] // kg, bn)
    out = fused_kernel.fused_lut_mpgemm_batched(
        xp, row_scale, pkp, wsp, k_group=kg, table_quant=table_quant,
        planes=planes, plane_scales=qw.plane_scales,
        tile=config).reshape(e, cp, -1)[:, :c, :qw.n]
    return _experts_zero_point(out, qw, None if qw.zero_prime is None
                               else x.to(torch.float32).sum(-1))


def lut_mpgemm_experts(x: torch.Tensor, qw: QuantizedWeight, *,
                       table_quant: Optional[str] = "per_row",
                       table: Optional[Table] = None,
                       fusion: str = "auto") -> torch.Tensor:
    """E experts' LUT mpGEMMs, x [E, C, K] against a stack of weights
    ([E, N, bytes]) -> f32 [E, C, N], as ``lut_mpgemm`` runs one: the
    fusion is resolved once from (C, N, G) (``resolve_dispatch`` with
    ``experts``); fused runs ``fused_lut_mpgemm_experts``, staged one
    launch of ``lut_mpgemm_batched`` on the given table (``expert_table``'s
    form) or on one built by ``expert_table``. The tile is the one C rows
    take alone, S the kernel's own plan over the E·Cp rows."""
    _check_not_plane_sliced(qw, "lut_mpgemm_experts")
    e, c, _ = x.shape
    kg, planes = qw.k_group, qw.num_planes
    plan = resolve_dispatch(c, qw.n, qw.g, kg, planes, fusion=fusion,
                            table_quant=table_quant, experts=e)
    if table is None and plan.fusion == "fused":
        return fused_lut_mpgemm_experts(x, qw, table_quant=table_quant)
    config, bm, _, _ = _expert_tile(c, kg, planes, table_quant, False)
    cp = _up(max(c, 1), bm)
    if table is None:
        table = expert_table(x, kg, table_quant)
    if table.values.shape[0] != e * cp:
        raise ValueError(f"lut_mpgemm_experts: the table has "
                         f"{table.values.shape[0]} rows, not {e} experts' "
                         f"{cp} padded rows (ops.expert_table)")
    out = lut_kernel.lut_mpgemm_batched(
        *staged_operands(table, qw, config), k_group=kg, planes=planes,
        plane_scales=qw.plane_scales,
        tile=config).reshape(e, cp, -1)[:, :c, :qw.n]
    return _experts_zero_point(out, qw, table.rowsum.reshape(e, cp)[:, :c])
