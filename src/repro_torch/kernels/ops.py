"""Wrappers around the CUDA kernels: padding to the kernels' tiles, the
closed-form per-row scale, the fusion decision, zero-point correction.

The zero-point correction (asymmetric weights) is a rank-1 update outside
the kernels, as in the reference. Padding is inert: padded rows get a row
scale of 1 and zero activations, padded K-groups have zero activations
(their decoded CW is nonzero at entry 0, but their table entries are 0),
and padded channels are sliced off.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import table as table_mod
from repro_torch.core.lmma import (LMMADescriptor, TileSchedule,
                                   schedule_tiles, select_fusion)
from repro_torch.core.mpgemm import FUSION_MODES
from repro_torch.core.quantize import QuantizedWeight
from repro_torch.core.table import Table
from repro_torch.kernels import fused_lut_mpgemm as fused_kernel
from repro_torch.kernels import lut_mpgemm as lut_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import table_precompute as tp_kernel

__all__ = ["table_precompute", "lut_mpgemm", "fused_lut_mpgemm",
           "pick_blocks", "auto_fusion", "resolve_dispatch", "FUSION_MODES"]


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


def resolve_dispatch(m, n, g, k_group, planes, *, fusion="auto") -> str:
    """The pipeline for one shape: "fused"/"staged" as forced, "auto" by
    ``auto_fusion``. (The CUDA kernels tile by ``lut_mpgemm.tile_for``.)"""
    if fusion not in FUSION_MODES:
        raise ValueError(f"fusion {fusion!r} not in {FUSION_MODES}")
    return auto_fusion(m, n, g, k_group, planes) if fusion == "auto" else fusion


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
    """[M, 1] per-row INT8 table scale from A alone (table.group_absmax);
    the staged and fused paths quantize with this same scale."""
    am = table_mod.group_absmax(a.to(torch.float32).reshape(a.shape[0], g,
                                                             k_group))
    return table_mod.true_divide(am.amax(dim=-1).clamp_min(1e-30),
                                 127.0)[:, None]


def _padded_row_scale(a, g, k_group, bm):
    # padded rows get an inert scale of 1
    return _pad_to(_closed_form_row_scale(a, g, k_group), bm, 0, value=1.0)


def _pad_packed(qw: QuantizedWeight, gp: int, bn: int):
    """Packed codes padded to gp K-groups and bn channels, scale alongside."""
    pkp = qw.packed
    pb_full = gp * qw.num_planes * qw.k_group // 8
    if pkp.shape[1] < pb_full:
        pkp = torch.nn.functional.pad(pkp, (0, pb_full - pkp.shape[1]))
    pkp = _pad_to(pkp, bn, 0)
    wsp = _pad_to(qw.scale.to(torch.float32), bn, 0)
    return pkp.contiguous(), wsp.contiguous()


def _rowsum(x, qw):
    """Σ_k x (f32), needed only by the zero-point correction."""
    return None if qw.zero_prime is None else x.to(torch.float32).sum(-1)


def table_precompute(a: torch.Tensor, k_group: int = 4,
                     table_quant: Optional[str] = "per_row") -> Table:
    """Kernel-backed independent precompute operator (§3.1.1)."""
    m, k_total = a.shape
    g = k_total // k_group
    e = 1 << (k_group - 1)
    af = a.to(torch.float32).contiguous()
    row_scale = (_closed_form_row_scale(af, g, k_group).contiguous()
                 if table_quant == "per_row" else None)
    values, scale = tp_kernel.table_precompute(af, k_group, table_quant,
                                               row_scale)
    rowsum = af.sum(-1)
    values = values.reshape(m, g, e)
    if table_quant is None:
        return Table(values, None, rowsum, k_group)
    return Table(values, scale.reshape(m, -1, 1), rowsum, k_group)


def fused_lut_mpgemm(x: torch.Tensor, qw: QuantizedWeight, *,
                     table_quant: Optional[str] = "per_row") -> torch.Tensor:
    """Single-kernel precompute→lookup mpGEMM (the table stays on chip)."""
    _check_not_plane_sliced(qw, "fused_lut_mpgemm")
    m = x.shape[0]
    g, kg, planes = qw.g, qw.k_group, qw.num_planes
    _, bm, bn, bg = lut_kernel.tile_for(m, kg)
    row_scale = (_padded_row_scale(x, g, kg, bm).contiguous()
                 if table_quant == "per_row" else None)
    xp = _pad_to(_pad_to(x.to(torch.float32), bm, 0), bg * kg, 1).contiguous()
    pkp, wsp = _pad_packed(qw, xp.shape[1] // kg, bn)
    out = fused_kernel.fused_lut_mpgemm(
        xp, row_scale, pkp, wsp, k_group=kg, table_quant=table_quant,
        planes=planes, plane_scales=qw.plane_scales)[:m, :qw.n]
    return ref.zero_point_correction(out, qw, _rowsum(x, qw))


def lut_mpgemm(x: torch.Tensor, qw: QuantizedWeight, *,
               table_quant: Optional[str] = "per_row",
               table: Optional[Table] = None,
               fusion: str = "auto") -> torch.Tensor:
    """LUT mpGEMM through the kernels. ``fusion`` picks the single fused
    kernel or the staged ``table_precompute`` + ``lut_mpgemm`` pair; "auto"
    asks the LMMA rule. A supplied ``table`` (shared across consumers)
    always runs staged."""
    _check_not_plane_sliced(qw, "lut_mpgemm")
    m = x.shape[0]
    g, kg, planes = qw.g, qw.k_group, qw.num_planes
    e = 1 << (kg - 1)
    fusion = resolve_dispatch(m, qw.n, g, kg, planes, fusion=fusion)
    if table is None and fusion == "fused":
        return fused_lut_mpgemm(x, qw, table_quant=table_quant)
    if table is None:
        table = table_precompute(x, kg, table_quant)
    _, bm, bn, bg = lut_kernel.tile_for(m, kg)
    tv = _pad_to(_pad_to(table.values.reshape(m, g * e), bm, 0), bg * e, 1)
    gp = tv.shape[1] // e
    ts = None
    if table.scale is not None:  # padded rows and groups: inert scale 1
        ts = _pad_to(table.scale.reshape(m, -1), bm, 0, value=1.0)
        if ts.shape[1] != 1:  # per_group
            ts = _pad_to(ts, bg, 1, value=1.0)
        ts = ts.contiguous()
    pkp, wsp = _pad_packed(qw, gp, bn)
    out = lut_kernel.lut_mpgemm(
        tv.contiguous(), ts, pkp, wsp, k_group=kg, planes=planes,
        plane_scales=qw.plane_scales)[:m, :qw.n]
    return ref.zero_point_correction(out, qw, table.rowsum)
