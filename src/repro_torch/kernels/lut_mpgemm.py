"""Staged LUT mpGEMM kernel: wrapper, plain version and launch count.

The CUDA kernel (``csrc/lut_mpgemm.cu``) replaces the TPU kernel
``repro/kernels/lut_mpgemm.py:lut_mpgemm_pallas``: it unpacks the packed
codes into CW tiles in shared memory and contracts them against the table.
Like the TPU kernel it has an int path (per_row INT8 tables, exact int32
sums, epilogue ``(acc·ts)·ws``) and an f32 path (float tables, or INT8
tables dequantized per group); a per-row f32 table is refused.

Inputs are pre-padded to the kernel's tile (``tile_for``, done by
``kernels.ops``). The wrapper launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.quantize import QuantizedWeight
from repro_torch.core.table import Table
from repro_torch.kernels import _build, ref

__all__ = ["lut_mpgemm", "lut_mpgemm_plain", "tile_for", "TILES"]

# (BM, BN, KT_MIN) of csrc/lut_common.cuh: SmallTile (config 0), LargeTile (1)
TILES = ((8, 32, 1024), (64, 64, 128))
launches = 0


def tile_for(m: int, k_group: int) -> Tuple[int, int, int, int]:
    """(config, BM, BN, bg) of the kernels' tile for M rows: rows pad to BM,
    channels to BN, K-groups to bg (groups per K-step)."""
    config = 0 if m <= TILES[0][0] else 1
    bm, bn, kt_min = TILES[config]
    return config, bm, bn, max(1, kt_min >> (k_group - 1))


def _mode(tv, ts, gp) -> int:
    """Kernel mode (csrc/lut_common.cuh: Mode) from the table's form, as
    ``lut_mpgemm_pallas`` dispatches: a [M, 1] scale is per_row."""
    if ts is None:
        if tv.dtype != torch.float32:
            raise ValueError("an unscaled table must be f32")
        return 0
    if ts.shape[1] == 1:
        if tv.dtype != torch.int8:
            raise ValueError("f32 path does not take per-row scales; "
                             "pre-scale tables in the wrapper")
        return 1
    if ts.shape[1] != gp or tv.dtype != torch.int8:
        raise ValueError(f"per-group scales need an int8 table and [M, {gp}] "
                         f"scales, got {tv.dtype} and {tuple(ts.shape)}")
    return 2


def lut_mpgemm_plain(tv, ts, packed, wscale, *, k_group: int, planes: int,
                     plane_scales: Sequence[float]) -> torch.Tensor:
    """Plain torch version: ``ref.lut_contract`` on the padded operands.
    Its per_row path contracts in float64, where the integer sums are
    exact, so it equals the kernel's int32 sums."""
    e = 1 << (k_group - 1)
    mp, ge = tv.shape
    gp = ge // e
    _mode(tv, ts, gp)
    qw = QuantizedWeight(packed, wscale, None, plane_scales, bits=planes,
                         k_group=k_group, k_total=gp * k_group,
                         n=packed.shape[0])
    table = Table(tv.reshape(mp, gp, e),
                  None if ts is None else ts.reshape(mp, -1, 1), None, k_group)
    return ref.lut_contract(table, qw)


def check_operands(name, rows, packed, wscale, k_group, planes, gp, device):
    """Shape, type, device and layout checks shared by both mpGEMM wrappers."""
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"{name}: packed codes must be uint8 [N, bytes]")
    if packed.shape[1] * 8 != gp * planes * k_group:
        raise ValueError(f"{name}: packed row of {packed.shape[1]} bytes does "
                         f"not hold {gp} groups x {planes} planes")
    if (wscale.dtype != torch.float32 or tuple(wscale.shape)
            != (packed.shape[0],)):
        raise ValueError(f"{name}: weight scale must be f32 [N]")
    for t in (rows, packed, wscale):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on "
                             f"{device}")


def launch_args(k_group, planes, plane_scales, m, n, gp):
    """Shared ctypes arguments: validated tile config and plane scales."""
    config, bm, bn, bg = tile_for(m, k_group)
    if m % bm or n % bn or gp % bg:
        raise ValueError(f"shape (M={m}, N={n}, G={gp}) is not padded to the "
                         f"tile (BM={bm}, BN={bn}, bg={bg})")
    ps = (ctypes.c_int * planes)(*[int(s) for s in plane_scales])
    return config, bg, ps


def lut_mpgemm(tv: torch.Tensor, ts: Optional[torch.Tensor],
               packed: torch.Tensor, wscale: torch.Tensor, *, k_group: int,
               planes: int, plane_scales: Sequence[float]) -> torch.Tensor:
    """tv [Mp, Gp*E] int8|f32; ts None | [Mp, 1] | [Mp, Gp] f32; packed
    uint8 [Np, Gp*B*K/8]; wscale f32 [Np] -> f32 [Mp, Np]."""
    global launches
    e = 1 << (k_group - 1)
    mp, ge = tv.shape
    gp = ge // e
    mode = _mode(tv, ts, gp)
    check_operands("lut_mpgemm", tv, packed, wscale, k_group, planes, gp,
                   tv.device)
    if ts is not None and (ts.dtype != torch.float32 or ts.device != tv.device
                           or not ts.is_contiguous() or ts.shape[0] != mp):
        raise ValueError("lut_mpgemm: table scales must be contiguous f32 "
                         "[M, *] on the table's device")
    if tv.data_ptr() % 4:
        raise ValueError("lut_mpgemm: the kernel reads the table in 4-byte "
                         "words; pass a 4-byte aligned table")
    if tv.device.type == "cpu":
        return lut_mpgemm_plain(tv, ts, packed, wscale, k_group=k_group,
                                planes=planes, plane_scales=plane_scales)
    if tv.device.type != "cuda":
        raise ValueError(f"lut_mpgemm: unsupported device {tv.device}")
    np_ = packed.shape[0]
    config, bg, ps = launch_args(k_group, planes, plane_scales, mp, np_, gp)
    out = torch.empty((mp, np_), device=tv.device, dtype=torch.float32)
    fn = _build.launcher("lut_mpgemm")
    with torch.cuda.device(tv.device):
        rc = fn(tv.data_ptr(), None if ts is None else ts.data_ptr(),
                packed.data_ptr(), wscale.data_ptr(), out.data_ptr(),
                mp, np_, gp, k_group, planes, ps, mode, config, bg,
                torch.cuda.current_stream(tv.device).cuda_stream)
    _build.check("lut_mpgemm", rc)
    launches += 1
    return out
