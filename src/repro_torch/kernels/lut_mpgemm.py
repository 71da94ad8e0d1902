"""Staged LUT mpGEMM kernel: wrapper, plain version and launch count.

The CUDA kernel (``csrc/lut_mpgemm.cu``) replaces the TPU kernel
``repro/kernels/lut_mpgemm.py:lut_mpgemm_pallas``: it unpacks the packed
codes into CW tiles in shared memory and contracts them against the table.
Like the TPU kernel it has an int path (per_row INT8 tables, exact int32
sums, epilogue ``(acc·ts)·ws``) and an f32 path (float tables, or INT8
tables dequantized per group); a per-row f32 table is refused.

The int path runs on the int8 tensor cores with its own tile
(``int_tile_for``) and splits the K-steps into contiguous ranges
(``split_for``) so that enough blocks fill the card; its partial int32 sums
go to a workspace the wrapper allocates, summed in order by a second
kernel of the same launch. The f32 path keeps the shared tiles
(``tile_for``).

Inputs are pre-padded to the kernel's tile (done by ``kernels.ops``). The
wrapper launches the kernel for CUDA tensors and runs the plain version for
CPU tensors; ``launches`` counts wrapper calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.quantize import QuantizedWeight
from repro_torch.core.table import Table
from repro_torch.kernels import _build, ref

__all__ = ["lut_mpgemm", "lut_mpgemm_plain", "tile_for", "int_tile_for",
           "split_for", "k_ranges", "TILES", "INT_TILES"]

# (BM, BN, KT_MIN) of csrc/lut_common.cuh: SmallTile (config 0), LargeTile (1)
TILES = ((8, 32, 1024), (64, 64, 128))
# (BM, BN) of the int path's tensor-core tiles (csrc/lut_mpgemm.cu: MmaSmall,
# MmaMid, MmaLarge = configs 0, 1, 2); a K-step holds INT_KT table entries
INT_TILES = ((16, 128), (64, 64), (128, 128))
INT_KT = 128
SMS = 132          # streaming multiprocessors of an H100 SXM
MIN_STEPS = 2      # least K-steps in one split
launches = 0


def tile_for(m: int, k_group: int) -> Tuple[int, int, int, int]:
    """(config, BM, BN, bg) of the kernels' tile for M rows: rows pad to BM,
    channels to BN, K-groups to bg (groups per K-step)."""
    config = 0 if m <= TILES[0][0] else 1
    bm, bn, kt_min = TILES[config]
    return config, bm, bn, max(1, kt_min >> (k_group - 1))


def int_tile_for(m: int, k_group: int, planes: int, kt: int = INT_KT
                 ) -> Tuple[int, int, int, int]:
    """(config, BM, BN, bg) of the int path's tile for M rows: the smallest
    row tile that holds M (the largest for more rows), and bg groups per
    K-step: kt table entries, more where the step's packed bytes per
    channel (bg·B·K/8) would not fill whole 4-byte words."""
    config = next((i for i, (bm, _) in enumerate(INT_TILES) if m <= bm),
                  len(INT_TILES) - 1)
    bm, bn = INT_TILES[config]
    bg = max(1, kt >> (k_group - 1))
    while (bg * planes * k_group) % 32:
        bg *= 2
    return config, bm, bn, bg


def split_for(mp: int, np_: int, gp: int, bm: int, bn: int, bg: int
              ) -> Tuple[int, List[Tuple[int, int]]]:
    """Split-K plan of the int path: (S, ranges of K-groups). The Gp/bg
    K-steps split into S contiguous ranges, the first steps % S of them one
    step longer, as the kernel computes them. S is the least count that
    gives tiles·S >= SMS blocks, cut to keep MIN_STEPS steps per range."""
    steps = gp // bg
    tiles = (mp // bm) * (np_ // bn)
    want = -(-SMS // tiles)
    s = max(1, min(want, steps // MIN_STEPS))
    return s, k_ranges(gp, bg, s)


def k_ranges(gp: int, bg: int, s: int) -> List[Tuple[int, int]]:
    """The K-group ranges of S contiguous splits of the Gp/bg K-steps, the
    first steps % S of them one step longer, as the kernels compute them."""
    q, r = divmod(gp // bg, s)
    starts = [z * q + min(z, r) for z in range(s + 1)]
    return [(a * bg, b * bg) for a, b in zip(starts, starts[1:])]


def device_workspace(cache, device: torch.device, words: int, tiles: int,
                     dtype: torch.dtype):
    """A split-K workspace (at least ``words`` of ``dtype``) and tile arrival
    counts (int32, at least ``tiles``) on ``device``, kept in ``cache``
    (device index -> the pair) and grown when a call needs more; both are
    zero when made."""
    work, arrivals = cache.get(device.index, (None, None))
    if work is None or work.numel() < words:
        work = torch.zeros(words, device=device, dtype=dtype)
    if arrivals is None or arrivals.numel() < tiles:
        arrivals = torch.zeros(tiles, device=device, dtype=torch.int32)
    cache[device.index] = (work, arrivals)
    return work, arrivals


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


MAX_QPRIME = 255  # the largest Σ|ps_b|: every q' is then exact in bf16


def plane_args(planes, plane_scales):
    """The plane scales as the kernels' C int array. Each must be an integer
    (the kernels take C ints) and Σ|ps_b| <= MAX_QPRIME (dequant_mpgemm's
    bf16 q' tiles then hold every q' = Σ_b ±ps_b exactly); anything else
    raises ValueError."""
    scales = [float(s) for s in plane_scales]
    if not all(s.is_integer() for s in scales):
        raise ValueError(f"plane scales must be integers, got {scales}")
    if sum(abs(s) for s in scales) > MAX_QPRIME:
        raise ValueError(f"plane scales {scales}: Σ|ps_b| exceeds "
                         f"{MAX_QPRIME}")
    return (ctypes.c_int * planes)(*[int(s) for s in scales])


def launch_args(k_group, planes, plane_scales, m, n, gp, tile=None):
    """Shared ctypes arguments: validated tile config (``tile``, by default
    the shared ``tile_for``) and plane scales."""
    config, bm, bn, bg = tile or tile_for(m, k_group)
    if m % bm or n % bn or gp % bg:
        raise ValueError(f"shape (M={m}, N={n}, G={gp}) is not padded to the "
                         f"tile (BM={bm}, BN={bn}, bg={bg})")
    return config, bg, plane_args(planes, plane_scales)


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
    if mode == 1 and (tv.data_ptr() % 16 or packed.data_ptr() % 4):
        raise ValueError("lut_mpgemm: the int path copies the table in "
                         "16-byte and the codes in 4-byte pieces; pass "
                         "aligned operands")
    if tv.device.type == "cpu":
        return lut_mpgemm_plain(tv, ts, packed, wscale, k_group=k_group,
                                planes=planes, plane_scales=plane_scales)
    if tv.device.type != "cuda":
        raise ValueError(f"lut_mpgemm: unsupported device {tv.device}")
    np_ = packed.shape[0]
    splits, work = 1, None
    if mode == 1:
        tile = int_tile_for(mp, k_group, planes)
        config, bg, ps = launch_args(k_group, planes, plane_scales, mp, np_,
                                     gp, tile)
        splits, _ = split_for(mp, np_, gp, tile[1], tile[2], bg)
        if splits > 1:
            work = torch.empty((splits, mp, np_), device=tv.device,
                               dtype=torch.int32)
    else:
        config, bg, ps = launch_args(k_group, planes, plane_scales, mp, np_,
                                     gp)
    out = torch.empty((mp, np_), device=tv.device, dtype=torch.float32)
    fn = _build.launcher("lut_mpgemm")
    with torch.cuda.device(tv.device):
        rc = fn(tv.data_ptr(), None if ts is None else ts.data_ptr(),
                packed.data_ptr(), wscale.data_ptr(), out.data_ptr(),
                None if work is None else work.data_ptr(), mp, np_, gp,
                k_group, planes, ps, mode, config, bg, splits,
                torch.cuda.current_stream(tv.device).cuda_stream)
    _build.check("lut_mpgemm", rc)
    launches += 1
    return out
