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
kernel of the same launch. Its table rows are padded to the tile.

The f32 paths run on the bf16 tensor cores (``csrc/bf16_mma.cuh``, shared
with ``dequant_mpgemm``): each table value split into F32_PASSES bf16
terms that sum to it exactly, the CW entries exact in bf16, f32 sums; each
output within rtol = atol = 1e-4 of the IEEE f32 plain version. Their tile
(``f32_tile_for``) and split plan (``f32_plan``: one wave of two blocks an
SM) are shared with ``fused_lut_mpgemm``'s f32 paths; the table's rows are
not padded. The f32 partial sums meet in a per-device workspace
(``f32_workspace``) and the last block of a tile adds them in split order
inside the one launch, so two calls give the same bits; calls on one
device must share one stream.

Channels and K-groups (and the int path's rows) are pre-padded to the
kernel's tile (done by ``kernels.ops``). The wrapper launches the kernel
for CUDA tensors and runs the plain version for CPU tensors; ``launches``
counts wrapper calls that launched the kernel.

``lut_mpgemm_batched`` is the same kernel with an expert axis (the MoE
FFN, which the reference runs as a vmap of the TPU kernel): E experts'
tables, each expert's rows padded to the tile's rows, against a stack of
E experts' packed weights, in one launch (``batched_launches`` counts
them); its plain version is ``lut_mpgemm_plain`` per expert.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.quantize import QuantizedWeight
from repro_torch.core.table import Table
from repro_torch.kernels import _build, ref

__all__ = ["lut_mpgemm", "lut_mpgemm_plain", "lut_mpgemm_batched",
           "lut_mpgemm_batched_plain", "expert_rows", "check_expert_rows",
           "int_tile_for", "split_for",
           "k_ranges", "f32_tile_for", "f32_plan", "f32_ring", "wave_splits",
           "max_splits", "check_splits", "INT_TILES", "BF16_TILES",
           "F32_PASSES"]

# (BM, BN) of the int path's tensor-core tiles (csrc/lut_mpgemm.cu: MmaSmall,
# MmaMid, MmaLarge = configs 0, 1, 2); a K-step holds INT_KT table entries
INT_TILES = ((16, 128), (64, 64), (128, 128))
INT_KT = 128
# (BM, BN, KT) of the bf16 tensor-core main loop (csrc/bf16_mma.cuh; the
# same MmaSmall, MmaMid, MmaLarge = configs 0, 1, 2): a K-step holds KT
# values of the contraction (weights for dequant_mpgemm, table entries for
# the LUT kernels' f32 paths). Each keeps the ring, the B tile and the
# three A term tiles within half an SM's shared memory, so BLOCKS_PER_SM
# blocks share an SM (the kernels' launch bounds hold their registers to
# that too). On an H100 at M = 128, dequant_mpgemm's K-steps of 64 (one
# block an SM) lost to 32 wherever the grid had more than 132 blocks.
BF16_TILES = ((16, 128, 128), (64, 64, 64), (128, 128, 32))
BLOCKS_PER_SM = 2
F32_PASSES = 3     # bf16 terms per table value (csrc/lut_mpgemm.cu: kTerms)
SMS = 132          # streaming multiprocessors of an H100 SXM
MIN_STEPS = 2      # least K-steps in one split
launches = 0
batched_launches = 0  # lut_mpgemm_batched's launches (the expert axis)
# device index -> (f32 split-K partials, int32 tile arrival counts, zero
# between launches), shared by the bf16 kernels: both LUT kernels' f32
# paths and dequant_mpgemm
_f32_workspaces: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def _tile_config(m: int, rows, tile: Optional[int]) -> int:
    """``tile`` (an index into a tile table whose row counts are ``rows``)
    when given, else the smallest row tile that holds M (the largest for
    more rows)."""
    if tile is not None:
        if not 0 <= tile < len(rows):
            raise ValueError(f"tile {tile} not in 0..{len(rows) - 1}")
        return tile
    return next((i for i, bm in enumerate(rows) if m <= bm), len(rows) - 1)


def _step_groups(kt: int, k_group: int, planes: int) -> int:
    """bg groups per K-step: kt table entries, more where the step's packed
    bytes per channel (bg·B·K/8) would not fill whole 4-byte words."""
    bg = max(1, kt >> (k_group - 1))
    while (bg * planes * k_group) % 32:
        bg *= 2
    return bg


def int_tile_for(m: int, k_group: int, planes: int, kt: int = INT_KT,
                 tile: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(config, BM, BN, bg) of the int path's tile for M rows: INT_TILES
    [tile] when given, else the smallest row tile that holds M (the largest
    for more rows), and bg groups per K-step of kt table entries."""
    config = _tile_config(m, [bm for bm, _ in INT_TILES], tile)
    bm, bn = INT_TILES[config]
    return config, bm, bn, _step_groups(kt, k_group, planes)


def split_for(mp: int, np_: int, gp: int, bm: int, bn: int, bg: int,
              splits: Optional[int] = None
              ) -> Tuple[int, List[Tuple[int, int]]]:
    """Split-K plan of the int path: (S, ranges of K-groups). The Gp/bg
    K-steps split into S contiguous ranges, the first steps % S of them one
    step longer, as the kernel computes them. S is ``splits`` when given
    (``check_splits``), else the least count that gives tiles·S >= SMS
    blocks, cut to keep MIN_STEPS steps per range."""
    steps = gp // bg
    if splits is not None:
        s = check_splits(splits, steps)
    else:
        tiles = (mp // bm) * (np_ // bn)
        want = -(-SMS // tiles)
        s = max(1, min(want, steps // MIN_STEPS))
    return s, k_ranges(gp, bg, s)


def max_splits(steps: int) -> int:
    """The most split-K ranges a plan gives ``steps`` K-steps: MIN_STEPS
    steps a range, and at least one range."""
    return max(1, steps // MIN_STEPS)


def check_splits(splits: int, steps: int) -> int:
    """A caller's split-K count, if 1 <= S <= ``max_splits(steps)``."""
    if not 1 <= splits <= max_splits(steps):
        raise ValueError(f"splits {splits} not in 1..{max_splits(steps)} "
                         f"for {steps} K-steps")
    return splits


def k_ranges(gp: int, bg: int, s: int) -> List[Tuple[int, int]]:
    """The K-group ranges of S contiguous splits of the Gp/bg K-steps, the
    first steps % S of them one step longer, as the kernels compute them."""
    q, r = divmod(gp // bg, s)
    starts = [z * q + min(z, r) for z in range(s + 1)]
    return [(a * bg, b * bg) for a, b in zip(starts, starts[1:])]


def wave_splits(tiles: int, steps: int) -> int:
    """Split-K count of the bf16 kernels: the most that keeps tiles·S
    within one wave of BLOCKS_PER_SM blocks on each SM (a partial second
    wave cost more on an H100 than longer ranges), with at least MIN_STEPS
    of the K-steps a range."""
    return max(1, min(SMS * BLOCKS_PER_SM // tiles, steps // MIN_STEPS))


def f32_tile_for(m: int, k_group: int, planes: int,
                 tile: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(config, BM, BN, bg) of the LUT kernels' f32 paths for M rows:
    BF16_TILES[tile] when given, else the smallest row tile that holds M
    (the largest for more rows), and bg groups per K-step of the tile's KT
    table entries."""
    config = _tile_config(m, [bm for bm, _, _ in BF16_TILES], tile)
    bm, bn, kt = BF16_TILES[config]
    return config, bm, bn, _step_groups(kt, k_group, planes)


def f32_plan(m: int, n: int, gp: int, k_group: int, planes: int,
             tile: Optional[int] = None, splits: Optional[int] = None):
    """Launch plan of the LUT kernels' f32 paths for M rows (as they are),
    N channels and Gp K-groups: ((config, BM, BN, bg), S, grid tiles); the
    tile ``f32_tile_for``'s, S ``splits`` when given (``check_splits``),
    else ``wave_splits``'s. Raises where N or Gp is not padded to the
    tile."""
    tile = f32_tile_for(m, k_group, planes, tile)
    _, bm, bn, bg = tile
    if n % bn or gp % bg:
        raise ValueError(f"shape (N={n}, G={gp}) is not padded to the tile "
                         f"(BN={bn}, bg={bg})")
    tiles = -(-m // bm) * (n // bn)
    s = (wave_splits(tiles, gp // bg) if splits is None
         else check_splits(splits, gp // bg))
    return tile, s, tiles


def f32_ring(kernel: str, m: int, k_group: int, planes: int,
             table_quant: Optional[str]) -> Tuple[int, int]:
    """(stages, dynamic shared memory bytes) of ``kernel``'s ("lut_mpgemm"
    or "fused_lut_mpgemm") f32 path for M rows, as its launch plans them
    (``<kernel>_ring`` of the card's library, built on first use)."""
    config, _, _, bg = f32_tile_for(m, k_group, planes)
    fn = getattr(_build.library(kernel), f"{kernel}_ring")
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    stages = ctypes.c_int()
    smem = fn(m, k_group, planes, 0 if table_quant is None else 2, config, bg,
              ctypes.byref(stages))
    if smem < 0:
        raise ValueError(f"{kernel}: no ring for M={m}, k_group={k_group}, "
                         f"planes={planes}, table_quant={table_quant}")
    return stages.value, smem


def f32_workspace(device: torch.device, words: int, tiles: int):
    """The bf16 kernels' split-K workspace and arrival counts on
    ``device`` (``device_workspace``), shared by both LUT kernels' f32
    paths and dequant_mpgemm."""
    return device_workspace(_f32_workspaces, device, words, tiles,
                            torch.float32)


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


def staged_plan(mode: int, mp: int, np_: int, gp: int, k_group: int,
                planes: int, tile: Optional[int] = None,
                splits: Optional[int] = None):
    """Launch plan of the staged kernel in ``mode`` (``_mode``) for Mp
    rows, Np channels and Gp K-groups: ((config, BM, BN, bg), S, grid
    tiles). The int path's tile (``int_tile_for``) with its rows padded and
    ``split_for``'s S; the f32 paths' ``f32_plan``. Raises where the
    operands are not padded to the tile or S is out of range."""
    if mode != 1:
        return f32_plan(mp, np_, gp, k_group, planes, tile, splits)
    tile = int_tile_for(mp, k_group, planes, tile=tile)
    _, bm, bn, bg = tile
    if mp % bm or np_ % bn or gp % bg:
        raise ValueError(f"shape (M={mp}, N={np_}, G={gp}) is not padded to "
                         f"the tile (BM={bm}, BN={bn}, bg={bg})")
    splits, _ = split_for(mp, np_, gp, bm, bn, bg, splits)
    return tile, splits, (mp // bm) * (np_ // bn)


def lut_mpgemm(tv: torch.Tensor, ts: Optional[torch.Tensor],
               packed: torch.Tensor, wscale: torch.Tensor, *, k_group: int,
               planes: int, plane_scales: Sequence[float],
               tile: Optional[int] = None,
               splits: Optional[int] = None) -> torch.Tensor:
    """tv [M, Gp*E] int8|f32; ts None | [M, 1] | [M, Gp] f32; packed
    uint8 [Np, Gp*B*K/8]; wscale f32 [Np] -> f32 [M, Np]. ``tile`` (an
    index into INT_TILES on the int path, BF16_TILES on the f32 paths) and
    ``splits`` (S) replace the plan's own; None keeps it."""
    return _lut_mpgemm(tv, ts, packed, wscale, 0, k_group=k_group,
                       planes=planes, plane_scales=plane_scales, tile=tile,
                       splits=splits)


def expert_rows(name: str, rows: int, packed: torch.Tensor,
                wscale: torch.Tensor) -> int:
    """Rows per expert, Cp, of a batched call: ``rows`` (E·Cp) over the E
    of packed [E, Np, bytes] and wscale [E, Np]."""
    if packed.dim() != 3 or wscale.dim() != 2:
        raise ValueError(f"{name}: batched weights are packed [E, Np, bytes] "
                         f"and wscale [E, Np]")
    e = packed.shape[0]
    if e < 1 or rows % e or wscale.shape[0] != e:
        raise ValueError(f"{name}: {rows} rows do not split into {e} experts")
    return rows // e


def check_expert_rows(cp: int, bm: int):
    """A batched call's Cp rows per expert must fill whole row tiles of
    BM rows, so that no block of the kernel straddles two experts."""
    if cp % bm:
        raise ValueError(f"{cp} rows per expert are not padded to the "
                         f"tile's {bm} rows")


def lut_mpgemm_batched(tv: torch.Tensor, ts: Optional[torch.Tensor],
                       packed: torch.Tensor, wscale: torch.Tensor, *,
                       k_group: int, planes: int,
                       plane_scales: Sequence[float], tile: int,
                       splits: Optional[int] = None) -> torch.Tensor:
    """E experts' staged mpGEMMs in one launch (the reference vmaps
    ``lut_mpgemm_pallas`` over the experts): tv [E·Cp, Gp*E'] and ts as
    ``lut_mpgemm`` takes them, expert e's rows e·Cp .. (e+1)·Cp - 1 with Cp
    a multiple of the tile's rows; packed [E, Np, Gp*B*K/8]; wscale f32
    [E, Np] -> f32 [E·Cp, Np]. ``tile`` is the caller's (``kernels.ops``:
    the tile an expert's C rows take alone); split-K plans over all E·Cp
    rows."""
    cp = expert_rows("lut_mpgemm_batched", tv.shape[0], packed, wscale)
    return _lut_mpgemm(tv, ts, packed, wscale, cp, k_group=k_group,
                       planes=planes, plane_scales=plane_scales, tile=tile,
                       splits=splits)


def lut_mpgemm_batched_plain(tv, ts, packed, wscale, *, k_group: int,
                             planes: int, plane_scales: Sequence[float]
                             ) -> torch.Tensor:
    """Plain version of ``lut_mpgemm_batched``: ``lut_mpgemm_plain`` per
    expert, on its row block and its weights."""
    cp = expert_rows("lut_mpgemm_batched", tv.shape[0], packed, wscale)
    return torch.cat([lut_mpgemm_plain(
        tv[i * cp:(i + 1) * cp], None if ts is None else ts[i * cp:(i + 1) * cp],
        packed[i], wscale[i], k_group=k_group, planes=planes,
        plane_scales=plane_scales) for i in range(packed.shape[0])])


def _lut_mpgemm(tv, ts, packed, wscale, cp: int, *, k_group: int,
                planes: int, plane_scales: Sequence[float],
                tile: Optional[int], splits: Optional[int]) -> torch.Tensor:
    """The launch of ``lut_mpgemm`` (cp = 0: packed [Np, bytes]; counted
    in ``launches``) and of ``lut_mpgemm_batched`` (cp = rows per expert:
    packed [E, Np, bytes]; counted in ``batched_launches``) for CUDA
    operands, the plain version for CPU ones."""
    global launches, batched_launches
    e = 1 << (k_group - 1)
    mp, ge = tv.shape
    gp = ge // e
    mode = _mode(tv, ts, gp)
    weights = packed if cp == 0 else packed.reshape(-1, packed.shape[-1])
    check_operands("lut_mpgemm", tv, weights, wscale.reshape(-1), k_group,
                   planes, gp, tv.device)
    if ts is not None and (ts.dtype != torch.float32 or ts.device != tv.device
                           or not ts.is_contiguous() or ts.shape[0] != mp):
        raise ValueError("lut_mpgemm: table scales must be contiguous f32 "
                         "[M, *] on the table's device")
    if tv.data_ptr() % 16 or packed.data_ptr() % 4:
        raise ValueError("lut_mpgemm: the kernel copies the table in "
                         "16-byte and the codes in 4-byte pieces; pass "
                         "aligned operands")
    np_ = packed.shape[-2]
    if tv.device.type == "cpu":
        if tile is not None or splits is not None:
            _, bm, _, _ = staged_plan(mode, mp, np_, gp, k_group, planes,
                                      tile, splits)[0]
            check_expert_rows(cp, bm)
        plain = lut_mpgemm_plain if cp == 0 else lut_mpgemm_batched_plain
        return plain(tv, ts, packed, wscale, k_group=k_group, planes=planes,
                     plane_scales=plane_scales)
    if tv.device.type != "cuda":
        raise ValueError(f"lut_mpgemm: unsupported device {tv.device}")
    (config, bm, _, bg), splits, tiles = staged_plan(
        mode, mp, np_, gp, k_group, planes, tile, splits)
    check_expert_rows(cp, bm)
    ps = plane_args(planes, plane_scales)
    work, arrivals = None, None
    if mode == 1 and splits > 1:
        work = torch.empty((splits, mp, np_), device=tv.device,
                           dtype=torch.int32)
    elif splits > 1:
        work, arrivals = f32_workspace(tv.device, splits * mp * np_, tiles)
    out = torch.empty((mp, np_), device=tv.device, dtype=torch.float32)
    fn = _build.launcher("lut_mpgemm")
    with torch.cuda.device(tv.device):
        rc = fn(tv.data_ptr(), None if ts is None else ts.data_ptr(),
                packed.data_ptr(), wscale.data_ptr(), out.data_ptr(),
                None if work is None else work.data_ptr(),
                None if arrivals is None else arrivals.data_ptr(), mp, np_,
                gp, k_group, planes, ps, mode, config, bg, splits, cp,
                torch.cuda.current_stream(tv.device).cuda_stream)
    _build.check("lut_mpgemm", rc)
    if cp:
        batched_launches += 1
    else:
        launches += 1
    return out
