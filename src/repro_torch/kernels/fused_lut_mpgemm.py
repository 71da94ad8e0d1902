"""Fused precompute→lookup kernel: wrapper, plain version and launch count.

The CUDA kernel (``csrc/fused_lut_mpgemm.cu``) replaces the TPU kernel
``repro/kernels/fused_lut_mpgemm.py:fused_lut_mpgemm_pallas``: it rebuilds
each table tile from the activations in shared memory (per_row INT8 with
the wrapper's row scale, per_group quantize→dequantize, or f32) and
contracts it against the CW tile at once, so the table never reaches device
memory. It shares the entry, quantization and CW code of the staged pair
(``csrc/lut_common.cuh``, ``csrc/lut_mma.cuh``), which makes per_row
bit-exact with them.

The per_row path (the decode path) runs on the int8 tensor cores with the
staged int path's row and channel tiles and split-K plan
(``lut_mpgemm.int_tile_for``, ``lut_mpgemm.split_for``) but K-steps twice
as wide (``int_tile``, ``INT_KT``). It takes any number of rows: x and the
row scale need no row padding, and the output has x's rows. Its split
sums meet in an int32 workspace inside the one launch; the workspace and
the tiles' arrival counts are allocated once per device, grown when a call
needs more, and left zeroed by every launch, so calls on one device must
share one stream.

None and per_group run on the bf16 tensor cores (``csrc/bf16_mma.cuh``)
with the staged kernel's f32 tile and split plan (``lut_mpgemm.f32_plan``)
and its f32 workspace (``lut_mpgemm.f32_workspace``): each block builds its
table tile from x in shared memory, splits each entry into bf16 terms that
sum to it exactly, and sums in f32; each output within rtol = atol = 1e-4
of the plain version, and two calls give the same bits. They too take x's
rows as they are.

Channels and K-groups are pre-padded to the tile (done by ``kernels.ops``).
The wrapper launches the kernel for CUDA tensors and runs the plain version
— the staged pair's plain versions composed — for CPU tensors.

``fused_lut_mpgemm_batched`` adds the expert axis (the MoE FFN): E experts'
activation rows, each expert's padded with zero rows to the tile's rows,
against a stack of E experts' packed weights, in one launch
(``batched_launches`` counts them); its plain version is
``fused_lut_mpgemm_plain`` per expert.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import lut_mpgemm as lut_kernel
from repro_torch.kernels.lut_mpgemm import (check_operands, device_workspace,
                                            f32_plan, f32_workspace,
                                            lut_mpgemm_plain, plane_args,
                                            split_for)
from repro_torch.kernels.table_precompute import (MODES, check_activations,
                                                  table_precompute_plain)

__all__ = ["fused_lut_mpgemm", "fused_lut_mpgemm_plain",
           "fused_lut_mpgemm_batched", "fused_lut_mpgemm_batched_plain",
           "int_tile", "int_plan", "INT_KT"]

# Table entries per K-step of the per_row path. At decode each K-step of a
# block waits in turn on its loads, its table build, its CW decode and its
# contraction, so fewer, wider steps cost less: on an H100 at tinyllama's
# decode shapes, 256 entries beat the staged path's 128 at four of the five,
# and 512 beat 256 at two only.
INT_KT = 2 * lut_kernel.INT_KT
launches = 0
batched_launches = 0  # fused_lut_mpgemm_batched's launches (the expert axis)
# device index -> (split-K workspace, tile arrival counts), int32, all zero
# between launches
_workspaces: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def fused_lut_mpgemm_plain(x, row_scale, packed, wscale, *, k_group: int,
                           table_quant: Optional[str], planes: int,
                           plane_scales: Sequence[float]) -> torch.Tensor:
    tv, ts = table_precompute_plain(x, k_group, table_quant, row_scale)
    return lut_mpgemm_plain(tv, ts, packed, wscale, k_group=k_group,
                            planes=planes, plane_scales=plane_scales)


def int_tile(m: int, k_group: int, planes: int, tile: Optional[int] = None):
    """(config, BM, BN, bg) of the per_row path for M rows: the staged int
    path's tile (``lut_mpgemm.int_tile_for``, INT_TILES[tile] when given)
    with INT_KT entries a step."""
    return lut_kernel.int_tile_for(m, k_group, planes, INT_KT, tile)


def int_plan(m: int, n: int, gp: int, k_group: int, planes: int,
             tile: Optional[int] = None, splits: Optional[int] = None):
    """Launch plan of the per_row path for M rows, N channels and Gp
    K-groups: ((config, BM, BN, bg), S, grid tiles), ``tile`` and
    ``splits`` as ``lut_mpgemm.int_tile_for`` and ``split_for`` take them.
    Raises where N or Gp is not padded to the tile."""
    tile = int_tile(m, k_group, planes, tile)
    _, bm, bn, bg = tile
    if n % bn or gp % bg:
        raise ValueError(f"shape (N={n}, G={gp}) is not padded to the tile "
                         f"(BN={bn}, bg={bg})")
    mp = -(-m // bm) * bm
    splits, _ = split_for(mp, n, gp, bm, bn, bg, splits)
    return tile, splits, (mp // bm) * (n // bn)


def fused_lut_mpgemm(x: torch.Tensor, row_scale: Optional[torch.Tensor],
                     packed: torch.Tensor, wscale: torch.Tensor, *,
                     k_group: int, table_quant: Optional[str], planes: int,
                     plane_scales: Sequence[float],
                     tile: Optional[int] = None,
                     splits: Optional[int] = None) -> torch.Tensor:
    """x f32 [M, Gp*K]; row_scale f32 [M, 1] (per_row); packed uint8
    [Np, Gp*B*K/8]; wscale f32 [Np] -> f32 [M, Np]. ``tile`` (an index into
    INT_TILES on per_row, BF16_TILES on float tables) and ``splits`` (S)
    replace the plan's own; None keeps it."""
    return _fused(x, row_scale, packed, wscale, 0, k_group=k_group,
                  table_quant=table_quant, planes=planes,
                  plane_scales=plane_scales, tile=tile, splits=splits)


def fused_lut_mpgemm_batched(x: torch.Tensor,
                             row_scale: Optional[torch.Tensor],
                             packed: torch.Tensor, wscale: torch.Tensor, *,
                             k_group: int, table_quant: Optional[str],
                             planes: int, plane_scales: Sequence[float],
                             tile: int,
                             splits: Optional[int] = None) -> torch.Tensor:
    """E experts' fused mpGEMMs in one launch (the reference vmaps
    ``fused_lut_mpgemm_pallas`` over the experts): x f32 [E·Cp, Gp*K],
    expert e's rows e·Cp .. (e+1)·Cp - 1 with Cp a multiple of the tile's
    rows (rows past an expert's own are zero); row_scale f32 [E·Cp, 1]
    (per_row); packed [E, Np, Gp*B*K/8]; wscale f32 [E, Np] -> f32
    [E·Cp, Np]. ``tile`` is the caller's (``kernels.ops``: the tile an
    expert's C rows take alone); split-K plans over all E·Cp rows."""
    cp = lut_kernel.expert_rows("fused_lut_mpgemm_batched", x.shape[0],
                                packed, wscale)
    return _fused(x, row_scale, packed, wscale, cp, k_group=k_group,
                  table_quant=table_quant, planes=planes,
                  plane_scales=plane_scales, tile=tile, splits=splits)


def fused_lut_mpgemm_batched_plain(x, row_scale, packed, wscale, *,
                                   k_group: int, table_quant: Optional[str],
                                   planes: int, plane_scales: Sequence[float]
                                   ) -> torch.Tensor:
    """Plain version of ``fused_lut_mpgemm_batched``:
    ``fused_lut_mpgemm_plain`` per expert, on its row block and its
    weights."""
    cp = lut_kernel.expert_rows("fused_lut_mpgemm_batched", x.shape[0],
                                packed, wscale)
    rows = lambda t, i: None if t is None else t[i * cp:(i + 1) * cp]
    return torch.cat([fused_lut_mpgemm_plain(
        rows(x, i), rows(row_scale, i), packed[i], wscale[i],
        k_group=k_group, table_quant=table_quant, planes=planes,
        plane_scales=plane_scales) for i in range(packed.shape[0])])


def _fused(x, row_scale, packed, wscale, cp: int, *, k_group: int,
           table_quant: Optional[str], planes: int,
           plane_scales: Sequence[float], tile: Optional[int],
           splits: Optional[int]) -> torch.Tensor:
    """The launch of ``fused_lut_mpgemm`` (cp = 0: packed [Np, bytes];
    counted in ``launches``) and of ``fused_lut_mpgemm_batched`` (cp = rows
    per expert: packed [E, Np, bytes]; counted in ``batched_launches``) for
    CUDA operands, the plain version for CPU ones."""
    global launches, batched_launches
    check_activations(x, k_group, table_quant, row_scale)
    m = x.shape[0]
    gp = x.shape[1] // k_group
    weights = packed if cp == 0 else packed.reshape(-1, packed.shape[-1])
    check_operands("fused_lut_mpgemm", x, weights, wscale.reshape(-1),
                   k_group, planes, gp, x.device)
    np_ = packed.shape[-2]
    plan = int_plan if table_quant == "per_row" else f32_plan
    if x.device.type == "cpu":
        if tile is not None or splits is not None:
            _, bm, _, _ = plan(m, np_, gp, k_group, planes, tile, splits)[0]
            lut_kernel.check_expert_rows(cp, bm)
        fn = (fused_lut_mpgemm_plain if cp == 0
              else fused_lut_mpgemm_batched_plain)
        return fn(x, row_scale, packed, wscale, k_group=k_group,
                  table_quant=table_quant, planes=planes,
                  plane_scales=plane_scales)
    if x.device.type != "cuda":
        raise ValueError(f"fused_lut_mpgemm: unsupported device {x.device}")
    if x.data_ptr() % 16 or packed.data_ptr() % 4:
        raise ValueError("fused_lut_mpgemm: the kernel copies x in 16-byte "
                         "and the codes in 4-byte pieces; pass aligned "
                         "operands")
    ps = plane_args(planes, plane_scales)
    (config, bm, _, bg), splits, tiles = plan(m, np_, gp, k_group, planes,
                                              tile, splits)
    lut_kernel.check_expert_rows(cp, bm)
    work, arrivals = None, None
    if table_quant == "per_row" and splits > 1:
        work, arrivals = device_workspace(_workspaces, x.device, m * np_,
                                          tiles, torch.int32)
    elif splits > 1:
        work, arrivals = f32_workspace(x.device, splits * m * np_, tiles)
    out = torch.empty((m, np_), device=x.device, dtype=torch.float32)
    fn = _build.launcher("fused_lut_mpgemm")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(),
                row_scale.data_ptr() if table_quant == "per_row" else None,
                packed.data_ptr(), wscale.data_ptr(), out.data_ptr(),
                None if work is None else work.data_ptr(),
                None if arrivals is None else arrivals.data_ptr(),
                m, np_, gp, k_group, planes, ps, MODES[table_quant], config,
                bg, splits, cp, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fused_lut_mpgemm", rc)
    if cp:
        batched_launches += 1
    else:
        launches += 1
    return out
