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

__all__ = ["fused_lut_mpgemm", "fused_lut_mpgemm_plain", "int_tile",
           "int_plan", "INT_KT"]

# Table entries per K-step of the per_row path. At decode each K-step of a
# block waits in turn on its loads, its table build, its CW decode and its
# contraction, so fewer, wider steps cost less: on an H100 at tinyllama's
# decode shapes, 256 entries beat the staged path's 128 at four of the five,
# and 512 beat 256 at two only.
INT_KT = 2 * lut_kernel.INT_KT
launches = 0
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
    global launches
    check_activations(x, k_group, table_quant, row_scale)
    m = x.shape[0]
    gp = x.shape[1] // k_group
    check_operands("fused_lut_mpgemm", x, packed, wscale, k_group, planes,
                   gp, x.device)
    np_ = packed.shape[0]
    plan = int_plan if table_quant == "per_row" else f32_plan
    if x.device.type == "cpu":
        if tile is not None or splits is not None:
            plan(m, np_, gp, k_group, planes, tile, splits)
        return fused_lut_mpgemm_plain(
            x, row_scale, packed, wscale, k_group=k_group,
            table_quant=table_quant, planes=planes, plane_scales=plane_scales)
    if x.device.type != "cuda":
        raise ValueError(f"fused_lut_mpgemm: unsupported device {x.device}")
    if x.data_ptr() % 16 or packed.data_ptr() % 4:
        raise ValueError("fused_lut_mpgemm: the kernel copies x in 16-byte "
                         "and the codes in 4-byte pieces; pass aligned "
                         "operands")
    ps = plane_args(planes, plane_scales)
    (config, _, _, bg), splits, tiles = plan(m, np_, gp, k_group, planes,
                                             tile, splits)
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
                bg, splits, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fused_lut_mpgemm", rc)
    launches += 1
    return out
