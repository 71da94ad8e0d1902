"""Dequantization-based mpGEMM kernel: wrapper, plain version and launch
count.

The CUDA kernel (``csrc/dequant_mpgemm.cu``) replaces the TPU kernel
``repro/kernels/dequant_mpgemm.py:dequant_mpgemm_pallas``: it unpacks the
packed codes, unfolds Eq. 6 into the reinterpreted weights
``q'[n, k] = Σ_b ps_b·(2·bit_b − 1)`` in shared memory, and computes
``out = (A·q'ᵀ)·ws``.

It runs on the bf16 tensor cores. q' is an integer with |q'| <= 255
(``lut_mpgemm.plane_args`` checks the plane scales), exact in bf16; each
f32 activation is split into PASSES = 3 bf16 terms that sum to it exactly
(``t_j`` = the remainder ``a − t_0 − … − t_{j−1}`` with its low 16 bits
cleared), each contracted into the same f32 sums. The result is within
1e-4 of the IEEE f32 product. The row and channel tiles are the int
paths' (16 × 128, 64 × 64, 128 × 128; ``TILES``, the bf16 main loop's
``lut_mpgemm.BF16_TILES``, shared with the LUT kernels' f32 paths), and
the K-steps split into contiguous ranges (``plan``) so that enough blocks
fill the card;
the f32 partial sums meet in a per-device workspace and the last block of
a tile adds them in split order inside the one launch, so two calls on
the same inputs give the same bits.

Inputs are pre-padded to the kernel's tile (``tile_for``: channels and
K-groups; x's rows as they are), done by ``kernels.ops``. The wrapper
launches the kernel for CUDA tensors and runs the plain version for CPU
tensors; ``launches`` counts kernel launches. The workspace and the tiles'
arrival counts (``lut_mpgemm.f32_workspace``, shared with the LUT
kernels' f32 paths) are allocated once per device, grown when a call
needs more, and the counts are left zeroed by every launch, so calls on
one device must share one stream.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.core.quantize import QuantizedWeight, plane_codes
from repro_torch.kernels import _build
from repro_torch.kernels.lut_mpgemm import (BF16_TILES, BLOCKS_PER_SM,
                                            check_operands, f32_workspace,
                                            plane_args, wave_splits)

__all__ = ["dequant_mpgemm", "dequant_mpgemm_plain", "tile_for", "plan",
           "ring", "TILES", "BLOCKS_PER_SM", "PASSES"]

# (BM, BN, KT) of the kernel's configs 0, 1, 2 (csrc/lut_mma.cuh: MmaSmall,
# MmaMid, MmaLarge): a K-step holds KT weights; BLOCKS_PER_SM blocks share
# an SM (lut_mpgemm.BF16_TILES says why these)
TILES = BF16_TILES
PASSES = 3  # bf16 terms per activation (csrc/dequant_mpgemm.cu: kTerms)
launches = 0


def tile_for(m: int, k_group: int) -> Tuple[int, int, int, int]:
    """(config, BM, BN, bg) of the kernel's tile for M rows: the smallest
    row tile that holds M (the largest for more rows), bg = KT / k_group
    groups per K-step."""
    config = next((i for i, (bm, _, _) in enumerate(TILES) if m <= bm),
                  len(TILES) - 1)
    bm, bn, kt = TILES[config]
    return config, bm, bn, kt // k_group


def plan(m: int, n: int, gp: int, k_group: int):
    """Launch plan for M rows, N channels and Gp K-groups: ((config, BM, BN,
    bg), S, grid tiles). The K-steps split into S ranges (``k_ranges``), S
    from ``lut_mpgemm.wave_splits``. Raises where N or Gp is not padded to
    the tile."""
    tile = tile_for(m, k_group)
    _, bm, bn, bg = tile
    if n % bn or gp % bg:
        raise ValueError(f"dequant_mpgemm: shape (N={n}, G={gp}) is not "
                         f"padded to the tile (BN={bn}, bg={bg})")
    tiles = -(-m // bm) * (n // bn)
    return tile, wave_splits(tiles, gp // bg), tiles


def ring(m: int, k_group: int, planes: int) -> Tuple[int, int]:
    """(stages, dynamic shared memory bytes) of the kernel's cp.async ring
    for M rows, as its launch plans them (``dequant_mpgemm_ring`` of the
    card's library, built on first use)."""
    config, _, _, bg = tile_for(m, k_group)
    fn = _build.library("dequant_mpgemm").dequant_mpgemm_ring
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    stages = ctypes.c_int()
    smem = fn(m, k_group, planes, config, bg, ctypes.byref(stages))
    if smem < 0:
        raise ValueError(f"dequant_mpgemm: no ring for M={m}, "
                         f"k_group={k_group}, planes={planes}")
    return stages.value, smem


def dequant_mpgemm_plain(a, packed, wscale, *, k_group: int, planes: int,
                         plane_scales: Sequence[float]) -> torch.Tensor:
    """Plain torch version: ``(a @ q'ᵀ) · ws`` in f32, with q' from
    ``core.quantize.plane_codes`` (no zero point). On the card the matmul
    is f32 only with TF32 off, torch's default."""
    gp = packed.shape[1] * 8 // (planes * k_group)
    qw = QuantizedWeight(packed, wscale, None, plane_scales, bits=planes,
                         k_group=k_group, k_total=gp * k_group,
                         n=packed.shape[0])
    return (a @ plane_codes(qw).T) * wscale[None, :]


def dequant_mpgemm(a: torch.Tensor, packed: torch.Tensor,
                   wscale: torch.Tensor, *, k_group: int, planes: int,
                   plane_scales: Sequence[float]) -> torch.Tensor:
    """a f32 [M, Gp*K]; packed uint8 [Np, Gp*B*K/8]; wscale f32 [Np]
    -> f32 [M, Np]."""
    global launches
    if a.dim() != 2 or a.dtype != torch.float32 or a.shape[1] % k_group:
        raise ValueError(f"dequant_mpgemm: activations must be f32 [M, G*K], "
                         f"got {a.dtype} {tuple(a.shape)}")
    m, gp = a.shape[0], a.shape[1] // k_group
    check_operands("dequant_mpgemm", a, packed, wscale, k_group, planes, gp,
                   a.device)
    np_ = packed.shape[0]
    if m == 0 or np_ == 0:
        return torch.empty((m, np_), device=a.device, dtype=torch.float32)
    if a.device.type == "cpu":
        return dequant_mpgemm_plain(a, packed, wscale, k_group=k_group,
                                    planes=planes, plane_scales=plane_scales)
    if a.device.type != "cuda":
        raise ValueError(f"dequant_mpgemm: unsupported device {a.device}")
    if a.data_ptr() % 16 or packed.data_ptr() % 4:
        raise ValueError("dequant_mpgemm: the kernel copies the activations "
                         "in 16-byte and the codes in 4-byte pieces; pass "
                         "aligned operands")
    (config, _, _, bg), splits, tiles = plan(m, np_, gp, k_group)
    ps = plane_args(planes, plane_scales)
    work, arrivals = (f32_workspace(a.device, splits * m * np_, tiles)
                      if splits > 1 else (None, None))
    out = torch.empty((m, np_), device=a.device, dtype=torch.float32)
    fn = _build.launcher("dequant_mpgemm")
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), packed.data_ptr(), wscale.data_ptr(),
                out.data_ptr(), None if work is None else work.data_ptr(),
                None if arrivals is None else arrivals.data_ptr(), m, np_, gp,
                k_group, planes, ps, config, bg, splits,
                torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("dequant_mpgemm", rc)
    launches += 1
    return out
