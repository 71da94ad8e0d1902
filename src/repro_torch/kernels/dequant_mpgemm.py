"""Dequantization-based mpGEMM kernel: wrapper, plain version and launch
count.

The CUDA kernel (``csrc/dequant_mpgemm.cu``) replaces the TPU kernel
``repro/kernels/dequant_mpgemm.py:dequant_mpgemm_pallas``: it unpacks the
packed codes, unfolds Eq. 6 into the reinterpreted weights
``q'[n, k] = Σ_b ps_b·(2·bit_b − 1)`` in shared memory, and computes
``out = (A·q'ᵀ)·ws`` in IEEE f32. Its 2·M·N·K f32 operations, not the
packed bytes, bound it on the H100 at the shapes it serves (decode M = 4
and prefill M = 128); the kernel keeps each weight tile on chip once per
block row and contracts it with register micro-tiles (see the source).

Inputs are pre-padded to the kernel's tile (``tile_for``, done by
``kernels.ops``). The wrapper launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.quantize import QuantizedWeight, plane_codes
from repro_torch.kernels import _build
from repro_torch.kernels.lut_mpgemm import TILES, check_operands, plane_args

__all__ = ["dequant_mpgemm", "dequant_mpgemm_plain", "tile_for"]

launches = 0


def tile_for(m: int, k_group: int) -> Tuple[int, int, int, int]:
    """(config, BM, BN, bg) of the kernel's tile for M rows: the LUT
    kernels' tiles (``lut_mpgemm.TILES``), with a K-step of KT_MIN weights,
    so bg = KT_MIN / k_group groups."""
    config = 0 if m <= TILES[0][0] else 1
    bm, bn, kt = TILES[config]
    return config, bm, bn, max(1, kt // k_group)


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
    """a f32 [Mp, Gp*K]; packed uint8 [Np, Gp*B*K/8]; wscale f32 [Np]
    -> f32 [Mp, Np]."""
    global launches
    if a.dim() != 2 or a.dtype != torch.float32 or a.shape[1] % k_group:
        raise ValueError(f"dequant_mpgemm: activations must be f32 [M, G*K], "
                         f"got {a.dtype} {tuple(a.shape)}")
    mp, gp = a.shape[0], a.shape[1] // k_group
    check_operands("dequant_mpgemm", a, packed, wscale, k_group, planes, gp,
                   a.device)
    if a.device.type == "cpu":
        return dequant_mpgemm_plain(a, packed, wscale, k_group=k_group,
                                    planes=planes, plane_scales=plane_scales)
    if a.device.type != "cuda":
        raise ValueError(f"dequant_mpgemm: unsupported device {a.device}")
    np_ = packed.shape[0]
    config, bm, bn, bg = tile_for(mp, k_group)
    if mp % bm or np_ % bn or gp % bg:
        raise ValueError(f"dequant_mpgemm: shape (M={mp}, N={np_}, G={gp}) is "
                         f"not padded to the tile (BM={bm}, BN={bn}, bg={bg})")
    ps = plane_args(planes, plane_scales)
    out = torch.empty((mp, np_), device=a.device, dtype=torch.float32)
    fn = _build.launcher("dequant_mpgemm")
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), packed.data_ptr(), wscale.data_ptr(),
                out.data_ptr(), mp, np_, gp, k_group, planes, ps, config, bg,
                torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("dequant_mpgemm", rc)
    launches += 1
    return out
