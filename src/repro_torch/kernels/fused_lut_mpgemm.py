"""Fused precompute→lookup kernel: wrapper, plain version and launch count.

The CUDA kernel (``csrc/fused_lut_mpgemm.cu``) replaces the TPU kernel
``repro/kernels/fused_lut_mpgemm.py:fused_lut_mpgemm_pallas``: it rebuilds
each table tile from the activations in shared memory (per_row INT8 with
the wrapper's row scale, per_group quantize→dequantize, or f32) and
contracts it against the CW tile at once, so the table never reaches device
memory. It shares the entry, quantization and CW code of the staged pair
(``csrc/lut_common.cuh``), which makes per_row bit-exact with them.

Inputs are pre-padded to the kernel's tile (``lut_mpgemm.tile_for``). The
wrapper launches the kernel for CUDA tensors and runs the plain version —
the staged pair's plain versions composed — for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lut_mpgemm import (check_operands, launch_args,
                                            lut_mpgemm_plain)
from repro_torch.kernels.table_precompute import (MODES, check_activations,
                                                  table_precompute_plain)

__all__ = ["fused_lut_mpgemm", "fused_lut_mpgemm_plain"]

launches = 0


def fused_lut_mpgemm_plain(x, row_scale, packed, wscale, *, k_group: int,
                           table_quant: Optional[str], planes: int,
                           plane_scales: Sequence[float]) -> torch.Tensor:
    tv, ts = table_precompute_plain(x, k_group, table_quant, row_scale)
    return lut_mpgemm_plain(tv, ts, packed, wscale, k_group=k_group,
                            planes=planes, plane_scales=plane_scales)


def fused_lut_mpgemm(x: torch.Tensor, row_scale: Optional[torch.Tensor],
                     packed: torch.Tensor, wscale: torch.Tensor, *,
                     k_group: int, table_quant: Optional[str], planes: int,
                     plane_scales: Sequence[float]) -> torch.Tensor:
    """x f32 [Mp, Gp*K]; row_scale f32 [Mp, 1] (per_row); packed uint8
    [Np, Gp*B*K/8]; wscale f32 [Np] -> f32 [Mp, Np]."""
    global launches
    check_activations(x, k_group, table_quant, row_scale)
    mp = x.shape[0]
    gp = x.shape[1] // k_group
    check_operands("fused_lut_mpgemm", x, packed, wscale, k_group, planes,
                   gp, x.device)
    if x.device.type == "cpu":
        return fused_lut_mpgemm_plain(
            x, row_scale, packed, wscale, k_group=k_group,
            table_quant=table_quant, planes=planes, plane_scales=plane_scales)
    if x.device.type != "cuda":
        raise ValueError(f"fused_lut_mpgemm: unsupported device {x.device}")
    np_ = packed.shape[0]
    config, bg, ps = launch_args(k_group, planes, plane_scales, mp, np_, gp)
    out = torch.empty((mp, np_), device=x.device, dtype=torch.float32)
    fn = _build.launcher("fused_lut_mpgemm")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(),
                row_scale.data_ptr() if table_quant == "per_row" else None,
                packed.data_ptr(), wscale.data_ptr(), out.data_ptr(),
                mp, np_, gp, k_group, planes, ps, MODES[table_quant], config,
                bg, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fused_lut_mpgemm", rc)
    launches += 1
    return out
