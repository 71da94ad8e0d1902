"""Table-precompute kernel: wrapper, plain version and launch count.

The CUDA kernel (``csrc/table_precompute.cu``) replaces the TPU kernel
``repro/kernels/table_precompute.py:table_precompute_pallas``. The wrapper
launches it for a CUDA tensor and runs the plain version for a CPU tensor;
any other device raises. ``launches`` counts kernel launches only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import table as table_mod
from repro_torch.kernels import _build

__all__ = ["table_precompute", "table_precompute_plain", "MODES"]

# table_quant -> the kernels' mode number (csrc/lut_common.cuh: Mode)
MODES = {None: 0, "per_row": 1, "per_group": 2}
launches = 0


def check_activations(a, k_group, table_quant, row_scale):
    if table_quant not in MODES:
        raise ValueError(f"unknown table_quant mode {table_quant!r}")
    if a.dim() != 2 or a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError(f"activations must be contiguous f32 [M, G*K], got "
                         f"{a.dtype} {tuple(a.shape)}")
    if a.shape[1] % k_group:
        raise ValueError(f"K={a.shape[1]} not divisible by k_group={k_group}")
    if table_quant == "per_row":
        if (row_scale is None or row_scale.dtype != torch.float32
                or tuple(row_scale.shape) != (a.shape[0], 1)
                or row_scale.device != a.device
                or not row_scale.is_contiguous()):
            raise ValueError("per_row needs the wrapper's contiguous f32 "
                             "[M, 1] row scale on the activations' device")


def table_precompute_plain(a: torch.Tensor, k_group: int,
                           table_quant: Optional[str],
                           row_scale: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version, ``core.table``'s precompute: (values [M, G*E],
    scale) — the per_row scale as given, the per_group scale [M, G], or
    None. per_row quantizes with the given row scale, as the kernel does."""
    m = a.shape[0]
    if table_quant != "per_row":
        t = table_mod.precompute_table(a, k_group, table_quant)
        return t.values.reshape(m, -1), (None if t.scale is None
                                         else t.scale.reshape(m, -1))
    t = table_mod.precompute_table(a, k_group)
    t = table_mod.quantize_table(t.values, t.rowsum, k_group, "per_row",
                                 scale=row_scale.reshape(m, 1, 1))
    return t.values.reshape(m, -1), row_scale


def table_precompute(a: torch.Tensor, k_group: int,
                     table_quant: Optional[str],
                     row_scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """a: contiguous f32 [M, G*K]; row_scale: f32 [M, 1] for per_row.
    Returns (values [M, G*E] f32 or int8, scale) as the plain version."""
    global launches
    check_activations(a, k_group, table_quant, row_scale)
    if a.device.type == "cpu":
        return table_precompute_plain(a, k_group, table_quant, row_scale)
    if a.device.type != "cuda":
        raise ValueError(f"table_precompute: unsupported device {a.device}")
    m, k_total = a.shape
    g = k_total // k_group
    e = 1 << (k_group - 1)
    values = torch.empty((m, g * e), device=a.device,
                         dtype=torch.float32 if table_quant is None
                         else torch.int8)
    scale = (torch.empty((m, g), device=a.device, dtype=torch.float32)
             if table_quant == "per_group" else None)
    fn = _build.launcher("table_precompute")
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(),
                row_scale.data_ptr() if table_quant == "per_row" else None,
                values.data_ptr(),
                scale.data_ptr() if scale is not None else None,
                m, g, k_group, MODES[table_quant],
                torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("table_precompute", rc)
    launches += 1
    return values, (row_scale if table_quant == "per_row" else scale)
