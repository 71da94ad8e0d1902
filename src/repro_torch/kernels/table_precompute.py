"""Table-precompute kernel: wrappers, plain versions and launch counts.

The CUDA kernel (``csrc/table_precompute.cu``) replaces the TPU kernel
``repro/kernels/table_precompute.py:table_precompute_pallas`` together with
the per_row row scale its wrapper computes (``repro/kernels/ops.py:
_closed_form_row_scale``): with no row scale given, one launch computes the
scale and the table. ``row_scale`` computes the scale alone, for the fused
kernel. Each wrapper launches its kernel for a CUDA tensor and runs the
plain version for a CPU tensor; any other device raises. ``launches``
counts table launches, ``row_scale_launches`` row-scale launches.

Non-finite inputs: the row scale of a row holding a NaN is NaN, of a row
holding an inf (and no NaN) inf, in both versions (as ``torch.amax`` and
``clamp_min`` give it); per_group scales follow the same rule per group.
The codes of such a row are unspecified.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import table as table_mod
from repro_torch.kernels import _build

__all__ = ["table_precompute", "table_precompute_plain", "row_scale",
           "row_scale_plain", "MODES"]

# table_quant -> the kernels' mode number (csrc/lut_common.cuh: Mode)
MODES = {None: 0, "per_row": 1, "per_group": 2}
launches = 0
row_scale_launches = 0


def _check_a(a, k_group):
    if a.dim() != 2 or a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError(f"activations must be contiguous f32 [M, G*K], got "
                         f"{a.dtype} {tuple(a.shape)}")
    if a.shape[1] % k_group:
        raise ValueError(f"K={a.shape[1]} not divisible by k_group={k_group}")


def check_activations(a, k_group, table_quant, row_scale, *,
                      scale_optional=False):
    """Raises on operands the kernels do not take. per_row needs a row
    scale unless ``scale_optional`` (the table kernel then computes it)."""
    if table_quant not in MODES:
        raise ValueError(f"unknown table_quant mode {table_quant!r}")
    _check_a(a, k_group)
    if table_quant == "per_row" and not (scale_optional and row_scale is None):
        if (row_scale is None or row_scale.dtype != torch.float32
                or tuple(row_scale.shape) != (a.shape[0], 1)
                or row_scale.device != a.device
                or not row_scale.is_contiguous()):
            raise ValueError("per_row needs the wrapper's contiguous f32 "
                             "[M, 1] row scale on the activations' device")


def row_scale_plain(a: torch.Tensor, k_group: int) -> torch.Tensor:
    """[M, 1] closed-form per_row scale (``core.table.group_absmax``):
    max over groups of Σ|a|, clamped at 1e-30, IEEE-divided by 127."""
    am = table_mod.group_absmax(a.to(torch.float32).reshape(
        a.shape[0], a.shape[1] // k_group, k_group))
    return table_mod.true_divide(am.amax(dim=-1).clamp_min(1e-30),
                                 127.0)[:, None]


def table_precompute_plain(a: torch.Tensor, k_group: int,
                           table_quant: Optional[str],
                           row_scale: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version, ``core.table``'s precompute: (values [M, G*E],
    scale) — the per_row scale [M, 1] (as given, or the closed form), the
    per_group scale [M, G], or None. per_row quantizes with that row
    scale, as the kernel does."""
    m, width = a.shape[0], (a.shape[1] // k_group) << (k_group - 1)
    if table_quant != "per_row":
        t = table_mod.precompute_table(a, k_group, table_quant)
        return t.values.reshape(m, width), (None if t.scale is None
                                            else t.scale[..., 0])
    if row_scale is None:
        row_scale = row_scale_plain(a, k_group)
    t = table_mod.precompute_table(a, k_group)
    t = table_mod.quantize_table(t.values, t.rowsum, k_group, "per_row",
                                 scale=row_scale.reshape(m, 1, 1))
    return t.values.reshape(m, width), row_scale


def table_precompute(a: torch.Tensor, k_group: int,
                     table_quant: Optional[str],
                     row_scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """a: contiguous f32 [M, G*K]; row_scale: f32 [M, 1] for per_row, or
    None to compute it in the same launch. Returns (values [M, G*E] f32 or
    int8, scale) as the plain version."""
    global launches
    check_activations(a, k_group, table_quant, row_scale, scale_optional=True)
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
    scale = None  # a scale the kernel writes: per_group, or per_row not given
    if table_quant == "per_group":
        scale = torch.empty((m, g), device=a.device, dtype=torch.float32)
    elif table_quant == "per_row" and row_scale is None:
        scale = torch.empty((m, 1), device=a.device, dtype=torch.float32)
    if m:  # no rows: nothing to launch
        fn = _build.launcher("table_precompute")
        with torch.cuda.device(a.device):
            rc = fn(a.data_ptr(),
                    None if row_scale is None else row_scale.data_ptr(),
                    values.data_ptr(),
                    None if scale is None else scale.data_ptr(),
                    m, g, k_group, MODES[table_quant],
                    torch.cuda.current_stream(a.device).cuda_stream)
        _build.check("table_precompute", rc)
        launches += 1
    if table_quant == "per_row" and scale is None:
        scale = row_scale  # given
    return values, scale


def row_scale(a: torch.Tensor, k_group: int) -> torch.Tensor:
    """a: contiguous f32 [M, G*K] -> the per_row scale f32 [M, 1], in one
    launch on CUDA (``row_scale_plain`` on the CPU)."""
    global row_scale_launches
    _check_a(a, k_group)
    if a.device.type == "cpu":
        return row_scale_plain(a, k_group)
    if a.device.type != "cuda":
        raise ValueError(f"row_scale: unsupported device {a.device}")
    m = a.shape[0]
    out = torch.empty((m, 1), device=a.device, dtype=torch.float32)
    if m == 0:  # no rows: nothing to launch
        return out
    fn = _build.launcher("row_scale")
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), out.data_ptr(), m, a.shape[1] // k_group,
                k_group, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("row_scale", rc)
    row_scale_launches += 1
    return out
