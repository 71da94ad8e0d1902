"""Plain-torch oracles for the mpGEMM kernels.

  * ``ref_dequant_mpgemm``    — A @ dequantize(W).T, the paper's baseline;
  * ``ref_lut_mpgemm_matmul`` — one GEMM ``T[M, G·E] @ CW[G·E, N]`` where CW
    folds the one-hot lookup, the plane scales and the Eq.-6 sign into an
    integer matrix with entries in [-15, 15].

The per_row INT8 contraction runs in float64: its integer sums (up to
~2.2e7 at B=4, K=5632) overflow float32's 24-bit mantissa but are exact in
float64, so this path is bit-exact with an int32 accumulator.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import QuantizedWeight, dequantize
from repro_torch.core.table import Table, precompute_table

__all__ = ["ref_dequant_mpgemm", "ref_lut_mpgemm_matmul", "lut_contract",
           "build_cw", "cw_from_codes", "zero_point_correction"]


def zero_point_correction(out, qw: QuantizedWeight, rowsum):
    """out[m,n] -= rowsum[m] * scale[n] * z'[n]  (no-op for symmetric)."""
    if qw.zero_prime is None:
        return out
    return out - torch.outer(rowsum, qw.scale * qw.zero_prime)


def ref_dequant_mpgemm(a, qw: QuantizedWeight):
    return a.to(torch.float32) @ dequantize(qw).T


def cw_from_codes(sign, idx, plane_scales, k_group: int) -> torch.Tensor:
    """(sign, idx) [N, G, B] -> CW entries int32 [N, G, E]:
    CW[n, g, e] = Σ_b ps_b·(1−2·sign[n,g,b])·[idx[n,g,b]==e]."""
    n, g, _ = sign.shape
    coeff = torch.stack([(1 - 2 * sign[..., b].to(torch.int32)) * int(ps)
                         for b, ps in enumerate(plane_scales)], dim=-1)
    cw = torch.zeros(n, g, 1 << (k_group - 1), dtype=torch.int32,
                     device=sign.device)
    return cw.scatter_add_(2, idx.to(torch.int64), coeff)


def build_cw(qw: QuantizedWeight, dtype=torch.int8) -> torch.Tensor:
    """Static combined-lookup weights CW [G*E, N] (entries in [-15, 15])."""
    sign, idx = qw.sign_idx()
    cw = cw_from_codes(sign, idx, qw.plane_scales, qw.k_group)
    return cw.permute(1, 2, 0).reshape(-1, qw.n).to(dtype)


def ref_lut_mpgemm_matmul(a, qw: QuantizedWeight,
                          table_quant: Optional[str] = None,
                          table: Optional[Table] = None):
    """T @ CW single-GEMM formulation (accepts a precomputed table)."""
    t = (table if table is not None
         else precompute_table(a, qw.k_group, table_quant))
    return zero_point_correction(lut_contract(t, qw), qw, t.rowsum)


def lut_contract(t: Table, qw: QuantizedWeight) -> torch.Tensor:
    """T @ CW with the table's epilogue, times the weight scale: the
    lookup without the zero-point correction (the staged kernel's plain
    version)."""
    m = t.values.shape[0]
    if t.scale is None:
        acc = t.values.reshape(m, -1) @ build_cw(qw, torch.float32)
    elif t.scale.shape[1] == 1:  # per_row: exact integer GEMM, then row scale
        acc = (t.values.reshape(m, -1).to(torch.float64)
               @ build_cw(qw, torch.float64)).to(torch.float32)
        acc = acc * t.scale[:, 0, 0][:, None]
    else:  # per_group: dequantize the entries, f32 GEMM
        tv = (t.values.to(torch.float32) * t.scale).reshape(m, -1)
        acc = tv @ build_cw(qw, torch.float32)
    return acc * qw.scale[None, :]
