"""Public mpGEMM API: high-precision activations × packed low-bit weights.

Modes (the reference's names):

  * ``"fp16"``       — dense GEMM on dequantized weights (x's dtype);
  * ``"dequant"``    — unpack→upcast to bf16→GEMM (the paper's baseline);
  * ``"lut_xla"``    — LUT in plain torch ops: table precompute + one
                       ``T @ CW`` GEMM (``kernels.ref``), also the oracle;
  * ``"lut_pallas"`` — the hand-written CUDA kernels (``kernels.ops``);
                       ``fusion`` picks fused precompute→lookup or the
                       staged pair ("tuned": the measured plan of the
                       active tuning cache, ``core.autotune``). On a CPU
                       tensor each kernel wrapper runs its plain version.

``mpgemm`` takes any leading batch dims; the contraction is the last axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from .quantize import QuantizedWeight, dequantize
from .table import Table, precompute_table

__all__ = ["mpgemm", "precompute_tables", "resolve_table_quant",
           "MPGEMM_MODES", "FUSION_MODES"]

MPGEMM_MODES = ("fp16", "dequant", "lut_xla", "lut_pallas")
FUSION_MODES = ("auto", "fused", "staged", "tuned")


def resolve_table_quant(table_quant: Optional[str],
                        device: torch.device) -> Optional[str]:
    """Map ``"auto"`` to a concrete mode: INT8 ``per_row`` tables on CUDA,
    where the int8 datapath is native, float tables on the CPU, where
    quantizing costs extra ops and accuracy. Other values pass through."""
    if table_quant == "auto":
        return "per_row" if torch.device(device).type == "cuda" else None
    return table_quant


def precompute_tables(x: torch.Tensor, k_group: int = 4,
                      table_quant: Optional[str] = "per_row",
                      mode: str = "lut_xla") -> Table:
    """Independent table-precompute operator, shared by every consumer of x:
    plain torch ops, or the precompute kernel under ``lut_pallas``."""
    table_quant = resolve_table_quant(table_quant, x.device)
    x2d = x.reshape(-1, x.shape[-1])
    if mode == "lut_pallas":
        from repro_torch.kernels import ops
        return ops.table_precompute(x2d, k_group, table_quant)
    return precompute_table(x2d, k_group, table_quant)


def mpgemm(x: torch.Tensor, qw: QuantizedWeight, *, mode: str = "lut_xla",
           table_quant: Optional[str] = "per_row",
           table: Optional[Table] = None, fusion: str = "auto",
           out_dtype=None) -> torch.Tensor:
    """y[..., n] = Σ_k x[..., k] · W[n, k] with W stored low-bit packed.

    ``table=`` supplies a precomputed shared table (implies staged).
    """
    if mode not in MPGEMM_MODES:
        raise ValueError(f"mode {mode!r} not in {MPGEMM_MODES}")
    table_quant = resolve_table_quant(table_quant, x.device)
    if x.shape[-1] != qw.k_total:
        raise ValueError(f"contract dim {x.shape[-1]} != k_total {qw.k_total}")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2d = x.reshape(-1, qw.k_total)

    if mode == "fp16":
        w = dequantize(qw).to(x.dtype)
        out = x2d.to(torch.float32) @ w.to(torch.float32).T
    elif mode == "dequant":
        w = dequantize(qw).to(torch.bfloat16)
        out = (x2d.to(torch.bfloat16).to(torch.float32)
               @ w.to(torch.float32).T)
    elif mode == "lut_xla":
        from repro_torch.kernels import ref
        out = ref.ref_lut_mpgemm_matmul(x2d, qw, table_quant=table_quant,
                                        table=table)
    else:  # lut_pallas
        from repro_torch.kernels import ops
        out = ops.lut_mpgemm(x2d, qw, table_quant=table_quant, table=table,
                             fusion=fusion)
    return out.reshape(*lead, qw.n).to(out_dtype)
