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
A stack of experts' weights (``QuantizedWeight.experts``: packed
[E, N, bytes]) takes x [E, C, K] and gives [E, C, N], expert e's rows
against expert e's weights: one batched kernel launch under ``lut_pallas``
(``kernels.ops.lut_mpgemm_experts``), the 2-D path per expert in the other
modes, as the reference vmaps its mpGEMM over the experts.

A weight in the offline-CW store (``QuantizedWeight.cw``, no packed codes)
runs only under ``lut_xla``; the other modes raise a ValueError.

``row_scale`` [M, 1] (per_row tables only): the scale the table is
quantized with, in place of the one computed from x's row. A row-parallel
layer under a mesh (``models.layers.lut_dense``) holds a K-range of each
row and gives the whole row's scale, so its table codes are the
single-device table's codes on that range (``row_scale`` computes a
K-range's own).
"""

from __future__ import annotations

from typing import Optional

import torch

from .quantize import QuantizedWeight, dequantize
from .table import Table, precompute_table

__all__ = ["mpgemm", "precompute_tables", "precompute_expert_tables",
           "resolve_table_quant", "row_scale",
           "MPGEMM_MODES", "FUSION_MODES"]

MPGEMM_MODES = ("fp16", "dequant", "lut_xla", "lut_pallas")
FUSION_MODES = ("auto", "fused", "staged", "tuned")


def cw_refusal(mode: str) -> str:
    """Why ``mode`` cannot run an offline-CW weight."""
    return (f"mpgemm_mode {mode!r} cannot run offline-CW weights (the "
            "store has no packed codes; only lut_xla reads it): serve "
            "them under lut_xla, or convert the packed tree with "
            "quant['store']='packed'")


def resolve_table_quant(table_quant: Optional[str],
                        device: torch.device) -> Optional[str]:
    """Map ``"auto"`` to a concrete mode: INT8 ``per_row`` tables on CUDA,
    where the int8 datapath is native, float tables on the CPU, where
    quantizing costs extra ops and accuracy. Other values pass through."""
    if table_quant == "auto":
        return "per_row" if torch.device(device).type == "cuda" else None
    return table_quant


def row_scale(x: torch.Tensor, k_group: int = 4,
              mode: str = "lut_xla") -> torch.Tensor:
    """[M, 1] per_row table scale of x's rows (x [..., K] flattened to
    rows): the row-scale kernel under ``lut_pallas``, its plain version
    otherwise (``core.table.group_absmax``: max over groups of Σ|x|,
    clamped at 1e-30, over 127)."""
    from repro_torch.kernels import table_precompute as tp_kernel
    x2d = x.reshape(-1, x.shape[-1]).to(torch.float32)
    if mode == "lut_pallas":
        return tp_kernel.row_scale(x2d.contiguous(), k_group)
    return tp_kernel.row_scale_plain(x2d, k_group)


def precompute_tables(x: torch.Tensor, k_group: int = 4,
                      table_quant: Optional[str] = "per_row",
                      mode: str = "lut_xla",
                      row_scale: Optional[torch.Tensor] = None) -> Table:
    """Independent table-precompute operator, shared by every consumer of x:
    plain torch ops, or the precompute kernel under ``lut_pallas``. A given
    ``row_scale`` [M, 1] quantizes a per_row table (module docstring)."""
    table_quant = resolve_table_quant(table_quant, x.device)
    x2d = x.reshape(-1, x.shape[-1])
    if table_quant != "per_row":
        row_scale = None
    if mode == "lut_pallas":
        from repro_torch.kernels import ops
        if row_scale is None:
            return ops.table_precompute(x2d, k_group, table_quant)
        return ops.table_precompute(x2d, k_group, table_quant,
                                    row_scale=row_scale)
    if row_scale is not None:
        from repro_torch.core.table import quantize_table
        t = precompute_table(x2d, k_group)
        return quantize_table(t.values, t.rowsum, k_group, "per_row",
                              scale=row_scale.to(torch.float32).reshape(
                                  -1, 1, 1))
    return precompute_table(x2d, k_group, table_quant)


def precompute_expert_tables(x: torch.Tensor, k_group: int = 4,
                             table_quant: Optional[str] = "per_row",
                             mode: str = "lut_xla") -> Table:
    """``precompute_tables`` for the consumers of an expert buffer x
    [E, C, K]: one table over the experts' rows, expert e's the e-th of E
    equal row blocks. Under ``lut_pallas`` the form the batched kernel
    takes (``kernels.ops.expert_table``: each block padded to the tile's
    rows, one launch), else the E·C rows as they are."""
    if mode == "lut_pallas":
        from repro_torch.kernels import ops
        return ops.expert_table(
            x, k_group, resolve_table_quant(table_quant, x.device))
    return precompute_tables(x, k_group, table_quant, mode)


def _expert_slice(table: Optional[Table], e: int, experts: int,
                  c: int) -> Optional[Table]:
    """Expert e's C rows of a table over ``experts`` equal row blocks."""
    if table is None:
        return None
    start = e * (table.values.shape[0] // experts)
    pick = lambda t: t[start:start + c]
    return Table(pick(table.values), None if table.scale is None
                 else pick(table.scale), pick(table.rowsum), table.k_group)


def mpgemm(x: torch.Tensor, qw: QuantizedWeight, *, mode: str = "lut_xla",
           table_quant: Optional[str] = "per_row",
           table: Optional[Table] = None, fusion: str = "auto",
           out_dtype=None,
           row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[..., n] = Σ_k x[..., k] · W[n, k] with W stored low-bit packed.

    ``table=`` supplies a precomputed shared table (implies staged);
    ``row_scale`` [M, 1] the per_row table's scale (module docstring),
    read by the LUT modes where they build the table.
    """
    if mode not in MPGEMM_MODES:
        raise ValueError(f"mode {mode!r} not in {MPGEMM_MODES}")
    table_quant = resolve_table_quant(table_quant, x.device)
    if x.shape[-1] != qw.k_total:
        raise ValueError(f"contract dim {x.shape[-1]} != k_total {qw.k_total}")
    if qw.is_cw and mode != "lut_xla":
        raise ValueError(cw_refusal(mode))
    out_dtype = out_dtype or x.dtype
    if qw.experts is not None:
        if x.dim() != 3 or x.shape[0] != qw.experts:
            raise ValueError(f"a stack of {qw.experts} experts' weights takes "
                             f"x [E, C, K], got {tuple(x.shape)}")
        if mode == "lut_pallas":
            from repro_torch.kernels import ops
            out = ops.lut_mpgemm_experts(x, qw, table_quant=table_quant,
                                         table=table, fusion=fusion)
            return out.to(out_dtype)
        return torch.stack([mpgemm(
            x[e], qw.expert(e), mode=mode, table_quant=table_quant,
            table=_expert_slice(table, e, qw.experts, x.shape[1]),
            fusion=fusion,
            out_dtype=out_dtype) for e in range(qw.experts)])
    lead = x.shape[:-1]
    x2d = x.reshape(-1, qw.k_total)
    if table_quant != "per_row":
        row_scale = None

    if mode == "fp16":
        w = dequantize(qw).to(x.dtype)
        out = x2d.to(torch.float32) @ w.to(torch.float32).T
    elif mode == "dequant":
        w = dequantize(qw).to(torch.bfloat16)
        out = (x2d.to(torch.bfloat16).to(torch.float32)
               @ w.to(torch.float32).T)
    elif mode == "lut_xla":
        from repro_torch.kernels import ref
        if table is None and row_scale is not None:
            table = precompute_tables(x2d, qw.k_group, table_quant, mode,
                                      row_scale)
        out = ref.ref_lut_mpgemm_matmul(x2d, qw, table_quant=table_quant,
                                        table=table)
    else:  # lut_pallas
        from repro_torch.kernels import ops
        out = ops.lut_mpgemm(x2d, qw, table_quant=table_quant, table=table,
                             fusion=fusion, row_scale=row_scale)
    return out.reshape(*lead, qw.n).to(out_dtype)
