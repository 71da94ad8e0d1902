"""Lookup-table precompute + symmetrization + table quantization (§3.1).

The half-table of a K-group ``a_0..a_{K-1}`` stores, for each entry
``e ∈ [0, 2^(K-1))``::

    T[e] = Σ_{i<K-1} a_i · (2·bit_i(e) − 1)  −  a_{K-1}

(σ_{K-1} pinned to −1; the other half follows by oddness). Table
quantization converts entries to INT8 with a dynamic scale, per activation
row (``per_row``) or per table (``per_group``).

Every sum here runs over k = 0..K−1 in order, one add at a time. The ±1
products are exact, so this order fixes every rounding, and the CUDA
kernels (``csrc/lut_common.cuh``) repeat it: their INT8 codes equal these
bit for bit. These functions are the plain version of the table-precompute
kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["Table", "sign_basis", "precompute_table", "quantize_table",
           "table_entries", "group_absmax", "dequantize_table",
           "true_divide"]


def true_divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d with an IEEE division on every device. (On CUDA, torch turns a
    division by a Python scalar into a multiplication by its reciprocal,
    which can differ in the last bit from the kernels' true division.) The
    divisor is filled on the device: a host-to-device copy would make the
    host wait for the stream."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


class Table(NamedTuple):
    """values [M, G, E] f32 or int8; scale None | [M,1,1] (per_row) |
    [M,G,1] (per_group); rowsum [M] f32 (zero-point correction)."""

    values: torch.Tensor
    scale: Optional[torch.Tensor]
    rowsum: torch.Tensor
    k_group: int


def sign_basis(k_group: int, device=None) -> torch.Tensor:
    """[K, E] ±1 basis: column e holds (σ_0..σ_{K-1}) with σ_{K-1} = -1.
    Built on ``device`` from arange (no host-to-device copy)."""
    ent = torch.arange(1 << (k_group - 1), device=device)
    rows = [2.0 * ((ent >> i) & 1).to(torch.float32) - 1.0
            for i in range(k_group - 1)]
    rows.append(torch.full_like(ent, -1.0, dtype=torch.float32))
    return torch.stack(rows)


def table_entries(a_groups: torch.Tensor, k_group: int) -> torch.Tensor:
    """[..., G, K] activations -> [..., G, E] half-table entries."""
    af = a_groups.to(torch.float32)
    basis = sign_basis(k_group, af.device)
    t = af[..., 0, None] * basis[0]
    for i in range(1, k_group):
        t = t + af[..., i, None] * basis[i]
    return t


def group_absmax(a_groups: torch.Tensor) -> torch.Tensor:
    """Closed form max_e |T[e]| = Σ_i |a_i| per group -> [..., G]."""
    af = a_groups.to(torch.float32).abs()
    s = af[..., 0]
    for i in range(1, af.shape[-1]):
        s = s + af[..., i]
    return s


def precompute_table(a: torch.Tensor, k_group: int = 4,
                     table_quant: Optional[str] = None) -> Table:
    """The independent precompute operator (DFG-transformed, §3.1.1).

    a: activations [M, K_total]; table_quant: None | 'per_group' | 'per_row'.
    """
    m, k_total = a.shape
    if k_total % k_group:
        raise ValueError(f"K_total={k_total} not divisible by k_group={k_group}")
    g = k_total // k_group
    af = a.to(torch.float32)
    rowsum = af.sum(dim=-1)
    a_groups = af.reshape(m, g, k_group)
    entries = table_entries(a_groups, k_group)
    if table_quant is None:
        return Table(entries, None, rowsum, k_group)
    return quantize_table(entries, rowsum, k_group, table_quant,
                          absmax=group_absmax(a_groups))


def quantize_table(entries: torch.Tensor, rowsum: torch.Tensor, k_group: int,
                   mode: str, absmax: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None) -> Table:
    """INT8 table quantization (§3.1.3): round half to even of
    entries / scale (a true division), clipped to [-127, 127]. A given
    ``scale`` (the kernels' [M, 1, 1] row scale) replaces the one computed
    from ``absmax``."""
    if mode not in ("per_group", "per_row"):
        raise ValueError(f"unknown table_quant mode {mode!r}")
    if scale is None:
        if absmax is None:
            absmax = entries.abs().amax(dim=-1)  # [M, G]
        absmax = (absmax[..., None] if mode == "per_group"
                  else absmax.amax(dim=-1)[:, None, None])
        scale = true_divide(absmax.clamp_min(1e-30), 127.0)
    q = torch.clamp(torch.round(entries / scale), -127, 127).to(torch.int8)
    return Table(q, scale, rowsum, k_group)


def dequantize_table(t: Table) -> torch.Tensor:
    if t.scale is None:
        return t.values
    return t.values.to(torch.float32) * t.scale
