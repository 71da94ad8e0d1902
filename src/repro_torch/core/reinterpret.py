"""Weight reinterpretation (paper §3.1.2, Eq. 1-6).

Unsigned B-bit codes ``q`` map onto the symmetric odd grid
``q' = 2q - (2^B - 1) = Σ_b 2^b σ_b`` with σ_b = ±1, so a B-bit weight is an
exact sum of B ±1 planes sharing one lookup table. Ternary codes
``t ∈ {-1, 0, 1}`` are two ±1 planes of equal scale: ``t = (σ_a + σ_b)/2``.
Eq. 6 folds the MSB-conditional bit negation into the stored codes offline.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "reinterpret_scale_zero",
    "codes_to_sign_planes",
    "ternary_to_sign_planes",
    "plane_scales_for",
    "fold_msb_negation",
    "unfold_group_codes",
]


def reinterpret_scale_zero(scale, zero, bits: int):
    """Eq. 2: adjust (s, z) -> (s', z') for the symmetric odd grid."""
    return scale / 2.0, 2.0 * zero + 1.0 - (1 << bits)


def plane_scales_for(bits: int, ternary: bool = False) -> np.ndarray:
    """Per-plane scales: [1,2,4,...] for the odd grid, [1,1] for ternary."""
    if ternary:
        return np.array([1.0, 1.0], dtype=np.float32)
    return (2.0 ** np.arange(bits)).astype(np.float32)


def codes_to_sign_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned codes [.., K] -> {0,1} sign planes [.., K, B] (bit b = plane b)."""
    shifts = torch.arange(bits, dtype=torch.int32, device=q.device)
    return ((q.to(torch.int32)[..., None] >> shifts) & 1).to(torch.uint8)


def ternary_to_sign_planes(t: torch.Tensor) -> torch.Tensor:
    """Ternary codes [.., K] -> two {0,1} planes [.., K, 2]:
    plane_a = 1 iff t >= 0, plane_b = 1 iff t > 0."""
    return torch.stack([(t >= 0), (t > 0)], dim=-1).to(torch.uint8)


def fold_msb_negation(planes: torch.Tensor, k_group: int):
    """Eq. 6: fold the MSB-conditional negation into the stored codes.

    planes: {0,1} [N, K, B] -> (sign, idx) uint8 [N, G, B] with
    ``dot(a, σ) == (1 - 2*sign) * T[idx]`` for the half-table T built with
    σ_{K-1} = -1.
    """
    n, k, b = planes.shape
    if k % k_group:
        raise ValueError(f"K={k} not divisible by k_group={k_group}")
    g = k // k_group
    grp = planes.reshape(n, g, k_group, b).to(torch.int32)
    msb = grp[:, :, k_group - 1, :]
    if k_group == 1:
        return msb.to(torch.uint8), torch.zeros_like(msb, dtype=torch.uint8)
    mask = (1 << (k_group - 1)) - 1
    weights = (1 << torch.arange(k_group - 1, dtype=torch.int32,
                                 device=planes.device))
    low = (grp[:, :, : k_group - 1, :] * weights[None, None, :, None]).sum(2)
    idx = torch.where(msb.bool(), (~low) & mask, low)
    return msb.to(torch.uint8), idx.to(torch.uint8)


def unfold_group_codes(sign: torch.Tensor, idx: torch.Tensor,
                       k_group: int) -> torch.Tensor:
    """Inverse of :func:`fold_msb_negation` -> {0,1} planes [N, K, B]."""
    n, g, b = idx.shape
    mask = (1 << (k_group - 1)) - 1
    idx32 = idx.to(torch.int32)
    low = torch.where(sign.bool(), (~idx32) & mask, idx32)
    bits = [((low >> i) & 1).to(torch.uint8) for i in range(k_group - 1)]
    bits.append(sign.to(torch.uint8))
    return torch.stack(bits, dim=2).reshape(n, g * k_group, b)
