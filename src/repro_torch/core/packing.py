"""Bit-level packing of folded group codes into dense uint8 streams.

The byte format is the reference's, bit for bit: for each output channel n
the ``k_group``-bit fields ``field(g, b) = sign<<(K-1) | idx`` are laid out
group-major (position ``g*B + b``) and packed little-endian into uint8, so a
channel takes exactly ``ceil(K_total * B / 8)`` bytes. k_group ∈ {1, 2, 4, 8}
keeps fields inside one byte.
"""

from __future__ import annotations

import torch

__all__ = ["pack_group_codes", "unpack_group_codes", "packed_bytes_per_channel"]

_SUPPORTED_K = (1, 2, 4, 8)


def packed_bytes_per_channel(k_total: int, bits: int) -> int:
    return (k_total * bits + 7) // 8


def _check(k_group: int):
    if k_group not in _SUPPORTED_K:
        raise ValueError(
            f"k_group={k_group} not byte-aligned; supported: {_SUPPORTED_K}")


def pack_group_codes(sign: torch.Tensor, idx: torch.Tensor,
                     k_group: int) -> torch.Tensor:
    """Pack (sign, idx) [N, G, B] into uint8 [N, ceil(G*B*k_group/8)]."""
    _check(k_group)
    n, g, b = idx.shape
    field = (sign.to(torch.int32) << (k_group - 1)) | idx.to(torch.int32)
    field = field.reshape(n, g * b)  # group-major: position g*B + b
    fields_per_byte = 8 // k_group
    pad = (-field.shape[1]) % fields_per_byte
    if pad:
        field = torch.nn.functional.pad(field, (0, pad))
    field = field.reshape(n, -1, fields_per_byte)
    shifts = k_group * torch.arange(fields_per_byte, dtype=torch.int32,
                                    device=field.device)
    return (field << shifts).sum(-1).to(torch.uint8)


def unpack_group_codes(packed: torch.Tensor, k_group: int, g: int, bits: int):
    """Inverse of :func:`pack_group_codes` -> (sign, idx) uint8 [N, G, B]."""
    _check(k_group)
    n = packed.shape[0]
    fields_per_byte = 8 // k_group
    mask = (1 << k_group) - 1
    shifts = k_group * torch.arange(fields_per_byte, dtype=torch.int32,
                                    device=packed.device)
    field = (packed[..., None].to(torch.int32) >> shifts) & mask
    field = field.reshape(n, -1)[:, : g * bits].reshape(n, g, bits)
    sign = (field >> (k_group - 1)).to(torch.uint8)
    idx = (field & ((1 << (k_group - 1)) - 1)).to(torch.uint8)
    return sign, idx
