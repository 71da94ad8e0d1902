"""Attention KV caches.

A cache is a tuple (k, v), each [L, B, S_cache, KV, hd], the reference's
layout. The model writes into it in place: layer l of the forward updates
``k[l]`` / ``v[l]`` at the positions it computes.
"""

from __future__ import annotations

import torch

__all__ = ["attn_cache", "cache_len", "slice_batch", "merge_batch"]


def attn_cache(n_layers: int, batch: int, s_cache: int, n_kv: int,
               head_dim: int, dtype=torch.bfloat16, device=None):
    shape = (n_layers, batch, s_cache, n_kv, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def cache_len(cache) -> int:
    """Sequence capacity of an attention cache."""
    return cache[0].shape[2]


def slice_batch(caches, idx: int):
    """Slot ``idx`` as a batch-1 view [L, 1, S, KV, hd] (shares memory)."""
    return tuple(c[:, idx:idx + 1] for c in caches)


def merge_batch(caches, slot_caches, idx: int):
    """Copy a batch-1 cache into slot ``idx`` of the pool, in place."""
    for c, sc in zip(caches, slot_caches):
        c[:, idx:idx + 1].copy_(sc)
    return caches
