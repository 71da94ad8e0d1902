"""Attention KV caches.

A dense cache is a tuple (k, v), each [L, B, S_cache, KV, hd], the
reference's layout. The model writes into it in place: layer l of the
forward updates ``k[l]`` / ``v[l]`` at the positions it computes.

A block-paged cache has the same two leaves shaped [L, num_blocks,
block_size, KV, hd] (``attn_cache(L, num_blocks, block_size, ...)``): a
pool of fixed-size blocks shared by all slots. Slot i's logical sequence is
the concatenation of the blocks its page-table row names, so logical
position p lives at ``pool[table[i, p // bs], p % bs]``. Block 0 is the
null block: idle and retired slots point every entry at it, so their
masked-out writes land somewhere harmless. Reads mask by valid length and
masked scores get exactly zero weight, so whatever lies beyond a slot's
valid length contributes exactly 0.0 and the paged path equals the dense
one bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["attn_cache", "cache_len", "slice_batch", "merge_batch",
           "paged_gather", "paged_scatter"]


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


def paged_gather(leaf: torch.Tensor, page_table: torch.Tensor):
    """[N, bs, ...] pool leaf + [B, nb] page table -> [B, nb*bs, ...]
    contiguous logical view (block j of a slot lands at offset j*bs)."""
    g = leaf[page_table]
    b, nb, bs = g.shape[:3]
    return g.reshape((b, nb * bs) + tuple(g.shape[3:]))


def paged_scatter(leaf: torch.Tensor, vals: torch.Tensor,
                  page_table: torch.Tensor, positions: torch.Tensor):
    """Write ``vals`` [B, S, ...] at logical ``positions`` [B, S] of each
    slot's paged sequence into the [N, bs, ...] pool ``leaf``, in place
    (the reference returns an updated copy; the port writes the pool it
    holds). Positions at or past the table's reach (nb*bs) go to the null
    block, never clamped onto a real block: a right-padded prefill tail can
    run past the slot's blocks."""
    bs, nb = leaf.shape[1], page_table.shape[1]
    blk = positions // bs
    phys = torch.gather(page_table, 1, blk.clamp(max=nb - 1))
    phys = torch.where(blk < nb, phys, torch.zeros_like(phys))
    leaf[phys, positions % bs] = vals.to(leaf.dtype)
    return leaf
