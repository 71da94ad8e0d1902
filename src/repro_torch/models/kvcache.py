"""Attention KV caches and SSM state caches.

A dense cache is a tuple (k, v), each [L, B, S_cache, KV, hd], the
reference's layout, or the int8 cache's four leaves (k, v, k_scale,
v_scale): int8 codes and f32 scales [L, B, S_cache, KV, 1]. The model
writes into it in place: layer l of the forward updates ``k[l]`` /
``v[l]`` (and the scales) at the positions it computes. The SSM
families' caches are the reference's trees (dicts and tuples of tensors):
Mamba state ``{"conv": [L, B, d_conv-1, d_inner], "ssm": [L, B, ...]}``
(f32), and zamba2's hybrid ``{"mamba": [G, A, B, ...] leaves, "kv": (k, v)
[G, B, S, KV, hd], "tail": [T, B, ...] leaves}``, also written in place.

The batch axis is not one fixed axis across these layouts, so
``batch_axes`` finds it per leaf from two caches built with batch 1 and
2, and ``seq_axes`` the sequence axis from two built with different
capacities (-1: the leaf holds O(1) state a slot, SSM conv and recurrent
state, or a rolling window cache clamped below both probes, which stays
slot-indexed under the block-paged pool). Probes are
built on ``torch.device("meta")``, the counterpart of the reference's
``jax.eval_shape``: shapes only, no memory.

A block-paged cache has the same leaves shaped [L, num_blocks,
block_size, KV, hd] (the scales' last axis 1; ``attn_cache(L,
num_blocks, block_size, ...)``): a pool of fixed-size blocks shared by
all slots. Slot i's logical sequence is
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

from repro_torch.core.tree import tree_map, tree_map_with_path

__all__ = ["is_int8", "attn_cache", "mamba_cache", "mamba2_cache",
           "layer_cache", "cache_len", "batch_axes", "seq_axes",
           "slice_batch", "merge_batch", "paged_gather", "paged_scatter"]


def is_int8(dtype) -> bool:
    """Whether ``dtype`` asks for the int8 KV cache ("int8" or torch.int8)."""
    return dtype == "int8" or dtype == torch.int8


def attn_cache(n_layers: int, batch: int, s_cache: int, n_kv: int,
               head_dim: int, dtype=torch.bfloat16, device=None, *,
               window=None):
    """(k, v), or with ``dtype`` "int8" (or torch.int8) the reference's
    int8 cache (k, v, k_scale, v_scale): int8 codes and f32 absmax scales
    [L, B, S, KV, 1], one a (position, head), which start at ones as the
    reference's do. Attention dequantizes it a chunk at a time.

    With ``window`` the cache holds S = min(s_cache, window) positions:
    below ``s_cache`` it is a rolling cache, position p in slot p mod
    window (``layers.attention_apply``). An int8 cache does not roll: the
    reference writes it at the position itself, clamped to the last
    window slots past the wrap, so it is refused."""
    s = min(s_cache, window) if window else s_cache
    if is_int8(dtype) and s < s_cache:
        raise ValueError(
            f"an int8 KV cache cannot be a rolling window cache (window "
            f"{window} < s_cache {s_cache}): the reference's int8 branch "
            "writes past the wrap at a clamped offset; use a bf16 cache "
            "or s_cache <= window")
    shape = (n_layers, batch, s, n_kv, head_dim)
    if is_int8(dtype):
        sshape = shape[:-1] + (1,)
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def mamba_cache(n_layers: int, batch: int, d_inner: int, d_state: int,
                d_conv: int, device=None):
    """Mamba1 state, f32 whatever the KV dtype (the reference's layout)."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"conv": z(n_layers, batch, d_conv - 1, d_inner),
            "ssm": z(n_layers, batch, d_inner, d_state)}


def mamba2_cache(n_layers: int, batch: int, n_heads: int, head_dim: int,
                 d_state: int, d_inner: int, d_conv: int, device=None):
    """Mamba2 state, f32: conv [L, B, d_conv-1, d_inner], SSM [L, B, H,
    hd, d_state]."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"conv": z(n_layers, batch, d_conv - 1, d_inner),
            "ssm": z(n_layers, batch, n_heads, head_dim, d_state)}


def layer_cache(cache, index):
    """Layer ``index``'s view of every leaf of an attention cache: (k, v),
    or the int8 cache's four leaves (views, written in place)."""
    return tuple(leaf[index] for leaf in cache)


def cache_len(cache) -> int:
    """Sequence capacity of an attention cache."""
    return cache[0].shape[2]


# ---------------------------------------------------------------------------
# cache trees and per-slot views (continuous-batching engine)
# ---------------------------------------------------------------------------

def _diff_axes(a: torch.Tensor, b: torch.Tensor):
    return [i for i, (p, q) in enumerate(zip(a.shape, b.shape)) if p != q]


def batch_axes(cache_b1, cache_b2):
    """Per-leaf batch axis, from two caches built with batch 1 and 2."""
    def one(path, a, b):
        diffs = _diff_axes(a, b)
        if len(diffs) != 1:
            raise ValueError(
                f"ambiguous batch axis for cache leaf at {path!r}: probe "
                f"shapes {tuple(a.shape)} vs {tuple(b.shape)} differ in "
                f"{len(diffs)} dims (expected exactly 1)")
        return diffs[0]
    return tree_map_with_path(one, cache_b1, cache_b2)


def seq_axes(cache_s1, cache_s2):
    """Per-leaf sequence axis, from two caches built with different
    capacities (same batch); -1 where the shape does not depend on it."""
    def one(path, a, b):
        diffs = _diff_axes(a, b)
        if len(diffs) > 1:
            raise ValueError(
                f"ambiguous sequence axis for cache leaf at {path!r}: probe "
                f"shapes {tuple(a.shape)} vs {tuple(b.shape)} differ in "
                f"{len(diffs)} dims (expected 0 or 1)")
        return diffs[0] if diffs else -1
    return tree_map_with_path(one, cache_s1, cache_s2)


def slice_batch(caches, idx: int, axes=None):
    """Slot ``idx`` as a batch-1 view of every leaf (shares memory);
    ``axes`` the per-leaf batch axes (None: axis 1 of every leaf, the
    layer-stacked layout)."""
    if axes is None:
        return tree_map(lambda c: c.narrow(1, idx, 1), caches)
    return tree_map(lambda c, ax: c.narrow(ax, idx, 1), caches, axes)


def merge_batch(caches, slot_caches, idx: int, axes=None):
    """Copy a batch-1 cache tree into slot ``idx`` of the pool, in place."""
    if axes is None:
        tree_map(lambda c, sc: c.narrow(1, idx, 1).copy_(sc), caches,
                 slot_caches)
    else:
        tree_map(lambda c, sc, ax: c.narrow(ax, idx, 1).copy_(sc),
                 caches, slot_caches, axes)
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
