"""Int8 gradient compression with error feedback.

Quantizing gradients to INT8 (blockwise absmax over blocks of 1024 — the
same primitive as the paper's table quantization) cuts the data-parallel
all-reduce's traffic 4× against f32. The quantization error is carried in
an error-feedback buffer and re-added the next step (EF-SGD style), which
keeps convergence. The train step applies the compress/decompress round
trip to the gradient summed over the data ranks, as the reference's step
does to its (pjit-summed) gradient. Under a mesh each rank holds blocks
of each gradient and of ``ef`` (sharded as the params): every group is
compressed whole on every rank (its blocks gathered, ``whole``) and each
rank keeps its blocks of the result (``local``), so a rank's compressed
gradient and residual are, bit for bit, its blocks of the whole
compression, also where a 1024-block crosses a shard boundary.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch

from repro_torch.core.table import true_divide
from repro_torch.core.tree import (tree_leaves, tree_map, tree_paths,
                                  tree_unflatten)

_BLOCK = 1024


def _quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """x -> its blockwise int8 round trip, dequantized, x's shape, f32."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blk = flat.reshape(-1, _BLOCK)
    s = true_divide(blk.abs().amax(dim=1, keepdim=True).clamp_min(1e-12),
                    127.0)
    q = torch.clamp(torch.round(blk / s), -127, 127)
    return (q * s).reshape(-1)[:x.numel()].reshape(x.shape)


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_decompress_tree(grads, ef: Optional = None, *, whole=None,
                             local=None) -> Tuple:
    """Returns (compressed grads, new error-feedback tree): each tensor's
    g + e through the int8 round trip, and the residual g + e − that; a
    tensor under 1024 elements passes uncompressed with a zero residual.

    A tensor is what the reference holds as one array: a layer stack (a
    list of layer dicts, or of lists for a nested stack) is stacked there
    along a leading axis, so the leaves at one path across the stack are
    taken together, concatenated in stack order (the stacked array's
    row-major order). Blocks, the size rule and the results are then the
    reference's, also where one layer's leaf is under 1024 elements or
    not a multiple of it.

    Under a mesh, ``whole(i, t)`` gives leaf i's whole tensor from this
    rank's block ``t`` (a collective: every rank calls it for every leaf
    in order) and ``local(i, t)`` this rank's block of a whole one; a
    group is compressed whole and each leaf's block kept."""
    if ef is None:
        ef = init_error_feedback(grads)
    named, efs = tree_paths(grads), tree_leaves(ef)
    groups = {}
    for i, (path, _) in enumerate(named):
        groups.setdefault(re.sub(r"\[\d+\]", "[*]", path), []).append(i)
    out_g, out_e = [None] * len(named), [None] * len(named)
    for idx in groups.values():
        gs, es = [named[i][1] for i in idx], [efs[i] for i in idx]
        if whole is not None:
            gs = [whole(i, t) for i, t in zip(idx, gs)]
            es = [whole(i, t) for i, t in zip(idx, es)]
        g = torch.cat([t.reshape(-1).to(torch.float32) for t in gs])
        gf = g + torch.cat([e.reshape(-1) for e in es])
        if g.numel() < _BLOCK:  # tiny tensors not worth compressing
            deq, res = gf, torch.zeros_like(gf)
        else:
            deq = _quantize_int8(gf)
            res = gf - deq
        sizes = [t.numel() for t in gs]
        keep = (lambda i, t: t) if local is None else local
        for i, t, d, r in zip(idx, gs, deq.split(sizes), res.split(sizes)):
            out_g[i] = keep(i, d.reshape(t.shape))
            out_e[i] = keep(i, r.reshape(t.shape))
    return tree_unflatten(grads, out_g), tree_unflatten(grads, out_e)
