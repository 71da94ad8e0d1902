"""Int8 gradient compression with error feedback.

Quantizing gradients to INT8 (blockwise absmax over blocks of 1024 — the
same primitive as the paper's table quantization) cuts the data-parallel
all-reduce's traffic 4× against f32. The quantization error is carried in
an error-feedback buffer and re-added the next step (EF-SGD style), which
keeps convergence. The port has no data-parallel mesh yet: the train step
applies the compress/decompress round trip to its local gradient, as the
reference's does before the all-reduce consumes it.
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
def compress_decompress_tree(grads, ef: Optional = None) -> Tuple:
    """Returns (compressed grads, new error-feedback tree): each tensor's
    g + e through the int8 round trip, and the residual g + e − that; a
    tensor under 1024 elements passes uncompressed with a zero residual.

    A tensor is what the reference holds as one array: a layer stack (a
    list of layer dicts, or of lists for a nested stack) is stacked there
    along a leading axis, so the leaves at one path across the stack are
    taken together, concatenated in stack order (the stacked array's
    row-major order). Blocks, the size rule and the results are then the
    reference's, also where one layer's leaf is under 1024 elements or
    not a multiple of it."""
    if ef is None:
        ef = init_error_feedback(grads)
    named, efs = tree_paths(grads), tree_leaves(ef)
    groups = {}
    for i, (path, _) in enumerate(named):
        groups.setdefault(re.sub(r"\[\d+\]", "[*]", path), []).append(i)
    out_g, out_e = [None] * len(named), [None] * len(named)
    for idx in groups.values():
        g = torch.cat([named[i][1].reshape(-1).to(torch.float32)
                       for i in idx])
        gf = g + torch.cat([efs[i].reshape(-1) for i in idx])
        if g.numel() < _BLOCK:  # tiny tensors not worth compressing
            deq, res = gf, torch.zeros_like(gf)
        else:
            deq = _quantize_int8(gf)
            res = gf - deq
        sizes = [named[i][1].numel() for i in idx]
        for i, d, r in zip(idx, deq.split(sizes), res.split(sizes)):
            out_g[i] = d.reshape(named[i][1].shape)
            out_e[i] = r.reshape(named[i][1].shape)
    return tree_unflatten(grads, out_g), tree_unflatten(grads, out_e)
