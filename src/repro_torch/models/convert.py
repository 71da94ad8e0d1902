"""Load the reference package's params into the port.

``from_jax_params`` takes the reference's param tree with every leaf
already turned into a numpy array (``jax.tree.map(np.asarray, params)``):
dicts of arrays, layer stacks whose leaves carry a leading [L] axis (the
hybrid's ``groups`` [G, A]), and packed weights as any object with the
reference ``QuantizedWeight`` attributes (leading [L], or [L, E] for a
stack of experts; the hybrid's ``groups`` and the VLM's ``self_groups``
carry [G, A]). It imports
neither JAX nor the reference package: the packed byte format is shared,
so the buffers load unchanged. A weight in the offline-CW store (``packed``
None, ``cw`` int8 [.., G·E, N], e.g. a tree the reference's CPU engine
expanded) loads as a CW weight, its ``cw`` indexed per layer and expert as
``packed`` is.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.quantize import QuantizedWeight, cw_layout
from repro_torch.models.api import resolve_device

_QW_FIELDS = ("packed", "scale", "plane_scales", "bits", "k_group",
              "k_total", "n")


def _is_qw(node) -> bool:
    return all(hasattr(node, f) for f in _QW_FIELDS)


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch has no numpy
        # bridge for it, so its bits travel as int16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _qw(node, device, index: Optional[tuple] = None) -> QuantizedWeight:
    pick = (lambda a: a) if index is None else (
        lambda a: None if a is None else a[index])
    return QuantizedWeight(
        _tensor(pick(node.packed), device), _tensor(pick(node.scale), device),
        _tensor(pick(node.zero_prime), device), node.plane_scales,
        bits=node.bits, k_group=node.k_group, k_total=node.k_total, n=node.n,
        plane_start=getattr(node, "plane_start", 0),
        stored_planes=getattr(node, "stored_planes", None),
        cw=_cw(_tensor(pick(getattr(node, "cw", None)), device)))


def _cw(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else cw_layout(t)


def _convert(node, device, index: Optional[tuple] = None) -> Any:
    if _is_qw(node):
        return _qw(node, device, index)
    if isinstance(node, dict):
        return {k: _convert(v, device, index) for k, v in node.items()}
    if node is None:
        return None
    return _tensor(node if index is None else node[index], device)


def _stacks(cfg) -> dict:
    """{key: the stacked dims} of the layer stacks of the family's tree."""
    if cfg.family == "hybrid":
        n_groups, tail = divmod(cfg.n_layers, cfg.attn_every)
        return {"groups": (n_groups, cfg.attn_every), "tail": (tail,)}
    if cfg.family == "vlm":
        n_groups = cfg.n_layers // cfg.xattn_every
        return {"self_groups": (n_groups, cfg.xattn_every - 1),
                "xattn_layers": (n_groups,)}
    if cfg.family == "audio":
        return {"enc_layers": (cfg.enc_layers,),
                "dec_layers": (cfg.n_layers,)}
    return {"layers": (cfg.n_layers - cfg.first_dense_layers,),
            "dense_layers": (cfg.first_dense_layers,)}


def _unstack(node, device, dims, prefix=()):
    """A stack with leading ``dims`` -> nested lists of layer dicts."""
    if len(dims) == 1:
        return [_convert(node, device, prefix + (i,)) for i in range(dims[0])]
    return [_unstack(node, device, dims[1:], prefix + (i,))
            for i in range(dims[0])]


def from_jax_params(np_tree, cfg, device="cuda", *, plan=None):
    """Reference param tree (numpy leaves) -> the port's param tree on
    ``device`` (the card unless the caller asks for the CPU): each stacked
    layer stack becomes a list of layer dicts. The MoE family has two:
    ``dense_layers`` ([first_dense_layers, ...]) and ``layers`` (the MoE
    layers); a batched expert weight keeps its [E, ...] after the layer
    index. The hybrid's ``groups`` [G, A, ...] become G lists of A layer
    dicts, its ``tail`` [T, ...] a list; its ``shared`` block is one dict.
    The VLM's ``self_groups`` [G, xattn_every - 1, ...] become G lists, its
    ``xattn_layers`` [G, ...] a list (each cross layer's scalar gates 0-dim
    tensors); whisper's ``enc_layers`` and ``dec_layers`` lists.

    With ``plan`` (a data x model mesh) the tree is converted on the CPU
    and only this rank's blocks (``distributed.sharding.shard_params``:
    its model coordinate's, every leaf whole over the data axis) go to
    ``device``, so no rank's device holds the whole tree: one set of
    reference weights carried into every rank."""
    device = resolve_device(device)
    stacks = _stacks(cfg)
    at = torch.device("cpu") if plan is not None else device
    tree = {k: (_unstack(v, at, stacks[k]) if k in stacks
                else _convert(v, at))
            for k, v in np_tree.items()}
    if plan is None:
        return tree
    from repro_torch.distributed.sharding import shard_params, tree_to
    return tree_to(shard_params(tree, plan, cfg), device)
