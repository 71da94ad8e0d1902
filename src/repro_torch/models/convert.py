"""Load the reference package's params into the port.

``from_jax_params`` takes the reference's param tree with every leaf
already turned into a numpy array (``jax.tree.map(np.asarray, params)``):
dicts of arrays, layer stacks whose leaves carry a leading [L] axis, and
packed weights as any object with the reference ``QuantizedWeight``
attributes (leading [L], or [L, E] for a stack of experts). It imports
neither JAX nor the reference package: the packed byte format is shared,
so the buffers load unchanged.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.quantize import QuantizedWeight
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


def _qw(node, device, index=None) -> QuantizedWeight:
    if getattr(node, "cw", None) is not None and node.packed is None:
        raise ValueError("CW-store weights cannot be loaded: convert the "
                         "packed tree (before the CPU engine's CW expansion)")
    pick = (lambda a: a) if index is None else (
        lambda a: None if a is None else a[index])
    return QuantizedWeight(
        _tensor(pick(node.packed), device), _tensor(pick(node.scale), device),
        _tensor(pick(node.zero_prime), device), node.plane_scales,
        bits=node.bits, k_group=node.k_group, k_total=node.k_total, n=node.n,
        plane_start=getattr(node, "plane_start", 0),
        stored_planes=getattr(node, "stored_planes", None))


def _convert(node, device, index=None) -> Any:
    if _is_qw(node):
        return _qw(node, device, index)
    if isinstance(node, dict):
        return {k: _convert(v, device, index) for k, v in node.items()}
    if node is None:
        return None
    return _tensor(node if index is None else node[index], device)


def from_jax_params(np_tree, cfg, device="cuda"):
    """Reference param tree (numpy leaves) -> the port's param tree on
    ``device`` (the card unless the caller asks for the CPU): each stacked
    layer stack becomes a list of layer dicts. The MoE family has two:
    ``dense_layers`` ([first_dense_layers, ...]) and ``layers`` (the MoE
    layers); a batched expert weight keeps its [E, ...] after the layer
    index."""
    device = resolve_device(device)
    counts = {"layers": cfg.n_layers - cfg.first_dense_layers,
              "dense_layers": cfg.first_dense_layers}
    return {k: ([_convert(v, device, index=i) for i in range(counts[k])]
                if k in counts else _convert(v, device))
            for k, v in np_tree.items()}
