"""Load the reference package's params into the port.

``from_jax_params`` takes the reference's param tree with every leaf
already turned into a numpy array (``jax.tree.map(np.asarray, params)``):
dicts of arrays, a layer stack whose leaves carry a leading [L] axis, and
packed weights as any object with the reference ``QuantizedWeight``
attributes. It imports neither JAX nor the reference package: the packed
byte format is shared, so the buffers load unchanged.
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
    return torch.from_numpy(np.array(a, copy=True)).to(device)


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
    ``device`` (the card unless the caller asks for the CPU): the stacked
    [L, ...] layers become a list of L layer dicts."""
    device = resolve_device(device)
    layers = [_convert(np_tree["layers"], device, index=i)
              for i in range(cfg.n_layers)]
    out = {k: _convert(v, device) for k, v in np_tree.items() if k != "layers"}
    out["layers"] = layers
    return out
