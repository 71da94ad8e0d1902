"""Convert float param trees to packed low-bit serving trees.

Every quantizable projection ``{"w": [in, out]}`` becomes
``{"qw": QuantizedWeight}`` (bias kept). The layer stack is a list of
per-layer dicts, walked like any other node. Never quantized: the
embedding, norms. ``quant["skip"]`` is a path regex of projections that
stay float.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import torch

from repro_torch.core import quantize as Q
from repro_torch.core.mpgemm import FUSION_MODES, MPGEMM_MODES

_QUANTIZABLE = re.compile(r"(wq|wk|wv|wo|gate|up|down|lm_head)$")
_NEVER = re.compile(r"(router|embed|pos_embed)")


def quantize_params(params: Dict[str, Any], quant: dict) -> Dict[str, Any]:
    """A new tree with projections replaced by packed weights. Validates
    ``mpgemm_mode``/``fusion`` here, before the first forward."""
    mode = quant.get("mpgemm_mode", "lut_xla")
    if mode not in MPGEMM_MODES:
        raise ValueError(f"mpgemm_mode {mode!r} not in {MPGEMM_MODES}")
    fusion = quant.get("fusion", "auto")
    if fusion not in FUSION_MODES:
        raise ValueError(f"fusion {fusion!r} not in {FUSION_MODES}")
    if mode == "fp16":
        return params  # the float reference path keeps float weights
    kg = quant.get("k_group", 4)
    skip = re.compile(quant["skip"]) if quant.get("skip") else None

    def walk(node, path):
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        if skip is not None and skip.search(path):
            return node
        if ("w" in node and _QUANTIZABLE.search(path)
                and not _NEVER.search(path) and node["w"].shape[0] % kg == 0):
            out = {"qw": Q.quantize(node["w"].T, quant.get("weight_bits", 2),
                                    k_group=kg,
                                    scheme=quant.get("scheme", "symmetric"))}
            if "b" in node:
                out["b"] = node["b"]
            return out
        return {k: walk(v, f"{path}/{k}") for k, v in node.items()}

    return walk(params, "")


def _tensors(params):
    """Every tensor of a param tree, packed-weight buffers included."""
    if isinstance(params, dict):
        for v in params.values():
            yield from _tensors(v)
    elif isinstance(params, list):
        for v in params:
            yield from _tensors(v)
    elif isinstance(params, Q.QuantizedWeight):
        yield from (t for t in (params.packed, params.scale,
                                params.zero_prime) if t is not None)
    elif torch.is_tensor(params):
        yield params


def quantized_bytes(params) -> int:
    """Total device bytes of a (possibly quantized) param tree."""
    return sum(t.numel() * t.element_size() for t in _tensors(params))
