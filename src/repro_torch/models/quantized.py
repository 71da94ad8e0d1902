"""Convert float param trees to packed low-bit serving trees.

Every quantizable projection ``{"w": [in, out]}`` becomes
``{"qw": QuantizedWeight}`` (bias kept), and an MoE layer's stacked expert
weights ``experts: {"gate", "up", "down": [E, in, out]}`` become batched
weights under the reference's names ``gate_qw``, ``up_qw``, ``down_qw``
(``Q.quantize_experts``). The layer stack is a list of per-layer dicts,
walked like any other node. The SSM projections (``in_proj``, ``x_proj``,
``dt_proj`` with its bias, ``out_proj``) pack like the others, and so do
the cross-attention layers' (``xattn/wq`` .. ``wo``) and whisper's
non-gated MLP (``up``, ``down``). Never quantized: the embedding, whisper's
``pos_embed``, norms, the VLM's scalar gates, the MoE router, conv taps,
the SSM's A, D and dt vectors. ``quant["skip"]`` is a path regex of projections that stay
float (zamba2-7b: ``ssm/(in_proj|out_proj)``, its Mamba2 projections). ``plane_sliced_params`` reads a packed tree at fewer
bit-planes (the self-speculative draft). ``quant["store"] == "cw"`` keeps
every weight in the offline-CW store (``Q.to_cw_format``), and
``to_cw_params`` converts a packed tree to it once.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import torch

from repro_torch.core import quantize as Q
from repro_torch.core.mpgemm import FUSION_MODES, MPGEMM_MODES

_QUANTIZABLE = re.compile(
    r"(wq|wk|wv|wo|gate|up|down|in_proj|out_proj|x_proj|dt_proj|lm_head)$")
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
    store = (Q.to_cw_format if quant.get("store") == "cw"
             else lambda qw: qw)

    def walk(node, path):
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        if skip is not None and skip.search(path):
            return node
        if ("w" in node and _QUANTIZABLE.search(path)
                and not _NEVER.search(path) and node["w"].shape[0] % kg == 0):
            out = {"qw": store(Q.quantize(
                node["w"].T, quant.get("weight_bits", 2), k_group=kg,
                scheme=quant.get("scheme", "symmetric")))}
            if "b" in node:
                out["b"] = node["b"]
            return out
        if path.endswith("experts"):  # stacked [E, in, out] -> batched
            out = {}
            for name, w in node.items():
                if w.shape[-2] % kg:
                    out[name] = w
                else:
                    out[name + "_qw"] = store(Q.quantize_experts(
                        w, quant.get("weight_bits", 2), k_group=kg,
                        scheme=quant.get("scheme", "symmetric")))
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
                                params.zero_prime, params.cw)
                    if t is not None)
    elif torch.is_tensor(params):
        yield params


def _map_qw(params, fn):
    """``params`` with every ``QuantizedWeight`` replaced by ``fn(qw)``;
    every other leaf shared as it is."""
    if isinstance(params, dict):
        return {k: _map_qw(v, fn) for k, v in params.items()}
    if isinstance(params, list):
        return [_map_qw(v, fn) for v in params]
    if isinstance(params, Q.QuantizedWeight):
        return fn(params)
    return params


def to_cw_params(params):
    """Every packed ``QuantizedWeight`` of a param tree in the offline-CW
    store (``Q.to_cw_format``, the reference's ``to_cw_params``): lut_xla
    then reads each CW matrix instead of expanding the codes every call,
    for 8× the weight bytes at W2 / K = 4 (G·E int8 entries for K
    weights), with the same bits."""
    return _map_qw(params, Q.to_cw_format)


def has_cw(params) -> bool:
    """Whether any weight of the tree is held only in the CW store."""
    found = []
    _map_qw(params, lambda qw: found.append(qw.is_cw))
    return any(found)


def plane_sliced_params(params, keep_planes: int):
    """Plane-sliced view of a packed param tree (§3.1.2): every
    ``QuantizedWeight`` becomes its top-``keep_planes`` view
    (``QuantizedWeight.plane_slice``), the same buffers read at fewer
    planes, so the tree is a coarser draft model at no extra weight bytes
    (self-speculative decoding's draft). Float leaves (norms, embedding,
    skipped projections) are shared as they are, so draft and target read
    one embedding and one float LM head. A CW-store weight cannot be
    sliced (its matrix bakes every plane in): ValueError, as in the
    reference."""
    def view(qw):
        if qw.is_cw:
            raise ValueError(
                "plane_sliced_params: CW-store weight cannot be "
                "plane-sliced; keep quant['store']='packed' for the "
                "self-speculation draft view")
        return qw.plane_slice(keep_planes)
    return _map_qw(params, view)


def extra_hbm_bytes(view_params, base_params) -> int:
    """Bytes of ``view_params`` whose storage ``base_params`` does not hold
    (by storage identity): 0 when the view is zero-copy."""
    def key(t):
        return t.device, t.untyped_storage().data_ptr()
    base = {key(t) for t in _tensors(base_params)}
    return sum(t.numel() * t.element_size() for t in _tensors(view_params)
               if key(t) not in base)


def quantized_bytes(params) -> int:
    """Total device bytes of a (possibly quantized) param tree."""
    return sum(t.numel() * t.element_size() for t in _tensors(params))
