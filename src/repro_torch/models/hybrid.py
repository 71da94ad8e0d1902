"""Zamba2-style hybrid: a Mamba2 backbone and one shared attention block.

The port of the reference's ``models/hybrid.py``. Structure: ``n_groups``
groups of (``attn_every`` Mamba2 layers, then the shared attention + MLP
block), then a tail of the leftover Mamba2 layers. The shared block has one
set of weights, reused at every invocation; each invocation owns its own
KV cache. The layer stacks are Python lists of per-layer dicts (``groups``:
G lists of A layers; ``tail``: T layers), walked in order, the counterpart
of the reference's nested ``lax.scan``.

Cache (``init_cache``), the reference's layout: ``{"mamba": {"conv",
"ssm"}`` leaves [G, A, B, ...] (batch axis 2), ``"kv": (k, v)`` [G, B, S,
KV, hd], ``"tail"`` leaves [T, B, ...] (batch axis 1)}. Under the
block-paged pool only ``kv`` is paged ([G, num_blocks, block_size, KV,
hd]); the Mamba state stays slot-indexed.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import kvcache, layers as L, ssm
from repro_torch.models import transformer as TR

Params = Dict[str, Any]


def shared_block_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    return {
        "attn_norm": L.norm_init(cfg.d_model, dtype, device),
        "shared_attn": L.attention_init(gen, cfg, dtype=dtype, device=device),
        "mlp_norm": L.norm_init(cfg.d_model, dtype, device),
        "shared_mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                                 device=device),
    }


def mamba_layer_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    return {"norm": L.norm_init(cfg.d_model, dtype, device),
            "ssm": ssm.mamba2_init(gen, cfg, dtype, device)}


def _mamba_layer_apply(p, h, cfg, cache, token_valid):
    y, _ = ssm.mamba2_apply(p["ssm"], L.rms_norm(p["norm"], h, cfg.norm_eps),
                            cfg, cache=cache, quant=cfg.quant,
                            token_valid=token_valid)
    return h + y


def _shared_apply(p, h, cfg, kv, cache_pos, page_table, window=None):
    a, _ = L.attention_apply(
        p["shared_attn"], L.rms_norm(p["attn_norm"], h, cfg.norm_eps), cfg,
        kv_cache=kv, cache_pos=cache_pos, quant=cfg.quant,
        page_table=page_table, window=window)
    h = h + a
    m = L.mlp_apply(p["shared_mlp"], L.rms_norm(p["mlp_norm"], h,
                                                cfg.norm_eps), cfg.quant)
    return h + m


def _layer_cache(tree, *index):
    """One Mamba layer's view {"conv", "ssm"} of a stacked state tree."""
    return {k: v[index] for k, v in tree.items()}


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
            caches=None, cache_pos=0, head: bool = True, page_table=None,
            token_valid=None, window=None):
    """(logits [B, S, V] or None, caches, aux), as ``transformer.forward``.
    ``token_valid`` [B] (real-token counts of a right-padded prefill chunk)
    is read by the Mamba2 layers; the shared attention needs no mask (a
    padded position writes K/V past the prompt, which decode overwrites
    before any query reads it). ``window``: sliding-window attention in
    the shared block (``long_500k``'s 8192; a rolling ``kv`` cache from
    ``init_cache(..., window=)``)."""
    h = TR.embed_apply(params["embed"], batch["tokens"]).to(
        cfg.activation_dtype)
    for g, group in enumerate(params["groups"]):
        for a, lp in enumerate(group):
            lc = None if caches is None else _layer_cache(caches["mamba"], g, a)
            h = _mamba_layer_apply(lp, h, cfg, lc, token_valid)
        kv = None if caches is None else kvcache.layer_cache(caches["kv"], g)
        h = _shared_apply(params["shared"], h, cfg, kv, cache_pos, page_table,
                          window)
    for t, lp in enumerate(params.get("tail", [])):
        lc = None if caches is None else _layer_cache(caches["tail"], t)
        h = _mamba_layer_apply(lp, h, cfg, lc, token_valid)
    if not head:
        return None, caches, {}
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return TR.head_apply(params["lm_head"], h, cfg.quant), caches, {}


def init_cache(cfg, batch: int, s_cache: int, dtype=torch.bfloat16,
               device=None, *, window=None):
    n_groups, tail = divmod(cfg.n_layers, cfg.attn_every)
    hd = cfg.d_inner // cfg.ssm_heads
    m = kvcache.mamba2_cache(n_groups * cfg.attn_every, batch, cfg.ssm_heads,
                             hd, cfg.ssm_state, cfg.d_inner, cfg.d_conv,
                             device)
    caches = {
        "mamba": {k: v.reshape((n_groups, cfg.attn_every) + v.shape[1:])
                  for k, v in m.items()},
        "kv": kvcache.attn_cache(n_groups, batch, s_cache, cfg.n_kv_heads,
                                 cfg.head_dim, dtype, device, window=window),
    }
    if tail:
        caches["tail"] = kvcache.mamba2_cache(
            tail, batch, cfg.ssm_heads, hd, cfg.ssm_state, cfg.d_inner,
            cfg.d_conv, device)
    return caches
