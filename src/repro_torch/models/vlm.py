"""Llama-3.2-Vision-style VLM backbone: a self-attention decoder with a
gated cross-attention layer every ``xattn_every`` layers.

The port of the reference's ``models/vlm.py``. The vision frontend is a
stub, as in the reference: ``batch["image_embeds"]`` carries precomputed
patch embeddings [B, n_img, d_model]. Their cross-attention K/V is computed
once per image (``compute_image_kv``) and kept in the cache for decode.

Structure: ``n_groups`` groups of (``xattn_every - 1`` self layers, then
one cross layer). The layer stacks are Python lists (``self_groups``: G
lists of ``xattn_every - 1`` layer dicts; ``xattn_layers``: G dicts),
walked in order, the counterpart of the reference's nested ``lax.scan``.

Cache (``init_cache``), the reference's layout: ``{"kv": (k, v)`` [G,
xattn_every - 1, B, S, KV, hd] (batch axis 2), ``"image_kv": (k, v)`` [G,
B, n_img, KV, hd]}. The image K/V has no sequence axis: it is
slot-resident under the block-paged pool, where only ``kv`` is paged.
The serving engine prefills tokens only, as the reference's does, so its
slots attend to a zero image K/V.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import kvcache, layers as L
from repro_torch.models import transformer as TR

Params = Dict[str, Any]


def xattn_layer_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    """A cross layer; its scalar gates start at 0 (the layer adds nothing
    until trained), as the reference's do."""
    return {
        "attn_norm": L.norm_init(cfg.d_model, dtype, device),
        "xattn": L.attention_init(gen, cfg, dtype=dtype, device=device),
        "gate_attn": torch.zeros((), dtype=dtype, device=device),
        "mlp_norm": L.norm_init(cfg.d_model, dtype, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                          device=device),
        "gate_mlp": torch.zeros((), dtype=dtype, device=device),
    }


def _gate(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return torch.tanh(g.to(torch.float32)).to(h.dtype)


def _xattn_apply(p, h, cfg, xkv, quant):
    a, _ = L.attention_apply(
        p["xattn"], L.rms_norm(p["attn_norm"], h, cfg.norm_eps), cfg,
        xattn_kv=xkv, causal=False, use_rope=False, quant=quant)
    h = h + _gate(p["gate_attn"], h) * a
    m = L.mlp_apply(p["mlp"], L.rms_norm(p["mlp_norm"], h, cfg.norm_eps),
                    quant)
    return h + _gate(p["gate_mlp"], h) * m


def compute_image_kv(params: Params, image_embeds: torch.Tensor, cfg):
    """Per-cross-layer image K/V, (k, v) each [G, B, n_img, KV, hd]: one
    ``lut_dense`` of ``wk`` and one of ``wv`` per cross layer."""
    b, n_img, _ = image_embeds.shape
    ks, vs = [], []
    for xp in params["xattn_layers"]:
        for proj, out in (("wk", ks), ("wv", vs)):
            y = L.lut_dense(xp["xattn"][proj], image_embeds, cfg.quant)
            out.append(y.reshape(b, n_img, cfg.n_kv_heads, cfg.head_dim))
    return torch.stack(ks), torch.stack(vs)


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
            caches=None, cache_pos=0, head: bool = True, page_table=None,
            token_valid=None, window=None):
    """(logits [B, S, V] or None, caches, aux), as ``transformer.forward``.
    With ``image_embeds`` in the batch the image K/V is computed (and,
    with caches, written into ``caches["image_kv"]``); without, it is read
    from the caches. ``token_valid`` is ignored (an attention-only stack);
    ``window`` applies to the self layers, never to cross attention."""
    h = TR.embed_apply(params["embed"], batch["tokens"]).to(
        cfg.activation_dtype)
    if "image_embeds" in batch:
        image_kv = compute_image_kv(
            params, batch["image_embeds"].to(cfg.activation_dtype), cfg)
        if caches is not None:
            for leaf, new in zip(caches["image_kv"], image_kv):
                leaf.copy_(new)
    else:
        image_kv = caches["image_kv"]
    for g, (group, xp) in enumerate(zip(params["self_groups"],
                                        params["xattn_layers"])):
        for a, lp in enumerate(group):
            lc = None if caches is None else (caches["kv"][0][g, a],
                                              caches["kv"][1][g, a])
            h, _ = TR.block_apply(lp, h, cfg, cache=lc, cache_pos=cache_pos,
                                  quant=cfg.quant, page_table=page_table,
                                  window=window)
        h = _xattn_apply(xp, h, cfg, (image_kv[0][g].to(h.dtype),
                                      image_kv[1][g].to(h.dtype)), cfg.quant)
    if not head:
        return None, caches, {}
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return TR.head_apply(params["lm_head"], h, cfg.quant), caches, {}


def init_cache(cfg, batch: int, s_cache: int, dtype=torch.bfloat16,
               device=None, *, window=None):
    if kvcache.is_int8(dtype):
        # the reference's VLM unpacks two cache leaves a layer and fails on
        # the int8 cache's four: the port refuses it up front
        raise ValueError(
            f"{cfg.arch_id}: the int8 KV cache is not served on the VLM "
            "family (the reference's VLM forward cannot read its four "
            "leaves); use kv_cache_dtype='bf16'")
    n_groups = cfg.n_layers // cfg.xattn_every
    n_self = cfg.xattn_every - 1
    k, v = kvcache.attn_cache(n_groups * n_self, batch, s_cache,
                              cfg.n_kv_heads, cfg.head_dim, dtype, device,
                              window=window)
    shape = (n_groups, n_self) + tuple(k.shape[1:])
    image = (n_groups, batch, cfg.n_image_tokens, cfg.n_kv_heads,
             cfg.head_dim)
    return {"kv": (k.reshape(shape), v.reshape(shape)),
            "image_kv": (torch.zeros(image, dtype=dtype, device=device),
                         torch.zeros(image, dtype=dtype, device=device))}
