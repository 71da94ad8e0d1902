"""Decoder-only dense transformer (llama family).

embedding → L × block (a Python loop over the per-layer param dicts, the
counterpart of the reference's ``lax.scan`` over stacked layers) → final
norm → LM head.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import kvcache, layers as L

Params = Dict[str, Any]


def embed_init(gen, vocab: int, d_model: int, dtype=torch.float32,
               device=None) -> Params:
    t = torch.randn(vocab, d_model, generator=gen, device=device,
                    dtype=torch.float32) * 0.02
    return {"table": t.to(dtype)}


def embed_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def head_apply(p: Params, h: torch.Tensor, quant=None) -> torch.Tensor:
    return L.lut_dense(p, h, quant)


def block_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    return {
        "attn_norm": L.norm_init(cfg.d_model, dtype, device),
        "attn": L.attention_init(gen, cfg, dtype=dtype, device=device),
        "mlp_norm": L.norm_init(cfg.d_model, dtype, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                          device=device),
    }


def block_apply(p: Params, h: torch.Tensor, cfg, *, cache=None, cache_pos=0,
                quant=None):
    a, cache = L.attention_apply(
        p["attn"], L.rms_norm(p["attn_norm"], h, cfg.norm_eps), cfg,
        kv_cache=cache, cache_pos=cache_pos, quant=quant)
    h = h + a
    m = L.mlp_apply(p["mlp"], L.rms_norm(p["mlp_norm"], h, cfg.norm_eps),
                    quant)
    return h + m, cache


def stack_apply(layers, h: torch.Tensor, cfg, *, caches=None, cache_pos=0,
                quant=None):
    """The layer loop; layer l reads and writes ``caches[*][l]`` in place."""
    for i, lp in enumerate(layers):
        lc = None if caches is None else (caches[0][i], caches[1][i])
        h, _ = block_apply(lp, h, cfg, cache=lc, cache_pos=cache_pos,
                           quant=quant)
    return h, caches


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
            caches=None, cache_pos=0, head: bool = True):
    """(logits [B, S, V] or None, caches, aux). ``head=False`` stops before
    the final norm and LM head, for callers that need only the caches
    (prefill), where the reference's compiler drops the head as dead code."""
    h = embed_apply(params["embed"], batch["tokens"]).to(cfg.activation_dtype)
    h, caches = stack_apply(params["layers"], h, cfg, caches=caches,
                            cache_pos=cache_pos, quant=cfg.quant)
    if not head:
        return None, caches, {}
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return head_apply(params["lm_head"], h, cfg.quant), caches, {}


def init_cache(cfg, batch: int, s_cache: int, dtype=torch.bfloat16,
               device=None):
    return kvcache.attn_cache(cfg.n_layers, batch, s_cache, cfg.n_kv_heads,
                              cfg.head_dim, dtype, device)
