"""Whisper-style encoder-decoder (the whisper-tiny backbone).

The port of the reference's ``models/audio.py``. The conv / mel frontend is
a stub, as in the reference: ``batch["audio_frames"]`` carries precomputed
frame embeddings [B, n_frames, d_model]. Encoder: bidirectional attention
with sinusoidal positions. Decoder: causal self-attention, then
cross-attention to the encoder's output, learned positions (a table of
``max_positions`` rows). LayerNorm with a bias and a non-gated GELU MLP
throughout; no RoPE.

Cache (``init_cache``), the reference's layout: ``{"kv": (k, v)`` [L, B,
S, KV, hd], ``"cross_kv": (k, v)`` [L, B, n_frames, KV, hd]}. The cross
K/V has no sequence axis: it is slot-resident under the block-paged pool,
where only ``kv`` is paged. The serving engine prefills tokens only, as
the reference's does, so its slots attend to a zero cross K/V.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import kvcache, layers as L
from repro_torch.models import transformer as TR

Params = Dict[str, Any]


def _sinusoid(n_pos: int, d: int, device=None) -> torch.Tensor:
    """[n_pos, d] f32: sines of the d/2 frequencies, then their cosines
    (concatenated, not interleaved)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def enc_layer_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    return {
        "attn_norm": L.norm_init(cfg.d_model, dtype, device, bias=True),
        "attn": L.attention_init(gen, cfg, dtype=dtype, device=device),
        "mlp_norm": L.norm_init(cfg.d_model, dtype, device, bias=True),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False,
                          dtype=dtype, device=device),
    }


def dec_layer_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    return {
        "attn_norm": L.norm_init(cfg.d_model, dtype, device, bias=True),
        "attn": L.attention_init(gen, cfg, dtype=dtype, device=device),
        "xattn_norm": L.norm_init(cfg.d_model, dtype, device, bias=True),
        "xattn": L.attention_init(gen, cfg, dtype=dtype, device=device),
        "mlp_norm": L.norm_init(cfg.d_model, dtype, device, bias=True),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False,
                          dtype=dtype, device=device),
    }


def encode(params: Params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames [B, F, d_model] (the stub frontend's output) -> encoder
    states [B, F, d_model]."""
    quant, eps = cfg.quant, cfg.norm_eps
    h = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)
    for lp in params["enc_layers"]:
        a, _ = L.attention_apply(lp["attn"], L.layer_norm(lp["attn_norm"], h,
                                                          eps), cfg,
                                 causal=False, use_rope=False, quant=quant)
        h = h + a
        h = h + L.mlp_apply(lp["mlp"], L.layer_norm(lp["mlp_norm"], h, eps),
                            quant)
    return L.layer_norm(params["enc_norm"], h, eps)


def compute_cross_kv(params: Params, enc_out: torch.Tensor, cfg):
    """Per-decoder-layer cross K/V, (k, v) each [L, B, F, KV, hd]."""
    b, f, _ = enc_out.shape
    ks, vs = [], []
    for lp in params["dec_layers"]:
        for proj, out in (("wk", ks), ("wv", vs)):
            y = L.lut_dense(lp["xattn"][proj], enc_out, cfg.quant)
            out.append(y.reshape(b, f, cfg.n_kv_heads, cfg.head_dim))
    return torch.stack(ks), torch.stack(vs)


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
            caches=None, cache_pos=0, head: bool = True, page_table=None,
            token_valid=None, window=None):
    """(logits [B, S, V] or None, caches, aux), as ``transformer.forward``.
    With ``audio_frames`` in the batch the encoder runs and its cross K/V
    is computed (and, with caches, written into ``caches["cross_kv"]``, or
    put there in place of the int8 cache's int8 zeros);
    without, the cross K/V is read from the caches. ``cache_pos`` a [B]
    tensor (per-slot decode) gives each slot its own learned positions.
    ``token_valid`` is ignored (an attention-only stack). ``window``
    applies to the decoder's self-attention (never to the encoder or the
    cross attention). The reference's whisper forward takes a window and
    drops it (``src/repro/models/audio.py``), so its windowed forward is
    its full one and its rolling cache is written past its end; the port
    applies the window, as the other families do."""
    tokens = batch["tokens"]
    quant, eps = cfg.quant, cfg.norm_eps
    s = tokens.shape[1]
    h = TR.embed_apply(params["embed"], tokens).to(cfg.activation_dtype)
    steps = torch.arange(s, device=tokens.device)
    per_slot = torch.is_tensor(cache_pos) and cache_pos.dim() == 1
    pos = cache_pos[:, None] + steps if per_slot else (cache_pos + steps)[None]
    # a right-padded prefill tail past the table reads its last row: those
    # positions are rewritten by decode before any query reads them
    pos = pos.clamp(max=cfg.max_positions - 1)
    h = h + params["pos_embed"][pos].to(h.dtype)
    if "audio_frames" in batch:
        enc_out = encode(params, batch["audio_frames"].to(
            cfg.activation_dtype), cfg)
        cross_kv = compute_cross_kv(params, enc_out, cfg)
        if caches is not None:
            if caches["cross_kv"][0].dtype == cross_kv[0].dtype:
                for leaf, new in zip(caches["cross_kv"], cross_kv):
                    leaf.copy_(new)
            else:
                # the int8 cache's int8 zeros: the f32 cross K/V replace
                # them, as they replace them in the reference's returned
                # cache tree
                caches["cross_kv"] = cross_kv
    else:
        cross_kv = caches["cross_kv"]
    for i, lp in enumerate(params["dec_layers"]):
        lc = None if caches is None else kvcache.layer_cache(caches["kv"], i)
        a, _ = L.attention_apply(
            lp["attn"], L.layer_norm(lp["attn_norm"], h, eps), cfg,
            kv_cache=lc, cache_pos=cache_pos, use_rope=False, quant=quant,
            page_table=page_table, window=window)
        h = h + a
        xa, _ = L.attention_apply(
            lp["xattn"], L.layer_norm(lp["xattn_norm"], h, eps), cfg,
            xattn_kv=(cross_kv[0][i].to(h.dtype), cross_kv[1][i].to(h.dtype)),
            causal=False, use_rope=False, quant=quant)
        h = h + xa
        h = h + L.mlp_apply(lp["mlp"], L.layer_norm(lp["mlp_norm"], h, eps),
                            quant)
    if not head:
        return None, caches, {}
    h = L.layer_norm(params["final_norm"], h, eps)
    return TR.head_apply(params["lm_head"], h, quant), caches, {}


def init_cache(cfg, batch: int, s_cache: int, dtype=torch.bfloat16,
               device=None, *, window=None):
    cross = (cfg.n_layers, batch, cfg.n_audio_frames, cfg.n_kv_heads,
             cfg.head_dim)
    # the int8 cache's cross K/V are int8 zeros, as the reference makes
    # them with the cache dtype
    cdt = torch.int8 if kvcache.is_int8(dtype) else dtype
    return {"kv": kvcache.attn_cache(cfg.n_layers, batch, s_cache,
                                     cfg.n_kv_heads, cfg.head_dim, dtype,
                                     device, window=window),
            "cross_kv": (torch.zeros(cross, dtype=cdt, device=device),
                         torch.zeros(cross, dtype=cdt, device=device))}
