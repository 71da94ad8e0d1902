"""Shared model layers: norms, RoPE, LutDense (the paper's integration
point), chunked attention and the gated MLP.

Every projection goes through :func:`lut_dense`, which dispatches on the
parameter form: float ``{"w": [in, out]}`` is a dense GEMM, packed
``{"qw": QuantizedWeight}`` is an mpGEMM in the configured mode.
Projections sharing an input (QKV; gate+up) share one precomputed lookup
table when the staged pipeline runs (§3.1.1).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core import mpgemm as mp

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32, device=None) -> Params:
    w = torch.randn(d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32) / math.sqrt(d_in)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def norm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"g": torch.ones(d, dtype=dtype, device=device)}


def attention_init(gen, cfg, *, dtype=torch.float32, device=None) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, **kw),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, **kw),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, **kw),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype=dtype, device=device),
    }


def mlp_init(gen, d_model: int, d_ff: int, *, dtype=torch.float32,
             device=None) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {"gate": dense_init(gen, d_model, d_ff, **kw),
            "up": dense_init(gen, d_model, d_ff, **kw),
            "down": dense_init(gen, d_ff, d_model, **kw)}


# ---------------------------------------------------------------------------
# LutDense — every matmul of the model
# ---------------------------------------------------------------------------

def lut_dense(p: Params, x: torch.Tensor, quant: Optional[dict] = None,
              table=None) -> torch.Tensor:
    """y = x @ W (+b)."""
    if "qw" in p:
        q = quant or {}
        y = mp.mpgemm(x, p["qw"], mode=q.get("mpgemm_mode", "lut_xla"),
                      table_quant=q.get("table_quant", "per_row"),
                      table=table, fusion=q.get("fusion", "auto"))
    else:
        w = p["w"].to(x.dtype).to(torch.float32)
        y = (x.to(torch.float32) @ w).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def resolve_fusion(m: int, k: int, quant: dict) -> str:
    """The lut_pallas ``fusion`` knob, resolved to "fused"/"staged" for a
    table shared by the consumers of one [m, k] activation. The decision
    uses the scheduler's widest N (2048): the fused working set only grows
    with bn, so fused there is fused for every consumer."""
    fusion = quant.get("fusion", "auto")
    if fusion != "auto":
        return fusion
    from repro_torch.kernels.ops import auto_fusion
    kg = quant.get("k_group", 4)
    return auto_fusion(m, 2048, max(1, k // kg), kg,
                       quant.get("weight_bits", 2))


def make_table(x: torch.Tensor, quant: Optional[dict]):
    """A lookup table shared by all consumers of ``x`` (§3.1.1), or None
    when the mode has no table or the fused kernel runs (it rebuilds the
    table on chip per consumer)."""
    if not quant or quant.get("mpgemm_mode") not in ("lut_xla", "lut_pallas"):
        return None
    if quant.get("mpgemm_mode") == "lut_pallas":
        m = max(1, math.prod(x.shape[:-1]))
        if resolve_fusion(m, x.shape[-1], quant) == "fused":
            return None
    return mp.precompute_tables(x, quant.get("k_group", 4),
                                quant.get("table_quant", "per_row"))


# ---------------------------------------------------------------------------
# norms, RoPE
# ---------------------------------------------------------------------------

def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["g"].to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x [B, S, H, hd], positions [B, S] or [S] -> rotated."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked attention (online softmax over KV chunks)
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, q_offset=0, causal: bool = True,
                      kv_valid_len=None, chunk: int = 1024) -> torch.Tensor:
    """q [B, Sq, H, hd], k/v [B, Skv, KV, hd] -> [B, Sq, H, hd].

    Online softmax over KV chunks in f32; never builds the [Sq, Skv] score
    matrix. GQA by head grouping. ``kv_valid_len`` ([B] or scalar) masks
    cache positions at or beyond each row's valid length; masked scores
    get exactly zero weight.
    """
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kv, rep, hd).to(torch.float32)
    chunk = min(chunk, skv)
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    neg = torch.finfo(torch.float32).min
    vl = kv_valid_len  # an int, or a [B] tensor -> [B, 1]
    if torch.is_tensor(vl):
        vl = vl.reshape(-1, 1)
    m = torch.full((b, sq, kv, rep), neg, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, kv, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, kv, rep, hd), dtype=torch.float32, device=dev)
    for c0 in range(0, skv, chunk):
        kc = k[:, c0:c0 + chunk].to(torch.float32)
        vc = v[:, c0:c0 + chunk].to(torch.float32)
        kv_pos = c0 + torch.arange(kc.shape[1], device=dev)
        s = torch.einsum("bsgrh,btgh->bsgrt", qg, kc) * scale
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]
            s = torch.where(mask[None, :, None, None, :], s, neg)
        if vl is not None:
            vmask = kv_pos[None, :] < vl  # [B or 1, chunk]
            s = torch.where(vmask[:, None, None, None, :], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bsgrt,btgh->bsgrh", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# attention + MLP blocks
# ---------------------------------------------------------------------------

def attention_apply(p: Params, x: torch.Tensor, cfg, *, kv_cache=None,
                    cache_pos=0, quant: Optional[dict] = None):
    """Returns (out, kv_cache); the cache is updated in place.

    * ``cache_pos`` a [B] tensor (per-slot decode, s == 1): each slot writes
      its token at its own position and attends to its valid prefix;
    * ``cache_pos`` an int with a cache (a prefill chunk at that offset):
      writes the chunk at the offset and attends causally over the cache;
    * no cache: causal attention over the sequence itself.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    per_slot = torch.is_tensor(cache_pos) and cache_pos.dim() == 1
    tbl = make_table(x, quant)
    q = lut_dense(p["wq"], x, quant, tbl).reshape(b, s, cfg.n_heads, hd)
    k = lut_dense(p["wk"], x, quant, tbl).reshape(b, s, cfg.n_kv_heads, hd)
    v = lut_dense(p["wv"], x, quant, tbl).reshape(b, s, cfg.n_kv_heads, hd)
    steps = torch.arange(s, device=x.device)
    positions = cache_pos[:, None] + steps if per_slot else cache_pos + steps
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        out = chunked_attention(q, k, v, q_offset=cache_pos, causal=True,
                                chunk=cfg.attn_chunk)
    elif per_slot:
        if s != 1:
            raise NotImplementedError("per-slot decode writes one token per "
                                      "slot (speculative bursts not ported)")
        ck, cv = kv_cache
        bi = torch.arange(b, device=x.device)
        ck[bi, cache_pos] = k[:, 0].to(ck.dtype)
        cv[bi, cache_pos] = v[:, 0].to(cv.dtype)
        out = chunked_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                causal=False, kv_valid_len=cache_pos + 1,
                                chunk=cfg.attn_chunk)
    else:
        ck, cv = kv_cache
        n = min(s, ck.shape[1] - cache_pos)  # a right-padded tail may overrun
        ck[:, cache_pos:cache_pos + n] = k[:, :n].to(ck.dtype)
        cv[:, cache_pos:cache_pos + n] = v[:, :n].to(cv.dtype)
        out = chunked_attention(q, ck, cv, q_offset=cache_pos, causal=True,
                                kv_valid_len=cache_pos + s,
                                chunk=cfg.attn_chunk)
    out = out.reshape(b, s, cfg.n_heads * hd)
    return lut_dense(p["wo"], out, quant), kv_cache


def mlp_apply(p: Params, x: torch.Tensor,
              quant: Optional[dict] = None) -> torch.Tensor:
    """SwiGLU MLP."""
    tbl = make_table(x, quant)
    g = lut_dense(p["gate"], x, quant, tbl)
    u = lut_dense(p["up"], x, quant, tbl)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return lut_dense(p["down"], h, quant)
