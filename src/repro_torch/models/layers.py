"""Shared model layers: norms, RoPE, LutDense (the paper's integration
point), chunked attention (self and cross) and the MLPs (gated SwiGLU,
whisper's GELU).

Every projection goes through :func:`lut_dense`, which dispatches on the
parameter form: float ``{"w": [in, out]}`` is a dense GEMM, packed
``{"qw": QuantizedWeight}`` is an mpGEMM in the configured mode.
Projections sharing an input (QKV; gate+up) share one precomputed lookup
table when the staged pipeline runs (§3.1.1).

Under a model-axis mesh (``distributed.sharding.shard_params`` marks each
linear's ``"tp"``) a projection runs on this rank's block: column-parallel
on its output channels with no collective, row-parallel on its K-range
with the partial products summed over the ranks, or whole. Attention runs
on the rank's local heads, so ``wo`` takes its input split; a consumer
whose layout disagrees with its producer's slices or gathers its input.

Training under a mesh (float weights, ``quant["qat"]``): the collectives
carry gradients (``collectives`` module docstring); a replicated
activation entering column-parallel projections passes
``collectives.replicated_input`` once (attention's QKV, the MLP's gate and
up), so its gradient is the sum of the ranks' partials; a row-parallel
weight is fake-quantized with its whole row's scale (the ranks' K-blocks
reduced: the max of their absmax, or their |w| sums over K), so every
rank quantizes its block as one device quantizes the whole row.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core import mpgemm as mp
from repro_torch.core.quantize import fake_quant, fq_scale
from repro_torch.core.table import true_divide
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import model_split
from repro_torch.models import kvcache

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32, device=None) -> Params:
    # scaled in place: a full-width head's draw is 0.26 GB, its copy
    # another
    w = torch.randn(d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32).div_(math.sqrt(d_in))
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def norm_init(d: int, dtype=torch.float32, device=None, *,
              bias: bool = False) -> Params:
    p = {"g": torch.ones(d, dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def attention_init(gen, cfg, *, dtype=torch.float32, device=None) -> Params:
    """Q, K, V and O projections; a cross-attention layer has the same
    four (its K and V read the image or encoder states)."""
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, **kw),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, **kw),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, **kw),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype=dtype, device=device),
    }


def mlp_init(gen, d_model: int, d_ff: int, *, gated: bool = True,
             dtype=torch.float32, device=None) -> Params:
    """SwiGLU (gate, up, down), or with ``gated=False`` whisper's GELU MLP
    (up, down)."""
    kw = dict(dtype=dtype, device=device)
    p = {"gate": dense_init(gen, d_model, d_ff, **kw)} if gated else {}
    p["up"] = dense_init(gen, d_model, d_ff, **kw)
    p["down"] = dense_init(gen, d_ff, d_model, **kw)
    return p


# ---------------------------------------------------------------------------
# LutDense — every matmul of the model
# ---------------------------------------------------------------------------

def lut_dense(p: Params, x: torch.Tensor, quant: Optional[dict] = None,
              table=None, *, x_split: bool = False) -> torch.Tensor:
    """y = x @ W (+b). A float W under ``quant["qat"]`` (the training
    forward) is fake-quantized per output channel along the input axis
    first, whatever ``quant["skip"]`` says, as in the reference.

    Under a mesh, ``x_split``: x holds this rank's block of its last dim
    (a column-parallel producer's output). A row-parallel W
    (``p["tp"] == "row"``) takes x's block (sliced here where x is whole)
    and sums its partial product over the model axis (``_row_parallel``);
    any other W takes x whole (gathered here where x is split). The
    output is this rank's block of channels where W is column-parallel,
    else whole. A linear with ``"blocks"`` (a mesh's control on one
    device, ``sharding.one_device_control``) runs its ranks' blocks in
    turn."""
    if "blocks" in p:
        mode, parts = p["blocks"]
        if mode == "col":
            return torch.cat([lut_dense(b, x, quant, table) for b in parts],
                             dim=-1)
        k = x.shape[-1] // len(parts)
        return _row_parallel(parts, [x[..., r * k:(r + 1) * k]
                                     for r in range(len(parts))], quant,
                             collectives.reduce_parts, x.shape[-1])
    if p.get("tp") == "row":
        m = model_split().axis_size("model")
        return _row_parallel([p], [x if x_split else _k_block(x)], quant,
                             lambda ts, op: collectives.all_reduce(ts[0], op),
                             x.shape[-1] * (m if x_split else 1))
    if x_split:
        x = collectives.all_gather(x, dim=-1)
    if "qw" in p:
        q = quant or {}
        y = mp.mpgemm(x, p["qw"], mode=q.get("mpgemm_mode", "lut_xla"),
                      table_quant=q.get("table_quant", "per_row"),
                      table=table, fusion=q.get("fusion", "auto"))
    else:
        w = p["w"]
        if quant and quant.get("qat"):
            w = fake_quant(w.T, quant.get("weight_bits", 2),
                           quant.get("scheme", "symmetric")).T
        w = w.to(x.dtype).to(torch.float32)
        y = (x.to(torch.float32) @ w).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _k_block(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of x's last dim over the model axis
    (``collectives.scatter``: its gradient gathers the ranks' blocks)."""
    return collectives.scatter(x, dim=-1, axis="model")


def _qat_row_blocks(ws, q: dict, reduce, k_total: int):
    """Row-parallel W blocks [K/m, N] fake-quantized with their whole rows'
    scales: each output channel's statistic over its K-blocks reduced by
    ``reduce`` (absmax: the max; ternary: the |w| sum, over ``k_total``)."""
    bits, scheme = q.get("weight_bits", 2), q.get("scheme", "symmetric")
    with torch.no_grad():
        wts = [w.T.to(torch.float32) for w in ws]
        if scheme == "ternary":
            stat = reduce([wt.abs().sum(dim=-1, keepdim=True)
                           for wt in wts], "sum")
        else:
            stat = reduce([wt.abs().amax(dim=-1, keepdim=True)
                           for wt in wts], "max")
        s = fq_scale(None, bits, scheme, stat=stat, k=k_total)
    return [fake_quant(w.T, bits, scheme, scale=s).T for w in ws]


def _row_parallel(parts, xs, quant: Optional[dict], reduce,
                  k_total: int) -> torch.Tensor:
    """A row-parallel projection: each W block's f32 partial product on
    its K-range of x (``parts`` and ``xs`` pair up: this rank's one, or a
    control's m), reduced over the ranks by ``reduce(tensors, op)``, then
    the bias once. A per_row INT8 table is quantized with the whole row's
    scale, the max of the K-ranges' row scales (exact: the scale is a
    monotone function of the row's largest group sum), so its codes are
    the single-device codes on each range; a float W under QAT is
    fake-quantized with its whole rows' scales (``_qat_row_blocks``;
    ``k_total`` is the contraction's whole K)."""
    q = quant or {}
    if "qw" in parts[0]:
        mode = q.get("mpgemm_mode", "lut_xla")
        tq = mp.resolve_table_quant(q.get("table_quant", "per_row"),
                                    xs[0].device)
        rs = None
        if tq == "per_row" and mode in ("lut_xla", "lut_pallas"):
            rs = reduce([mp.row_scale(x, p["qw"].k_group, mode)
                         for p, x in zip(parts, xs)], "max")
        ys = [mp.mpgemm(x, p["qw"], mode=mode, table_quant=tq,
                        fusion=q.get("fusion", "auto"),
                        out_dtype=torch.float32, row_scale=rs)
              for p, x in zip(parts, xs)]
    else:
        ws = [p["w"] for p in parts]
        if q.get("qat"):
            ws = _qat_row_blocks(ws, q, reduce, k_total)
        ys = [x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)
              for w, x in zip(ws, xs)]
    y = reduce(ys, "sum").to(xs[0].dtype)
    if "b" in parts[0]:
        y = y + parts[0]["b"].to(y.dtype)
    return y


def resolve_fusion(m: int, k: int, quant: dict) -> str:
    """The lut_pallas ``fusion`` knob, resolved to "fused"/"staged" for a
    table shared by the consumers of one [m, k] activation. "auto" uses the
    scheduler's widest N (2048): the fused working set only grows with bn,
    so fused there is fused for every consumer. Under "tuned" the tuning
    cache votes first (``autotune.lookup_fusion_any``: the largest-N entry
    of this activation's shape); a miss falls back to "auto"."""
    fusion = quant.get("fusion", "auto")
    if fusion not in ("auto", "tuned"):
        return fusion
    kg = quant.get("k_group", 4)
    bits = quant.get("weight_bits", 2)
    if fusion == "tuned":
        from repro_torch.core.autotune import lookup_fusion_any
        tuned = lookup_fusion_any(m, max(1, k // kg), kg, bits)
        if tuned is not None:
            return tuned
    from repro_torch.kernels.ops import auto_fusion
    return auto_fusion(m, 2048, max(1, k // kg), kg, bits)


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
                                quant.get("table_quant", "per_row"),
                                quant["mpgemm_mode"])


# ---------------------------------------------------------------------------
# norms, RoPE
# ---------------------------------------------------------------------------

def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["g"].to(torch.float32)).to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (mean, population variance, ``rsqrt(var + eps)``),
    with a bias where ``p`` has one (whisper)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["g"].to(torch.float32)
    if "b" in p:
        out = out + p["b"].to(torch.float32)
    return out.to(x.dtype)


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

def _quantize_kv_slice(x: torch.Tensor):
    """[B, S, KV, hd] -> (int8 codes, f32 scales [B, S, KV, 1]): absmax a
    (position, head), the reference's int8 KV quantizer. ``torch.round``
    rounds half to even, as ``jnp.round`` does; the divisions are IEEE
    ones on every device (``true_divide``)."""
    xf = x.to(torch.float32)
    sc = true_divide(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8),
                     127.0)
    q = torch.round(xf / sc).clamp(-127, 127).to(torch.int8)
    return q, sc


def _write_kv(kv_cache, k, v, write):
    """Store fresh k / v [B, S, KV, hd] into the cache's leaves through
    ``write(leaf, vals)``: (k, v) as they are, the int8 cache's four leaves
    as codes and scales. Returns (k, v, k_scale, v_scale) to attend over:
    the cache leaves as ``write`` left them (scales None for (k, v))."""
    if len(kv_cache) == 4:
        (kq, ks), (vq, vs) = _quantize_kv_slice(k), _quantize_kv_slice(v)
        for leaf, vals in zip(kv_cache, (kq, vq, ks, vs)):
            write(leaf, vals)
        return kv_cache
    for leaf, vals in zip(kv_cache, (k, v)):
        write(leaf, vals)
    return tuple(kv_cache) + (None, None)


def chunked_attention(q, k, v, *, q_offset=0, causal: bool = True,
                      window: Optional[int] = None, kv_valid_len=None,
                      chunk: int = 1024, k_scale=None,
                      v_scale=None) -> torch.Tensor:
    """q [B, Sq, H, hd], k/v [B, Skv, KV, hd] -> [B, Sq, H, hd].

    Online softmax over KV chunks in f32; never builds the [Sq, Skv] score
    matrix. GQA by head grouping. ``kv_valid_len`` masks cache positions at
    or beyond a valid length: an int, [B] (one per row), or [B, Sq] (one per
    query: per-slot decode and the speculative burst, where query j reads
    the positions up to its own write). ``window`` (sliding-window
    attention) masks keys ``window`` or more positions behind the query
    (q_pos − kv_pos ≥ window). Masked scores get exactly zero weight.

    With per-query valid lengths and Sq > 1 each query runs alone, as a
    decode step's single query does: the batched GEMMs' kernels, and so
    their summation order, change with the number of queries, so query j of
    a speculative verify burst gets the bits of an s = 1 step at its
    position.

    ``k_scale`` / ``v_scale`` [B, Skv, KV, 1] (the int8 cache): k and v are
    int8 codes, dequantized a chunk at a time inside the loop (codes times
    scales in f32), so no f32 copy of the cache is made.
    """
    b, sq, h, hd = q.shape
    if torch.is_tensor(kv_valid_len) and kv_valid_len.dim() == 2 and sq > 1:
        return torch.cat([chunked_attention(
            q[:, j:j + 1].contiguous(), k, v, q_offset=q_offset + j,
            causal=causal, window=window, kv_valid_len=kv_valid_len[:, j],
            chunk=chunk,
            k_scale=k_scale, v_scale=v_scale)
            for j in range(sq)], dim=1)
    skv, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kv, rep, hd).to(torch.float32)
    chunk = min(chunk, skv)
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    neg = torch.finfo(torch.float32).min
    vl = kv_valid_len  # an int, or a [B] / [B, 1] tensor -> [B, 1]
    if torch.is_tensor(vl):
        vl = vl.reshape(-1, 1)
    m = torch.full((b, sq, kv, rep), neg, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, kv, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, kv, rep, hd), dtype=torch.float32, device=dev)
    for c0 in range(0, skv, chunk):
        kc = k[:, c0:c0 + chunk].to(torch.float32)
        vc = v[:, c0:c0 + chunk].to(torch.float32)
        if k_scale is not None:
            kc = kc * k_scale[:, c0:c0 + chunk]
            vc = vc * v_scale[:, c0:c0 + chunk]
        kv_pos = c0 + torch.arange(kc.shape[1], device=dev)
        s = torch.einsum("bsgrh,btgh->bsgrt", qg, kc) * scale
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]
            s = torch.where(mask[None, :, None, None, :], s, neg)
        if window is not None:
            mask = q_pos[:, None] - kv_pos[None, :] < window
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
                    cache_pos=0, quant: Optional[dict] = None,
                    page_table: Optional[torch.Tensor] = None,
                    window: Optional[int] = None, xattn_kv=None,
                    causal: bool = True, use_rope: bool = True):
    """Returns (out, kv_cache); the cache is updated in place. ``kv_cache``
    is (k, v) or the int8 cache's (k, v, k_scale, v_scale): fresh k / v
    are quantized a (position, head) at a time (``_quantize_kv_slice``)
    and written as codes and scales in every branch below, and attention
    reads the codes through the scales.

    * ``xattn_kv`` (k, v) [B, S_kv, KV, hd] (cross-attention: precomputed
      image or encoder K/V): only ``wq`` and ``wo`` run, every query attends
      to every key without a mask or RoPE, and no cache is read or written;
    * ``use_rope=False`` leaves q and k unrotated (whisper); ``causal=False``
      (an encoder, no cache) lets every position attend to every other.

    * ``cache_pos`` a [B] tensor (per-slot decode): slot b writes its s
      tokens at positions cache_pos[b] .. cache_pos[b] + s - 1 and query j
      attends to the positions up to its own (s > 1 is the speculative
      verify burst). A burst's writes past the cache are dropped, as the
      reference drops them; an s = 1 write must lie inside the cache (the
      engine keeps it there);
    * ``cache_pos`` an int with a cache (a prefill chunk at that offset):
      writes the chunk at the offset and attends causally over the cache,
      at offset 0 too. (The reference attends over the fresh k / v instead
      when its offset is the static int 0; its engine's prefill passes a
      traced offset and reads the cache, as the port always does. With an
      int8 cache the two differ by the quantization of the chunk's K/V.)
    * no cache: causal attention over the sequence itself.

    With ``page_table`` ([B, nb] int64) the cache leaves are pool-shaped
    [num_blocks, block_size, KV, hd]: the fresh k/v scatter through the
    table (positions past its reach go to the null block), the slot's
    blocks gather into a [B, nb*bs] view, and the same ``chunked_attention``
    call as the dense branch runs on it (bit-exact with dense when nb*bs ==
    max_seq; see ``kvcache``).

    ``window`` (sliding-window attention, the self-attention only): a query
    attends to the keys less than ``window`` positions behind it. A cache
    exactly ``window`` long (``kvcache.attn_cache(window=)`` below
    ``s_cache``) is a rolling cache: a chunk at offset p writes slot
    (p + j) mod window, and attention scores each slot by the global
    position it holds (``_rolling_positions``, ``_attend_rolling``), as the
    reference does. So a chunk of s > 1 tokens that wraps overwrites keys
    its own earlier queries still need, and those queries see fewer than
    ``window`` keys, as in the reference; s = 1 decode steps are exact.
    Any other cache, and no cache, take the window mask. Refused, where
    the reference answers wrongly: the paged pool (NotImplementedError, as
    the reference raises), per-slot decode (the reference's per-slot
    branch never reads the window) and an int8 cache written past its
    end (it does not roll; the reference clamps the write offset).
    """
    if window is not None:
        if page_table is not None:
            raise NotImplementedError(
                "paged KV cache does not support sliding-window attention")
        if torch.is_tensor(cache_pos) and cache_pos.dim() == 1:
            raise ValueError(
                "sliding-window attention is not served with per-slot "
                "decode (cache_pos [B]): the reference's per-slot branch "
                "ignores the window")
    b, s, _ = x.shape
    hd = cfg.head_dim
    attend = chunked_attention
    if "heads" in p:  # a mesh's control: the ranks' head blocks in turn
        attend = functools.partial(_head_blocks, p["heads"])
    per_slot = torch.is_tensor(cache_pos) and cache_pos.dim() == 1
    # float projections (quant["skip"]: olmoe's attention) read no table;
    # in cross-attention only wq reads it, as in the reference
    tbl = make_table(x, quant) if "qw" in p["wq"] else None
    # under a mesh: this rank's heads (the whole heads where attention
    # runs replicated)
    heads_split = p["wq"].get("tp") == "col"
    if heads_split:
        x = collectives.replicated_input(x)
    q = lut_dense(p["wq"], x, quant, tbl).reshape(b, s, -1, hd)
    if xattn_kv is not None:
        k, v = xattn_kv
        out = attend(q, k, v, causal=False, chunk=cfg.attn_chunk)
        out = out.reshape(b, s, -1)
        return lut_dense(p["wo"], out, quant, x_split=heads_split), kv_cache
    k = lut_dense(p["wk"], x, quant, tbl).reshape(b, s, -1, hd)
    v = lut_dense(p["wv"], x, quant, tbl).reshape(b, s, -1, hd)
    steps = torch.arange(s, device=x.device)
    positions = cache_pos[:, None] + steps if per_slot else cache_pos + steps
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        out = attend(q, k, v, q_offset=cache_pos, causal=causal,
                     window=window, chunk=cfg.attn_chunk)
    elif page_table is not None:
        pos2d = positions if per_slot else torch.full(
            (b, 1), cache_pos, dtype=torch.int64, device=x.device) + steps
        leaves = _write_kv(kv_cache, k, v, lambda leaf, vals:
                           kvcache.paged_scatter(leaf, vals, page_table,
                                                 pos2d))
        kg, vg, ksg, vsg = (None if leaf is None
                            else kvcache.paged_gather(leaf, page_table)
                            for leaf in leaves)
        if per_slot:
            if ksg is None:
                kg, vg = kg.to(q.dtype), vg.to(q.dtype)
            out = attend(q, kg, vg, causal=False,
                         kv_valid_len=pos2d + 1,
                         chunk=cfg.attn_chunk, k_scale=ksg,
                         v_scale=vsg)
        else:
            out = attend(q, kg, vg, q_offset=cache_pos,
                         causal=causal, kv_valid_len=cache_pos + s,
                         chunk=cfg.attn_chunk, k_scale=ksg,
                         v_scale=vsg)
    elif per_slot:
        wpos = positions
        if s > 1:
            # an entry past the cache repeats the slot's last in-range entry
            # (its position and its value), so it writes nothing new: the
            # write is dropped without touching a live position (the int8
            # cache quantizes each position alone, so its codes and scale
            # repeat too)
            jj = torch.minimum(steps,
                               kv_cache[0].shape[1] - 1 - cache_pos[:, None])
            wpos = cache_pos[:, None] + jj
            idx = jj[:, :, None, None].expand_as(k)
            k, v = k.gather(1, idx), v.gather(1, idx)
        bi = torch.arange(b, device=x.device)[:, None]

        def write(leaf, vals):
            leaf[bi, wpos] = vals.to(leaf.dtype)
        ck, cv, cks, cvs = _write_kv(kv_cache, k, v, write)
        if cks is None:
            ck, cv = ck.to(q.dtype), cv.to(q.dtype)
        out = attend(q, ck, cv, causal=False,
                     kv_valid_len=positions + 1,
                     chunk=cfg.attn_chunk, k_scale=cks,
                     v_scale=cvs)
    elif (window is not None and len(kv_cache) == 2
          and kv_cache[0].shape[1] == window):
        out = _rolling_apply(q, k, v, kv_cache, cache_pos, window)
    else:
        s_cache = kv_cache[0].shape[1]
        if window is not None and cache_pos + s > s_cache:
            raise ValueError(
                f"sliding-window attention: positions {cache_pos}.."
                f"{cache_pos + s - 1} run past a {s_cache}-position "
                + ("int8 cache, which does not roll (the reference clamps "
                   "the write offset)" if len(kv_cache) == 4 else "cache"))
        # a right-padded tail may overrun the cache
        n = min(s, s_cache - cache_pos)

        def write(leaf, vals):
            leaf[:, cache_pos:cache_pos + n] = vals[:, :n].to(leaf.dtype)
        ck, cv, cks, cvs = _write_kv(kv_cache, k, v, write)
        out = attend(q, ck, cv, q_offset=cache_pos, causal=causal,
                     window=window, kv_valid_len=cache_pos + s,
                     chunk=cfg.attn_chunk, k_scale=cks,
                     v_scale=cvs)
    out = out.reshape(b, s, -1)
    return lut_dense(p["wo"], out, quant, x_split=heads_split), kv_cache


def _head_blocks(m: int, q, k, v, *, k_scale=None, v_scale=None,
                 **kw) -> torch.Tensor:
    """``chunked_attention`` over m blocks of heads in turn, each on
    contiguous copies of its q / k / v (and scale) blocks, concatenated:
    the calls a 1 x m mesh's ranks make on their local heads and caches
    (``sharding.one_device_control``), whose batched GEMMs' kernels, and
    so their summation order, follow the number of heads."""
    def blk(t, r):
        if t is None:
            return None
        n = t.shape[2] // m
        return t[:, :, r * n:(r + 1) * n].contiguous()
    return torch.cat([chunked_attention(
        blk(q, r), blk(k, r), blk(v, r), k_scale=blk(k_scale, r),
        v_scale=blk(v_scale, r), **kw) for r in range(m)], dim=2)


def _rolling_apply(q, k, v, kv_cache, cache_pos, window: int):
    """The rolling cache's branch of ``attention_apply``: write the chunk
    at slots (cache_pos + j) mod window, then attend over every slot by
    its stored global position."""
    s = q.shape[1]
    if s > window:
        raise ValueError(f"a {s}-token chunk is longer than the "
                         f"{window}-position rolling cache")
    steps = torch.arange(s, device=q.device)
    slot = (cache_pos + steps) % window
    ck, cv = kv_cache
    ck[:, slot] = k.to(ck.dtype)
    cv[:, slot] = v.to(cv.dtype)
    stored = _rolling_positions(cache_pos + s, window, q.device)
    return _attend_rolling(q, ck, cv, q_pos=cache_pos + steps,
                           stored_pos=stored, window=window)


def _rolling_positions(next_pos, window: int, device=None) -> torch.Tensor:
    """The global position each rolling-cache slot holds when the next
    write is at ``next_pos``: the largest p < next_pos with p mod window
    equal to the slot (negative: never written)."""
    slots = torch.arange(window, device=device)
    return slots + torch.div(next_pos - 1 - slots, window,
                             rounding_mode="floor") * window


def _attend_rolling(q, ck, cv, *, q_pos, stored_pos, window: int):
    """Attention over a rolling cache [B, window, KV, hd], each slot scored
    by its stored global position: one f32 softmax over the slots, as the
    reference's."""
    b, s, h, hd = q.shape
    kv = ck.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd).to(torch.float32)
    sc = torch.einsum("bsgrh,btgh->bsgrt", qg,
                      ck.to(torch.float32)) * hd ** -0.5
    valid = (stored_pos[None, :] >= 0) & (stored_pos[None, :]
                                          <= q_pos[:, None])
    valid &= q_pos[:, None] - stored_pos[None, :] < window
    sc = torch.where(valid[None, :, None, None, :], sc,
                     torch.finfo(torch.float32).min)
    pr = torch.softmax(sc, dim=-1)
    out = torch.einsum("bsgrt,btgh->bsgrh", pr, cv.to(torch.float32))
    return out.reshape(b, s, h, hd).to(q.dtype)


def mlp_apply(p: Params, x: torch.Tensor,
              quant: Optional[dict] = None) -> torch.Tensor:
    """SwiGLU MLP, or without a ``gate`` whisper's GELU MLP (the tanh
    form, ``jax.nn.gelu``'s default). Float weights (the training
    forward) read no table."""
    tbl = make_table(x, quant) if "qw" in p["up"] else None
    if p["up"].get("tp") == "col":
        x = collectives.replicated_input(x)
    if "gate" in p:
        g = lut_dense(p["gate"], x, quant, tbl)
        u = lut_dense(p["up"], x, quant, tbl)
        h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = torch.nn.functional.gelu(
            lut_dense(p["up"], x, quant, tbl).to(torch.float32),
            approximate="tanh").to(x.dtype)
    return lut_dense(p["down"], h, quant, x_split=p["up"].get("tp") == "col")
