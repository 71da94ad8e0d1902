"""Mamba1 / Mamba2 selective-state-space blocks (falcon-mamba, zamba2).

The port of the reference's ``models/ssm.py``. The dense projections
(``in_proj``, ``x_proj``, ``dt_proj``, ``out_proj``) go through
``layers.lut_dense``, so packed weights run the LUT mpGEMM kernels. The
depthwise causal conv, the selective scan and Mamba2's SSD are
activation × activation (no static low-bit operand): plain torch ops, out
of mpGEMM scope, as they are plain ``jnp`` in the reference.

Prefill runs a chunked scan: chunks of ``ssm_chunk`` tokens in order,
carrying the state h from one to the next. Within a chunk the recurrence
h_t = exp(dt_t·A) h_{t-1} + dt_t x_t B_t is evaluated in closed form from
L = cumsum(dt·A) (≤ 0, non-increasing): h_t = exp(L_t) h_0 + Σ_{s≤t}
exp(L_t − L_s) dt_s x_s B_s, the exponent masked to −inf above the diagonal
before the ``exp``, so no product of decays underflows to 0/0 (the
reference multiplies decays in an associative scan; its Mamba2 SSD uses
this same cumulative-sum form). Mamba1's chunk holds [B, c, c, d_inner,
d_state] weights (134 MB at falcon-mamba-7b's c = 16, B = 1, f32).
Decode (s = 1) is the O(1) state update. The sums run in another order
than XLA's: states agree with the reference to about 1e-5 relative (f32).

``token_valid`` ([B] count of real tokens from the left) makes a
right-padded tail chunk leave the conv and SSM state exactly as if only
the real tokens had been seen: the carried conv state ends at each row's
last real token, and dt is 0 at padded positions (decay 1, input 0).

Caches ``{"conv": [B, d_conv-1, d_inner], "ssm": [B, ...]}`` (one layer's
view of ``kvcache.mamba_cache`` / ``mamba2_cache``) are updated in place
and returned. The dtype casts are the reference's: Mamba1 casts the conv
output back to the activation dtype before ``x_proj``, Mamba2 keeps it f32.
Simplifications the reference documents: conv on the x path only,
ngroups = 1.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# depthwise causal conv (shared by mamba1/2)
# ---------------------------------------------------------------------------

def _causal_dwconv(x, conv_w, conv_b, conv_state=None, valid=None):
    """x [B, S, C], conv_w [W, C] depthwise causal -> (y, new_state).

    The taps are summed in f32 in the reference's order. ``valid`` ([B]
    int, None = all real) makes the returned state end at each row's last
    real token; outputs are causal, so real positions never see padding.
    """
    b, s, c = x.shape
    w = conv_w.shape[0]
    if conv_state is None:
        left = torch.zeros((b, w - 1, c), dtype=x.dtype, device=x.device)
    else:
        left = conv_state.to(x.dtype)
    xp = torch.cat([left, x], dim=1)  # [B, S+W-1, C]
    y = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for i in range(w):  # W is tiny (4): unrolled taps
        y = y + xp[:, i:i + s].to(torch.float32) * conv_w[i].to(torch.float32)
    y = y + conv_b.to(torch.float32)
    if w == 1:
        new_state = xp[:, :0]
    elif valid is None:
        new_state = xp[:, -(w - 1):]
    else:
        # token j of x sits at xp[:, j + w - 1]; the state after `valid`
        # real tokens is xp[:, valid : valid + w - 1]
        idx = valid.to(torch.int64)[:, None] + torch.arange(
            w - 1, device=x.device)[None, :]
        new_state = torch.gather(xp, 1, idx[..., None].expand(-1, -1, c))
    return y.to(x.dtype), new_state


def _mask_dt(dt, token_valid):
    """dt [B, S, ...] zeroed at padded positions: decay exp(0) = 1 and
    input 0 make the state update a no-op there."""
    if token_valid is None:
        return dt
    s = dt.shape[1]
    mask = (torch.arange(s, device=dt.device)[None, :]
            < token_valid.to(dt.device)[:, None])  # [B, S]
    return dt * mask.reshape(mask.shape + (1,) * (dt.dim() - 2))


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _silu(x):
    return x * torch.sigmoid(x)


def _pad_seq(t, pad):
    """Zero-pad t [B, S, ...] by ``pad`` positions at the end of S."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))],
                     dim=1)


def _segment_weights(cum):
    """exp(L_t - L_s) for s <= t, 0 above the diagonal: cum [B, c, ...] ->
    [B, c(t), c(s), ...], masked before the exp. In place on the one new
    tensor (134 MB a chunk at falcon-mamba-7b's width), which an
    out-of-place ``masked_fill`` would copy. Autograd allows both: it
    saves the exp's output, which only a later in-place write into the
    result would break."""
    c = cum.shape[1]
    tri = torch.ones((c, c), dtype=torch.bool, device=cum.device).tril()
    seg = cum[:, :, None] - cum[:, None, :]
    tri = tri.reshape((1, c, c) + (1,) * (cum.dim() - 2))
    return seg.masked_fill_(~tri, float("-inf")).exp_()


def _recording(*ts) -> bool:
    """Whether autograd records ops on ``ts``: the training forward. The
    serving engine runs with grad enabled on params that need none."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# Mamba1 (falcon-mamba)
# ---------------------------------------------------------------------------

def mamba_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv
    kw = dict(dtype=dtype, device=device)
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": L.dense_init(gen, d, 2 * di, **kw),
        "conv_w": torch.full((dc, di), 0.1, **kw),
        "conv_b": torch.zeros(di, **kw),
        "x_proj": L.dense_init(gen, di, cfg.dt_rank + 2 * ds, **kw),
        "dt_proj": L.dense_init(gen, cfg.dt_rank, di, bias=True, **kw),
        "A_log": torch.log(a)[None, :].expand(di, ds).to(dtype).contiguous(),
        "D": torch.ones(di, **kw),
        "out_proj": L.dense_init(gen, di, d, **kw),
    }


def _mamba1_chunk(dt_c, x_c, b_c, c_c, a, h, inplace=True):
    """One chunk of the selective scan: dt_c, x_c [B, c, di], b_c, c_c
    [B, c, ds], a [di, ds], h [B, di, ds] -> (y [B, c, di], end h)."""
    cum = torch.cumsum(dt_c[..., None] * a, dim=1)       # [B,c,di,ds]
    inp = (dt_c * x_c)[..., None] * b_c[:, :, None, :]    # [B,c,di,ds]
    # Σ_s w[t, s] · inp[s] as one product and one reduction (an einsum
    # here lowers to ~10^5 tiny batched GEMMs at full width)
    w = _segment_weights(cum)
    # in place when serving; autograd saved w for the product's backward
    w = w.mul_(inp[:, None]) if inplace else w * inp[:, None]
    hs = torch.exp(cum) * h[:, None] + w.sum(dim=2)
    return torch.einsum("btdz,btz->btd", hs, c_c), hs[:, -1]


def _mamba1_scan(dt, xf, bf, cf, a, h, c: int):
    """The chunked selective scan. dt, xf [B, S, di], bf, cf [B, S, ds],
    a [di, ds], h [B, di, ds] -> (y [B, S, di], final h).

    Serving multiplies each chunk's segment weights in place. The
    training forward (autograd recording) takes the out-of-place
    product, which gives the same bits, and recomputes each chunk in the
    backward pass (``checkpoint``, the reference's ``jax.checkpoint`` of
    the chunk body): only the chunk inputs and the carried h are kept, not the
    [B, c, c, di, ds] weights (B × 134 MB a chunk at full width)."""
    s = dt.shape[1]
    pad = (-s) % c  # dt = 0 on the padding: a no-op update
    dt, xf, bf, cf = (_pad_seq(t, pad) for t in (dt, xf, bf, cf))
    train = _recording(dt, xf, bf, cf, a, h)
    ys = []
    for c0 in range(0, s + pad, c):
        chunk = (dt[:, c0:c0 + c], xf[:, c0:c0 + c], bf[:, c0:c0 + c],
                 cf[:, c0:c0 + c], a, h)
        if train:
            y, h = checkpoint(_mamba1_chunk, *chunk, False,
                              use_reentrant=False)
        else:
            y, h = _mamba1_chunk(*chunk)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], h


def mamba_apply(p: Params, x: torch.Tensor, cfg, *, cache=None, quant=None,
                token_valid=None):
    """x [B, S, D] -> (y [B, S, D], cache updated in place or None)."""
    b, s, _ = x.shape
    di, ds, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    # a float in_proj (quant["skip"]) reads no table
    tbl = L.make_table(x, quant) if "qw" in p["in_proj"] else None
    xz = L.lut_dense(p["in_proj"], x, quant, tbl)
    xp, z = xz[..., :di], xz[..., di:]

    conv_state = None if cache is None else cache["conv"]
    xc, new_conv = _causal_dwconv(xp, p["conv_w"], p["conv_b"], conv_state,
                                  valid=token_valid)
    xc = _silu(xc.to(torch.float32)).to(x.dtype)

    dbc = L.lut_dense(p["x_proj"], xc, quant)
    # dt is a column slice of x_proj's output: contiguous before a kernel
    dt = dbc[..., :r].contiguous()
    bmat, cmat = dbc[..., r:r + ds], dbc[..., r + ds:]
    dt = _softplus(L.lut_dense(p["dt_proj"], dt, quant).to(torch.float32))
    dt = _mask_dt(dt, token_valid)                            # [B, S, di]
    a = -torch.exp(p["A_log"].to(torch.float32))              # [di, ds]
    xf = xc.to(torch.float32)
    bf, cf = bmat.to(torch.float32), cmat.to(torch.float32)

    h0 = (torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
          if cache is None else cache["ssm"].to(torch.float32))
    if s == 1:  # decode: the O(1) state update
        decay1 = torch.exp(dt[:, 0, :, None] * a[None])
        inp1 = (dt[:, 0] * xf[:, 0])[..., None] * bf[:, 0, None, :]
        h_end = decay1 * h0 + inp1
        y = torch.einsum("bdz,bz->bd", h_end, cf[:, 0])[:, None]
    else:
        y, h_end = _mamba1_scan(dt, xf, bf, cf, a, h0,
                                min(cfg.ssm_chunk, s))
    y = y + p["D"].to(torch.float32) * xf
    y = y * _silu(z.to(torch.float32))
    y = L.lut_dense(p["out_proj"], y.to(x.dtype), quant)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h_end)
    return y, cache


# ---------------------------------------------------------------------------
# Mamba2 (zamba2)
# ---------------------------------------------------------------------------

def mamba2_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv
    nh = cfg.ssm_heads
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": L.dense_init(gen, d, 2 * di + 2 * ds + nh, **kw),
        "conv_w": torch.full((dc, di), 0.1, **kw),
        "conv_b": torch.zeros(di, **kw),
        "A_log": torch.zeros(nh, **kw),
        "dt_bias": torch.zeros(nh, **kw),
        "D": torch.ones(nh, **kw),
        "norm_g": torch.ones(di, **kw),
        "out_proj": L.dense_init(gen, di, d, **kw),
    }


def _ssd_scan(dt, xh, bf, cf, a, h, c: int):
    """Mamba2's chunked SSD: within a chunk the per-head scalar decay
    turns the recurrence into masked [c, c] score products, and only the
    chunk-boundary state is carried. dt [B, S, nh], xh [B, S, nh, hd], bf,
    cf [B, S, ds], a [nh], h [B, nh, hd, ds] -> (y [B, S, nh, hd], h)."""
    s = dt.shape[1]
    pad = (-s) % c
    dt, xh, bf, cf = (_pad_seq(t, pad) for t in (dt, xh, bf, cf))
    ys = []
    for c0 in range(0, s + pad, c):
        dt_c, x_c = dt[:, c0:c0 + c], xh[:, c0:c0 + c]
        b_c, c_c = bf[:, c0:c0 + c], cf[:, c0:c0 + c]
        cum = torch.cumsum(dt_c * a, dim=1)                  # [B,c,nh], <= 0
        cb = torch.einsum("btz,bsz->bts", c_c, b_c)
        w = _segment_weights(cum)                            # [B,t,s,nh]
        dtx = dt_c[..., None] * x_c                          # [B,s,nh,hd]
        y_c = torch.einsum("bts,btsh,bshp->bthp", cb, w, dtx)
        y_c = y_c + torch.einsum("btz,bhpz,bth->bthp", c_c, h,
                                 torch.exp(cum))
        wend = torch.exp(cum[:, -1:, :] - cum)
        h = (torch.exp(cum[:, -1])[:, :, None, None] * h
             + torch.einsum("bshp,bsz,bsh->bhpz", dtx, b_c, wend))
        ys.append(y_c)
    return torch.cat(ys, dim=1)[:, :s], h


def mamba2_apply(p: Params, x: torch.Tensor, cfg, *, cache=None, quant=None,
                 token_valid=None):
    """x [B, S, D] -> (y [B, S, D], cache updated in place or None)."""
    b, s, _ = x.shape
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = di // nh
    tbl = L.make_table(x, quant) if "qw" in p["in_proj"] else None
    proj = L.lut_dense(p["in_proj"], x, quant, tbl)
    xp, z = proj[..., :di], proj[..., di:2 * di]
    bmat, cmat = proj[..., 2 * di:2 * di + ds], proj[..., 2 * di + ds:
                                                     2 * di + 2 * ds]
    dt = proj[..., 2 * di + 2 * ds:]

    conv_state = None if cache is None else cache["conv"]
    xc, new_conv = _causal_dwconv(xp, p["conv_w"], p["conv_b"], conv_state,
                                  valid=token_valid)
    xc = _silu(xc.to(torch.float32))  # stays f32, as in the reference

    dt = _softplus(dt.to(torch.float32)
                   + p["dt_bias"].to(torch.float32))          # [B, S, nh]
    dt = _mask_dt(dt, token_valid)
    a = -torch.exp(p["A_log"].to(torch.float32))              # [nh]
    xh = xc.reshape(b, s, nh, hd)
    bf, cf = bmat.to(torch.float32), cmat.to(torch.float32)

    h0 = (torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
          if cache is None else cache["ssm"].to(torch.float32))
    if s == 1:
        decay1 = torch.exp(dt[:, 0] * a)[:, :, None, None]
        inp1 = ((dt[:, 0, :, None] * xh[:, 0])[..., None]
                * bf[:, 0, None, None, :])
        h_end = decay1 * h0 + inp1
        y = torch.einsum("bhpz,bz->bhp", h_end, cf[:, 0])[:, None]
    else:
        y, h_end = _ssd_scan(dt, xh, bf, cf, a, h0, min(cfg.ssm_chunk, s))
    y = y + p["D"].to(torch.float32)[None, None, :, None] * xh
    y = y.reshape(b, s, di)
    y = y * _silu(z.to(torch.float32))  # gated
    # RMSNorm over all of d_inner before out_proj (mamba2 style)
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * p["norm_g"].to(torch.float32)
    y = L.lut_dense(p["out_proj"], y.to(x.dtype), quant)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h_end)
    return y, cache
