"""Optimizers, the reference's (no torch.optim: the tests hold each update
against the reference's on the same trees).

  * ``adamw``      — the default; ``state_bits=8`` keeps m and v as INT8
                     codes with blockwise (2048) absmax f32 scales.
  * ``adafactor``  — factored second moments (rows + cols) for every leaf
                     whose last two dims are >= 128.
  * ``momentum``   — SGD + momentum (baseline).

API: ``opt = make_optimizer(name, lr=..., **kw)``; ``state = opt.init(params)``;
``params, state = opt.update(grads, state, params)``: new trees, the inputs
untouched. ``update(..., gnorm=)`` takes the gradients' global norm as
given (AdamW's clip reads it; a mesh's train step computes it over the
ranks' blocks, ``train_loop``); the others ignore it. ``lr`` is a float
or a function of the step tensor (``lr_schedule``). The step counter,
the bias corrections, Adafactor's decay and the schedule are f32 tensor
arithmetic, as in the reference (Python floats are f64 and would round
differently).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.table import true_divide
from repro_torch.core.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _lr_at(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def _pick(params, out, i: int):
    """Element ``i`` of the per-leaf result tuples of ``out`` (a tree shaped
    like ``params`` up to its leaves)."""
    return tree_map(lambda _, o: o[i], params, out)


# ---------------------------------------------------------------------------
# int8 state quantization (blockwise absmax)
# ---------------------------------------------------------------------------

_BLOCK = 2048


def _q8(x: torch.Tensor):
    """float -> (int8 codes [nb, 2048], f32 scales [nb, 1]), absmax a block."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blk = flat.reshape(-1, _BLOCK)
    s = true_divide(blk.abs().amax(dim=1, keepdim=True).clamp_min(1e-12),
                    127.0)
    q = torch.clamp(torch.round(blk / s), -127, 127).to(torch.int8)
    return q, s.to(torch.float32)


def _dq8(q: torch.Tensor, s: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * s).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


# ---------------------------------------------------------------------------
# AdamW (optionally with int8 m/v)
# ---------------------------------------------------------------------------

def adamw(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
          state_bits: Optional[int] = None, grad_clip: Optional[float] = 1.0):
    use_q8 = state_bits == 8

    def init(params):
        def zeros_like_state(p):
            z = torch.zeros_like(p, dtype=torch.float32)
            if use_q8 and p.numel() >= _BLOCK:
                q, s = _q8(z)
                return {"q": q, "s": s}
            return z
        return {"step": _step0(params),
                "m": tree_map(zeros_like_state, params),
                "v": tree_map(zeros_like_state, params)}

    @torch.no_grad()
    def update(grads, state, params, gnorm=None):
        step = state["step"] + 1
        if grad_clip is not None:
            gnorm = global_norm(grads) if gnorm is None else gnorm
            factor = torch.clamp_max(
                _f32(grad_clip, gnorm) / gnorm.clamp_min(1e-12), 1.0)
            grads = tree_map(lambda g: g * factor, grads)
        t = step.to(torch.float32)
        lr_t = _lr_at(lr, step)
        bc1 = 1 - _f32(b1, t) ** t
        bc2 = 1 - _f32(b2, t) ** t

        def upd(p, g, m, v):
            gf = g.to(torch.float32)
            mf = _dq8(m["q"], m["s"], p.shape) if isinstance(m, dict) else m
            vf = _dq8(v["q"], v["s"], p.shape) if isinstance(v, dict) else v
            mf = b1 * mf + (1 - b1) * gf
            vf = b2 * vf + (1 - b2) * torch.square(gf)
            u = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            newp = (p.to(torch.float32) - lr_t * u).to(p.dtype)
            if isinstance(m, dict):
                qm, sm = _q8(mf)
                qv, sv = _q8(vf)
                return newp, {"q": qm, "s": sm}, {"q": qv, "s": sv}
            return newp, mf, vf

        out = tree_map(upd, params, grads, state["m"], state["v"])
        return (_pick(params, out, 0),
                {"step": step, "m": _pick(params, out, 1),
                 "v": _pick(params, out, 2)})

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------

def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_threshold=1.0,
              min_dim_size_to_factor=128, weight_decay=0.0):
    def _factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def state_for(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"step": _step0(params), "v": tree_map(state_for, params)}

    @torch.no_grad()
    def update(grads, state, params, gnorm=None):
        step = state["step"] + 1
        t = step.to(torch.float32)
        lr_t = _lr_at(lr, step)
        beta2 = 1.0 - t ** _f32(-decay, t)

        def upd(p, g, s):
            gf = g.to(torch.float32)
            g2 = torch.square(gf) + eps
            if "vr" in s:
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
                denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps)
                vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                new_s = {"vr": vr, "vc": vc}
            else:
                vhat = beta2 * s["v"] + (1 - beta2) * g2
                new_s = {"v": vhat}
            u = gf / torch.sqrt(vhat + eps)
            # update clipping (Adafactor's RMS rule)
            rms = torch.sqrt(torch.square(u).mean() + 1e-12)
            u = u / torch.clamp_min(true_divide(rms, clip_threshold), 1.0)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * u).to(p.dtype), new_s

        out = tree_map(upd, params, grads, state["v"])
        return _pick(params, out, 0), {"step": step, "v": _pick(params, out, 1)}

    return Optimizer(init, update)


def momentum(lr=1e-2, beta=0.9, weight_decay=0.0):
    def init(params):
        return {"step": _step0(params),
                "m": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)}

    @torch.no_grad()
    def update(grads, state, params, gnorm=None):
        lr_t = _lr_at(lr, state["step"] + 1)

        def upd(p, g, m):
            mf = beta * m + g.to(torch.float32)
            u = mf + weight_decay * p.to(torch.float32) if weight_decay else mf
            return (p.to(torch.float32) - lr_t * u).to(p.dtype), mf

        out = tree_map(upd, params, grads, state["m"])
        return (_pick(params, out, 0),
                {"step": state["step"] + 1, "m": _pick(params, out, 1)})

    return Optimizer(init, update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)
    return torch.sqrt(total)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adamw8bit":
        return adamw(state_bits=8, **kw)
    if name == "adafactor":
        return adafactor(**kw)
    if name == "momentum":
        return momentum(**kw)
    raise ValueError(f"unknown optimizer {name!r}")


def lr_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup + cosine decay, an f32 function of the step tensor."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = true_divide(s, float(max(warmup, 1)))
        prog = torch.clamp(true_divide(s - warmup, float(max(total - warmup,
                                                              1))), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return fn
