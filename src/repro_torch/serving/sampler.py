"""Token samplers: greedy / temperature / top-k / top-p.

Parameters are python scalars or per-slot [B] tensors. Sentinels, as in
the reference: ``temperature <= 0`` is greedy for that slot, ``top_k == 0``
disables top-k, ``top_p >= 1`` disables the nucleus cut. Random draws come
from an explicit ``torch.Generator`` (Gumbel-max over the masked logits),
so no call here waits for the device. ``rows`` (start, total): the rows
given are rows start.. of a batch of ``total`` split over data ranks;
the whole batch's noise is drawn and these rows kept, so a row draws
what it draws on one device and every later draw stays in step.
"""

from __future__ import annotations

import torch


def _static_scalars(*vals) -> bool:
    return all(isinstance(v, (int, float)) for v in vals)


def _per_row(val, b, dtype, device):
    return torch.as_tensor(val, dtype=dtype, device=device).expand(b)


def mask_logits(logits, *, temperature=0.0, top_k=0, top_p=1.0):
    """Temperature-scale then top-k/top-p mask logits per row: [B, V] ->
    f32 [B, V] with ``-inf`` outside the kept set. Greedy rows are scaled
    by 1; ``top_k`` clips to [1, V]."""
    lf = logits.to(torch.float32)
    b, v = lf.shape
    dev = lf.device
    temp = _per_row(temperature, b, torch.float32, dev)
    tk = _per_row(top_k, b, torch.int64, dev)
    tp = _per_row(top_p, b, torch.float32, dev)
    x = lf / torch.where(temp > 0.0, temp, 1.0)[:, None]
    if _static_scalars(top_k, top_p) and top_k <= 0 and top_p >= 1.0:
        return x
    k_eff = torch.clamp(torch.where(tk > 0, tk, v), 1, v)
    x_desc = torch.sort(x, dim=-1, descending=True).values
    kth = torch.gather(x_desc, 1, (k_eff - 1)[:, None])
    xm = torch.where(x < kth, -torch.inf, x)
    # top-p on the top-k-masked logits: the masked entries are exactly the
    # tail of x_desc, so no second sort is needed
    n_kept = (x_desc >= kth).sum(dim=-1, keepdim=True)
    x_desc = torch.where(torch.arange(v, device=dev)[None, :] < n_kept,
                         x_desc, -torch.inf)
    cum = torch.cumsum(torch.softmax(x_desc, dim=-1), dim=-1)
    cutoff_idx = torch.clamp((cum < tp[:, None]).sum(dim=-1), 0, v - 1)
    cutoff = torch.gather(x_desc, 1, cutoff_idx[:, None])
    return torch.where((xm < cutoff) & (tp[:, None] < 1.0), -torch.inf, xm)


def uniform(gen: torch.Generator, shape, device, rows=None):
    """U[0, 1) noise of ``shape``; with ``rows`` (start, total) the rows
    start.. of the noise of a [total, ...] batch."""
    if rows is None:
        return torch.rand(shape, generator=gen, device=device)
    start, total = rows
    return torch.rand((total,) + tuple(shape[1:]), generator=gen,
                      device=device)[start:start + shape[0]]


def categorical(gen: torch.Generator, logits, rows=None):
    """One draw per row from softmax(logits) over the last axis
    (Gumbel-max)."""
    u = uniform(gen, logits.shape, logits.device, rows)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample(gen: torch.Generator, logits, *, temperature=0.0, top_k=0,
           top_p=1.0, rows=None):
    """logits [B, V] -> tokens [B] (int64)."""
    lf = logits.to(torch.float32)
    greedy = torch.argmax(lf, dim=-1)
    if _static_scalars(temperature, top_k, top_p) and temperature <= 0.0:
        return greedy
    x = mask_logits(lf, temperature=temperature, top_k=top_k, top_p=top_p)
    sampled = categorical(gen, x, rows)
    temp = _per_row(temperature, lf.shape[0], torch.float32, lf.device)
    return torch.where(temp <= 0.0, greedy, sampled)
