"""Decoder-only dense transformer (llama family).

embedding → L × block (a Python loop over the per-layer param dicts, the
counterpart of the reference's ``lax.scan`` over stacked layers) → final
norm → LM head; ``lm_loss`` is the training loss.

Under a model-axis mesh (``distributed.sharding``) the embedding table and
the LM head are split over the vocab: a rank looks up the tokens in its
rows and the ranks' rows are summed (one nonzero term a token: exact),
and each rank's logits of its vocab block are gathered, so every rank
returns the whole logits and samples the same token. Under a data axis a
rank's forward takes its own rows of the batch (the engine's slots); the
mesh's one-device control (``"rows"``: D in the tree,
``sharding.one_device_control``) runs a batch D divides as D row blocks
in turn (``row_blocks``).

Training under a mesh: the embedding's and the head's collectives carry
gradients (``collectives``); under an FSDP plan (ZeRO-3) the embedding,
each layer and the head gather their data-axis blocks just before they
run (``collectives.fsdp_gather_tree``), and a layer runs under
``torch.utils.checkpoint``, so its gathered weights are dropped after its
forward and gathered again for its backward: no rank holds the whole
float model outside one layer, the embedding and the head.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (current_plan, local_kv_heads,
                                              model_split, plan_scope)
from repro_torch.models import kvcache, layers as L

Params = Dict[str, Any]


def embed_init(gen, vocab: int, d_model: int, dtype=torch.float32,
               device=None) -> Params:
    t = torch.randn(vocab, d_model, generator=gen, device=device,
                    dtype=torch.float32).mul_(0.02)  # in place: no copy
    return {"table": t.to(dtype)}


def embed_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    p = collectives.fsdp_gather_tree(p)
    table = p["table"]
    if p.get("tp") != "vocab":
        return table[tokens]
    # this rank's vocab rows [r·V/m, (r+1)·V/m): its tokens' rows, zeros
    # for the others, summed over the ranks in f32 (exact)
    v = table.shape[0]
    local = tokens - model_split().rank_along("model") * v
    inside = (local >= 0) & (local < v)
    rows = table[local.clamp(0, v - 1)].to(torch.float32)
    rows = torch.where(inside[..., None], rows, 0.0)
    return collectives.all_reduce(rows, "sum").to(table.dtype)


def head_apply(p: Params, h: torch.Tensor, quant=None) -> torch.Tensor:
    """Logits [.., V]; a vocab-split head's blocks gathered in rank order."""
    p = collectives.fsdp_gather_tree(p)
    if p.get("tp") == "col":
        h = collectives.replicated_input(h)
    y = L.lut_dense(p, h, quant)
    return collectives.all_gather(y, dim=-1) if p.get("tp") == "col" else y


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None, *,
            tokens: Optional[int] = None) -> torch.Tensor:
    """Token-mean cross entropy in f32; with ``mask`` the mean over the
    masked-in tokens (at least one). ``tokens``: the NLL sum over these
    logits divided by that count instead (a data rank's share of the
    whole batch's token mean)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if tokens is not None:
        return nll.sum() / tokens
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def block_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    return {
        "attn_norm": L.norm_init(cfg.d_model, dtype, device),
        "attn": L.attention_init(gen, cfg, dtype=dtype, device=device),
        "mlp_norm": L.norm_init(cfg.d_model, dtype, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                          device=device),
    }


def _norm(p: Params, h: torch.Tensor, cfg, cache_pos) -> torch.Tensor:
    """RMS norm; a per-slot burst (the speculative verify forward) is
    normalised one position at a time, so each call holds a decode step's
    rows: a GPU reduction's summation order follows the row count."""
    if torch.is_tensor(cache_pos) and h.shape[1] > 1:
        return torch.cat([L.rms_norm(p, h[:, j:j + 1].contiguous(),
                                     cfg.norm_eps)
                          for j in range(h.shape[1])], dim=1)
    return L.rms_norm(p, h, cfg.norm_eps)


def block_apply(p: Params, h: torch.Tensor, cfg, *, cache=None, cache_pos=0,
                quant=None, page_table=None, window=None):
    a, cache = L.attention_apply(
        p["attn"], _norm(p["attn_norm"], h, cfg, cache_pos), cfg,
        kv_cache=cache, cache_pos=cache_pos, quant=quant,
        page_table=page_table, window=window)
    h = h + a
    m = L.mlp_apply(p["mlp"], _norm(p["mlp_norm"], h, cfg, cache_pos), quant)
    return h + m, cache


def stack_apply(layers, h: torch.Tensor, cfg, *, caches=None, cache_pos=0,
                quant=None, page_table=None, window=None):
    """The layer loop; layer l reads and writes ``caches[*][l]`` in place.
    ``page_table`` ([B, nb], paged caches) is one table for all layers."""
    plan = current_plan()
    zero3 = (plan is not None and plan.fsdp is not None and caches is None
             and torch.is_grad_enabled())
    for i, lp in enumerate(layers):
        if zero3:  # gathered in the forward, again in the backward
            h = checkpoint(functools.partial(_gathered_block, lp, cfg=cfg,
                                             quant=quant, window=window,
                                             plan=plan),
                           h, use_reentrant=False)
            continue
        lp = collectives.fsdp_gather_tree(lp)
        lc = None if caches is None else kvcache.layer_cache(caches, i)
        h, _ = block_apply(lp, h, cfg, cache=lc, cache_pos=cache_pos,
                           quant=quant, page_table=page_table, window=window)
    return h, caches


def _gathered_block(lp: Params, h: torch.Tensor, *, cfg, quant, window,
                    plan):
    """One layer of an FSDP train forward: its blocks gathered, then run,
    under ``plan`` (its recomputation runs in the backward, on autograd's
    own thread where the card's backward runs)."""
    with plan_scope(plan):
        return block_apply(collectives.fsdp_gather_tree(lp), h, cfg,
                           quant=quant, window=window)[0]


def row_blocks(params: Params, tokens, caches=None, cache_pos=0,
               page_table=None):
    """The forward's arguments as the row blocks it runs in turn: D blocks
    of B / D rows where the tree is a data-axis control (``"rows"``: D)
    and D divides the batch, else one block holding the arguments
    themselves. A block's dense caches are the rows' views along the
    batch axis (1; written in place), a paged pool stays whole with the
    rows' page-table rows, a per-slot ``cache_pos`` keeps its rows."""
    d, b = params.get("rows", 1), tokens.shape[0]
    blk = dict(tokens=tokens, caches=caches, cache_pos=cache_pos,
               page_table=page_table)
    if d == 1 or b % d:
        return [blk]
    n, out = b // d, []
    for r in range(d):
        rows = slice(r * n, (r + 1) * n)
        out.append(dict(
            tokens=tokens[rows], page_table=(None if page_table is None
                                             else page_table[rows]),
            cache_pos=(cache_pos[rows] if torch.is_tensor(cache_pos)
                       and cache_pos.dim() == 1 else cache_pos),
            caches=(caches if caches is None or page_table is not None
                    else tuple(c.narrow(1, r * n, n) for c in caches))))
    return out


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
            caches=None, cache_pos=0, head: bool = True, page_table=None,
            token_valid=None, window=None):
    """(logits [B, S, V] or None, caches, aux). ``head=False`` stops before
    the final norm and LM head, for callers that need only the caches
    (prefill), where the reference's compiler drops the head as dead code.
    With ``page_table`` ([B, nb] int64) ``caches`` is a block pool
    (``kvcache`` module docstring). ``token_valid`` is accepted and
    ignored: a right-padded chunk's pad positions write K/V past the
    prompt, which decode overwrites before any query reads it. ``window``:
    sliding-window attention in every layer (``L.attention_apply``; a
    rolling cache from ``init_cache(..., window=)``). A data-axis control
    runs its row blocks in turn (``row_blocks``)."""
    blocks = row_blocks(params, batch["tokens"], caches, cache_pos,
                        page_table)
    if len(blocks) > 1:
        one = {k: v for k, v in params.items() if k != "rows"}
        outs = [forward(one, {"tokens": blk.pop("tokens")}, cfg, head=head,
                        window=window, **blk)[0] for blk in blocks]
        return (torch.cat(outs) if head else None), caches, {}
    h = embed_apply(params["embed"], batch["tokens"]).to(cfg.activation_dtype)
    h, caches = stack_apply(params["layers"], h, cfg, caches=caches,
                            cache_pos=cache_pos, quant=cfg.quant,
                            page_table=page_table, window=window)
    if not head:
        return None, caches, {}
    h = _norm(params["final_norm"], h, cfg, cache_pos)
    return head_apply(params["lm_head"], h, cfg.quant), caches, {}


def init_cache(cfg, batch: int, s_cache: int, dtype=torch.bfloat16,
               device=None, *, window=None):
    """The attention cache; under a mesh of this rank's KV heads
    (``sharding.local_kv_heads``)."""
    return kvcache.attn_cache(cfg.n_layers, batch, s_cache,
                              local_kv_heads(cfg), cfg.head_dim, dtype,
                              device, window=window)
