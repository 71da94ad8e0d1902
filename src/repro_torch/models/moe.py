"""Mixture-of-Experts LM (olmoe, kimi-k2) with sort-based dispatch.

The port of the reference's ``models/moe.py`` (its single-device path, and
its quantized path under a mesh; the float experts' ``shard_map`` dispatch,
training's, is not ported). Routing is
token-choice top-k with an f32 router that is never quantized. Dispatch
builds no [T, E] one-hot: the T·k assignments are sorted by expert id
(stable, so a token's assignments and equal ids keep their order), each
assignment's position within its expert comes from the per-expert counts,
and the tokens are written into a capacity-bucketed [E, C, D] buffer;
assignments past an expert's capacity are dropped (their output is zero),
and kept ones never share a slot. The expert FFN runs on the [E, C, D]
buffer as one batched mpGEMM a projection (``core.mpgemm``: one launch of
a kernel's batched wrapper under ``lut_pallas``), every expert computed,
empty capacity included, as the reference's vmap computes them.

Determinism. The reference's combine (``y.at[tok].add``) adds each token's
k contributions in the sorted order, so in increasing expert id, starting
from zero. The port gathers them [T, k, D] in that order and adds over k
in a fixed loop: no atomics, so the same inputs give the same bits on the
card (a paged pool equals a dense one), and the sums are the reference's.
Nothing here waits for the card: counts come from a scatter-add, not
``bincount``, and dropped assignments go to a trash row, not through a
boolean mask.

Under a model-axis mesh (``distributed.sharding``: the expert stacks split
along E, ``experts["tp"] == "expert"``, the router replicated) every rank
routes all tokens and builds the whole [E, C, D] buffer, as the
reference's quantized path does, runs its E/m experts, and the ranks'
expert outputs are gathered in expert order: the combine is then the
single-device one, in the same order.

Under a data axis a rank holds its own rows of the batch, yet the
reference routes globally: its quantized experts never take the
``shard_map`` path, so capacity and drops come from all B·S tokens. So a
rank routes its tokens, gathers every data rank's top-k ids and weights
(one small int64 collective a layer: [T, 2k + E + 1] with the router's
probabilities and log-sum-exp for the aux losses, f32 bits carried as
int64), takes the global positions and capacity from them, and writes
only its own kept tokens into the [E, C, D] buffer. An expert FFN's rows
are independent, so each of its tokens gets one device's bits; the keep
mask is one device's. The mesh's one-device control routes its row
blocks together the same way (``moe_mlp_blocks``).

Aux outputs: the load-balance loss (Switch-style E·Σ f_e·P_e) and the
router-z loss, averaged over the MoE layers. A forward without its head
(``head=False``: prefill, caches only) skips them.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.core import mpgemm as mp
from repro_torch.core.quantize import fake_quant
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import data_split, model_split
from repro_torch.models import kvcache, layers as L
from repro_torch.models import transformer as TR

Params = Dict[str, Any]


def _expert_init(gen, e: int, d_in: int, d_out: int, dtype, device):
    w = torch.randn(e, d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32).div_(math.sqrt(d_in))  # no copy
    return w.to(dtype)


def moe_mlp_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    p = {
        # the router stays f32
        "router": {"w": torch.randn(d, e, generator=gen, device=device,
                                    dtype=torch.float32) * 0.02},
        "experts": {
            "gate": _expert_init(gen, e, d, f, dtype, device),
            "up": _expert_init(gen, e, d, f, dtype, device),
            "down": _expert_init(gen, e, f, d, dtype, device),
        },
    }
    if cfg.n_shared_experts:
        p["shared_mlp"] = L.mlp_init(gen, d, f * cfg.n_shared_experts,
                                     dtype=dtype, device=device)
    return p


def _capacity(t: int, k: int, e: int, factor: float) -> int:
    """Slots per expert: ⌈t·k·factor / e⌉ rounded up to 8, at least 8."""
    c = int(math.ceil(t * k * factor / e))
    return max(8, -(-c // 8) * 8)


def _expert_ffn(w: Params, x: torch.Tensor, quant) -> torch.Tensor:
    """The experts' SwiGLU FFN on the dispatch buffer x [E, C, D] ->
    [E, C, D]. Packed experts (``gate_qw`` ...) run one batched mpGEMM a
    projection, ``gate`` and ``up`` sharing one table where the plan at
    (C, D) is staged (§3.1.1: the fused kernel rebuilds its table on chip);
    float experts run batched f32 products of x and the weights rounded to
    x's dtype, fake-quantized along their contraction axis first under
    ``quant["qat"]`` (the training forward)."""
    if "gate_qw" in w:
        q = quant or {}
        mode = q.get("mpgemm_mode", "lut_xla")
        tq = q.get("table_quant", "per_row")
        kg = q.get("k_group", 4)
        fusion = q.get("fusion", "auto")
        # the tuning cache holds 2-D shapes: expert calls follow the auto
        # rule (``kernels.ops.resolve_dispatch``), so does the table
        rule = dict(q, fusion="auto") if fusion == "tuned" else q
        share = mode == "lut_xla" or (
            mode == "lut_pallas"
            and L.resolve_fusion(x.shape[1], x.shape[2], rule) == "staged")
        tbl = (mp.precompute_expert_tables(x, kg, tq, mode)
               if share else None)
        kw = dict(mode=mode, table_quant=tq, fusion=fusion)
        g = mp.mpgemm(x, w["gate_qw"], table=tbl, **kw)
        u = mp.mpgemm(x, w["up_qw"], table=tbl, **kw)
        h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
        return mp.mpgemm(h, w["down_qw"], **kw)

    def bmm(a, wt):
        if quant and quant.get("qat"):  # per expert and output channel
            wt = fake_quant(wt.transpose(1, 2), quant.get("weight_bits", 2),
                            quant.get("scheme", "symmetric")).transpose(1, 2)
        return torch.bmm(a.to(torch.float32),
                         wt.to(a.dtype).to(torch.float32)).to(a.dtype)

    g, u = bmm(x, w["gate"]), bmm(x, w["up"])
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return bmm(h, w["down"])


def moe_mlp_apply(p: Params, x: torch.Tensor, cfg, quant=None, *,
                  aux: bool = True, with_keep: bool = False):
    """x [B, S, D] -> (y [B, S, D], {"lb_loss", "router_z_loss"} or {}).
    Every one of the B·S tokens is routed and takes capacity, pad tokens
    too, as in the reference: t = B·S sets the capacity (under a data
    axis, the B·S tokens of every data rank). ``with_keep`` adds "keep":
    the [T, k] mask of the kept assignments, T the batch's tokens in
    every data rank."""
    ys, out = moe_mlp_blocks(p, [x], cfg, quant, aux=aux,
                             with_keep=with_keep)
    return ys[0], out


def _route(router: Params, xf: torch.Tensor, k: int, aux: bool):
    """(probs [T, E], top_p [T, k], top_i [T, k], lse [T] or None) of
    tokens xf [T, D] through the f32 router."""
    logits = xf.to(torch.float32) @ router["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # top-k as jax.lax.top_k: descending, the lower expert id first on ties
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    return probs, top_p, top_i, (torch.logsumexp(logits, dim=-1)
                                 if aux else None)


def _gather_routes(probs, top_p, top_i, lse):
    """Every data rank's routing, in data order: one int64 collective
    carrying the f32 values' bits."""
    f32 = lambda t: t.view(torch.int32).to(torch.int64)
    k, e = top_i.shape[1], probs.shape[1]
    parts = [top_i, f32(top_p)] + ([] if lse is None else
                                   [f32(probs), f32(lse[:, None])])
    g = collectives.all_gather(torch.cat(parts, dim=1), dim=0, axis="data")
    back = lambda t: t.to(torch.int32).view(torch.float32)
    return (None if lse is None else back(g[:, 2 * k:2 * k + e]),
            back(g[:, k:2 * k]), g[:, :k].contiguous(),
            None if lse is None else back(g[:, -1]))


def moe_mlp_blocks(p: Params, xs, cfg, quant=None, *, aux: bool = True,
                   with_keep: bool = False):
    """``moe_mlp_apply`` over the row blocks ``xs`` of one batch (each
    [b_r, S, D]) -> (their outputs, losses). One block is the batch, or
    under a data axis (``sharding.data_split``) this rank's rows, whose
    routing is gathered from every data rank; several are the mesh's
    control running the data ranks' blocks on one device. Each block's
    router and shared expert run at its row count; capacity, keep mask
    and dispatch are the whole batch's, and only the tokens held here are
    written into the expert buffer and combined."""
    e, k = cfg.num_experts, cfg.top_k
    d = xs[0].shape[-1]
    dev = xs[0].device
    xfs = [x.reshape(-1, d) for x in xs]
    routes = [_route(p["router"], xf, k, aux) for xf in xfs]
    xf = xfs[0] if len(xs) == 1 else torch.cat(xfs)
    probs, top_p, top_i, lse = routes[0] if len(xs) == 1 else (
        None if z[0] is None else torch.cat(z) for z in zip(*routes))
    t_own, lo = xf.shape[0], 0
    split = data_split()
    if split is not None:
        lo = split.rank_along("batch") * t_own
        probs, top_p, top_i, lse = _gather_routes(probs, top_p, top_i, lse)
    t = top_i.shape[0]

    # ---- sort-based dispatch ----------------------------------------------
    eid = top_i.reshape(-1)                               # [T·k]
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, eid, torch.ones_like(eid))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[sorted_eid]
    cap = _capacity(t, k, e, cfg.capacity_factor)
    keep = pos_in_e < cap
    slot = sorted_eid * cap + torch.clamp_max(pos_in_e, cap - 1)
    tok = order // k                                      # source token
    # kept assignments own distinct slots; dropped ones, and under a data
    # axis the other ranks' tokens, go to the trash row
    disp = torch.zeros(e * cap + 1, d, dtype=xf.dtype, device=dev)
    if t_own == t:
        disp[torch.where(keep, slot, e * cap)] = xf[tok]
    else:
        mine = (tok >= lo) & (tok < lo + t_own)
        disp[torch.where(keep & mine, slot, e * cap)] = xf[
            (tok - lo).clamp(0, t_own - 1)]
    buf = disp[:-1].reshape(e, cap, d)
    if p["experts"].get("tp") == "expert":  # this rank's E/m experts
        plan = model_split()
        el = e // plan.axis_size("model")
        r = plan.rank_along("model")
        out = collectives.all_gather(_expert_ffn(
            p["experts"], buf[r * el:(r + 1) * el], quant), dim=0)
    else:
        out = _expert_ffn(p["experts"], buf, quant)
    out = out.reshape(e * cap, d)

    # ---- combine: each token's k contributions in increasing expert id ----
    contrib = (torch.where(keep[:, None], out[slot], 0).to(torch.float32)
               * top_p.reshape(-1)[order][:, None])       # [T·k, D], sorted
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=dev)         # sorted position
    ranks = rank.reshape(t, k)
    if t_own != t:  # this rank's tokens
        ranks = ranks[lo:lo + t_own]
    picks = contrib[ranks.sort(dim=1).values]             # [T_own, k, D]
    y = torch.zeros(t_own, d, dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + picks[:, j]

    if "shared_mlp" in p:
        sh = [L.mlp_apply(p["shared_mlp"], x, quant) for x in xfs]
        y = y + (sh[0] if len(sh) == 1 else torch.cat(sh)).to(torch.float32)

    losses = {}
    if aux:
        f_e = counts.to(torch.float32) / (t * k) * e      # mean of one-hots
        p_e = probs.mean(dim=0)
        losses = {"lb_loss": e * torch.sum(f_e / e * p_e),
                  "router_z_loss": torch.square(lse).mean()}
    if with_keep:
        kept = torch.empty_like(keep)
        kept[order] = keep
        losses["keep"] = kept.reshape(t, k)
    ys = y.to(xs[0].dtype).split([xf_.shape[0] for xf_ in xfs])
    return [yb.reshape(x.shape) for yb, x in zip(ys, xs)], losses


# ---------------------------------------------------------------------------
# MoE block + LM
# ---------------------------------------------------------------------------

def block_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    return {
        "attn_norm": L.norm_init(cfg.d_model, dtype, device),
        "attn": L.attention_init(gen, cfg, dtype=dtype, device=device),
        "mlp_norm": L.norm_init(cfg.d_model, dtype, device),
        "moe": moe_mlp_init(gen, cfg, dtype, device),
    }


def dense_block_init(gen, cfg, dtype=torch.float32, device=None) -> Params:
    """A leading dense layer (kimi-k2's first): the dense block with the
    MLP width ``dense_d_ff``."""
    return TR.block_init(gen, cfg.replace(d_ff=cfg.dense_d_ff or cfg.d_ff),
                         dtype, device)


def _attention_half(p: Params, h: torch.Tensor, cfg, *, cache=None,
                    cache_pos=0, quant=None, page_table=None, window=None):
    """h + the block's attention; the cache is written in place."""
    a, _ = L.attention_apply(
        p["attn"], TR._norm(p["attn_norm"], h, cfg, cache_pos), cfg,
        kv_cache=cache, cache_pos=cache_pos, quant=quant,
        page_table=page_table, window=window)
    return h + a


def block_apply(p: Params, h: torch.Tensor, cfg, *, cache=None, cache_pos=0,
                quant=None, page_table=None, aux: bool = True, window=None):
    h = _attention_half(p, h, cfg, cache=cache, cache_pos=cache_pos,
                        quant=quant, page_table=page_table, window=window)
    m, losses = moe_mlp_apply(p["moe"],
                              TR._norm(p["mlp_norm"], h, cfg, cache_pos),
                              cfg, quant, aux=aux)
    return h + m, cache, losses


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg, *,
            caches=None, cache_pos=0, head: bool = True, page_table=None,
            token_valid=None, window=None):
    """(logits [B, S, V] or None, caches, aux), as ``transformer.forward``
    (``token_valid`` ignored, ``window`` in every layer, as there).
    Layer i of the caches is dense layer i for i < first_dense_layers, then
    the MoE layers in order. ``head=False`` stops before the final norm
    and LM head and computes no aux losses. A data-axis control's row
    blocks (``transformer.row_blocks``) run each layer in turn, and its
    MoE layers route them together (``moe_mlp_blocks``)."""
    blocks = TR.row_blocks(params, batch["tokens"], caches, cache_pos,
                           page_table)
    nd, quant = cfg.first_dense_layers, cfg.quant
    hs = [TR.embed_apply(params["embed"], b["tokens"]).to(
        cfg.activation_dtype) for b in blocks]

    def kw(b, i):
        return dict(cache=None if b["caches"] is None
                    else kvcache.layer_cache(b["caches"], i),
                    cache_pos=b["cache_pos"], quant=quant,
                    page_table=b["page_table"], window=window)

    for i, lp in enumerate(params.get("dense_layers", [])):
        hs = [TR.block_apply(lp, h, cfg, **kw(b, i))[0]
              for h, b in zip(hs, blocks)]
    lb = zl = 0.0
    for j, lp in enumerate(params["layers"]):
        hs = [_attention_half(lp, h, cfg, **kw(b, nd + j))
              for h, b in zip(hs, blocks)]
        xs = [TR._norm(lp["mlp_norm"], h, cfg, b["cache_pos"])
              for h, b in zip(hs, blocks)]
        if len(xs) == 1:
            m, losses = moe_mlp_apply(lp["moe"], xs[0], cfg, quant, aux=head)
            ms = [m]
        else:
            ms, losses = moe_mlp_blocks(lp["moe"], xs, cfg, quant, aux=head)
        hs = [h + m for h, m in zip(hs, ms)]
        if head:
            lb, zl = lb + losses["lb_loss"], zl + losses["router_z_loss"]
    if not head:
        return None, caches, {}
    logits = [TR.head_apply(params["lm_head"], TR._norm(
        params["final_norm"], h, cfg, b["cache_pos"]), quant)
        for h, b in zip(hs, blocks)]
    n_moe = cfg.n_layers - nd
    return (logits[0] if len(logits) == 1 else torch.cat(logits), caches,
            {"lb_loss": lb / n_moe, "router_z_loss": zl / n_moe})


def init_cache(cfg, batch: int, s_cache: int, dtype=torch.bfloat16,
               device=None, *, window=None):
    return TR.init_cache(cfg, batch, s_cache, dtype, device, window=window)
