"""Per-slot decoding modes of the continuous-batching engine.

The engine serves every slot of its pool in one decode loop, so a
request's decoding mode is per-slot device state, like its sampling
params, and the step functions here are vectorized over the pool:

  * the **mode registry**: ``parse("beam:4")`` / ``parse("spec:draft2b")``
    turn a request's ``decoding`` string into a :class:`DecodingMode`; its
    ``kind`` is the integer the engine keeps per slot;
  * **beam_select**: one beam expansion for every beam group of the pool;
  * **speculative_accept**: rejection sampling over a drafted token block,
    with greedy rows reduced to exact argmax agreement, so greedy
    speculation emits plain greedy decoding's tokens.

Kinds:
  * ``NORMAL``: greedy / temperature / top-k / top-p sampling, one token a
    step;
  * ``BEAM``: width-W beam search. The W hypotheses hold W pool slots with
    one ``beam_group`` id (the leader's slot index); each step every member
    becomes one of the group's W best continuations, and the engine copies
    caches to match. Sampling params are ignored;
  * ``SPEC``: self-speculative decoding. The draft model is the same packed
    weight read at fewer bit-planes (``models.quantized.plane_sliced_params``,
    paper §3.1.2: a B-bit packed weight is a sum of ±1 planes, so its top
    planes are a coarser model at no extra weight bytes). The engine drafts
    K tokens with it, verifies them and a bonus position in one s = K + 1
    forward of the full model, and emits the longest accepted prefix plus
    one token.

Random draws come from an explicit ``torch.Generator``. Whether any row
samples is the caller's host-side knowledge (``sampling``), so no function
here makes the host wait for the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serving.sampler import categorical, uniform

__all__ = ["NORMAL", "BEAM", "SPEC", "DecodingMode", "parse", "beam_select",
           "speculative_accept", "rank_hypotheses", "stable_topk"]

NORMAL, BEAM, SPEC = 0, 1, 2

NEG = -1e30  # finite -inf stand-in: survives top-k and float adds


@dataclasses.dataclass(frozen=True)
class DecodingMode:
    """A parsed decoding request: its kind and static hyperparameters."""
    kind: int
    name: str
    beam_width: int = 1          # BEAM: pool slots the group holds
    draft_planes: int = 0        # SPEC: planes kept in the draft view

    def __post_init__(self):
        if self.kind == BEAM and self.beam_width < 1:
            raise ValueError(f"beam width must be >= 1, got {self.beam_width}")
        if self.kind == SPEC and self.draft_planes < 1:
            raise ValueError(
                f"spec draft needs >= 1 plane, got {self.draft_planes}")


def parse(spec: str) -> DecodingMode:
    """A request's or the CLI's decoding string as a :class:`DecodingMode`.

    Grammar: ``greedy`` | ``sample`` | ``beam[:W]`` | ``spec[:draft<N>b]``
    (also ``spec:N``). Defaults: beam width 4, draft 2 planes.
    """
    s = spec.strip().lower()
    head, _, arg = s.partition(":")
    if head in ("greedy", "sample"):
        if arg:
            raise ValueError(f"decoding {spec!r}: {head} takes no argument")
        return DecodingMode(NORMAL, head)
    if head == "beam":
        return DecodingMode(BEAM, "beam", beam_width=int(arg) if arg else 4)
    if head == "spec":
        planes = 2
        if arg:
            m = arg[len("draft"):] if arg.startswith("draft") else arg
            planes = int(m[:-1] if m.endswith("b") else m)
        return DecodingMode(SPEC, "spec", draft_planes=planes)
    raise ValueError(f"unknown decoding mode {spec!r} "
                     "(expected greedy | sample | beam[:W] | spec[:draftNb])")


# ---------------------------------------------------------------------------
# beam search: one expansion step over the whole pool
# ---------------------------------------------------------------------------

def stable_topk(x: torch.Tensor, k: int):
    """The k largest of each row, best first, the lower index first on a
    tie (``jax.lax.top_k``'s order; ``torch.topk`` promises none). Ties are
    common here: masked candidates and new members' scores all round to
    exactly ``NEG``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_select(cum_score, logp, live, group):
    """One beam expansion for every beam group in the pool, vectorized.

    Args:
      cum_score: [B] f32 cumulative hypothesis log-prob per slot.
      logp:      [B, V] f32 log-softmax of this step's logits.
      live:      [B] bool, the slot holds a still-expanding hypothesis.
      group:     [B] int beam-group id (the leader's slot index); < 0 for
                 slots that are not beam members.

    Returns ``(parent, token, score)``, each [B]: live slot ``b`` becomes
    the ``r``-th best continuation of its group, ``r`` being ``b``'s rank
    among the group's live slots (every member computes the same candidate
    list and takes its own rank). Other slots return themselves with their
    score unchanged.

    The candidate list is exact: each live slot offers its top ``min(B, V)``
    continuations, and a group of at most B live members needs at most B
    winners, even if one parent supplies all of them.
    """
    b, v = logp.shape
    wmax = min(b, v)
    total = torch.where(live[:, None], cum_score[:, None] + logp, NEG)
    vals, toks = stable_topk(total, wmax)                   # [B, Wmax]

    same = (group[:, None] == group[None, :]) & (group[:, None] >= 0)
    same = same & live[None, :]                             # b's live peers
    cand = torch.where(same[:, :, None], vals[None, :, :], NEG)
    cvals, cidx = stable_topk(cand.reshape(b, b * wmax), wmax)

    # rank of slot b among its group's live slots, by index
    idx = torch.arange(b, device=logp.device)
    rank = (same & (idx[None, :] < idx[:, None])).sum(dim=1)
    pick = torch.gather(cidx, 1, rank[:, None])[:, 0]
    parent_b = pick // wmax
    tok = toks[parent_b, pick % wmax]
    score = torch.gather(cvals, 1, rank[:, None])[:, 0]

    parent = torch.where(live, parent_b, idx)
    token = torch.where(live, tok, torch.zeros_like(tok))
    score = torch.where(live, score, cum_score)
    return parent, token, score


def rank_hypotheses(scores, lengths, alpha: float):
    """GNMT length-normalized final ranking: score / ((5 + len) / 6)^alpha,
    on the host; ``alpha = 0`` is the raw cumulative log-prob."""
    scores = np.asarray(scores, np.float64)
    lengths = np.maximum(np.asarray(lengths, np.float64), 1.0)
    return scores / ((5.0 + lengths) / 6.0) ** alpha


# ---------------------------------------------------------------------------
# self-speculation: accept or reject a drafted token block
# ---------------------------------------------------------------------------

def speculative_accept(gen, draft_toks, q_logits, p_logits, tgt_raw_argmax,
                       greedy, *, sampling: bool, rows=None):
    """Leviathan / Chen rejection sampling over a drafted block, vectorized.

    Args:
      gen:        ``torch.Generator`` for the accept coins and the residual
                  and bonus draws.
      draft_toks: [B, K] tokens proposed by the draft view.
      q_logits:   [B, K, V] draft logits after each slot's sampling mask
                  (``sampler.mask_logits``), or None when not ``sampling``.
      p_logits:   [B, K+1, V] masked target logits for the same positions
                  and the bonus position K, or None when not ``sampling``.
      tgt_raw_argmax: [B, K+1] argmax of the raw target logits. Greedy
                  agreement and replacement use it, not argmax(softmax):
                  plain greedy decoding takes the raw argmax, and a softmax
                  can round two near-ties onto one float.
      greedy:     [B] bool, the slot decodes greedily.
      sampling:   whether any row samples. False (every row greedy) takes
                  the argmax shortcut and draws nothing; the full branch
                  gives greedy rows the same values.
      rows:       (start, total) where the rows are a data rank's of a
                  batch of ``total``: the whole batch's noise is drawn
                  (``sampler.uniform``).

    Returns ``(accept, repl, bonus)``:
      accept [B, K] bool: draft token j survives verification;
      repl   [B, K]:      the token emitted at the first rejected j;
      bonus  [B]:         the extra token when every draft survives.

    Greedy rows accept iff the draft token is the target's argmax, and
    replace with it, so they emit plain greedy decoding's tokens. Sampling
    rows emit tokens distributed as the target's masked distribution
    (accept with probability min(1, p/q), else draw from max(p - q, 0)
    renormalized).
    """
    k = draft_toks.shape[1]
    tgt_argmax = tgt_raw_argmax[:, :k]
    acc_greedy = draft_toks == tgt_argmax
    if not sampling:
        return acc_greedy, tgt_argmax, tgt_raw_argmax[:, k]

    p_dist = torch.softmax(p_logits, dim=-1)               # [B, K+1, V]
    q_dist = torch.softmax(q_logits, dim=-1)               # [B, K, V]
    p_k = p_dist[:, :k]
    p_tok = torch.gather(p_k, -1, draft_toks[..., None])[..., 0]
    q_tok = torch.gather(q_dist, -1, draft_toks[..., None])[..., 0]
    u = uniform(gen, draft_toks.shape, draft_toks.device, rows)
    accept = torch.where(greedy[:, None], acc_greedy,
                         u * q_tok.clamp_min(1e-30) < p_tok)

    # residual max(p - q, 0); where it is all zero (p == q) draw from p
    res = (p_k - q_dist).clamp_min(0.0)
    mass = res.sum(dim=-1, keepdim=True)
    res = torch.where(mass > 0.0, res / mass.clamp_min(1e-30), p_k)
    r_stoch = categorical(gen, torch.log(res.clamp_min(1e-30)), rows)
    repl = torch.where(greedy[:, None], tgt_argmax, r_stoch)

    bonus_stoch = categorical(gen, torch.log(p_dist[:, k].clamp_min(1e-30)),
                              rows)
    bonus = torch.where(greedy, tgt_raw_argmax[:, k], bonus_stoch)
    return accept, repl, bonus
