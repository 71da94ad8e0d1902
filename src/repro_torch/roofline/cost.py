"""Operations and bytes counted from shapes: the port's stand-in for the
reference's loop-aware HLO walker (``roofline/hlo_cost.py``), which has
no PyTorch analogue.

  * ``bound(nbytes, ops)``: the least time the card takes for a function,
    the larger of its bytes at the memory rate and its operations at the
    peak rate of their type (``hw``);
  * ``mpgemm_cost``: the bytes and operations of one call of each kernel
    path (``chip_smoke.py`` phase 3's bound: each input read once, each
    output written once; operations the function needs);
  * ``step_cost``: the useful operations and the least bytes of a model's
    decode step or prefill chunk (``PERF.md`` §3 states the formula).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.quantize import QuantizedWeight
from repro_torch.kernels.dequant_mpgemm import PASSES as DEQUANT_PASSES
from repro_torch.kernels.lut_mpgemm import F32_PASSES
from repro_torch.roofline import hw

__all__ = ["bound", "mpgemm_cost", "step_cost"]

# a cached K/V element's bytes: the serving engine's f32 cache
KV_BYTES = 4


def bound(nbytes: float, ops: Dict[str, float]) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of ``nbytes`` at the memory rate
    and Σ operations / peak rate of their type, and which one it is."""
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = sum(n / hw.PEAK_OPS[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mpgemm_cost(kernel: str, m: int, n: Optional[int] = 0, k: int = 0, *,
                table_quant: Optional[str] = "per_row", bits: int = 2,
                k_group: int = 4, row_scale_given: bool = True
                ) -> Tuple[int, Dict[str, int]]:
    """(bytes, {type: operations}) of one call of ``kernel`` on [M, K]
    activations and an [N, K] B-bit weight, packed codes and f32 scales.

    * ``lut_mpgemm`` (the staged lookup): the table [M, G·E] (INT8 codes
      and a row scale for per_row, f32 for None, codes and group scales
      for per_group), the packed weight, the f32 output; 2·M·N·K int8
      operations per_row, else the bf16 tensor-core operations it issues
      (``F32_PASSES`` bf16 terms an f32 value: 3 × 2·M·N·K);
    * ``fused_lut_mpgemm``: f32 activations (and the per_row row scale
      where given) in place of the table, plus the M·G·E·(k_group − 1) f32
      adds that build the table entries;
    * ``dequant_mpgemm``: f32 activations, the packed weight, the output;
      its ``PASSES`` (3) × 2·M·N·K bf16;
    * ``table_precompute``: f32 activations (and a given row scale) in,
      the table out; its entries' adds, the INT8 rounding and a computed
      scale's reduction in f32;
    * ``row_scale``: f32 activations in, M f32 scales out, M·K f32."""
    g, e, n = k // k_group, 1 << (k_group - 1), n or 0
    pk_bytes = n * math.ceil(k * bits / 8) + 4 * n
    out_bytes = 4 * m * n
    entry_ops = m * g * e * (k_group - 1)
    if table_quant == "per_row":
        lut_ops = {"int8": 2 * m * n * k}
    else:
        lut_ops = {"bf16": F32_PASSES * 2 * m * n * k}
    if kernel == "lut_mpgemm":
        table_bytes = {None: 4 * m * g * e, "per_row": m * g * e + 4 * m,
                       "per_group": m * g * e + 4 * m * g}[table_quant]
        return table_bytes + pk_bytes + out_bytes, lut_ops
    if kernel == "fused_lut_mpgemm":
        given = table_quant == "per_row" and row_scale_given
        return (4 * m * k + (4 * m if given else 0) + pk_bytes + out_bytes,
                dict(lut_ops, f32=entry_ops))
    if kernel == "dequant_mpgemm":
        return (pk_bytes + 4 * m * k + out_bytes,
                {"bf16": DEQUANT_PASSES * 2 * m * n * k})
    if kernel == "table_precompute":
        given = table_quant == "per_row" and row_scale_given
        computed = table_quant == "per_group" or (
            table_quant == "per_row" and not given)
        out = (4 * m * g * e if table_quant is None else m * g * e + (
            4 * m * g if table_quant == "per_group" else 0 if given
            else 4 * m))
        return (4 * m * k + (4 * m if given else 0) + out,
                {"f32": entry_ops + (0 if table_quant is None else m * g * e)
                 + (m * k if computed else 0)})
    if kernel == "row_scale":
        return 4 * m * k + 4 * m, {"f32": m * k}
    raise ValueError(f"unknown kernel {kernel!r}")


# ---------------------------------------------------------------------------
# a model step
# ---------------------------------------------------------------------------

# subtrees a token-only step does not read: whisper's encoder, and every
# cross-attention's K and V projections (their K/V are cached)
_NOT_PER_TOKEN = ("enc_layers", "enc_norm")
_CROSS_KV = ("wk", "wv")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _qw_bytes(qw: QuantizedWeight) -> int:
    return sum(_nbytes(t) for t in (qw.packed, qw.cw, qw.scale,
                                    qw.zero_prime) if t is not None)


def _walk(node, path, visit):
    if isinstance(node, dict):
        for key, v in node.items():
            _walk(v, path + (key,), visit)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _walk(v, path + (str(i),), visit)
    else:
        visit(path, node)


def _param_terms(cfg, params, tokens: int, table_quant) -> Dict[str, float]:
    """Bytes a step reads of the params at least, and its projections'
    operations by type."""
    lut_type = "int8" if table_quant == "per_row" else "bf16"
    share = (min(cfg.top_k, cfg.num_experts) / cfg.num_experts
             if cfg.family == "moe" and cfg.num_experts else 1.0)
    uses = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 1)
    out = {"param_bytes": 0.0, "weights": 0.0, lut_type: 0.0, "f32": 0.0}

    def visit(path, leaf):
        if any(p in _NOT_PER_TOKEN for p in path) or (
                "xattn" in path and path[-2 if path[-1] in ("w", "b", "qw")
                                         else -1] in _CROSS_KV):
            return
        expert = "experts" in path
        frac = share if expert else 1.0
        times = uses if path[0] == "shared" else 1
        if isinstance(leaf, QuantizedWeight):
            w = leaf.n * leaf.k_total * (leaf.experts or 1) * frac
            out["param_bytes"] += _qw_bytes(leaf) * frac
            out["weights"] += w * times
            out[lut_type] += 2 * w * times * tokens
        elif torch.is_tensor(leaf):
            if path[-1] == "table" or path[0] == "pos_embed":
                # an embedding reads the tokens' rows only
                out["param_bytes"] += tokens * leaf.shape[-1] * (
                    leaf.element_size())
                return
            out["param_bytes"] += _nbytes(leaf) * frac
            if leaf.dim() >= 2 and (path[-1] == "w" or expert):
                w = leaf.numel() * frac
                out["weights"] += w * times
                out["f32"] += 2 * w * times * tokens
    _walk(params, (), visit)
    return out


def _attention_layers(cfg):
    """(self-attention layers, [(cross layers, keys each)])."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every, []
    if cfg.family == "ssm":
        return 0, []
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.xattn_every
        return cfg.n_layers - n_cross, [(n_cross, cfg.n_image_tokens)]
    if cfg.family == "audio":
        return cfg.n_layers, [(cfg.n_layers, cfg.n_audio_frames)]
    return cfg.n_layers, []


def _state_bytes(cfg) -> int:
    """A slot's SSM state (f32): conv and recurrent state of every Mamba
    layer."""
    if cfg.family == "ssm":
        per = (cfg.d_conv - 1) * cfg.d_inner + cfg.d_inner * cfg.ssm_state
        return 4 * cfg.n_layers * per
    if cfg.family == "hybrid":
        hd = cfg.d_inner // cfg.ssm_heads
        per = ((cfg.d_conv - 1) * cfg.d_inner
               + cfg.ssm_heads * hd * cfg.ssm_state)
        return 4 * cfg.n_layers * per
    return 0


def step_cost(cfg, params, batch: int,
              context: Union[int, Sequence[int]], kind: str = "decode", *,
              chunk: int = 128,
              table_quant: Optional[str] = "per_row") -> Dict[str, float]:
    """The useful operations and the least bytes of one step of ``batch``
    slots: a decode step (one token a slot) or a prefill chunk (``chunk``
    tokens a slot). ``context``: the positions each slot holds in its
    cache before the step (one int for all, or one a slot). K/V elements
    are the engine's f32 ones (``KV_BYTES``).

    * operations: 2 × the weights a token passes through × tokens, by type
      (packed projections ``int8`` under per_row tables, else ``bf16``; f32
      projections ``f32``), the hybrid's shared block once per invocation,
      an MoE layer's experts at top_k of num_experts; plus attention's
      4 · keys · n_heads · head_dim a query and layer (f32), cross
      attention over its cached keys;
    * bytes: the param tree as stored, each tensor once (an embedding: the
      tokens' rows; an MoE layer's experts at top_k / num_experts, the
      least a step can read; a token-only step reads no encoder and no
      cross K/V projection), plus the attention K/V read once and the new
      tokens' K/V written once, plus the SSM state read and written.
    Exact for the dense family."""
    if kind not in ("decode", "prefill"):
        raise ValueError(f"kind {kind!r}: 'decode' or 'prefill'")
    per_slot = 1 if kind == "decode" else chunk
    ctx = [context] * batch if isinstance(context, int) else list(context)
    if len(ctx) != batch:
        raise ValueError(f"{len(ctx)} contexts for {batch} slots")
    tokens = batch * per_slot
    terms = _param_terms(cfg, params, tokens, table_quant)
    n_self, cross = _attention_layers(cfg)
    hd, kvh = cfg.head_dim, cfg.n_kv_heads
    keys_read = keys_attended = 0
    for c in ctx:
        keys_read += c + per_slot  # positions after the step
        keys_attended += sum(q + 1 for q in range(c, c + per_slot))
    kv_read = n_self * keys_read * 2 * kvh * hd * KV_BYTES
    kv_write = n_self * tokens * 2 * kvh * hd * KV_BYTES
    attn_ops = 4 * n_self * keys_attended * cfg.n_heads * hd
    for layers, keys in cross:
        kv_read += layers * batch * keys * 2 * kvh * hd * KV_BYTES
        attn_ops += 4 * layers * tokens * keys * cfg.n_heads * hd
    state = 2 * batch * _state_bytes(cfg)
    ops = {k: terms[k] for k in ("int8", "bf16", "f32") if k in terms}
    ops["f32"] = ops.get("f32", 0.0) + attn_ops
    min_bytes = terms["param_bytes"] + kv_read + kv_write + state
    return {"tokens": tokens, "weights_per_token": terms["weights"],
            "param_bytes": terms["param_bytes"], "kv_read_bytes": kv_read,
            "kv_write_bytes": kv_write, "state_bytes": state,
            "min_bytes": min_bytes, "ops": ops,
            "model_flops": float(sum(ops.values()))}
