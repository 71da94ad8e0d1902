"""Model API for the reference's six families (dense, MoE, SSM, hybrid,
VLM, audio): param init (float or packed serving weights), forward and
cache init, dispatched on ``cfg.family``.

``forward`` and ``init_cache`` take the mesh plan from
``distributed.sharding.plan_scope`` (params sharded by ``shard_params``):
the dense and MoE families serve across the model and data axes, the
dense family also trains there (an FSDP plan, or any plan under
``check_train_mesh``); MoE training under a mesh waits for ROADMAP.md
queue 1 item 9 step 3, and the others under any mesh raise a ValueError
naming step 8. A 1x1 plan is the single-device path."""

from __future__ import annotations

import torch

from repro_torch.configs.registry import ArchConfig
from repro_torch.distributed.sharding import current_plan, shard_params
from repro_torch.models import audio, hybrid, kvcache, layers as L, moe
from repro_torch.models import quantized, ssm, transformer, vlm


class _SsmLM:
    """The SSM LM (falcon-mamba): Mamba1 blocks in the standard stack, a
    namespace with ``transformer``'s interface (the reference's
    ``api._SsmLM``)."""

    @staticmethod
    def block_init(gen, cfg, dtype=torch.float32, device=None):
        return {"norm": L.norm_init(cfg.d_model, dtype, device),
                "ssm": ssm.mamba_init(gen, cfg, dtype, device)}

    @staticmethod
    def forward(params, batch, cfg, *, caches=None, cache_pos=0,
                head: bool = True, page_table=None, token_valid=None,
                window=None):
        """(logits or None, caches, aux). The state is O(1) a slot:
        nothing is paged, ``cache_pos``, ``page_table`` and ``window`` go
        unread (no attention), as in the reference."""
        h = transformer.embed_apply(params["embed"], batch["tokens"]).to(
            cfg.activation_dtype)
        for i, lp in enumerate(params["layers"]):
            lc = None if caches is None else {k: v[i]
                                              for k, v in caches.items()}
            y, _ = ssm.mamba_apply(lp["ssm"], L.rms_norm(lp["norm"], h,
                                                         cfg.norm_eps),
                                   cfg, cache=lc, quant=cfg.quant,
                                   token_valid=token_valid)
            h = h + y
        if not head:
            return None, caches, {}
        h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
        return (transformer.head_apply(params["lm_head"], h, cfg.quant),
                caches, {})

    @staticmethod
    def init_cache(cfg, batch, s_cache, dtype=torch.bfloat16, device=None,
                   *, window=None):
        return kvcache.mamba_cache(cfg.n_layers, batch, cfg.d_inner,
                                   cfg.ssm_state, cfg.d_conv, device)


_FAMILY = {"dense": transformer, "moe": moe, "ssm": _SsmLM,
           "hybrid": hybrid, "vlm": vlm, "audio": audio}


def resolve_device(name) -> torch.device:
    """The device to run on: a CUDA device must exist; only an explicit
    "cpu" runs on the CPU (the kernels' plain versions), never a silent
    fall back."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but no CUDA device is "
            "available; pass device='cpu' (--device cpu) to run the "
            "kernels' plain versions")
    return device


def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda", *,
                serve_quantized: bool = True, plan=None):
    """Random params from ``gen``, made on ``device`` (the card unless the
    caller asks for the CPU). With serve_quantized and a quant config,
    projections are packed per cfg.quant layer by layer, so full-width
    float weights never all exist at once. Layer stacks are lists of layer
    dicts (the hybrid's ``groups``: G lists of ``attn_every`` layers; the
    VLM's ``self_groups``: G lists of ``xattn_every - 1``, beside its G
    ``xattn_layers``; whisper's ``enc_layers`` and ``dec_layers``). The
    VLM's gates are 0.0, as the reference's init leaves them.

    With a mesh ``plan`` (the dense and MoE families; an FSDP plan, the
    dense family's float training build, also cuts each float weight to
    its data-axis block) this rank's blocks alone: the embedding, each
    layer once packed, and the head are cut to the rank's blocks
    (``sharding.shard_params`` on that subtree) before
    the next is drawn, in the whole build's order of draws, so the tree
    equals ``shard_params(init_params(...), plan, cfg)`` leaf for leaf and
    the device never holds more than the rank's shard and one float
    subtree."""
    device = resolve_device(device)
    dtype = cfg.param_dtype
    pack = serve_quantized and cfg.quant
    if plan is not None:
        _check_mesh(cfg, plan)

    def cut(key, node):
        """``node`` as this rank's blocks, at the path ``key`` (its index
        in a stack changes no rule)."""
        if plan is None:
            return node
        return shard_params({key: node}, plan, cfg)[key]

    def finish(tree):
        tree = quantized.quantize_params(tree, cfg.quant) if pack else tree
        return cut("layers", [tree])[0]

    params = {
        "embed": cut("embed", transformer.embed_init(
            gen, cfg.vocab_size, cfg.d_model, dtype, device)),
        "final_norm": L.norm_init(cfg.d_model, dtype, device),
    }
    if cfg.family == "moe":
        # one layer's float experts at a time: olmoe-1b-7b's are 1.6 GB
        params["layers"] = [
            finish(moe.block_init(gen, cfg, dtype, device))
            for _ in range(cfg.n_layers - cfg.first_dense_layers)]
        if cfg.first_dense_layers:
            params["dense_layers"] = [
                finish(moe.dense_block_init(gen, cfg, dtype, device))
                for _ in range(cfg.first_dense_layers)]
    elif cfg.family == "ssm":
        params["layers"] = [finish(_SsmLM.block_init(gen, cfg, dtype, device))
                            for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_groups, tail = divmod(cfg.n_layers, cfg.attn_every)
        layer = lambda: finish(hybrid.mamba_layer_init(gen, cfg, dtype,
                                                       device))
        params["groups"] = [[layer() for _ in range(cfg.attn_every)]
                            for _ in range(n_groups)]
        if tail:
            params["tail"] = [layer() for _ in range(tail)]
        params["shared"] = finish(hybrid.shared_block_init(gen, cfg, dtype,
                                                           device))
    elif cfg.family == "vlm":
        n_groups = cfg.n_layers // cfg.xattn_every
        params["self_groups"] = [
            [finish(transformer.block_init(gen, cfg, dtype, device))
             for _ in range(cfg.xattn_every - 1)] for _ in range(n_groups)]
        params["xattn_layers"] = [
            finish(vlm.xattn_layer_init(gen, cfg, dtype, device))
            for _ in range(n_groups)]
    elif cfg.family == "audio":
        params["pos_embed"] = (torch.randn(
            cfg.max_positions, cfg.d_model, generator=gen, device=device,
            dtype=torch.float32) * 0.01).to(dtype)
        params["enc_layers"] = [
            finish(audio.enc_layer_init(gen, cfg, dtype, device))
            for _ in range(cfg.enc_layers)]
        params["enc_norm"] = L.norm_init(cfg.d_model, dtype, device,
                                         bias=True)
        params["dec_layers"] = [
            finish(audio.dec_layer_init(gen, cfg, dtype, device))
            for _ in range(cfg.n_layers)]
        params["final_norm"] = L.norm_init(cfg.d_model, dtype, device,
                                           bias=True)
    else:
        params["layers"] = [
            finish(transformer.block_init(gen, cfg, dtype, device))
            for _ in range(cfg.n_layers)]
    head = {"lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                    dtype=dtype, device=device)}
    params["lm_head"] = cut("lm_head", (quantized.quantize_params(
        head, cfg.quant) if pack else head)["lm_head"])
    return params


MESH_FAMILIES = ("dense", "moe")
TRAIN_MESH_FAMILIES = ("dense",)


def splits(plan) -> bool:
    """Whether ``plan`` splits the model or the batch (a 1x1 plan or None
    is the single-device path)."""
    return plan is not None and (plan.axis_size("model") > 1
                                 or plan.axis_size("batch") > 1)


def _check_mesh(cfg: ArchConfig, plan=None):
    """Raise where ``plan`` (default: the active plan) splits the model or
    the batch and the family does not run under a mesh, or where it has an
    FSDP axis (a training plan) and the family does not train under
    one."""
    active = current_plan() if plan is None else plan
    if not splits(active):
        return
    if cfg.family not in MESH_FAMILIES:
        raise ValueError(
            f"{cfg.arch_id}: the {cfg.family} family does not run under a "
            "mesh yet (only dense and MoE do): ROADMAP.md queue 1 item 9 "
            "step 8")
    if active.axis_size("fsdp") > 1:
        check_train_mesh(cfg, active)


def check_train_mesh(cfg: ArchConfig, plan):
    """Raise where ``plan`` splits the model or the batch and the family
    does not train under a mesh: only the dense family does. MoE waits for
    the expert-parallel training path (the reference's per-data-shard
    routing, ``_moe_mlp_shardmap``, a different function from one
    device's): ROADMAP.md queue 1 item 9 step 3; the SSM, hybrid, VLM and
    audio families for step 8."""
    if not splits(plan) or cfg.family in TRAIN_MESH_FAMILIES:
        return
    step = ("3 (the expert-parallel training path, the reference's "
            "_moe_mlp_shardmap)" if cfg.family == "moe" else "8")
    raise ValueError(
        f"{cfg.arch_id}: the {cfg.family} family does not train under a "
        f"mesh yet (only dense does): ROADMAP.md queue 1 item 9 step {step}")


def forward(params, batch, cfg: ArchConfig, **kw):
    """(logits, caches, aux). ``token_valid`` ([B] real-token counts of a
    right-padded prefill chunk) is read by the SSM and hybrid families and
    ignored by the dense and MoE ones. ``window`` (sliding-window
    attention) applies to every family's self-attention; the SSM family
    has none and ignores it."""
    _check_mesh(cfg)
    return _FAMILY[cfg.family].forward(params, batch, cfg, **kw)


def init_cache(cfg: ArchConfig, batch: int, s_cache: int, dtype=None,
               device="cuda", *, window=None):
    """The family's cache. ``dtype`` None follows ``cfg.kv_cache_dtype``,
    as the reference's does: "int8" gives the int8 attention cache
    (``kvcache.attn_cache``), anything else bf16. ``window``: the
    attention caches hold min(s_cache, window) positions, a rolling cache
    below s_cache (``shape("long_500k").window``)."""
    _check_mesh(cfg)
    if dtype is None:
        dtype = "int8" if cfg.kv_cache_dtype == "int8" else torch.bfloat16
    return _FAMILY[cfg.family].init_cache(cfg, batch, s_cache, dtype,
                                          resolve_device(device),
                                          window=window)
