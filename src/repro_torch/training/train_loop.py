"""Train-step factory: the QAT forward (the paper's technique in training),
microbatch gradient accumulation and the int8 gradient-compression hook.

``make_train_step(cfg, opt, ...)`` returns ``(state, batch) -> (state,
metrics)``: a new state (the input state is not modified), metrics as 0-dim
tensors on the device. The batch is numpy arrays or tensors; they are moved
to the params' device. Every family of the registry trains, as in the
reference: the VLM's batch carries ``image_embeds`` and whisper's
``audio_frames`` beside the tokens. The shardings of the reference's
``train_shardings`` wait for a mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.registry import ArchConfig
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.distributed import compression
from repro_torch.models import api
from repro_torch.models.transformer import lm_loss
from repro_torch.training.optimizer import Optimizer, global_norm

TrainState = Dict[str, Any]  # {"params", "opt", "step"} (+ "ef")


def make_loss_fn(cfg: ArchConfig, lb_coef=0.01, z_coef=0.001):
    """(params, batch) -> (loss, metrics): the token-mean cross entropy,
    plus ``lb_coef``·lb_loss + ``z_coef``·router_z_loss where the forward
    returns them (MoE)."""
    def loss_fn(params, batch):
        logits, _, aux = api.forward(params, batch, cfg)
        loss = lm_loss(logits, batch["labels"])
        metrics = {"lm_loss": loss}
        if "lb_loss" in aux:
            loss = loss + lb_coef * aux["lb_loss"] + z_coef * aux["router_z_loss"]
            metrics.update(aux)
        metrics["loss"] = loss
        return loss, metrics
    return loss_fn


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The batch on ``device``: integer entries (tokens, labels) as int64,
    floating ones (the frontends' image embeddings and audio frames) as
    f32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        dtype = torch.float32 if t.is_floating_point() else torch.int64
        out[k] = t.to(device=device, dtype=dtype)
    return out


def make_train_step(
    cfg: ArchConfig,
    opt: Optimizer,
    *,
    microbatches: int = 1,
    grad_compression: Optional[str] = None,  # None | "int8"
    qat: bool = True,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Build the train step. QAT fake-quant is applied when the config has a
    quant block (paper §5: the mpGEMM technique on the training forward)."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression {grad_compression!r}: None or "
                         "'int8'")
    if qat and cfg.quant:
        cfg = cfg.with_quant(qat=True)
    loss_fn = make_loss_fn(cfg)

    def single(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return (tree_unflatten(params, list(grads)),
                {k: v.detach() for k, v in metrics.items()})

    def accumulate(params, batch):
        if microbatches == 1:
            return single(params, batch)
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             "microbatches")
        mb = [{k: v[i * (b // microbatches):(i + 1) * (b // microbatches)]
               for k, v in batch.items()} for i in range(microbatches)]
        # the reference's order: microbatch 0, and the scan over 1..n-1
        # (summed from zero) added to it
        g1, m1 = single(params, mb[0])
        g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        m = {k: torch.zeros_like(v) for k, v in m1.items()}
        for x in mb[1:]:
            gi, mi = single(params, x)
            g = tree_map(torch.add, g, gi)
            m = {k: m[k] + mi[k] for k in m}
        inv = 1.0 / microbatches
        g = tree_map(lambda a, c: (a + c) * inv, g, g1)
        return g, {k: (m[k] + m1[k]) * inv for k in m}

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state["params"]
        grads, metrics = accumulate(
            params, _to_device(batch, tree_leaves(params)[0].device))
        if grad_compression == "int8":
            # the error-feedback residual lives in state["ef"]
            grads, new_ef = compression.compress_decompress_tree(
                grads, state.get("ef"))
        else:
            new_ef = state.get("ef")
        new_params, new_opt = opt.update(grads, state["opt"], params)
        metrics["grad_norm"] = global_norm(grads)
        new_state = dict(state, params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        if new_ef is not None:
            new_state["ef"] = new_ef
        return new_state, metrics

    return step


def init_train_state(gen: torch.Generator, cfg: ArchConfig, opt: Optimizer,
                     device="cuda",
                     grad_compression: Optional[str] = None) -> TrainState:
    """Float params from ``gen`` on ``device`` (the card unless the caller
    asks for the CPU), the optimizer's state and the step counter."""
    params = api.init_params(gen, cfg, device, serve_quantized=False)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=api.resolve_device(device))}
    if grad_compression == "int8":
        state["ef"] = compression.init_error_feedback(params)
    return state
