"""Train-step factory: the QAT forward (the paper's technique in training),
microbatch gradient accumulation, the int8 gradient-compression hook, and
training under a (data, model) mesh.

``make_train_step(cfg, opt, ...)`` returns ``(state, batch) -> (state,
metrics)``: a new state (the input state is not modified), metrics as 0-dim
tensors on the device. The batch is numpy arrays or tensors; they are moved
to the params' device. Every family of the registry trains, as in the
reference: the VLM's batch carries ``image_embeds`` and whisper's
``audio_frames`` beside the tokens.

Under a mesh (``plan=``, or the plan of an enclosing ``plan_scope``; the
dense family only, ``api.check_train_mesh``) the step computes the
function the one-device step computes, as pjit gives the reference: only
where leaves live and the order of f32 sums differ. Each rank holds
its blocks of the state (``init_train_state(..., plan=)``, or
``sharding.shard_train_state``; ``train_shardings`` gives the specs) and
is given the whole batch:

  * data: a rank keeps its rows (``sharding.local_rows``) and its loss is
    its share of the whole batch's token mean (its NLL sum over the whole
    batch's token count); each microbatch's gradients are summed over the
    data ranks in rank order (the leaves FSDP splits by the gather's
    backward, the others in one all-gather);
  * FSDP (``make_plan(fsdp=True)``, ZeRO-3): a rank holds its data-axis
    block of each float weight and of its optimizer state and ``ef``; the
    forward gathers a layer's blocks just before it runs and again for its
    backward (``models/transformer.py``);
  * model: column- and row-parallel projections, attention by whole KV
    heads, the vocab-split embedding and head (``models/layers.py``), the
    loss over the gathered logits;
  * the global norm (AdamW's clip, ``grad_norm``) sums each leaf's
    squares over its blocks in rank order: a leaf FSDP would split is
    summed as its D data blocks whether or not the plan splits it, so
    FSDP on and off give the same bits; a model-split leaf over the model
    ranks; a replicated leaf once;
  * the optimizer runs on each rank's blocks where its state mirrors the
    param (AdamW's m and v, momentum); where the reference replicates the
    state (the 8-bit ``{"q", "s"}``, Adafactor's vectors) the leaf's
    gradient and param are gathered whole, updated whole on every rank,
    and the rank keeps its block;
  * int8 compression: each group compressed whole (``compression``);
  * metrics: ``loss``, ``lm_loss`` and ``grad_norm``, equal on every
    rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.registry import ArchConfig
from repro_torch.core.tree import (tree_leaves, tree_map, tree_paths,
                                  tree_unflatten)
from repro_torch.distributed import collectives, compression
from repro_torch.distributed import sharding as SH
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
    plan=None,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Build the train step. QAT fake-quant is applied when the config has a
    quant block (paper §5: the mpGEMM technique on the training forward).
    ``plan`` (or an enclosing ``plan_scope``'s) that splits the model or
    the batch: the mesh step (module docstring) on this rank's blocks,
    the same body with ``_MeshWork``'s hooks in place of ``_OneDevice``'s
    identities."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression {grad_compression!r}: None or "
                         "'int8'")
    if qat and cfg.quant:
        cfg = cfg.with_quant(qat=True)
    plan = SH.current_plan() if plan is None else plan
    work = _MeshWork(cfg, opt, plan) if api.splits(plan) else _OneDevice(
        cfg, opt)

    def single(params, batch, tokens):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = work.loss(tree_unflatten(params, leaves), batch,
                                      tokens)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return (work.sum_grads(list(grads)),
                {k: v.detach() for k, v in metrics.items()})

    def accumulate(params, batch):
        """(gradient leaves, metrics) of ``batch`` (this rank's rows)."""
        batch, tokens = work.rows(_to_device(batch,
                                             tree_leaves(params)[0].device))
        if microbatches == 1:
            g, m = single(params, batch, tokens)
            return g, work.sum_metrics(m)
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(work.unsplit.format(b=b, n=microbatches))
        mb = [{k: v[i * (b // microbatches):(i + 1) * (b // microbatches)]
               for k, v in batch.items()} for i in range(microbatches)]
        per = None if tokens is None else tokens // microbatches
        # the reference's order: microbatch 0, and the scan over 1..n-1
        # (summed from zero) added to it
        g1, m1 = single(params, mb[0], per)
        g = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
        m = {k: torch.zeros_like(v) for k, v in m1.items()}
        for x in mb[1:]:
            gi, mi = single(params, x, per)
            g = [a + c for a, c in zip(g, gi)]
            m = {k: m[k] + mi[k] for k in m}
        inv = 1.0 / microbatches
        g = [(a + c) * inv for a, c in zip(g, g1)]
        return g, work.sum_metrics({k: (m[k] + m1[k]) * inv for k in m})

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state["params"]
        work.prepare(params)
        grads, metrics = accumulate(params, batch)
        new_ef = state.get("ef")
        if grad_compression == "int8":
            # the error-feedback residual lives in state["ef"]
            g, new_ef = compression.compress_decompress_tree(
                tree_unflatten(params, grads), new_ef,
                whole=work.whole, local=work.block)
            grads = tree_leaves(g)
        gnorm = work.global_norm(grads)
        new_params, new_opt = work.update(grads, state["opt"], params, gnorm)
        metrics["grad_norm"] = gnorm
        new_state = dict(state, params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        if new_ef is not None:
            new_state["ef"] = new_ef
        return new_state, metrics

    def grads(state, batch):
        """(the gradient tree, metrics) of ``batch``: what ``step``
        compresses and applies (under a mesh: this rank's blocks of the
        data-summed gradient)."""
        params = state["params"]
        work.prepare(params)
        g, metrics = accumulate(params, batch)
        return tree_unflatten(params, g), metrics

    step.grads = grads
    return step


class _OneDevice:
    """The train step's hooks on one device: the loss of
    ``make_loss_fn``, every other hook the identity."""

    unsplit = "batch {b} does not split into {n} microbatches"

    def __init__(self, cfg: ArchConfig, opt: Optimizer):
        self.opt = opt
        self.loss_fn = make_loss_fn(cfg)

    def prepare(self, params):
        pass

    def rows(self, batch):
        """(the rows this device trains on, the whole batch's token count
        where the loss divides by it, else None: the token mean)."""
        return batch, None

    def loss(self, params, batch, tokens):
        return self.loss_fn(params, batch)

    def sum_grads(self, grads):
        return grads

    def sum_metrics(self, metrics):
        return metrics

    whole = block = None  # compress_decompress_tree's: the leaf itself

    def global_norm(self, grads) -> torch.Tensor:
        return global_norm(grads)

    def update(self, grads, opt_state, params, gnorm):
        return self.opt.update(tree_unflatten(params, grads), opt_state,
                               params, gnorm=gnorm)


def _meta_params(cfg: ArchConfig):
    """The whole float param tree on the meta device: shapes, no draw."""
    return api.init_params(None, cfg, "meta", serve_quantized=False)


def param_layout(cfg: ArchConfig, plan, meta=None):
    """``sharding.shard_params`` of the whole float param tree on the meta
    device (``meta``, built here when not given): every rank's marks, and
    its blocks' shapes, without a draw."""
    return SH.shard_params(_meta_params(cfg) if meta is None else meta,
                           plan, cfg)


def param_specs(params, plan, cfg: ArchConfig):
    """The physical spec of each leaf of this rank's param tree
    ``params`` under ``plan``, in its leaf order."""
    return SH.specs_for(params, param_layout(cfg, plan), plan)


def _whole_like(params, meta):
    """The meta tree ``meta``'s tensors (the whole shapes) in the leaf
    order of ``params``."""
    whole = dict(tree_paths(meta))
    return [whole[p] for p, _ in tree_paths(params)]


def _mirror_flags(opt: Optimizer, params, whole, specs):
    """Per param leaf, whether its optimizer state mirrors it (the
    reference's rule over ``opt.init`` of the whole tree): its state is
    then held and updated as blocks, else whole on every rank."""
    meta = tree_unflatten(params, whole)
    st = opt.init(meta)
    flags = [True] * len(specs)
    for k, sub in st.items():
        if k == "step":
            continue
        got = tree_leaves(SH.map_by_param(lambda sp, x: SH.mirrors(x, sp),
                                          meta, sub, specs))
        flags = [a and b for a, b in zip(flags, got)]
    return flags


class _MeshWork(_OneDevice):
    """The train step's hooks on this rank of ``plan``'s mesh (module
    docstring): its rows and its share of the token mean, the sums over
    the data ranks, the global norm over blocks, the update of replicated
    state whole."""

    unsplit = "a data rank's {b} rows do not split into {n} microbatches"

    def __init__(self, cfg, opt, plan):
        api.check_train_mesh(cfg, plan)
        self.cfg, self.opt, self.plan = cfg, opt, plan
        self.meta = _meta_params(cfg)
        self.marked = param_layout(cfg, plan, self.meta)
        self.d, self.m = plan.axis_size("batch"), plan.axis_size("model")
        self.data_ax = plan.batch[0] if plan.batch else None
        # the dims FSDP would split: the norm's data blocks either way
        self._variant = dataclasses.replace(plan, fsdp=self.data_ax)
        self._variant_marked = param_layout(cfg, self._variant, self.meta)
        self._paths = None

    def prepare(self, params):
        """Per-leaf specs and flags, in ``params``'s leaf order (made once
        a tree structure)."""
        paths = tuple(p for p, _ in tree_paths(params))
        if paths == self._paths:
            return
        self._paths = paths
        self.specs = SH.specs_for(params, self.marked, self.plan)
        model_ax = self.plan.resolve("model")
        self.fsdp_split = [self.data_ax in sp for sp in self.specs]
        self.model_split = [model_ax in sp for sp in self.specs]
        self.norm_dims = [sp.index(self.data_ax) if self.data_ax in sp
                          else None for sp in SH.specs_for(
                              params, self._variant_marked, self._variant)]
        self.mirrored = _mirror_flags(self.opt, params,
                                      _whole_like(params, self.meta),
                                      self.specs)

    # -- gradients ---------------------------------------------------------
    def rows(self, batch):
        b = batch["tokens"].shape[0]
        if b % self.d:
            raise ValueError(f"batch {b} does not split over {self.d} data "
                             "ranks")
        rows = SH.local_rows(self.plan, b)
        return ({k: v[rows] for k, v in batch.items()},
                batch["labels"].numel())

    def loss(self, params, batch, tokens):
        """This rank's share of the whole batch's token mean, the forward
        under the plan; the backward runs outside it, as a CUDA backward
        runs (on autograd's own thread): nothing of it may read the
        plan."""
        with SH.plan_scope(self.plan):
            logits = api.forward(SH.with_marks(params, self.marked), batch,
                                 self.cfg)[0]
            loss = lm_loss(logits, batch["labels"], tokens=tokens)
        return loss, {"lm_loss": loss, "loss": loss}

    def sum_grads(self, grads):
        """The leaves FSDP does not split summed over the data ranks in
        one all-gather (the others by the gather's backward)."""
        if self.d > 1:
            idx = [i for i, f in enumerate(self.fsdp_split) if not f]
            with SH.plan_scope(self.plan):
                flat = collectives.all_reduce(torch.cat(
                    [grads[i].reshape(-1) for i in idx]), "sum", axis="data")
            for i, t in zip(idx, flat.split([grads[i].numel()
                                             for i in idx])):
                grads[i] = t.reshape(grads[i].shape)
        return grads

    def sum_metrics(self, metrics):
        """The ranks' shares of the mean, summed."""
        with SH.plan_scope(self.plan):
            vals = collectives.all_reduce(torch.stack(list(
                metrics.values())), "sum", axis="data")
        return dict(zip(metrics, vals.unbind()))

    # -- the global norm and the update -----------------------------------
    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum over leaves (in tree order) of each leaf's f32
        sum of squares, summed over its blocks in rank order (module
        docstring): equal on every rank, and for FSDP on and off."""
        d, n = self.d, len(grads)
        sq = lambda t: torch.sum(torch.square(t.to(torch.float32)))
        dev = grads[0].device
        cols = torch.zeros(n, d, dtype=torch.float32, device=dev)
        own = self.plan.rank_along("batch")
        for i, g in enumerate(grads):
            dim = self.norm_dims[i]
            if self.fsdp_split[i]:
                cols[i, own] = sq(g)
            elif dim is not None and d > 1:
                k = g.shape[dim] // d
                for j in range(d):
                    cols[i, j] = sq(g.narrow(dim, j * k, k).contiguous())
            else:
                cols[i, 0] = sq(g)
        with SH.plan_scope(self.plan):
            if any(self.fsdp_split):
                every = collectives.all_gather(cols[None], dim=0,
                                               axis="data")
                idx = torch.tensor([i for i, f in enumerate(self.fsdp_split)
                                    if f], device=dev)
                for j in range(d):
                    cols[idx, j] = every[j, idx, j]
            tot = cols[:, 0]
            for j in range(1, d):
                tot = tot + cols[:, j]
            if self.m > 1 and any(self.model_split):
                parts = collectives.all_gather(tot[None], dim=0, axis="model")
                summed = parts[0]
                for r in range(1, self.m):
                    summed = summed + parts[r]
                tot = torch.where(torch.tensor(self.model_split, device=dev),
                                  summed, tot)
        return torch.sqrt(sum(tot[i] for i in range(n)))

    def whole(self, i, t):
        return SH.whole_of(t, self.specs[i], self.plan)

    def block(self, i, t):
        return SH.block_of(t, self.specs[i], self.plan)

    def update(self, grads, opt_state, params, gnorm):
        """``opt.update`` on this rank's blocks; a leaf whose state is
        replicated is updated whole (gathered) and its block kept."""
        p = tree_leaves(params)
        g = list(grads)
        whole = [i for i, f in enumerate(self.mirrored)
                 if not f and any(a is not None for a in self.specs[i])]
        for i in whole:
            g[i], p[i] = self.whole(i, g[i]), self.whole(i, p[i])
        new_p, new_opt = self.opt.update(
            tree_unflatten(params, g), opt_state, tree_unflatten(params, p),
            gnorm=gnorm)
        out = tree_leaves(new_p)
        for i in whole:
            out[i] = self.block(i, out[i])
        return tree_unflatten(params, out), new_opt


def train_shardings(state: TrainState, plan, cfg: ArchConfig):
    """The spec tree of a whole train state under ``plan`` (the reference's
    ``train_shardings``, specs for its NamedShardings: a tuple of physical
    axis names or None per dim): params by the rules as ``shard_params``
    resolves them (``cfg`` for the port's whole-heads rule), each
    optimizer leaf its param's spec where it is an array of the param's
    rank, else replicated (``()``: the 8-bit ``{"q", "s"}``, Adafactor's
    vectors), ``ef`` as the params, ``step`` replicated."""
    meta = tree_map(lambda t: t.to("meta"), state["params"])
    specs = SH.leaf_specs(SH.shard_params(meta, plan, cfg), plan)
    return SH.train_specs(state, specs)


def init_train_state(gen: torch.Generator, cfg: ArchConfig, opt: Optimizer,
                     device="cuda",
                     grad_compression: Optional[str] = None, *,
                     plan=None) -> TrainState:
    """Float params from ``gen`` on ``device`` (the card unless the caller
    asks for the CPU), the optimizer's state and the step counter. With a
    mesh ``plan`` this rank's blocks alone, built directly
    (``api.init_params(plan=)``: each subtree cut as it is drawn, in the
    whole build's order of draws): equal to ``shard_train_state`` of the
    whole state."""
    if api.splits(plan):
        api.check_train_mesh(cfg, plan)
        marked = api.init_params(gen, cfg, device, serve_quantized=False,
                                 plan=plan)
        params = SH.strip_marks(marked)
        specs = SH.leaf_specs(marked, plan)
        whole = _whole_like(params, _meta_params(cfg))
        mirrored = _mirror_flags(opt, params, whole, specs)
        # the optimizers' init reads shapes only: a replicated state is
        # made at its leaf's whole shape
        like = [p if f else torch.zeros(w.shape, dtype=p.dtype,
                                        device=p.device)
                for p, f, w in zip(tree_leaves(params), mirrored, whole)]
        opt_state = opt.init(tree_unflatten(params, like))
    else:
        params = api.init_params(gen, cfg, device, serve_quantized=False)
        opt_state = opt.init(params)
    state = {"params": params, "opt": opt_state,
             "step": torch.zeros((), dtype=torch.int32,
                                 device=api.resolve_device(device))}
    if grad_compression == "int8":
        state["ef"] = compression.init_error_feedback(params)
    return state
