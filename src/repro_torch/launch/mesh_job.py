"""The rank worker of a mesh: what a spawned rank (``launch.mesh.spawn``)
runs to load one set of weights, keep its blocks and serve, or to train
(``train``: ``launch/train.py``'s run with its arguments, on the rank's
device, under the training plan), so that it imports this package and
nothing else.

``run(rank, device, jobs, data=1)`` runs each job of a list in turn, on a
``data`` x (world / data) mesh. A job loads
one set of global weights (``params``: a ``torch.save``'d param tree; or
``np_tree``: a pickled numpy tree of the reference's, through
``convert.from_jax_params(..., plan=)``), keeps this rank's blocks
(``distributed.sharding.shard_params``) on ``device``, or (``build``)
makes them there as ``launch/serve.py`` does (``build_params``: random
from seed 0, each layer cut to the rank's blocks as it is made), and
runs, under the plan:

  * ``forwards``: {name: (cfg, tokens [B, S])} teacher-forced logits,
    the whole batch's: under a data axis that divides B a rank runs its
    rows (``sharding.local_rows``) and the logits are gathered over it;
  * ``serves``: {name: (cfg, engine kwargs, requests as dicts)} through
    ``ServingEngine(plan=...)``: each request's tokens (and beams), the
    engine's stats, the kernels' launches (counts set to 0 just before the
    serve and read just after), the collectives' counters and the serve's
    wall time;
  * ``probes``: {name: (fn, args)} the caller's own checks, run last:
    ``fn(ctx, *args)`` with ctx {"rank", "device", "plan", "params",
    "engines"} (``params`` None in a job that loads none), ``fn`` a
    function of a module the rank can import.

Every result comes back from every rank, tensors on the CPU, with the
rank's mesh coordinate, the hash of the leaves the rank holds whole
(``replicated_digest``: equal on every rank of a model coordinate, and
on every rank where the model axis has one) and the rank's peak device
memory in the job.
"""

from __future__ import annotations

import hashlib
import pickle
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.quantize import QuantizedWeight
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (for_batch, local_rows,
                                              plan_scope, shard_params,
                                              tree_to)
from repro_torch.launch import mesh as mesh_mod

__all__ = ["run", "train", "replicated_digest", "kernel_counts",
           "reset_kernel_counts"]


def replicated_digest(params) -> str:
    """sha256 over every leaf of the nodes a rank holds whole: those with
    no ``"tp"`` mark (norms, the router, replicated projections)."""
    h = hashlib.sha256()

    def leaf(path, t):
        t = t.detach().to("cpu").contiguous()
        h.update(f"{path}:{t.dtype}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")

    def walk(node, path):
        if isinstance(node, dict):
            if "tp" in node:
                return
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif isinstance(node, QuantizedWeight):
            for c in ("packed", "scale", "zero_prime", "cw"):
                if getattr(node, c) is not None:
                    leaf(f"{path}/{c}", getattr(node, c))
        elif torch.is_tensor(node):
            leaf(path, node)

    walk(params, "")
    return h.hexdigest()


def _kernel_modules():
    from repro_torch.kernels import dequant_mpgemm as dk
    from repro_torch.kernels import fused_lut_mpgemm as fk
    from repro_torch.kernels import lut_mpgemm as lk
    from repro_torch.kernels import table_precompute as tk
    return {"table_precompute": tk, "lut_mpgemm": lk,
            "fused_lut_mpgemm": fk, "dequant_mpgemm": dk}


def reset_kernel_counts():
    mods = _kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    mods["table_precompute"].row_scale_launches = 0
    mods["lut_mpgemm"].batched_launches = 0
    mods["fused_lut_mpgemm"].batched_launches = 0


def kernel_counts() -> Dict[str, int]:
    """{kernel: launches} of the four wrappers, the row scale and the two
    batched (expert-axis) wrappers."""
    mods = _kernel_modules()
    out = {name: mod.launches for name, mod in mods.items()}
    out["row_scale"] = mods["table_precompute"].row_scale_launches
    out["lut_mpgemm_batched"] = mods["lut_mpgemm"].batched_launches
    out["fused_lut_mpgemm_batched"] = mods["fused_lut_mpgemm"].batched_launches
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(cfg, engine_kw, requests, params, plan, device):
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, plan=plan, **engine_kw)
    reqs = [Request(**dict(r, prompt=np.asarray(r["prompt"])))
            for r in requests]
    for r in reqs:
        eng.submit(r)
    _sync(device)
    reset_kernel_counts()
    collectives.reset_counters()
    t0 = time.perf_counter()
    eng.run_to_completion()
    _sync(device)
    return eng, {"outputs": [r.output for r in reqs],
                 "beams": [r.beams for r in reqs], "stats": eng.stats(),
                 "launches": kernel_counts(),
                 "wall_s": time.perf_counter() - t0,
                 "collectives": collectives.counters()}


def _load(job, plan, device):
    """This rank's blocks of the job's global weights on ``device``."""
    if job.get("build"):
        from repro_torch.launch.serve import build_params
        return build_params(job["cfg"], device, job["cfg"].quant is not None,
                            plan)
    if "np_tree" in job:
        from repro_torch.models.convert import from_jax_params
        with open(job["np_tree"], "rb") as f:
            return from_jax_params(pickle.load(f), job["cfg"], device,
                                   plan=plan)
    params = torch.load(job["params"], weights_only=False)
    return tree_to(shard_params(params, plan, job["cfg"]), device)


def run(rank: int, device: torch.device, jobs, data: int = 1):
    """Each job of ``jobs`` (module docstring) on this rank of a ``data``
    x (world / data) mesh, its weights freed before the next; returns
    their results."""
    plan = mesh_mod.make_plan(mesh_mod.make_serving_mesh(
        data=data, model=torch.distributed.get_world_size() // data,
        device=device), fsdp=False)
    return [_job(rank, device, job, plan) for job in jobs]


def train(rank: int, device: torch.device, argv) -> int:
    """A spawned rank's training run: ``launch/train.py``'s ``main(argv)``
    on the group the spawn set up, on the rank's ``device``; its exit
    code."""
    from repro_torch.launch import train as train_mod
    return train_mod.main(argv, device)


def forward(params, tokens, cfg, plan, device):
    """Teacher-forced logits of the whole batch ``tokens`` under ``plan``:
    this rank's rows where the data axis divides the batch, gathered over
    it in data order."""
    from repro_torch.distributed import collectives
    from repro_torch.models import api
    p = for_batch(plan, tokens.shape[0])
    with plan_scope(p):
        logits = api.forward(params, {"tokens": tokens[local_rows(
            p, tokens.shape[0])].to(device)}, cfg)[0]
        return collectives.all_gather(logits, dim=0, axis="data")


def _job(rank, device, job, plan):
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = None
    res: Dict[str, Any] = {"rank": rank, "device": str(device),
                           "backend": plan.mesh.backend,
                           "coords": plan.mesh.coords}
    if "params" in job or "np_tree" in job or job.get("build"):
        params = _load(job, plan, device)
        _sync(device)
        res["load_s"] = time.perf_counter() - t0
        res["replicated_digest"] = replicated_digest(params)
    res["forwards"] = {}
    for name, (cfg, tokens) in job.get("forwards", {}).items():
        res["forwards"][name] = forward(params, tokens, cfg, plan,
                                        device).to("cpu")
    engines, res["serves"] = {}, {}
    for name, (cfg, kw, reqs) in job.get("serves", {}).items():
        engines[name], res["serves"][name] = _serve(cfg, kw, reqs, params,
                                                    plan, device)
    ctx = {"rank": rank, "device": device, "plan": plan, "params": params,
           "engines": engines}
    res["probes"] = {}
    for name, (fn, args) in job.get("probes", {}).items():
        with plan_scope(plan):
            res["probes"][name] = fn(ctx, *args)
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else None)
    res["seconds"] = time.perf_counter() - t0
    return res
