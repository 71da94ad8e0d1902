"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 30 --batch 8 --seq 256 [--ckpt-dir ckpt --ckpt-every 10] \\
        [--mesh 2x1]

Wires together: config → float params → optimizer → train step (the QAT
forward unless ``--no-qat``) → data pipeline → checkpoint/restart manager.
A rerun with the same ``--ckpt-dir`` resumes from its newest complete
checkpoint ("resumed from step N") and runs on to ``--steps``. It exits
1 when the mean loss of the last 10 steps is above 1.02× that of the
first 10 (only over runs of 20 steps or more).

Runs on the CUDA card in f32 activations; ``--device cpu`` runs on the CPU
(the tests do this, at ``--reduced`` size). Without a card and without
``--device cpu`` it stops with an error. The dense, MoE, SSM and hybrid
archs train from ``SyntheticLM`` tokens. The VLM and audio archs are
refused with a ValueError: their forwards need the stub frontends'
``image_embeds`` / ``audio_frames``, which token data does not carry (the
reference's launcher cannot train them either); ``make_train_step`` trains
them from a batch that has them.

``--mesh DxM`` trains the dense archs across D·M ranks under the
reference's training plan (``launch.mesh.make_plan(mesh, fsdp=True)``):
D data ranks, each taking its rows of every batch and holding its FSDP
(ZeRO-3) block of every float weight and of its optimizer state, M model
ranks splitting the projections (``training.train_loop``). The ranks come
from torchrun (each joins the group it describes) or are spawned here
(``launch/mesh_job.py``'s ``train``: ranks on ``cuda:(r % device_count)``,
NCCL where each has a card of its own, gloo where they share one; on the
CPU over gloo with ``--device cpu``). Rank 0 prints and writes the
checkpoints (the whole state, in the single-device format: a mesh run
resumes on one device and back)::

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --mesh 2x2 --steps 20 --batch 4 --seq 32

``--mesh single`` is the reference's (16, 16) production mesh, which
needs 256 ranks (torchrun); ``--mesh multi`` (its pod axis) is refused,
naming ROADMAP.md queue 1 item 9 step 5; the MoE, SSM, hybrid, VLM and
audio archs under a mesh are refused (steps 3 and 8).
"""

from __future__ import annotations

import argparse
import builtins
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.data import Prefetcher, SyntheticLM
from repro_torch.training.train_loop import init_train_state, make_train_step

# the batch entry each frontend family's forward reads beside the tokens
FRONTEND_INPUTS = {"vlm": "image_embeds", "audio": "audio_frames"}


def main(argv=None, rank_device=None):
    """The training run; ``rank_device``: a spawned rank's device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adamw8bit", "adafactor", "momentum"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-feasible)")
    ap.add_argument("--no-qat", action="store_true",
                    help="disable the paper's QAT fake-quant forward")
    ap.add_argument("--grad-compression", default=None, choices=[None, "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--mesh", default="none",
                    help="none | single (the reference's 16x16, 256 ranks) "
                         "| multi (its pod axis: refused) | DxM (data x "
                         "model ranks, e.g. 2x2; FSDP over data)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh == "multi":
        ap.error(f"--mesh multi: {mesh_mod.POD_AXIS_REFUSAL}")
    elif args.mesh == "single":
        mesh = (16, 16)
    elif args.mesh != "none":
        try:
            mesh = tuple(int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            mesh = ()
        if len(mesh) != 2 or min(mesh) < 1:
            ap.error(f"--mesh wants none, single, multi or 'DxM' (e.g. "
                     f"2x2), got {args.mesh!r}")

    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    cfg = cfg.replace(activation_dtype=torch.float32)
    if cfg.family in FRONTEND_INPUTS:
        raise ValueError(
            f"{args.arch}: the {cfg.family} forward needs "
            f"batch[{FRONTEND_INPUTS[cfg.family]!r}] (the stub frontend's "
            "input), and the synthetic token data carries tokens only; "
            "train it through training.train_loop.make_train_step with a "
            "batch that has it")
    if mesh is None:
        return _train(args, cfg, api.resolve_device(args.device), None)
    if mesh[0] * mesh[1] > 1:
        from repro_torch.distributed.sharding import AxisPlan, Mesh
        api.check_train_mesh(cfg, AxisPlan(Mesh(("data", "model"), mesh,
                                                (0, 0), {})))
    if rank_device is not None or dist.is_initialized():
        return _train(args, cfg, rank_device, mesh, ap)
    device = mesh_mod.from_env(args.device)
    if device is not None:  # a rank torchrun started
        try:
            return _train(args, cfg, device, mesh, ap)
        finally:
            dist.destroy_process_group()
    if mesh == (16, 16):
        ap.error(f"--mesh single: mesh 16x16 needs 256 ranks, have 1 (the "
                 "reference's production mesh: start 256 ranks with "
                 "torchrun)")
    from repro_torch.launch import mesh_job
    codes = mesh_mod.spawn(mesh_job.train, mesh[0] * mesh[1],
                           device=args.device,
                           args=(list(sys.argv[1:] if argv is None
                                      else argv),))
    return codes[0]


def _train(args, cfg, device, mesh, ap=None):
    """The training loop, on one device or as one rank of the mesh (on
    ``device``, joined to the group)."""
    plan = None
    if mesh is not None:
        try:
            m = (mesh_mod.make_production_mesh(device=device)
                 if mesh == (16, 16) and args.mesh == "single" else
                 mesh_mod.make_serving_mesh(data=mesh[0], model=mesh[1],
                                            device=device))
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
        plan = mesh_mod.make_plan(m, fsdp=True)
    rank0 = plan is None or dist.get_rank() == 0
    print = builtins.print if rank0 else (lambda *a, **k: None)
    if plan is not None:
        print(f"training mesh {plan.mesh.shape[0]}x{plan.mesh.shape[1]} "
              f"(data x model), FSDP over data, backend "
              f"{plan.mesh.backend}, rank 0 on {device}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    sched = opt_mod.lr_schedule(args.lr, warmup=20, total=args.steps)
    opt = opt_mod.make_optimizer(args.optimizer, lr=sched)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                              grad_compression=args.grad_compression,
                              qat=not args.no_qat, plan=plan)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_train_state(gen, cfg, opt, device,
                             grad_compression=args.grad_compression,
                             plan=plan)
    start = 0
    rm = None
    if args.ckpt_dir:
        rm = ckpt_mod.RestartManager(args.ckpt_dir, every=args.ckpt_every,
                                     plan=plan, cfg=cfg)
        restored, start = rm.restore_or_none(state)
        if restored is not None:
            state = restored
            print(f"resumed from step {start}")

    data = Prefetcher(SyntheticLM(cfg.vocab_size, args.batch, args.seq),
                      start_step=start)
    t0 = time.perf_counter()
    losses = []
    try:
        for step in range(start, args.steps):
            state, metrics = step_fn(state, data.next())
            losses.append(float(metrics["loss"]))  # waits for the step
            if rm:
                rm.maybe_save(step + 1, state)
            if (step + 1) % args.log_every == 0:
                dt = (time.perf_counter() - t0) / args.log_every
                print(f"step {step+1:5d}  loss "
                      f"{np.mean(losses[-args.log_every:]):.4f}"
                      f"  {dt*1e3:.0f} ms/step", flush=True)
                t0 = time.perf_counter()
        if rm:
            rm.maybe_save(args.steps, state, force=True)
            rm.wait()
    finally:
        data.close()
    if not losses:  # resumed at/after the target step: nothing to run
        print("no steps to run (already at target step)")
        return 0
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"loss {first:.4f} -> {last:.4f} over {len(losses)} steps",
          flush=True)
    # short resume windows overlap; only fail on a clear regression
    return 0 if (last <= first * 1.02 or len(losses) < 20) else 1


if __name__ == "__main__":
    raise SystemExit(main())
