"""Serving entry point: random weights packed to the low-bit format, served
through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --requests 8 --max-new 16 --mode lut_pallas --prefill-chunk 128 \\
        [--cache-block-size 16 --prefix-cache] [--decoding beam:2]

``--decoding`` is every request's mode: ``greedy``, ``sample``, ``beam:W``
(W pool slots a request) or ``spec:draftNb`` (self-speculation drafting
with the top N bit-planes of the same packed weights, ``--spec-k`` tokens a
round). The kernels refuse plane-sliced views, so ``spec`` runs under
``--mode lut_xla`` (``lut_pallas`` raises NotImplementedError at the first
draft) and is refused under ``fp16``.

``--arch`` is any of ``configs.registry.list_archs()``; each serves its
own weight scheme (``paper-bitnet-3b``: ternary, ``--weight-bits`` refused;
the others W2 symmetric unless ``--weight-bits`` says otherwise;
``olmoe-1b-7b`` keeps its attention float, ``zamba2-7b`` its Mamba2
in/out projections). The MoE archs (``olmoe-1b-7b``; ``kimi-k2-1t-a32b``,
which fits a card only ``--reduced``) serve every mode, ``spec`` under
``--mode lut_xla`` as for the dense archs; the verify burst routes its
B·(K+1) tokens with the capacity they set, as the reference's does, so a
greedy ``spec`` stream can part from the greedy one where an expert
overflows. The SSM and hybrid
archs (``falcon-mamba-7b``: Mamba1, attention-free; ``zamba2-7b``: Mamba2
with one shared attention block) and the cross-attention archs
(``llama-3.2-vision-11b``: a gated image cross layer every 5 layers;
``whisper-tiny``: an encoder-decoder) serve greedy, sampled and beam
requests; ``spec`` raises ValueError (their SSM state or cross K/V cannot
rewind a rejected draft), and ``--prefix-cache`` is turned off with a
warning (slot-resident state cannot be shared by block reference). As in
the reference, requests carry tokens only: the VLM and whisper serve with
a zero image / encoder K/V (their ``image_embeds`` / ``audio_frames``
inputs run in a teacher-forced ``api.forward``).

Telemetry and tuning: ``--fusion tuned`` dispatches each projection with
the measured plan of the tuning cache (``--tuning-cache PATH``; the
heuristic on a miss), ``--pretune`` measures every shape the engine
dispatches first and saves the cache; ``--trace-out`` writes a
Chrome-trace / Perfetto JSON of the request lifecycle, ``--metrics-out``
the metrics snapshot (JSON, or Prometheus text for a ``.prom`` path), and
``--dispatch-log`` every mpGEMM dispatch decision::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lut_pallas \
        --prefill-chunk 128 --fusion tuned --tuning-cache tc.json \
        --pretune --trace-out trace.json --dispatch-log dispatch.json

Mesh: ``--mesh DxM`` (``--tp N`` is ``--mesh 1xN``; the two are mutually
exclusive) serves the dense and MoE archs across D·M ranks: M model
ranks a data rank, tensor-parallel layers and expert-parallel MoE
(``distributed.sharding``), and D data ranks, each decoding its own
max_batch / D slots (``serving.engine``). Each rank builds its own blocks
alone (``api.init_params(plan=)``): no rank's device ever holds the
whole model. Started by torchrun, each rank joins the group torchrun
describes; otherwise the ranks are spawned here (``launch.mesh.spawn``,
ranks on ``cuda:(r % device_count)``, NCCL where each has a card of its
own, gloo where they share one; with ``--device cpu`` on the CPU over
gloo)::

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --mesh 2x2

Every rank serves the same requests with the same seed; rank (0, 0)
prints the single-device lines and one mesh line.

Runs on the CUDA card; ``--device cpu`` runs every kernel's plain version
on the CPU instead (the tests do this, at ``--reduced`` size). Without a
card and without ``--device cpu`` it stops with an error.
"""

from __future__ import annotations

import argparse
import builtins
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.core.mpgemm import FUSION_MODES, MPGEMM_MODES
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api
from repro_torch.obs import dispatch as dispatch_obs
from repro_torch.obs.trace import Tracer
from repro_torch.serving import decoding
from repro_torch.serving.engine import Request, ServingEngine


# the float projections of an arch's ``quant["skip"]``, as text
SKIP_NAMES = {"attn": "attention",
              "ssm/(in_proj|out_proj)": "Mamba in/out projections"}


def scheme_name(quant: dict) -> str:
    """The weight scheme as text: "ternary", or the bits and the scheme
    (e.g. "W2 symmetric"), and the projections that stay float where the
    arch keeps some (olmoe-1b-7b: "W2 symmetric, float attention";
    zamba2-7b: "W2 symmetric, float Mamba in/out projections")."""
    name = ("ternary" if quant["scheme"] == "ternary"
            else f"W{quant['weight_bits']} {quant['scheme']}")
    skip = quant.get("skip")
    if skip:
        name += ", float " + SKIP_NAMES.get(skip, skip)
    return name


def main(argv=None, rank_device=None):
    """The serve; ``rank_device``: a spawned rank's device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=registry.list_archs(),
                    help="the reference's 11 archs in six families: dense "
                         "(tinyllama-1.1b, ...), MoE (olmoe-1b-7b), SSM "
                         "(falcon-mamba-7b), hybrid (zamba2-7b), VLM "
                         "(llama-3.2-vision-11b) and audio (whisper-tiny)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode steps per host sync")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="fixed prompt-chunk length of admission prefill")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (<=0 greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k (0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="per-request nucleus mass (>=1 disables)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop a slot when it samples this token id")
    ap.add_argument("--decoding", default="greedy",
                    help="per-request decoding mode: greedy | sample | "
                         "beam:W (width-W beam search, W pool slots per "
                         "request) | spec:draftNb (bit-plane self-"
                         "speculation drafting with the top N planes of "
                         "the same packed weights)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per speculative verify round")
    ap.add_argument("--mode", default="lut_xla", choices=list(MPGEMM_MODES))
    ap.add_argument("--fusion", default="auto", choices=list(FUSION_MODES),
                    help="lut_pallas precompute placement: fused keeps the "
                         "table on chip, staged writes it to device memory, "
                         "tuned reads the measured tuning cache")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH",
                    help="persistent kernel-tuning cache (JSON) that "
                         "--fusion tuned reads; created or updated by "
                         "--pretune")
    ap.add_argument("--pretune", action="store_true",
                    help="before serving, measure-tune every mpGEMM shape "
                         "this engine dispatches and save the cache "
                         "(lut_pallas only)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace / Perfetto JSON of the "
                         "request lifecycle (admit, prefill and decode-chunk "
                         "spans)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot as JSON (a "
                         ".prom suffix writes Prometheus text instead)")
    ap.add_argument("--dispatch-log", default=None, metavar="PATH",
                    help="record every mpGEMM dispatch decision (shape key, "
                         "fusion, tile, split-K count, tuned or heuristic) "
                         "of this serve and write it as JSON")
    ap.add_argument("--cache-block-size", type=int, default=None,
                    help="enable the block-paged KV cache pool with this "
                         "many positions per block (must divide --max-seq)")
    ap.add_argument("--num-cache-blocks", type=int, default=None,
                    help="pool size in blocks incl. the reserved null block "
                         "(default: dense-equivalent capacity)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="hash-based shared-prefix block reuse (requires "
                         "--cache-block-size; identical prefixes prefill "
                         "once and fan out by block reference)")
    ap.add_argument("--weight-bits", type=int, default=None,
                    help="bits of a symmetric or asymmetric scheme (default: "
                         "the arch's); the ternary scheme has no such choice")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None, metavar="DXM",
                    help="serving mesh 'data x model', e.g. 2x2: shards the "
                         "packed weights and KV heads over M ranks and the "
                         "decode slots over D. Default: one device")
    ap.add_argument("--tp", type=int, default=None, metavar="N",
                    help="tensor-parallel shortcut for --mesh 1xN")
    args = ap.parse_args(argv)
    if args.mesh is not None and args.tp is not None:
        ap.error("--mesh and --tp are mutually exclusive")
    mesh = None
    if args.mesh is not None:
        try:
            data, model = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            ap.error(f"--mesh wants 'DxM' (e.g. 2x2), got {args.mesh!r}")
        mesh = (data, model)
    elif args.tp is not None:
        mesh = (1, args.tp)
    if mesh is not None and min(mesh) < 1:
        ap.error(f"each mesh axis needs >= 1 rank, got {mesh}")
    world = 1 if mesh is None else mesh[0] * mesh[1]
    if world == 1 or dist.is_initialized():
        return _serve(ap, args, mesh, rank_device)
    device = mesh_mod.from_env(args.device)
    if device is not None:  # a rank torchrun started
        return _serve(ap, args, mesh, device)
    if mesh_mod.rank_device(0, args.device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()  # here, once: the ranks load the libraries
    mesh_mod.spawn(_serve_rank, world, device=args.device,
                   args=(list(sys.argv[1:] if argv is None else argv),))
    return 0


def _serve_rank(rank, device, argv):
    """A spawned rank's serve (``launch.mesh.spawn``): ``main`` on the
    group the spawn set up, on the rank's ``device``."""
    return main(argv, device)


def build_params(cfg, device, quantized: bool, plan=None):
    """The serve's weights: random from seed 0, packed per ``cfg.quant``
    where ``quantized``; under a mesh ``plan`` this rank's blocks alone,
    each layer cut to them as it is made (``api.init_params(plan=)``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return api.init_params(gen, cfg, device, serve_quantized=quantized,
                           plan=plan)


def _serve(ap, args, mesh, rank_device):
    """The serve of ``main``, on one device or as one rank of the mesh
    (on ``rank_device``)."""
    plan = None
    if mesh is not None:
        plan = mesh_mod.make_plan(mesh_mod.make_serving_mesh(
            data=mesh[0], model=mesh[1], device=rank_device), fsdp=False)
    rank0 = plan is None or plan.mesh.coords == (0, 0)
    print = builtins.print if rank0 else (lambda *a, **k: None)
    if args.prefix_cache and args.cache_block_size is None:
        ap.error("--prefix-cache requires --cache-block-size")
    try:
        dm = decoding.parse(args.decoding)
    except ValueError as e:
        ap.error(str(e))
    spec_draft_planes = dm.draft_planes if dm.kind == decoding.SPEC else None
    if spec_draft_planes is not None and args.mode == "fp16":
        ap.error("--decoding spec needs a quantized mode: the draft is a "
                 "bit-plane slice of the packed weights")

    device = rank_device or api.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    cfg = cfg.replace(activation_dtype=torch.float32)
    if args.weight_bits is not None:
        if cfg.quant["scheme"] == "ternary":
            ap.error(f"--weight-bits: {args.arch} has ternary weights")
        cfg = cfg.with_quant(weight_bits=args.weight_bits)
    cfg = cfg.with_quant(mpgemm_mode=args.mode, fusion=args.fusion)

    print(f"init + quantize ({args.mode}, {scheme_name(cfg.quant)}) on "
          f"{device} ...")
    if plan is not None:
        m = plan.mesh
        print(f"serving mesh {m.sizes['data']}x{m.sizes['model']} (data x "
              f"model) over {m.sizes['data'] * m.sizes['model']} ranks, "
              f"backend {m.backend}, rank 0 on {m.device}")
    quantized = args.mode != "fp16"
    params = build_params(cfg, device, quantized, plan)
    if not quantized:
        cfg = cfg.replace(quant=None)
    if args.fusion == "tuned" and args.tuning_cache is None \
            and not args.pretune:
        print("note: --fusion tuned without --tuning-cache falls back to the "
              "auto heuristic on every dispatch")

    tracer = Tracer() if args.trace_out is not None else None
    eng = ServingEngine(cfg, params, max_batch=args.max_batch,
                        max_seq=args.max_seq, decode_chunk=args.decode_chunk,
                        prefill_chunk=args.prefill_chunk, eos_id=args.eos_id,
                        cache_block_size=args.cache_block_size,
                        num_cache_blocks=args.num_cache_blocks,
                        prefix_cache=args.prefix_cache, spec_k=args.spec_k,
                        spec_draft_planes=spec_draft_planes,
                        tuning_cache=args.tuning_cache, tracer=tracer,
                        plan=plan)
    if args.pretune:
        if eng.tuning_cache is None:  # tune in memory for this process
            from repro_torch.core import autotune
            eng.tuning_cache = autotune.configure(None)
        t0 = time.time()
        n = eng.pretune(verbose=True)
        print(f"pretuned {n} mpGEMM shapes in {time.time() - t0:.1f}s -> "
              f"{args.tuning_cache or '(in memory only)'}")
    # the serve's dispatches only, not the tuner's measurements
    recorder = (dispatch_obs.enable(dispatch_obs.DispatchRecorder())
                if args.dispatch_log is not None else None)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        eng.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, plen),
            max_new_tokens=args.max_new, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, decoding=args.decoding))
    t0 = time.time()
    chunks = eng.run_to_completion()
    dt = time.time() - t0
    st = eng.stats()
    total_new = st["decode_tokens"]
    print(f"served {args.requests} requests / {total_new} tokens in "
          f"{dt:.2f}s ({chunks} chunk cycles, {total_new / dt:.1f} tok/s, "
          f"continuous batching over {args.max_batch} slots)")
    print(f"host syncs/token {st['host_syncs_per_token']:.4f} "
          f"(decode_chunk={args.decode_chunk}), chunk latency "
          f"p50 {st['p50_chunk_ms']:.1f} ms / p95 {st['p95_chunk_ms']:.1f} ms")
    if st["paged"]:
        print(f"paged cache: {st['num_cache_blocks']} blocks of "
              f"{st['cache_block_size']}, {st['blocks_in_use']} in use, "
              f"{st['admit_blocked']} of {st['admit_attempts']} admissions "
              f"blocked, {st['prefill_tokens_reused']} prompt tokens reused, "
              f"prefix cache {st.get('prefix_cache')}")
    if "spec" in st:
        sp = st["spec"]
        print(f"spec: {sp['draft_planes']}-plane draft, k={sp['spec_k']}, "
              f"{sp['verify_steps']} verify rounds, "
              f"{sp['accepted_draft_tokens']} drafts accepted, "
              f"{sp['mean_emitted_per_step']:.2f} tokens a round, "
              f"{sp['draft_extra_hbm_bytes']} extra weight bytes")
    if dm.kind == decoding.BEAM:
        print(f"beam: width {dm.beam_width}, length alpha "
              f"{eng.beam_length_alpha}")
    if st["mesh"] is not None:
        ms = st["mesh"]
        print(f"mesh: {ms['shape']}, backend {ms['backend']}, rank 0's "
              f"collectives {ms['collective_calls']} calls, "
              f"{ms['collective_bytes']} bytes, {ms['collective_s']:.2f} s "
              "(" + ", ".join(f"{a} {c['calls']}"
                              for a, c in ms["collectives_by_axis"].items())
              + f"); rank 0's slots {ms['slots']}")
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"trace: {len(tracer)} events -> {args.trace_out} (open at "
              "ui.perfetto.dev)")
    if args.metrics_out is not None:
        with open(args.metrics_out, "w") as f:
            if args.metrics_out.endswith(".prom"):
                f.write(eng.prometheus_text())
            else:
                json.dump(eng.metrics_snapshot(), f, indent=2)
        print(f"metrics -> {args.metrics_out}")
    if recorder is not None:
        dispatch_obs.disable()
        s = recorder.summary()
        with open(args.dispatch_log, "w") as f:
            json.dump(s, f, indent=2)
        print(f"dispatch log: {s['decisions']} mpGEMM decisions "
              f"({s['tuned']} tuned, {s['heuristic']} heuristic, "
              f"{s['forced']} forced) -> {args.dispatch_log}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
