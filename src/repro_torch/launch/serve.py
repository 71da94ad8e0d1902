"""Serving entry point: random weights packed to the low-bit format, served
through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --requests 8 --max-new 16 --mode lut_pallas --prefill-chunk 128

Runs on the CUDA card; ``--device cpu`` runs every kernel's plain version
on the CPU instead (the tests do this, at ``--reduced`` size). Without a
card and without ``--device cpu`` it stops with an error.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.mpgemm import FUSION_MODES, MPGEMM_MODES
from repro_torch.models import api
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=registry.list_archs())
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
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop a slot when it samples this token id")
    ap.add_argument("--mode", default="lut_xla", choices=list(MPGEMM_MODES))
    ap.add_argument("--fusion", default="auto", choices=list(FUSION_MODES),
                    help="lut_pallas precompute placement: fused keeps the "
                         "table on chip, staged writes it to device memory")
    ap.add_argument("--weight-bits", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = api.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    cfg = cfg.replace(activation_dtype=torch.float32)
    cfg = cfg.with_quant(mpgemm_mode=args.mode, weight_bits=args.weight_bits,
                         fusion=args.fusion)

    print(f"init + quantize ({args.mode}, W{args.weight_bits}) on {device} ...")
    quantized = args.mode != "fp16"
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = api.init_params(gen, cfg, device, serve_quantized=quantized)
    if not quantized:
        cfg = cfg.replace(quant=None)

    eng = ServingEngine(cfg, params, max_batch=args.max_batch,
                        max_seq=args.max_seq, decode_chunk=args.decode_chunk,
                        prefill_chunk=args.prefill_chunk, eos_id=args.eos_id)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        eng.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, plen),
            max_new_tokens=args.max_new, temperature=args.temperature))
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
