#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repo root, on a machine with one H100

Phases (each prints its own line; any failure ends the run with a non-zero
exit and no result line):

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the three kernels from ``src/repro_torch/csrc``;
  3. kernels — each kernel against its plain torch version on the card, at
     the main path's shapes (M ∈ {4, 128}; (N, K) of tinyllama-1.1b's
     projections and head), every table_quant mode: per_row bit-exact,
     None / per_group within 1e-4 relative. Device times with CUDA events
     (``time_ms``: L2 flushed before every launch, the host's queueing
     hidden behind a spin on the card): kernel, plain version, a bf16
     ``torch.matmul`` yardstick, and the bound (``bound``):
       bytes = each input read once + each output written once (packed
               weights and their scales, activations or table, output);
       ops   = 2·M·N·K int8 for the two mpGEMMs (the multiply-adds of the
               product; the one-hot T·CW contraction over G·E entries is
               the kernels' way of doing it, not work the function needs),
               plus M·G·E·(K-1) f32 adds of the table entries where the
               kernel builds them;
       bound_ms = max(bytes / 3.35 TB/s, ops / peak of their type);
  4. serve   — full-width tinyllama-1.1b, W2 symmetric K=4, random weights
     from a fixed seed made on the card, served through the port's engine
     (lut_pallas, table_quant auto -> per_row, fusion auto, 4 requests with
     130-200 token prompts, 16 new tokens, prefill chunk 128, decode chunk
     8, greedy). Every kernel's launch count must be > 0 and host syncs per
     token <= 1/decode_chunk;
  5. parity  — a teacher-forced 128-token forward through the kernels
     (lut_pallas) and through the plain torch LUT path (lut_xla), both with
     per_row tables: the logits must be equal bit for bit, because every
     per_row projection is exact integer arithmetic with the same epilogue.

The line before the last is the card's name and power limit; the line
before that the kernels' JSON record; the last line
``{"ok": true, "device": {...}}``. Per-shape details go to
``chip_smoke.json`` in the kernels' build directory
(``src/repro_torch/build/``).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate
PEAK_OPS_S = {"int8": 1979e12, "f32": 67e12}  # dense, published peaks
MODES = (None, "per_row", "per_group")
SHAPES = ((2048, 2048), (256, 2048), (5632, 2048), (2048, 5632), (32000, 2048))
ROWS = (4, 128)            # decode batch, prefill chunk
KG, BITS = 4, 2
MAIN_M = {"fused_lut_mpgemm": 4, "lut_mpgemm": 128, "table_precompute": 128}


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps, flush):
    """Median device time of ``fn`` over ``reps`` launches, each after an
    L2 flush (CUDA events around the launch only). A spin of ~2 ms on the
    card ahead of each start event keeps the card busy while the host
    queues the call, so the events time the device work, not the host's
    Python around the launch."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)  # clock cycles: ~2 ms at 1.98 GHz
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and
    Σ operations / peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = sum(n / PEAK_OPS_S[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_weight(gen, n, k):
    from repro_torch.core.quantize import QuantizedWeight
    packed = torch.randint(0, 256, (n, k * BITS // 8), generator=gen,
                           device="cuda", dtype=torch.uint8)
    scale = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-3
    return QuantizedWeight(packed, scale, None, (1.0, 2.0), bits=BITS,
                           k_group=KG, k_total=k, n=n)


def check_kernels(flush):
    """Phase 3. Returns (per-shape records, per-kernel max_abs_err)."""
    from repro_torch.core.quantize import dequantize
    from repro_torch.kernels import fused_lut_mpgemm as fk
    from repro_torch.kernels import lut_mpgemm as lk
    from repro_torch.kernels import ops
    from repro_torch.kernels import table_precompute as tk
    from repro_torch.core import table as T

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    e = 1 << (KG - 1)
    records, err = [], {"table_precompute": 0.0, "lut_mpgemm": 0.0,
                        "fused_lut_mpgemm": 0.0}

    def compare(name, got, want, tq, what):
        got, want = got.to(torch.float64), want.to(torch.float64)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {what}: non-finite output")
        diff = (got - want).abs().max().item()
        err[name] = max(err[name], diff)
        if tq == "per_row" and diff != 0.0:
            raise AssertionError(f"{name} {what}: per_row must be bit-exact, "
                                 f"max |diff| {diff}")
        rel = diff / max(want.abs().max().item(), 1e-30)
        if rel > 1e-4:
            raise AssertionError(f"{name} {what}: rel err {rel:.3g} > 1e-4")

    for m in ROWS:
        for n, k in SHAPES:
            g = k // KG
            x = torch.randn(m, k, generator=gen, device="cuda")
            qw = random_weight(gen, n, k)
            w_bf16 = dequantize(qw).to(torch.bfloat16)
            x_bf16 = x.to(torch.bfloat16)
            library_mm = lambda: torch.matmul(x_bf16, w_bf16.T)
            _, bm, bn, bg = lk.tile_for(m, KG)
            xp = ops._pad_to(ops._pad_to(x, bm, 0), bg * KG, 1).contiguous()
            gp = xp.shape[1] // KG
            pkp, wsp = ops._pad_packed(qw, gp, bn)
            basis = T.sign_basis(KG, "cuda")
            groups = x.reshape(m * g, KG)
            pw = dict(k_group=KG, planes=BITS, plane_scales=qw.plane_scales)
            for tq in MODES:
                what = f"M={m} N={n} K={k} table_quant={tq}"
                rs = (ops._padded_row_scale(x, g, KG, bm).contiguous()
                      if tq == "per_row" else None)
                rs_tp = rs[:m].contiguous() if rs is not None else None
                # table precompute
                got = tk.table_precompute(x, KG, tq, rs_tp)
                want = tk.table_precompute_plain(x, KG, tq, rs_tp)
                for gv, wv in zip(got, want):
                    if wv is not None:
                        compare("table_precompute", gv, wv, tq, what)
                # staged lookup on the (padded) table
                tv, ts = tk.table_precompute_plain(xp, KG, tq, rs)
                got = lk.lut_mpgemm(tv, ts, pkp, wsp, **pw)
                want = lk.lut_mpgemm_plain(tv, ts, pkp, wsp, **pw)
                compare("lut_mpgemm", got, want, tq, what)
                # fused
                fw = dict(pw, table_quant=tq)
                got = fk.fused_lut_mpgemm(xp, rs, pkp, wsp, **fw)
                want = fk.fused_lut_mpgemm_plain(xp, rs, pkp, wsp, **fw)
                compare("fused_lut_mpgemm", got, want, tq, what)
                if tq != "per_row":
                    continue
                # times and bounds (the main path runs per_row)
                pk_bytes = qw.packed.numel() + 4 * n
                out_bytes = 4 * m * n
                lut_ops = {"int8": 2 * m * n * k}
                entry_ops = {"f32": m * g * e * (KG - 1)}
                recs = {
                    "table_precompute": (
                        lambda: tk.table_precompute(x, KG, tq, rs_tp),
                        lambda: tk.table_precompute_plain(x, KG, tq, rs_tp),
                        lambda: torch.matmul(groups, basis),
                        4 * m * k + 4 * m + m * g * e, entry_ops),
                    "lut_mpgemm": (
                        lambda: lk.lut_mpgemm(tv, ts, pkp, wsp, **pw),
                        lambda: lk.lut_mpgemm_plain(tv, ts, pkp, wsp, **pw),
                        library_mm, m * g * e + 4 * m + pk_bytes + out_bytes,
                        lut_ops),
                    "fused_lut_mpgemm": (
                        lambda: fk.fused_lut_mpgemm(xp, rs, pkp, wsp, **fw),
                        lambda: fk.fused_lut_mpgemm_plain(xp, rs, pkp, wsp,
                                                          **fw),
                        library_mm, 4 * m * k + 4 * m + pk_bytes + out_bytes,
                        dict(lut_ops, **entry_ops)),
                }
                for name, (kern, plain, lib, nbytes, nops) in recs.items():
                    b_ms, b_by = bound(nbytes, nops)
                    records.append({
                        "kernel": name, "m": m, "n": n, "k": k,
                        "table_quant": tq,
                        "kernel_ms": time_ms(kern, 10, flush),
                        "plain_ms": time_ms(plain, 3, flush),
                        "library_ms": time_ms(lib, 10, flush),
                        "bound_ms": b_ms, "bound_by": b_by})
    return records, err


def serve(cfg, params, seed):
    """Phase 4: 4 requests through the engine; returns (engine, requests)."""
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, max_batch=4, max_seq=256,
                        decode_chunk=8, prefill_chunk=128)
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(130, 201))),
                    max_new_tokens=16) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    torch.cuda.synchronize()
    return eng, reqs


def decode_step_profile(eng):
    """Wall time of a decode chunk (host clock, synchronized) against the
    device time of its kernels (torch.profiler), per decode step. The
    profiler runs on a second chunk, so its host overhead stays out of the
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    n = eng.decode_chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._decode_chunk(sampling=False)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._decode_chunk(sampling=False)
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time_total
    busy_ms = sum(per_name.values()) / 1e3 / n
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms,
            # None: the profiler saw no device activity (not measured)
            "busy_ms": busy_ms if per_name else None,
            "idle_share": 1.0 - busy_ms / wall_ms if per_name else None,
            "top": [(name[:60], t / 1e3 / n) for name, t in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_lut_mpgemm as fk
    from repro_torch.kernels import lut_mpgemm as lk
    from repro_torch.kernels import table_precompute as tk
    from repro_torch.models import api

    t_start = time.perf_counter()
    card = device_line()
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    paths = _build.build_all()
    ptxas = {n: [ln.strip() for ln in (_build.BUILD_DIR / f"{n}.ptxas.txt")
                 .read_text().splitlines() if "registers" in ln]
             for n in paths if (_build.BUILD_DIR / f"{n}.ptxas.txt").exists()}
    print(f"build: {len(paths)} kernels in {_build.build_seconds:.1f} s "
          f"(nvcc {_build.nvcc_path()})", flush=True)

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    records, err = check_kernels(flush)
    print("kernels: " + "; ".join(
        f"{r['kernel']} M={r['m']} N={r['n']} K={r['k']}: "
        f"{r['kernel_ms']:.4f} ms (plain {r['plain_ms']:.4f}, bf16 matmul "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
        f"{r['bound_by']})" for r in records), flush=True)
    print("kernels vs plain: max |diff| " + ", ".join(
        f"{k} {v:.3g}" for k, v in err.items())
        + " (per_row bit-exact; None/per_group <= 1e-4 relative)", flush=True)

    # phase 4: the main path, at full width
    cfg = registry.get_config("tinyllama-1.1b").replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode="lut_pallas",
                                                   fusion="auto")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = api.init_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    print(f"serve: tinyllama-1.1b W2 params made on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    serve(cfg, params, seed=1)  # warm-up: lazy CUDA/cuBLAS state, kernels
    kernels = {"table_precompute": tk, "lut_mpgemm": lk,
               "fused_lut_mpgemm": fk}
    for mod in kernels.values():
        mod.launches = 0
    eng, reqs = serve(cfg, params, seed=2)
    launches = {name: mod.launches for name, mod in kernels.items()}
    st = eng.stats()
    if not all(r.done and len(r.output) == 16 for r in reqs):
        raise AssertionError("serve: not every request finished with 16 tokens")
    if min(launches.values()) <= 0:
        raise AssertionError(f"serve: a kernel never ran: {launches}")
    if st["host_syncs_per_token"] > 1.0 / eng.decode_chunk:
        raise AssertionError(f"serve: {st['host_syncs_per_token']} host syncs "
                             f"per token > 1/{eng.decode_chunk}")
    # one more decode chunk with torch's sync check armed: any call in the
    # chunk that makes the host wait for the card raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_chunk(sampling=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step = decode_step_profile(eng)
    print(f"serve: {len(reqs)} requests, prompts "
          f"{[len(r.prompt) for r in reqs]}, {st['decode_tokens']} tokens; "
          f"decode {st['decode_tok_s']:.1f} tok/s, chunk p50 "
          f"{st['p50_chunk_ms']:.1f} ms / p95 {st['p95_chunk_ms']:.1f} ms, "
          f"host syncs/token {st['host_syncs_per_token']:.4f} (a decode chunk "
          f"under torch's sync check: no hidden sync); launches "
          f"{launches}", flush=True)

    busy = ("device busy not measured (the profiler saw no device events)"
            if step["busy_ms"] is None else
            f"device busy {step['busy_ms']:.2f} ms (idle share "
            f"{step['idle_share']:.3f}); device time by kernel: " + ", ".join(
                f"{n} {t:.2f} ms" for n, t in step["top"]))
    print(f"serve: one decode step (4 slots, 22 layers): wall "
          f"{step['wall_ms']:.2f} ms, {busy}", flush=True)

    # phase 5: kernels vs plain LUT path through the whole model
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")
    logits = {}
    for mode in ("lut_pallas", "lut_xla"):
        c = cfg.with_quant(mpgemm_mode=mode, table_quant="per_row")
        logits[mode] = api.forward(params, {"tokens": toks}, c)[0]
    a, b = logits["lut_pallas"], logits["lut_xla"]
    if tuple(a.shape) != (1, 128, cfg.vocab_size) or not torch.isfinite(a).all():
        raise AssertionError(f"parity: bad logits {tuple(a.shape)}")
    diff = (a - b).abs().max().item()
    print(f"parity: 128-token forward, lut_pallas vs lut_xla (per_row), max "
          f"|logit diff| {diff} (tolerance 0: exact), max |logit| "
          f"{a.abs().max().item():.4g}", flush=True)
    if diff != 0.0:
        raise AssertionError("parity: kernels and plain path disagree")

    main_recs = [r for r in records if r["m"] == MAIN_M[r["kernel"]]
                 and (r["kernel"] != "table_precompute"
                      or (r["n"], r["k"]) in ((2048, 2048), (2048, 5632)))]
    sources = {"table_precompute": ("src/repro_torch/csrc/table_precompute.cu",
                                    "src/repro/kernels/table_precompute.py:62"),
               "lut_mpgemm": ("src/repro_torch/csrc/lut_mpgemm.cu",
                              "src/repro/kernels/lut_mpgemm.py:119"),
               "fused_lut_mpgemm": ("src/repro_torch/csrc/fused_lut_mpgemm.cu",
                                    "src/repro/kernels/fused_lut_mpgemm.py:126")}
    summary = []
    for name, (src, replaces) in sources.items():
        rs = [r for r in main_recs if r["kernel"] == name]
        tot = lambda key: float(sum(r[key] for r in rs))
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err[name],
            "ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] for r in rs if r["bound_by"] == by)),
            "library_ms": tot("library_ms"),
            "shapes": [[r["m"], r["n"], r["k"]] for r in rs]})
    with open(_build.BUILD_DIR / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "records": records, "summary": summary,
                   "serve": st, "decode_step": step, "launches": launches,
                   "ptxas": ptxas,
                   "parity_max_abs_diff": diff,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
