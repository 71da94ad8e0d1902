"""Port telemetry: tests/test_telemetry.py's contracts inside the port, on
the reduced tinyllama-1.1b engine (CPU, one torch thread).

  * the metrics registry: bounded histograms with exact aggregates and
    interpolated percentiles, get-or-create, Prometheus text; the same
    observations give the reference's percentiles and ``export_stats``
    names (``repro.obs.metrics``);
  * the tracer: nesting, validation, save / load, its torch.profiler
    annotation;
  * the dispatch recorder, and ``ops.resolve_dispatch`` recording its decision
    (and, with no recorder, building no record);
  * the engine: every ``BASE_KEYS`` key of ``stats()`` present and finite,
    fresh and after a serve, in dense, paged, spec and beam pools; the
    trace's span taxonomy, with the reference engine's counts per (name,
    phase) on the same prompts and weights; tracing changes no token and
    no sync count; ``reset()`` zeroes the series; the tuning cache's
    counters; the snapshot and Prometheus text.
"""

import json
import math
import threading

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.obs import metrics as jmetrics
from repro.obs.trace import Tracer as JTracer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.models.convert import from_jax_params
from repro_torch.obs import dispatch as dispatch_obs
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, export_stats)
from repro_torch.obs.trace import Tracer, load_trace, validate_chrome_trace
from repro_torch.serving.engine import Request, ServingEngine

from test_torch_serving import _one_torch_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_counter_and_gauge_basics():
    c = Counter("c_total")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = Gauge("g")
    g.set(2.5)
    g.add(-1.0)
    assert g.value == 1.5
    with pytest.raises(ValueError):
        Counter("0bad name")


def test_histogram_bounded_reservoir_exact_aggregates():
    h = Histogram("h", reservoir_size=64)
    xs = np.arange(5000, dtype=float)
    for x in xs:
        h.observe(x)
    snap = h.snapshot()
    assert len(h._res) <= 64
    assert snap["count"] == 5000
    assert snap["sum"] == pytest.approx(xs.sum())
    assert snap["min"] == 0.0 and snap["max"] == 4999.0
    assert snap["mean"] == pytest.approx(xs.mean())
    assert 1000 < snap["p50"] < 4000


def test_histogram_interpolated_percentiles():
    """p50 20.0 and p95 29.0 of 10, 20 and 30 (numpy "linear"), not the
    nearest rank; 2.5 the median of 1..4; empty histograms are 0."""
    h = Histogram("h2")
    for v in (10.0, 20.0, 30.0):
        h.observe(v)
    assert h.percentile(0.50) == pytest.approx(20.0)
    assert h.percentile(0.95) == pytest.approx(29.0)
    assert h.percentile(0.95) == pytest.approx(
        float(np.percentile([10, 20, 30], 95)))
    h2 = Histogram("h3")
    for v in (1.0, 2.0, 3.0, 4.0):
        h2.observe(v)
    assert h2.percentile(0.5) == pytest.approx(2.5)
    with pytest.raises(ValueError):
        h2.percentile(1.5)
    empty = Histogram("h4").snapshot()
    assert all(math.isfinite(v) for v in empty.values()
               if isinstance(v, float))
    assert Histogram("h5").percentile(0.99) == 0.0


@pytest.mark.parametrize("n", [3, 100, 3000])
def test_histogram_and_export_match_the_reference(n):
    """The same observations give the reference's count, sum, min, max,
    mean and percentiles (within 1e-12; below the reservoir size the sample
    is every observation) and export_stats writes the same gauge names."""
    rng = np.random.default_rng(n)
    xs = rng.exponential(0.01, n)
    size = 4096
    ours = Histogram("lat_seconds", reservoir_size=size)
    ref = jmetrics.Histogram("lat_seconds", reservoir_size=size)
    for x in xs:
        ours.observe(x)
        ref.observe(x)
    a, b = ours.snapshot(), ref.snapshot()
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float):
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-12), k
        else:
            assert a[k] == b[k], k
    stats = {"decode_tokens": n, "p50_chunk_ms": float(xs[0]),
             "spec": {"verify_steps": 3, "draft-planes": 2},
             "mesh": None, "paged": True, "tuning_cache": {"path": "x"}}
    r1, r2 = MetricsRegistry(), jmetrics.MetricsRegistry()
    assert export_stats(r1, stats) == jmetrics.export_stats(r2, stats)
    assert r1.names() == r2.names()
    for name in r1.names():
        assert r1.get(name).value == r2.get(name).value


def test_registry_to_json_matches_the_reference():
    """``MetricsRegistry.to_json`` gives the reference's text for the same
    instruments and observations, at the default indent and another."""
    regs = MetricsRegistry(), jmetrics.MetricsRegistry()
    for r in regs:
        r.set_common_labels(host="0", arch="tinyllama-1.1b")
        r.counter("req_total", help="requests").inc(3)
        r.gauge("slot_occupancy_ratio").set(0.75)
        h = r.histogram("lat_seconds", help="latency", unit="s")
        for x in (0.5, 0.125, 2.0, 0.25):
            h.observe(x)
    ours, ref = regs
    assert ours.to_json() == ref.to_json()
    assert ours.to_json(indent=None) == ref.to_json(indent=None)
    assert json.loads(ours.to_json()) == ours.snapshot()


def test_registry_get_or_create_reset_and_kind_conflict():
    r = MetricsRegistry()
    c1 = r.counter("x_total")
    assert r.counter("x_total") is c1
    with pytest.raises(ValueError):
        r.histogram("x_total")
    r.counter("engine_a").inc(3)
    r.counter("pool_b").inc(7)
    r.reset("engine_")
    assert r.get("engine_a").value == 0
    assert r.get("pool_b").value == 7


def test_prometheus_text_exposition():
    r = MetricsRegistry()
    r.set_common_labels(host="0")
    r.counter("req_total", help="requests").inc(2)
    r.histogram("lat_seconds", help="latency").observe(0.5)
    txt = r.prometheus_text()
    assert "# HELP req_total requests" in txt
    assert "# TYPE req_total counter" in txt
    assert 'req_total{host="0"} 2' in txt
    assert "# TYPE lat_seconds summary" in txt
    assert 'quantile="0.95"' in txt
    assert 'lat_seconds_count{host="0"} 1' in txt
    json.dumps(r.snapshot())


def test_registry_thread_safety():
    r = MetricsRegistry()
    c = r.counter("n_total")
    h = r.histogram("v", reservoir_size=32)

    def work():
        for i in range(2000):
            c.inc()
            h.observe(float(i))

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert c.value == 8 * 2000 and h.count == 8 * 2000
    assert len(h._res) <= 32


def test_export_stats_flattens_nested_numbers():
    r = MetricsRegistry()
    n = export_stats(r, {"a": 1, "nested": {"b": 2.5, "skip": "str"},
                         "none": None, "flag": True}, prefix="eng")
    assert n == 2
    assert r.get("eng_a").value == 1.0
    assert r.get("eng_nested_b").value == 2.5
    assert r.get("eng_flag") is None


# ---------------------------------------------------------------------------
# tracer and validation
# ---------------------------------------------------------------------------

def test_tracer_spans_nest_and_validate():
    tr = Tracer(annotate_torch_profiler=False)
    with tr.span("outer", a=1):
        with tr.span("inner"):
            pass
        tr.instant("mark")
    tr.async_begin("request", id=7, mode="greedy")
    tr.async_end("request", id=7, tokens=3)
    doc = tr.chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    summary = validate_chrome_trace(doc["traceEvents"])
    assert summary["by_phase"]["X"] == 2
    assert summary["by_phase"]["b"] == summary["by_phase"]["e"] == 1
    evs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert evs["inner"]["ts"] >= evs["outer"]["ts"]
    assert (evs["inner"]["ts"] + evs["inner"]["dur"]
            <= evs["outer"]["ts"] + evs["outer"]["dur"] + 1e-3)
    assert evs["outer"]["args"] == {"a": 1}


def test_tracer_threads_get_tracks_and_disabled_records_nothing():
    tr = Tracer(annotate_torch_profiler=False)
    barrier = threading.Barrier(3)

    def work():
        with tr.span("thread_span"):
            barrier.wait(timeout=10)

    ts = [threading.Thread(target=work) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    with tr.span("main_span"):
        pass
    assert validate_chrome_trace(tr.chrome_trace()["traceEvents"])[
        "tracks"] == 4
    off = Tracer(enabled=False)
    with off.span("x"):
        off.instant("y")
    off.async_begin("request", id=1)
    off.async_end("request", id=1)
    assert len(off) == 0


def test_validate_rejects_bad_traces():
    base = {"pid": 1, "tid": 1, "ts": 0.0}
    with pytest.raises(ValueError, match="begin without end"):
        validate_chrome_trace([dict(base, name="r", ph="b", cat="request",
                                    id=1)])
    with pytest.raises(ValueError, match="without begin"):
        validate_chrome_trace([dict(base, name="r", ph="e", cat="request",
                                    id=1)])
    x = {"pid": 1, "tid": 1, "cat": "c"}
    with pytest.raises(ValueError, match="must nest"):
        validate_chrome_trace([dict(x, name="a", ph="X", ts=0.0, dur=10.0),
                               dict(x, name="b", ph="X", ts=5.0, dur=10.0)])
    with pytest.raises(ValueError, match="dur"):
        validate_chrome_trace([dict(x, name="a", ph="X", ts=0.0)])
    with pytest.raises(ValueError, match="missing or mistyped"):
        validate_chrome_trace([{"name": "a", "ph": "X"}])


def test_trace_save_load_roundtrip(tmp_path):
    tr = Tracer(annotate_torch_profiler=False)
    with tr.span("s", k="v"):
        pass
    evs = load_trace(tr.save(str(tmp_path / "t.json")))
    validate_chrome_trace(evs)
    assert any(e["name"] == "s" and e["args"] == {"k": "v"} for e in evs)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([1, 2]))
    with pytest.raises(ValueError, match="traceEvents"):
        load_trace(str(bad))


def test_spans_annotate_the_torch_profiler():
    """With the annotation on, a span is a record_function range in a
    torch.profiler trace taken around it; off, it is not."""
    from torch.profiler import ProfilerActivity, profile
    for on in (True, False):
        tr = Tracer(annotate_torch_profiler=on)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tr.span("decode_chunk"):
                torch.ones(4).sum()
        names = {e.key for e in prof.key_averages()}
        assert ("decode_chunk" in names) == on
        assert len(tr) == 3  # process / thread names and the span


# ---------------------------------------------------------------------------
# dispatch profiling
# ---------------------------------------------------------------------------

def test_dispatch_recorder_dedup_and_summary():
    rec = dispatch_obs.DispatchRecorder()
    rec.record("dispatch", "k1", "fused", "auto", "heuristic", (16, 128, 32),
               8)
    rec.record("dispatch", "k1", "fused", "auto", "heuristic", (16, 128, 32),
               8)
    rec.record("dispatch", "k2", "staged", "tuned", "tuned", (16, 128, 16))
    rec.record("select_fusion", "d1", "fused", "auto", "heuristic")
    s = rec.summary()
    assert s["decisions"] == 2
    assert s["tuned"] == 1 and s["heuristic"] == 1 and s["forced"] == 0
    r1 = next(r for r in rec.records("dispatch") if r.key == "k1")
    assert r1.count == 2 and r1.block_n == 128 and r1.splits == 8
    json.dumps(s)


def test_recording_context_restores_previous():
    prev = dispatch_obs.get_active()
    with dispatch_obs.recording() as rec:
        assert dispatch_obs.get_active() is rec
        dispatch_obs.record("dispatch", "k", "fused", "auto", "heuristic")
        assert len(rec) == 1
    assert dispatch_obs.get_active() is prev


def test_resolve_dispatch_records_its_decision():
    """Each call is one dispatch (count), keyed by autotune.shape_key, with
    the kernel's tile and S; forced policies are recorded as such."""
    with dispatch_obs.recording() as rec:
        for _ in range(3):
            plan = ops.resolve_dispatch(4, 2048, 512, 4, 2)
    (r,) = rec.records("dispatch")
    _, bm, bn, bg, s = ops.kernel_plan(4, 2048, 512, 4, 2, "per_row",
                                       plan.fusion)
    assert (r.fusion, r.requested, r.source, r.count) == (
        plan.fusion, "auto", "heuristic", 3)
    assert r.key == "m4.n2048.g512.kg4.w2.f32.tqper_row"
    assert (r.block_m, r.block_n, r.block_g, r.splits) == (bm, bn, bg, s)
    with dispatch_obs.recording() as rec:
        ops.resolve_dispatch(4, 2048, 512, 4, 2, fusion="staged",
                         table_quant=None)
    (r,) = rec.records("dispatch")
    assert (r.source, r.fusion) == ("forced", "staged")
    assert r.key.endswith(".tqnone")


def test_no_recorder_builds_no_record(monkeypatch):
    """With no recorder active the dispatch builds neither the key nor the
    kernel plan: its one added cost is the check."""
    def boom(*a, **k):
        raise AssertionError("record built with no recorder active")
    dispatch_obs.disable()
    monkeypatch.setattr(ops, "kernel_plan", boom)
    monkeypatch.setattr(ops.autotune, "shape_key", boom)
    assert ops.resolve_dispatch(4, 2048, 512, 4, 2).source == "heuristic"
    assert ops.resolve_dispatch(128, 2048, 512, 4, 2).fusion == "staged"


# ---------------------------------------------------------------------------
# engine: stats schema, trace, behaviour
# ---------------------------------------------------------------------------

BASE_KEYS = {
    "decode_chunk", "prefill_chunk", "decode_syncs", "decode_tokens",
    "host_syncs_per_token", "prefill_dispatches", "p50_chunk_ms",
    "p95_chunk_ms", "decode_tok_s", "paged", "mesh", "cache_hbm_bytes",
    "slot_occupancy", "peak_active_slots", "admit_attempts", "admit_blocked",
    "admission_blocked_rate", "prefill_s", "prefill_tokens",
    "prefill_tokens_reused",
}


def _assert_finite(obj, path="stats"):
    if isinstance(obj, dict):
        for k, v in obj.items():
            _assert_finite(v, f"{path}.{k}")
    elif isinstance(obj, bool) or obj is None or isinstance(obj, str):
        pass
    else:
        assert np.isfinite(obj), f"non-finite {path} = {obj!r}"


def _quant(cfg):
    # packed store, so the same params serve the spec pool too
    return cfg.with_quant(mpgemm_mode="lut_xla", weight_bits=4,
                          store="packed", skip="lm_head")


@pytest.fixture(scope="module")
def tl():
    """(reference cfg, reference params, port cfg, port params): the same
    packed weights in both packages."""
    jc = _quant(jreg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=jnp.float32))
    jparams = japi.init_params(jax.random.key(0), jc, serve_quantized=True)
    tc = _quant(treg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=torch.float32))
    return jc, jparams, tc, from_jax_params(
        jax.tree.map(np.asarray, jparams), tc, "cpu")


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(4, 12)))
            for _ in range(n)]


ENGINE_CONFIGS = {
    "dense": (dict(), "greedy", set()),
    "paged": (dict(cache_block_size=8, prefix_cache=True), "greedy",
              {"cache_block_size", "num_cache_blocks", "blocks_in_use",
               "prefix_cache"}),
    "spec": (dict(spec_k=3, spec_draft_planes=2), "spec:draft2b", {"spec"}),
    "beam": (dict(), "beam:2", set()),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CONFIGS))
def test_stats_schema_fresh_and_post_retire(tl, name):
    _, _, tc, params = tl
    kw, dec, extra = ENGINE_CONFIGS[name]
    eng = ServingEngine(tc, params, max_batch=2, max_seq=64, decode_chunk=4,
                        prefill_chunk=4, **kw)
    fresh = eng.stats()
    assert BASE_KEYS <= set(fresh), BASE_KEYS - set(fresh)
    _assert_finite(fresh)
    assert fresh["decode_tok_s"] == 0.0 and fresh["p50_chunk_ms"] == 0.0
    assert fresh["mesh"] is None and fresh["slot_occupancy"] == 0.0
    for i, p in enumerate(_prompts(tc.vocab_size, 3)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=6, decoding=dec))
    if name == "beam":
        assert eng.step() and eng.stats()["beam"]["active_groups"] == 1
    eng.run_to_completion()
    st = eng.stats()
    assert (BASE_KEYS | extra) <= set(st), (BASE_KEYS | extra) - set(st)
    _assert_finite(st)
    assert st["decode_tokens"] > 0 and st["decode_tok_s"] > 0
    assert 0 < st["slot_occupancy"] <= 1.0
    assert eng._h_chunk_s.count == st["decode_syncs"]
    assert eng._h_prefill_s.count == st["prefill_dispatches"]
    if name == "spec":
        assert st["spec"]["verify_steps"] > 0
    if name == "paged":
        assert st["blocks_in_use"] == len(eng._prefix)


def test_percentiles_interpolate_in_stats(tl):
    _, _, tc, params = tl
    eng = ServingEngine(tc, params, max_batch=2, max_seq=64)
    for v in (0.010, 0.020, 0.030):
        eng._h_chunk_s.observe(v)
    st = eng.stats()
    assert st["p50_chunk_ms"] == pytest.approx(20.0)
    assert st["p95_chunk_ms"] == pytest.approx(29.0)
    assert st["decode_tok_s"] == 0.0  # no tokens yet
    assert not hasattr(eng, "_chunk_s")  # no unbounded per-chunk list


def _events(tracer):
    evs = tracer.chrome_trace()["traceEvents"]
    validate_chrome_trace(evs)
    return evs


def test_engine_trace_schema(tl):
    """Balanced async request spans (the zero-budget request's too), one
    decode_chunk span per sync with its attributes, an admit span per
    request, prefill spans, a prefix_hit instant for a shared prompt."""
    _, _, tc, params = tl
    tracer = Tracer(annotate_torch_profiler=False)
    eng = ServingEngine(tc, params, max_batch=2, max_seq=64, decode_chunk=4,
                        prefill_chunk=4, cache_block_size=8,
                        prefix_cache=True, tracer=tracer)
    prompts = _prompts(tc.vocab_size, 3)
    shared = np.concatenate([prompts[0], prompts[0], prompts[1]])
    for i, p in enumerate(prompts + [shared, shared]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    eng.submit(Request(uid=99, prompt=prompts[0], max_new_tokens=0))
    eng.run_to_completion()
    evs = _events(tracer)
    begins = [e for e in evs if e["ph"] == "b"]
    assert len(begins) == len([e for e in evs if e["ph"] == "e"]) == 6
    assert {e["id"] for e in begins} == {0, 1, 2, 3, 4, 99}
    chunks = [e for e in evs if e["name"] == "decode_chunk"]
    assert len(chunks) == eng.stats()["decode_syncs"]
    for c in chunks:
        assert 0 < c["args"]["occupancy"] <= 1.0
        assert c["args"]["active_slots"] >= 1 and c["args"]["steps"] == 4
    admits = [e for e in evs if e["name"] == "admit"]
    assert len(admits) == 6 and all(a["args"]["paged"] for a in admits)
    prefills = [e for e in evs if e["name"] == "prefill_chunk"]
    assert len(prefills) == eng.stats()["prefill_dispatches"]
    hits = [e for e in evs if e["name"] == "prefix_hit"]
    # the second of two equal prompts reuses the first one's blocks
    assert 4 in {h["args"]["uid"] for h in hits}


def _counts(evs):
    out = {}
    for e in evs:
        out[(e["name"], e["ph"])] = out.get((e["name"], e["ph"]), 0) + 1
    return out


def test_trace_counts_match_the_reference_engine(tl):
    """One dense pool's trace has the reference engine's counts per (name,
    phase) on the same prompts and weights."""
    jc, jparams, tc, params = tl
    prompts = _prompts(tc.vocab_size, 3, seed=1)
    kw = dict(max_batch=2, max_seq=64, decode_chunk=4, prefill_chunk=4)
    jtr = JTracer(annotate_xla=False)
    jeng = JEngine(jc, jparams, tracer=jtr, **kw)
    ttr = Tracer(annotate_torch_profiler=False)
    teng = ServingEngine(tc, params, tracer=ttr, **kw)
    for eng, req_cls in ((jeng, JRequest), (teng, Request)):
        for i, p in enumerate(prompts):
            eng.submit(req_cls(uid=i, prompt=p.astype(np.int32),
                               max_new_tokens=6))
        eng.submit(req_cls(uid=9, prompt=prompts[0].astype(np.int32),
                           max_new_tokens=0))
        eng.run_to_completion()
    want = _counts(jtr.chrome_trace()["traceEvents"])
    got = _counts(_events(ttr))
    assert got == want
    assert got[("decode_chunk", "X")] == teng.decode_syncs


def test_tracing_does_not_change_behaviour(tl):
    """Same tokens, same sync count, with and without a tracer (its
    profiler annotation on)."""
    _, _, tc, params = tl

    def serve(tracer):
        eng = ServingEngine(tc, params, max_batch=2, max_seq=64,
                            decode_chunk=4, prefill_chunk=4, tracer=tracer)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(_prompts(tc.vocab_size, 3))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        return [r.output for r in reqs], eng.stats()

    out_off, st_off = serve(None)
    out_on, st_on = serve(Tracer())
    assert out_on == out_off
    assert st_on["decode_syncs"] == st_off["decode_syncs"]
    assert st_on["host_syncs_per_token"] == st_off["host_syncs_per_token"]
    assert st_on["host_syncs_per_token"] <= 1 / 4


def test_engine_reset_zeroes_metric_series(tl):
    _, _, tc, params = tl
    eng = ServingEngine(tc, params, max_batch=2, max_seq=64)
    for i, p in enumerate(_prompts(tc.vocab_size, 2)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
    eng.run_to_completion()
    assert eng._h_chunk_s.count > 0 and eng._h_prefill_s.count > 0
    eng.reset()
    assert eng._h_chunk_s.count == 0 and eng._h_prefill_s.count == 0
    st = eng.stats()
    assert st["decode_tok_s"] == 0.0 and st["slot_occupancy"] == 0.0


def test_tuning_cache_counters_in_stats(tl, tmp_path):
    from repro_torch.core import autotune
    _, _, tc, params = tl
    try:
        eng = ServingEngine(tc, params, max_batch=2, max_seq=64,
                            tuning_cache=str(tmp_path / "tc.json"))
        assert autotune.get_active() is eng.tuning_cache
        counters = eng.stats()["tuning_cache"]
        for k in ("entries", "hits", "misses", "sanitized", "foreign"):
            assert k in counters
        eng.tuning_cache.lookup("nonexistent-shape")
        assert eng.stats()["tuning_cache"]["misses"] >= 1
        with dispatch_obs.recording():
            ops.resolve_dispatch(4, 2048, 512, 4, 2, fusion="tuned")
            assert eng.stats()["dispatch"] == {
                "decisions": 1, "tuned": 0, "heuristic": 1, "forced": 0}
    finally:
        autotune.deactivate()


def test_metrics_snapshot_and_prometheus(tl):
    _, _, tc, params = tl
    eng = ServingEngine(tc, params, max_batch=2, max_seq=64,
                        cache_block_size=8, prefix_cache=True)
    for i, p in enumerate(_prompts(tc.vocab_size, 2)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
    eng.run_to_completion()
    snap = eng.metrics_snapshot()
    m = snap["metrics"]
    assert m["engine_decode_chunk_seconds"]["count"] == eng.decode_syncs
    assert m["blockpool_blocks_granted_total"]["value"] > 0
    assert m["prefix_cache_misses_total"]["value"] >= 0
    assert m["engine_decode_tokens"]["value"] == eng.decode_tokens
    assert (m["blockpool_blocks_in_use"]["value"]
            == eng.stats()["blocks_in_use"])
    txt = eng.prometheus_text()
    assert "engine_decode_chunk_seconds_count" in txt
    assert "blockpool_blocks_in_use" in txt
    json.dumps(snap)
