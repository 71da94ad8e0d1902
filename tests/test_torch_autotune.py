"""Port autotuner and design-space model: the contracts of
tests/test_autotune.py and tests/test_lmma_dse.py inside the port (CPU,
one torch thread, tiny shapes, repeats=1); the property-based ones are in
test_torch_autotune_properties.py.

  * candidates: the heuristic's own plan first, every candidate a plan the
    wrappers accept;
  * durability: corrupt, truncated and unknown-version files warn and
    degrade; a foreign backend's file (the reference's too) is kept and
    sanitized at lookup; malformed entries are skipped; concurrent writers
    never tear the file;
  * tuning: tune -> save -> reload gives the same dispatch; tuned numerics
    equal auto's; tuned without a cache is auto; the engine's ``pretune``
    and a ``fusion="tuned"`` serve;
  * ``shape_key``, ``mux_density`` and ``tile_traffic`` equal the
    reference's.
"""

import json
import threading
import warnings

import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import dse as jdse
from repro_torch.configs import registry as treg
from repro_torch.core import autotune, dse, lmma
from repro_torch.core.autotune import TunedConfig, TuningCache
from repro_torch.core.quantize import quantize
from repro_torch.kernels import fused_lut_mpgemm as fused_kernel
from repro_torch.kernels import lut_mpgemm as lut_kernel
from repro_torch.kernels import ops
from repro_torch.models import api, layers
from repro_torch.obs import dispatch as dispatch_obs
from repro_torch.serving.engine import Request, ServingEngine

from test_torch_serving import _one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(4, 512, 16, 4, 2), (16, 256, 7, 3, 1), (64, 2048, 256, 8, 3),
          (128, 2048, 512, 4, 2), (1, 130, 40, 4, 4)]


@pytest.fixture(autouse=True)
def _no_active_cache():
    """Every test starts and ends without an active cache or recorder."""
    autotune.deactivate()
    dispatch_obs.disable()
    yield
    autotune.deactivate()
    dispatch_obs.disable()


@pytest.fixture(scope="module")
def tiny_qw():
    rng = np.random.default_rng(7)
    return quantize(torch.from_numpy(rng.normal(size=(128, 64)).astype(
        np.float32)), 2, k_group=4)


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tq", ["per_row", None])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_candidate_configs_heuristic_first(shape, tq):
    """Candidate 0 is what "auto" runs (the fusion rule, the kernels' own
    tile and S); the rest are other plans the wrappers accept, the other
    fusion on the heuristic's tile among them."""
    m, n, g, kg, planes = shape
    cands = autotune.candidate_configs(m, n, g, kg, planes, table_quant=tq,
                                       max_candidates=4)
    assert 1 < len(cands) <= 4
    assert cands[0].source == "heuristic"
    assert all(c.source == "measured" for c in cands[1:])
    assert len({c.knobs for c in cands}) == len(cands)
    hf = ops.auto_fusion(m, n, g, kg, planes)
    config, _, _, _, s = ops.kernel_plan(m, n, g, kg, planes, tq, hf)
    assert cands[0].knobs == (hf, config, s)
    assert cands[1].fusion != hf and cands[1].tile == config
    for c in cands:
        assert autotune.sanitize_config(c, m, n, g, kg, planes, tq) == c
        ops.kernel_plan(m, n, g, kg, planes, tq, c.fusion, c.tile, c.splits)
    assert len(autotune.candidate_configs(m, n, g, kg, planes,
                                          table_quant=tq,
                                          max_candidates=1)) == 1


def test_kernel_plan_is_the_wrappers_plan():
    """With no tile or S given, ``kernel_plan`` is each path's own plan."""
    m, n, g, kg, planes = 4, 2048, 512, 4, 2
    assert ops.kernel_plan(m, n, g, kg, planes, "per_row", "fused") == (
        0, 16, 128, 32, 8)
    tile, s, _ = fused_kernel.int_plan(m, n, g, kg, planes)
    assert ops.kernel_plan(m, n, g, kg, planes, "per_row", "fused") == (
        *tile, s)
    tile, s, _ = lut_kernel.staged_plan(1, 128, n, g, kg, planes)
    assert ops.kernel_plan(128, n, g, kg, planes, "per_row", "staged") == (
        *tile, s)
    tile, s, _ = lut_kernel.f32_plan(128, n, g, kg, planes)
    for fusion in ("fused", "staged"):
        assert ops.kernel_plan(128, n, g, kg, planes, None, fusion) == (
            *tile, s)
    # a tile and S given replace the plan's; S beyond the K-steps raises
    got = ops.kernel_plan(128, n, g, kg, planes, "per_row", "staged", 1, 3)
    assert (got[0], got[4]) == (1, 3)
    with pytest.raises(ValueError, match="splits"):
        ops.kernel_plan(m, n, g, kg, planes, "per_row", "fused", 0, 17)
    with pytest.raises(ValueError, match="tile"):
        ops.kernel_plan(m, n, g, kg, planes, "per_row", "fused", 3)


# ---------------------------------------------------------------------------
# durability
# ---------------------------------------------------------------------------

def _write(path, entries, **head):
    doc = {"version": autotune.CACHE_FORMAT_VERSION, "backend": "cpu",
           "torch_version": torch.__version__,
           "cuda_version": torch.version.cuda, "entries": entries}
    doc.update(head)
    path.write_text(json.dumps(doc))
    return str(path)


def test_corrupt_cache_warns_and_degrades(tmp_path):
    p = tmp_path / "cache.json"
    p.write_text("{garbage not json")
    with pytest.warns(UserWarning, match="unreadable"):
        cache = TuningCache(str(p))
    assert len(cache) == 0 and not cache.foreign


def test_truncated_cache_warns_and_degrades(tmp_path):
    cache = TuningCache(str(tmp_path / "good.json"))
    cache.put(autotune.shape_key(4, 512, 16, 4, 2),
              TunedConfig("fused", 0, 4))
    cache.save()
    text = (tmp_path / "good.json").read_text()
    trunc = tmp_path / "trunc.json"
    trunc.write_text(text[: len(text) // 2])
    with pytest.warns(UserWarning, match="unreadable"):
        assert len(TuningCache(str(trunc))) == 0


def test_version_mismatch_warns_and_degrades(tmp_path):
    p = _write(tmp_path / "cache.json",
               {"m4.n512.g16.kg4.w2.f32.tqper_row":
                TunedConfig("fused", 0, 4).as_dict()}, version=99)
    with pytest.warns(UserWarning, match="unknown format"):
        assert len(TuningCache(p)) == 0


def test_foreign_backend_kept_but_sanitized(tmp_path):
    """A file tuned on another card warns, keeps its entries, and every
    lookup repairs or drops them: an absurd plan cannot reach a kernel."""
    good = autotune.shape_key(4, 512, 16, 4, 2)
    bad = autotune.shape_key(4, 512, 16, 4, 2, table_quant=None)
    p = _write(tmp_path / "cache.json",
               {good: TunedConfig("fused", 99, 10 ** 6).as_dict(),
                bad: TunedConfig("fused", -1, 2).as_dict()},
               backend="NVIDIA H100 80GB HBM3", cuda_version="12.4")
    with pytest.warns(UserWarning, match="re-validated"):
        cache = autotune.configure(p)
    assert cache.foreign and len(cache) == 2
    tc = autotune.lookup_tuned(4, 512, 16, 4, 2)
    assert tc.tile == len(lut_kernel.INT_TILES) - 1
    bg = ops.kernel_plan(4, 512, 16, 4, 2, "per_row", "fused", tc.tile)[3]
    assert tc.splits == lut_kernel.max_splits(-(-16 // bg))
    assert autotune.lookup_tuned(4, 512, 16, 4, 2, table_quant=None) is None
    assert cache.counters()["sanitized"] == 2
    # the dropped entry falls back to the heuristic
    assert ops.resolve_dispatch(4, 512, 16, 4, 2, fusion="tuned",
                            table_quant=None).source == "heuristic"


def test_reference_cache_file_is_kept_and_falls_back(tmp_path):
    """A cache the reference wrote (its blocks are no knob of the port's
    kernels) loads as foreign with a warning; its entries are skipped, and
    "tuned" dispatch falls back to the heuristic."""
    p = str(tmp_path / "ref.json")
    ref = jautotune.TuningCache(p, backend="cpu")
    key = jautotune.shape_key(4, 512, 16, 4, 2)
    assert key == autotune.shape_key(4, 512, 16, 4, 2)
    ref.put(key, jautotune.TunedConfig("staged", 8, 256, 16))
    ref.save()
    with pytest.warns(UserWarning, match="re-validated"):
        cache = autotune.configure(p)
    assert cache.foreign and len(cache) == 0
    assert ops.resolve_dispatch(4, 512, 16, 4, 2, fusion="tuned") == \
        ops.resolve_dispatch(4, 512, 16, 4, 2)


def test_malformed_entries_skipped_rest_kept(tmp_path):
    good = autotune.shape_key(4, 512, 16, 4, 2)
    p = tmp_path / "cache.json"
    # json writes and reads inf as Infinity: int(inf) is an OverflowError
    p.write_text(json.dumps({
        "version": autotune.CACHE_FORMAT_VERSION, "backend": "cpu",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "entries": {
            good: TunedConfig("fused", 0, 4).as_dict(),
            "bad-1": "not a dict",
            "bad-2": {"fusion": "fused", "tile": "x", "splits": 1},
            "bad-3": {"fusion": "fused", "tile": float("inf"), "splits": 1},
            "bad-4": {"fusion": "fused", "tile": 0, "splits": float("nan")},
            "bad-5": {"fusion": "staged", "block_m": 8},
        }}))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a same-backend file: no warning
        cache = TuningCache(str(p))
    assert len(cache) == 1 and cache.lookup(good) is not None


def test_concurrent_writers_never_tear_the_file(tmp_path):
    p = str(tmp_path / "cache.json")
    errors = []

    def writer(tid):
        try:
            cache = TuningCache(p, backend="cpu")
            for i in range(20):
                cache.put(f"m{tid}.n{i}.g1.kg4.w2.f32.tqper_row",
                          TunedConfig("staged", 0, 1, steady_ms=i))
                cache.save()
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    def reader():
        import os
        for _ in range(200):
            if not os.path.exists(p):
                continue
            try:
                with open(p) as f:
                    json.load(f)
            except json.JSONDecodeError as e:  # pragma: no cover
                errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    threads.append(threading.Thread(target=reader))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    assert len(TuningCache(p, backend="cpu")) > 0


# ---------------------------------------------------------------------------
# tuning: round trip, numerics, fallback, memo
# ---------------------------------------------------------------------------

def test_tune_roundtrip_identical_dispatch(tmp_path, tiny_qw):
    qw, m = tiny_qw, 4
    cache = TuningCache(str(tmp_path / "cache.json"))
    best, measured = autotune.tune_mpgemm(m, qw, cache=cache, repeats=1,
                                          max_candidates=2)
    assert len(measured) == 2 and measured[0].source == "heuristic"
    assert best.source == "measured" and best.steady_ms > 0
    assert all(c.compile_ms > 0 for c in measured)
    assert best.steady_ms <= best.heuristic_ms + 1e-9
    cache.save()
    want = ops.Plan(best.fusion, best.tile, best.splits, "tuned")
    for _ in range(2):  # the second as a fresh process would load it
        autotune.configure(cache.path)
        assert ops.resolve_dispatch(m, qw.n, qw.g, qw.k_group, qw.num_planes,
                                fusion="tuned") == want
        autotune.deactivate()


@pytest.mark.parametrize("tq", ["per_row", None])
def test_tuned_numerics_match_auto(tiny_qw, tq):
    """A tuned plan with another fusion, tile and S gives auto's bits on
    the CPU (per_row: exact integer sums; float tables: the same plain
    ops)."""
    qw, m = tiny_qw, 4
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(m, qw.k_total)).astype(np.float32))
    want = ops.lut_mpgemm(x, qw, table_quant=tq, fusion="auto")
    assert ops.resolve_dispatch(m, qw.n, qw.g, qw.k_group,
                                qw.num_planes).fusion == "fused"
    cache = autotune.configure(None)
    cache.put(autotune.shape_key(m, qw.n, qw.g, qw.k_group, qw.num_planes,
                                 table_quant=tq),
              TunedConfig("staged", 1, 1))
    with dispatch_obs.recording() as rec:
        got = ops.lut_mpgemm(x, qw, table_quant=tq, fusion="tuned")
    assert torch.equal(got, want)
    (r,) = rec.records("dispatch")
    assert (r.source, r.fusion, r.splits) == ("tuned", "staged", 1)
    tiles = lut_kernel.INT_TILES if tq == "per_row" else lut_kernel.BF16_TILES
    assert (r.block_m, r.block_n) == tuple(tiles[1][:2])


def test_tuned_without_cache_falls_back_to_auto(tiny_qw):
    qw, m = tiny_qw, 4
    want = ops.resolve_dispatch(m, qw.n, qw.g, qw.k_group, qw.num_planes)
    got = ops.resolve_dispatch(m, qw.n, qw.g, qw.k_group, qw.num_planes,
                           fusion="tuned")
    assert got == want and got.source == "heuristic"


def test_lookup_memo_follows_the_active_cache():
    """lookup_tuned is memoized per shape; storing an entry, configuring
    another cache or deactivating invalidates it."""
    args = (4, 512, 128, 4, 2)
    key = autotune.shape_key(*args)
    cache = autotune.configure(None)
    assert autotune.lookup_tuned(*args) is None
    assert autotune.lookup_tuned(*args) is None
    assert cache.counters()["misses"] == 1  # memoized
    cache.put(key, TunedConfig("staged", 0, 2))
    assert autotune.lookup_tuned(*args).knobs == ("staged", 0, 2)
    assert ops.resolve_dispatch(*args, fusion="tuned").fusion == "staged"
    assert autotune.lookup_fusion_any(4, 128, 4, 2) == "staged"
    cache.put(key, TunedConfig("fused", 0, 1))
    assert autotune.lookup_tuned(*args).knobs == ("fused", 0, 1)
    assert autotune.lookup_fusion_any(4, 128, 4, 2) == "fused"
    autotune.configure(None)
    assert autotune.lookup_tuned(*args) is None
    autotune.deactivate()
    assert autotune.lookup_fusion_any(4, 128, 4, 2) is None


def test_lookup_fusion_any_votes_the_largest_n():
    cache = autotune.configure(None)
    cache.put(autotune.shape_key(4, 256, 16, 4, 2),
              TunedConfig("staged", 0, 1))
    cache.put(autotune.shape_key(4, 2048, 16, 4, 2),
              TunedConfig("fused", 0, 1))
    cache.put(autotune.shape_key(8, 4096, 16, 4, 2),
              TunedConfig("staged", 0, 1))
    assert autotune.lookup_fusion_any(4, 16, 4, 2) == "fused"
    assert autotune.lookup_fusion_any(4, 32, 4, 2) is None
    quant = {"fusion": "tuned", "k_group": 4, "weight_bits": 2}
    assert layers.resolve_fusion(4, 64, quant) == "fused"
    assert layers.resolve_fusion(8, 64, quant) == "staged"
    # a miss falls back to the heuristic's vote
    assert layers.resolve_fusion(128, 2048, quant) == layers.resolve_fusion(
        128, 2048, dict(quant, fusion="auto"))


def test_wrappers_check_a_given_plan_on_the_cpu(tiny_qw):
    """A tile or S the kernels would refuse raises on the CPU too."""
    qw = tiny_qw
    x = torch.ones((4, qw.k_total))
    with pytest.raises(ValueError, match="tile"):
        ops.lut_mpgemm(x, qw, fusion="fused", tile=5)
    with pytest.raises(ValueError, match="splits"):
        ops.lut_mpgemm(x, qw, fusion="staged", splits=99)
    with pytest.raises(ValueError, match="splits"):
        ops.lut_mpgemm(x, qw, table_quant=None, fusion="fused", splits=0)


# ---------------------------------------------------------------------------
# the engine: pretune and a tuned serve
# ---------------------------------------------------------------------------

def _engine_cfg(fusion):
    return treg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=torch.float32).with_quant(
        mpgemm_mode="lut_pallas", table_quant="per_row", fusion=fusion)


def test_engine_pretune_then_tuned_serve(tmp_path):
    """pretune() tunes every projection shape at M = max_batch and
    prefill_chunk and saves the cache; a fusion="tuned" serve dispatches
    every projection from it, with auto's tokens (per_row: exact)."""
    gen = torch.Generator()
    gen.manual_seed(0)
    cfg = _engine_cfg("auto")
    params = api.init_params(gen, cfg, "cpu")
    kw = dict(max_batch=2, max_seq=64, decode_chunk=4, prefill_chunk=8)
    prompts = [np.random.default_rng(s).integers(0, cfg.vocab_size, 11)
               for s in range(3)]

    def serve(eng):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        return [r.output for r in reqs]

    want = serve(ServingEngine(cfg, params, **kw))
    path = str(tmp_path / "tc.json")
    eng = ServingEngine(_engine_cfg("tuned"), params, tuning_cache=path,
                        **kw)
    shapes = autotune.collect_qw_shapes(params)
    assert eng.pretune(repeats=1, max_candidates=2) == 2 * len(shapes)
    assert eng.pretune(repeats=1, max_candidates=2) == 0  # all cached
    assert len(TuningCache(path)) == 2 * len(shapes)
    with dispatch_obs.recording():
        assert serve(eng) == want
        s = eng.stats()["dispatch"]
    assert s["decisions"] > 0 and s["tuned"] == s["decisions"]
    assert eng.stats()["tuning_cache"]["hits"] == s["decisions"]


def test_pretune_outside_lut_pallas_warns(tmp_path):
    cfg = _engine_cfg("tuned").with_quant(mpgemm_mode="lut_xla")
    gen = torch.Generator()
    gen.manual_seed(0)
    eng = ServingEngine(cfg, api.init_params(gen, cfg, "cpu"), max_batch=2,
                        max_seq=32, tuning_cache=str(tmp_path / "tc.json"))
    with pytest.warns(UserWarning, match="no-op"):
        assert eng.pretune() == 0


# ---------------------------------------------------------------------------
# the reference's keys and DSE models; LMMA descriptors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tq", ["per_row", "per_group", None])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_shape_key_equals_the_reference(shape, tq):
    m, n, g, kg, planes = shape
    assert autotune.shape_key(m, n, g, kg, planes, table_quant=tq) == \
        jautotune.shape_key(m, n, g, kg, planes, table_quant=tq)


def test_mux_density_and_tile_traffic_equal_the_reference():
    for k in range(1, 9):
        for kw in (dict(), dict(lut_bits=16, fp_accum=True),
                   dict(symmetrized=False), dict(fused_precompute=False)):
            assert dse.mux_density(k, **kw) == jdse.mux_density(k, **kw)
    for args in ((2, 64, 4), (4, 2048, 2048), (128, 256, 5632)):
        for kw in (dict(), dict(k_group=2, w_bits=4, lut_bits=16)):
            assert dse.tile_traffic(*args, **kw) == jdse.tile_traffic(
                *args, **kw)
    assert dse.sweep_tiles() == jdse.sweep_tiles()


def test_dse_paper_and_hopper_optima():
    assert dse.best_k_mux(8, False) == 4   # paper Fig 11, INT tables
    assert dse.best_k_mux(16, True) == 5   # paper Fig 11, FP tables
    assert dse.best_k_tensor_core() <= 2   # int8 tensor cores
    assert dse.best_k_tensor_core(int8_tables=False) <= 2
    # float tables pay three bf16 passes at half the int8 rate
    assert dse.tensor_core_cost(4, int8_tables=False)["compute"] == \
        pytest.approx(dse.tensor_core_cost(4)["compute"] * 3 * 1979 / 989)


def test_dse_symmetrization_and_fusion_improve_density():
    for k in (2, 3, 4, 5):
        assert dse.mux_density(k, symmetrized=True) > \
            dse.mux_density(k, symmetrized=False)
    for k in (2, 4):
        assert dse.mux_density(k, fused_precompute=True) > \
            dse.mux_density(k, fused_precompute=False)


def test_tile_traffic_eq7_eq8():
    r = dse.tile_traffic(2, 64, 4, k_group=4, w_bits=2, lut_bits=8)
    assert r["table"] == 2 * 1 * 8 * 1
    assert r["weights"] == 64 * 1 * 4 * 2 / 8


def test_lmma_name_and_schedule():
    d = lmma.LMMADescriptor(m=2, n=64, k=4096, a_dtype="bf16", w_bits=2)
    assert d.name().startswith("lmma.m2n64k4096.")
    ts = lmma.schedule_tiles(lmma.LMMADescriptor(m=4096, n=8192, k=8192,
                                                 w_bits=2, k_group=4))
    assert ts.bn >= 2 * ts.bm and ts.bn % 128 == 0
    assert ts.vmem_bytes <= lmma.SCHEDULE_BYTES
    small = lmma.schedule_tiles(lmma.LMMADescriptor(m=8, n=128, k=64,
                                                    w_bits=1, k_group=2))
    assert small.bm >= 8 and small.bn >= 128 and small.bg >= 8


def test_select_fusion_records_its_decision():
    desc = lmma.LMMADescriptor(m=4, n=2048, k=2048, w_bits=2, k_group=4)
    with dispatch_obs.recording() as rec:
        fusion = lmma.select_fusion(desc)
    (r,) = rec.records("select_fusion")
    assert (r.key, r.fusion, r.source) == (desc.name(), fusion, "heuristic")
