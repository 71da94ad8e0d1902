"""The model-axis mesh on the CPU: ranks spawned over gloo
(``launch.mesh.spawn``, a ``file://`` rendezvous under the test's tmp
dir, one torch thread a rank), each running ``launch.mesh_job.run`` on one
set of the reference's weights carried in through
``convert.from_jax_params(..., plan=)``.

What the ranks must give (1x2 and 1x4; reduced tinyllama-1.1b has 2 KV
heads, so 1x4 runs attention whole and splits the MLP, embedding and head):
  * fp16 (packed weights dequantized, and the float tree) and float-table
    lut_xla logits within 1e-4 of the port's single-device forward and of
    the reference's ``api.forward``: GSPMD-style sharding changes no
    result, so only f32 summation order moves them;
  * per_row tables: a row-parallel layer's table codes on its K-range
    equal the single-device table's codes there (the whole row's scale is
    the max of the ranks' scales), and the logits stay within the
    tie-flip allowance of tests/test_torch_configs.py (0.15, greedy token
    equal at >= 90% of the positions): the partial sums of a row-parallel
    layer move its output by f32 rounding, and an INT8 code downstream
    then flips where an entry sits within that of a rounding boundary;
  * reduced olmoe-1b-7b at 1x2: every MoE layer's output bit-equal to the
    single-device layer's (each expert runs whole on one rank);
  * reduced paper-bitnet-3b (ternary) at 1x2;
  * engine streams at 1x2 (greedy, sampled with the same seed, beam, spec,
    the paged pool with prefix caching) equal to the single-device
    engine's, and equal on every rank;
  * ``launch/serve.py --tp 2 --device cpu``; the refusals (FSDP, a
    sequence axis, the SSM, hybrid, VLM and audio families under any
    mesh).
"""

import pickle
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import mesh_job
from repro_torch.models import api as tapi
from repro_torch.models.convert import from_jax_params

KG = 4
# tests/test_torch_configs.py's per_row tolerance (rtol = atol)
PER_ROW_TOL = 0.15
REQ_KW = dict(max_batch=4, max_seq=64, decode_chunk=4, prefill_chunk=16)


def _cfg(arch, mode="lut_xla", tq=None, quantized=True):
    cfg = treg.get_reduced(arch).replace(activation_dtype=torch.float32)
    if not quantized:
        return cfg.replace(quant=None)
    return cfg.with_quant(mpgemm_mode=mode, table_quant=tq)


def _jcfg(arch, mode="lut_xla", tq=None, quantized=True):
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    cfg = jreg.get_reduced(arch).replace(activation_dtype=jnp.float32)
    if not quantized:
        return cfg.replace(quant=None)
    return cfg.with_quant(mpgemm_mode=mode, table_quant=tq)


def _plain(node):
    """The reference's numpy tree with each packed weight as a plain
    namespace (a rank unpickles it without the reference package)."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if hasattr(node, "plane_scales"):
        arr = lambda a: None if a is None else np.asarray(a)
        return types.SimpleNamespace(
            packed=arr(node.packed), scale=arr(node.scale),
            zero_prime=arr(node.zero_prime), cw=arr(node.cw),
            plane_scales=node.plane_scales, bits=node.bits,
            k_group=node.k_group, k_total=node.k_total, n=node.n,
            plane_start=node.plane_start, stored_planes=node.stored_planes)
    return np.asarray(node)


def _tokens(vocab, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape))


def _requests(vocab):
    """Five requests sharing a 20-token prefix (the paged pool's prefix
    cache reuses its blocks), 6 new tokens each."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, 20)
    return [dict(uid=i, prompt=np.concatenate(
        [shared, rng.integers(0, vocab, 3 + 2 * i)]), max_new_tokens=6)
        for i in range(5)]


SERVES = {  # name: (engine kwargs beyond REQ_KW, request kwargs)
    "greedy": ({}, {}),
    "sample": ({"seed": 3}, dict(decoding="sample", temperature=0.9,
                                 top_k=40, top_p=0.9)),
    "beam": ({}, dict(decoding="beam:2")),
    "spec": ({"spec_draft_planes": 1, "spec_k": 2},
             dict(decoding="spec:draft1b")),
    "paged": ({"cache_block_size": 8, "prefix_cache": True}, {}),
}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's reduced trees (tinyllama packed and float, olmoe
    and paper-bitnet-3b packed: float params from the reference's init,
    packed by its ``quantize_params`` in one jitted program), as reference
    params and pickled plain numpy trees."""
    import jax
    from repro.models import api as japi
    from repro.models import quantized as jquant
    d = tmp_path_factory.mktemp("tp_weights")
    out = {}
    for name, arch in (("tiny", "tinyllama-1.1b"), ("olmoe", "olmoe-1b-7b"),
                       ("bitnet", "paper-bitnet-3b")):
        jc = _jcfg(arch)
        floats = japi.init_params(jax.random.key(1), jc,
                                  serve_quantized=False)
        packed = jax.jit(lambda tree: jquant.quantize_params(
            tree, jc.quant))(floats)
        trees = {name: (True, packed)}
        if name == "tiny":
            trees["tiny_float"] = (False, floats)
        for key, (quantized, params) in trees.items():
            np_tree = _plain(jax.tree.map(np.asarray, params))
            path = d / f"{key}.pkl"
            with open(path, "wb") as f:
                pickle.dump(np_tree, f)
            out[key] = (arch, quantized, params, np_tree, str(path))
    return out


def _job(weights, name, **parts):
    arch, quantized, _, _, path = weights[name]
    return dict(cfg=_cfg(arch, quantized=quantized), np_tree=path, **parts)


TINY_TOKENS = _tokens(512, (2, 20), 1)
FORWARDS = {  # name: (mode, table_quant)
    "fp16": ("fp16", None), "lut_xla": ("lut_xla", None),
    "per_row": ("lut_xla", "per_row"), "pallas_per_row": ("lut_pallas",
                                                          "per_row")}


def _jobs(weights, model):
    tiny = {n: (_cfg("tinyllama-1.1b", mode, tq), TINY_TOKENS)
            for n, (mode, tq) in FORWARDS.items()}
    rng = np.random.default_rng(5)
    x_row = torch.from_numpy(rng.normal(size=(6, 192)).astype(np.float32))
    jobs = [_job(weights, "tiny", forwards=tiny, probes={"tables": (
                 _tables_probe, ([(x_row, KG, "lut_xla"),
                                  (x_row, KG, "lut_pallas")],))}),
            _job(weights, "tiny_float", forwards={"float": (
                _cfg("tinyllama-1.1b", quantized=False), TINY_TOKENS)})]
    if model == 2:
        reqs = _requests(512)
        jobs[0]["serves"] = {
            name: (_cfg("tinyllama-1.1b"), dict(REQ_KW, **ekw),
                   [dict(r, **rkw) for r in reqs])
            for name, (ekw, rkw) in SERVES.items()}
        ocfg = _cfg("olmoe-1b-7b", "lut_pallas", "per_row")
        xs = [torch.from_numpy(rng.normal(size=(2, 9, ocfg.d_model)).astype(
            np.float32)) for _ in range(ocfg.n_layers)]
        jobs.append(_job(weights, "olmoe", probes={"moe": (
            _moe_probe, (ocfg, xs))}, forwards={
            "per_row": (ocfg, _tokens(ocfg.vocab_size, (2, 12), 2))}))
        jobs.append(_job(weights, "bitnet", forwards={
            "lut_xla": (_cfg("paper-bitnet-3b"),
                        _tokens(512, (2, 12), 3))}))
    return jobs


def _tables_probe(ctx, items):
    """Each (x, k_group, mode): this rank's K-range of x and its per_row
    table quantized with the max of the ranks' row scales, as a
    row-parallel layer builds it (``layers._row_parallel``)."""
    from repro_torch.core import mpgemm as mp
    from repro_torch.distributed import collectives
    from repro_torch.models.layers import _k_block
    out = []
    for x, kg, mode in items:
        xl = _k_block(x)
        rs = collectives.all_reduce(mp.row_scale(xl, kg, mode), "max")
        t = mp.precompute_tables(xl, kg, "per_row", mode, rs)
        out.append((t.values, t.scale))
    return out


def _moe_probe(ctx, cfg, xs):
    """Each MoE layer's ``moe_mlp_apply`` on its given input x_l."""
    from repro_torch.models import moe
    return [moe.moe_mlp_apply(lp["moe"], x, cfg, cfg.quant, aux=False)[0]
            for lp, x in zip(ctx["params"]["layers"], xs)]


@pytest.fixture(scope="module")
def spawned(weights, tmp_path_factory):
    """model axis size -> every rank's job results, each mesh spawned
    once."""
    cache = {}

    def get(model):
        if model not in cache:
            init = tmp_path_factory.mktemp(f"rdzv{model}") / "init"
            cache[model] = mesh_mod.spawn(
                mesh_job.run, model, device="cpu",
                init_method=f"file://{init}",
                args=(_jobs(weights, model),), threads=1)
        return cache[model]

    return get


MESHES = pytest.mark.parametrize("model", [2, 4], ids=["1x2", "1x4"])


@pytest.fixture
def ranks(spawned, model):
    """(model axis size, every rank's job results)."""
    return model, spawned(model)


def _single(weights, name, cfg):
    _, _, _, np_tree, _ = weights[name]
    return from_jax_params(np_tree, cfg, "cpu")


@MESHES
def test_ranks_agree_bit_for_bit(ranks):
    model, res = ranks
    assert len(res) == model
    for j in range(len(res[0])):
        first = res[0][j]
        assert first["backend"] == "gloo"
        for r in res[1:]:
            assert r[j]["replicated_digest"] == first["replicated_digest"]
            assert r[j]["forwards"].keys() == first["forwards"].keys()
            assert all(torch.equal(v, first["forwards"][k])
                       for k, v in r[j]["forwards"].items())
            assert {k: v["outputs"] for k, v in r[j]["serves"].items()} == {
                k: v["outputs"] for k, v in first["serves"].items()}
            if "moe" in first["probes"]:
                assert all(torch.equal(a, b) for a, b in zip(
                    r[j]["probes"]["moe"], first["probes"]["moe"]))


@MESHES
@pytest.mark.parametrize("name", ["fp16", "lut_xla", "float"])
def test_float_paths_match_single_device_and_reference(ranks, weights, name):
    import jax.numpy as jnp
    from repro.models import api as japi
    model, res = ranks
    job = 1 if name == "float" else 0
    wname = "tiny_float" if name == "float" else "tiny"
    mode, tq = FORWARDS.get(name, (None, None))
    cfg = _cfg("tinyllama-1.1b", mode, tq, quantized=name != "float")
    got = res[0][job]["forwards"][name]
    single = tapi.forward(_single(weights, wname, cfg),
                          {"tokens": TINY_TOKENS}, cfg)[0]
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-4,
                               atol=1e-4)
    jc = _jcfg("tinyllama-1.1b", mode, tq, quantized=name != "float")
    want, _, _ = japi.forward(weights[wname][2], {"tokens": jnp.asarray(
        TINY_TOKENS.numpy(), jnp.int32)}, jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-4, atol=1e-4)


@MESHES
@pytest.mark.parametrize("name", ["per_row", "pallas_per_row"])
def test_per_row_logits_within_the_tie_flip_allowance(ranks, weights, name):
    model, res = ranks
    mode, tq = FORWARDS[name]
    cfg = _cfg("tinyllama-1.1b", mode, tq)
    got = res[0][0]["forwards"][name].numpy()
    want = tapi.forward(_single(weights, "tiny", cfg),
                        {"tokens": TINY_TOKENS}, cfg)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=PER_ROW_TOL, atol=PER_ROW_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def _plan_of(m):
    return SH.AxisPlan(mesh=SH.Mesh(("data", "model"), (1, m), (0, 0), {}))


@MESHES
@pytest.mark.parametrize("name", ["lut_xla", "per_row", "pallas_per_row"])
def test_logits_equal_the_one_device_control(ranks, weights, name):
    """The mesh adds exactly the split contractions to the single-device
    arithmetic: the logits equal, bit for bit, one device's forward with
    each split linear contracted block by block as the ranks do
    (``sharding.one_device_control``: ``wo`` and ``down`` over the m
    K-ranges with the whole row's scale, the column blocks concatenated)."""
    model, res = ranks
    mode, tq = FORWARDS[name]
    cfg = _cfg("tinyllama-1.1b", mode, tq)
    ctl = SH.one_device_control(_single(weights, "tiny", cfg), _plan_of(model),
                                cfg)
    want = tapi.forward(ctl, {"tokens": TINY_TOKENS}, cfg)[0]
    assert torch.equal(res[0][0]["forwards"][name], want)


@MESHES
def test_row_parallel_table_codes_equal_single_device(ranks):
    from repro_torch.core.table import precompute_table
    model, res = ranks
    x = _jobs_tables_x()
    want = precompute_table(x, KG, "per_row")
    g = want.values.shape[1] // model
    for r, out in enumerate(res):
        for values, scale in out[0]["probes"]["tables"]:
            assert torch.equal(values, want.values[:, r * g:(r + 1) * g])
            assert torch.equal(scale.reshape(-1), want.scale.reshape(-1))


def _jobs_tables_x():
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.normal(size=(6, 192)).astype(np.float32))


def test_moe_layers_bit_equal_single_device(spawned, weights):
    from repro_torch.models import moe
    res = spawned(2)
    _, (cfg, xs) = _jobs(weights, 2)[2]["probes"]["moe"]
    params = _single(weights, "olmoe", cfg)
    for lp, x, got in zip(params["layers"], xs, res[0][2]["probes"]["moe"]):
        want, _ = moe.moe_mlp_apply(lp["moe"], x, cfg, cfg.quant, aux=False)
        assert torch.equal(got, want)
    # the whole model, per_row: within the tie-flip allowance
    ocfg, toks = _jobs(weights, 2)[2]["forwards"]["per_row"]
    want = tapi.forward(params, {"tokens": toks}, ocfg)[0].numpy()
    got = res[0][2]["forwards"]["per_row"].numpy()
    np.testing.assert_allclose(got, want, rtol=PER_ROW_TOL, atol=PER_ROW_TOL)


def test_bitnet_float_tables_match_single_device(spawned, weights):
    res = spawned(2)
    cfg, toks = _jobs(weights, 2)[3]["forwards"]["lut_xla"]
    want = tapi.forward(_single(weights, "bitnet", cfg), {"tokens": toks},
                        cfg)[0]
    np.testing.assert_allclose(res[0][3]["forwards"]["lut_xla"].numpy(),
                               want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(SERVES))
def test_engine_streams_equal_single_device(spawned, weights, name):
    """Tokens equal; beam scores (f32 sums of log-probs) within 1e-5."""
    from repro_torch.serving.engine import Request, ServingEngine
    res = spawned(2)
    cfg = _cfg("tinyllama-1.1b")
    ekw, rkw = SERVES[name]
    eng = ServingEngine(cfg, _single(weights, "tiny", cfg),
                        **dict(REQ_KW, **ekw))
    reqs = [Request(**dict(r, **rkw)) for r in _requests(512)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    got = res[0][0]["serves"][name]
    assert got["outputs"] == [r.output for r in reqs]
    assert all(len(o) > 0 for o in got["outputs"])
    if name == "beam":
        for got_b, r in zip(got["beams"], reqs):
            assert [t for t, _ in got_b] == [t for t, _ in r.beams]
            np.testing.assert_allclose([s for _, s in got_b],
                                       [s for _, s in r.beams], rtol=1e-5)
    mesh = got["stats"]["mesh"]
    assert mesh["shape"] == {"data": 1, "model": 2}
    assert mesh["backend"] == "gloo" and mesh["collective_calls"] > 0
    assert mesh["host_staged_bytes"] == 0
    if name == "paged":
        assert got["stats"]["prefill_tokens_reused"] > 0


def test_serve_entry_point_tp2_on_cpu(capfd):
    from repro_torch.launch import serve
    assert serve.main(["--reduced", "--device", "cpu", "--tp", "2",
                       "--requests", "2", "--max-new", "4",
                       "--mode", "lut_pallas"]) == 0
    out = capfd.readouterr().out
    assert "serving mesh 1x2 (data x model) over 2 ranks, backend gloo" in out
    assert out.count("served 2 requests / 8 tokens") == 1  # rank 0 alone
    assert "mesh: {'data': 1, 'model': 2}" in out


def test_refusals():
    """What stays refused: a sequence axis, and the SSM, hybrid, VLM and
    audio families under a mesh, whether it splits the model or the batch
    (a data axis and ``--mesh 2x1`` are served: tests/test_torch_dp.py).
    ``make_plan`` maps FSDP onto the data axis, the reference's default
    (training under a mesh: tests/test_torch_train_mesh.py); serving
    passes ``fsdp=False``, and the engine refuses an FSDP plan."""
    from repro_torch.distributed import collectives
    from repro_torch.launch import serve
    fsdp_plan = mesh_mod.make_plan(mesh_mod.make_serving_mesh(), fsdp=True)
    assert fsdp_plan.fsdp == "data" and fsdp_plan.resolve("fsdp") == "data"
    assert mesh_mod.make_plan(mesh_mod.make_serving_mesh()) == fsdp_plan
    assert mesh_mod.make_plan(mesh_mod.make_serving_mesh(),
                              fsdp=False).fsdp is None
    seq_plan = SH.AxisPlan(mesh=SH.Mesh(("data", "model"), (2, 1), (0, 0),
                                        {}), seq="data")
    with SH.plan_scope(seq_plan):
        for op in (collectives.sp_scatter, collectives.sp_gather):
            with pytest.raises(NotImplementedError, match="queue 1 item 9"):
                op(torch.zeros(2, 4))
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--mesh", "1x2",
                    "--tp", "2"])
    from repro_torch.serving.engine import ServingEngine
    for shape in ((1, 2), (2, 1), (2, 2)):
        plan = SH.AxisPlan(mesh=SH.Mesh(("data", "model"), shape, (0, 0),
                                        {"data": None, "model": None}))
        for arch in ("falcon-mamba-7b", "zamba2-7b", "llama-3.2-vision-11b",
                     "whisper-tiny"):
            cfg = _cfg(arch)
            params = tapi.init_params(torch.Generator().manual_seed(0), cfg,
                                      "cpu")
            with pytest.raises(ValueError, match="queue 1 item 9"):
                ServingEngine(cfg, params, plan=plan, max_batch=2,
                              max_seq=16)
            with pytest.raises(ValueError, match="queue 1 item 9"):
                tapi.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu", plan=plan)
    cfg = _cfg("tinyllama-1.1b")
    params = tapi.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="without FSDP"):
        ServingEngine(cfg, params, max_batch=2, max_seq=16,
                      plan=SH.AxisPlan(mesh=SH.Mesh(("data", "model"),
                                                    (2, 1), (0, 0), {}),
                                       fsdp="data"))


def test_a_rank_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.rank_device(0, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.spawn(mesh_job.run, 2, args=([],))
