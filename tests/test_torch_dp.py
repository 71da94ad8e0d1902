"""The data axis on the CPU: ranks spawned over gloo as in
tests/test_torch_tp.py (``launch.mesh.spawn``, a ``file://`` rendezvous,
one torch thread a rank), each running ``launch.mesh_job.run`` on a 2x1
and a 2x2 (data x model) mesh with the reference's weights carried in by
``convert.from_jax_params(..., plan=)``. Reduced tinyllama-1.1b; at 2x2
also reduced olmoe-1b-7b.

What the ranks must give, each against the mesh's one-device control
(``sharding.one_device_control``: the data ranks' row blocks in turn at
their row counts, the model ranks' blocks as in tests/test_torch_tp.py)
bit for bit, and against one device and the reference:
  * teacher-forced logits: equal to the control's; fp16 and float-table
    lut_xla within 1e-4 of the port's single-device forward and of the
    reference's ``api.forward``; per_row within the tie-flip allowance of
    tests/test_torch_configs.py (0.15);
  * engine streams (greedy, seeded sampled, beam, spec, fp16, per_row,
    the int8 KV cache, the paged pool with prefix caching, and a pool of 3
    slots, which 2 data ranks do not divide: the batch replicated) equal
    to the control's and equal on every rank; fp16 and float-table streams equal to one device's; a
    per_row stream may part from one device's only at a near tie (the
    top-2 margin there is recorded and held below twice the allowance);
  * the paged pool: a prompt ending on a block boundary leaves a pending
    divergence block on data rank 0; after its first decode chunk a
    request on data rank 1 shares it by reference, so the block must have
    reached rank 1 (``prefill_tokens_reused`` and the streams equal one
    device's, the shared blocks equal on both data ranks);
  * olmoe at 2x2 with capacity factor 1 (tokens dropped): each MoE layer
    on the data ranks' rows routes the whole batch, its keep mask equal to
    the reference's routing on the whole batch and its output equal to
    the single-device layer's bit for bit and to the reference's
    ``moe_mlp_apply`` within 1e-4;
  * ``api.init_params(..., plan=)`` equal leaf for leaf to
    ``shard_params(init_params(...))`` (no process group needed);
  * ``launch/serve.py --mesh 2x1`` prints on one rank.
"""

import hashlib
import pickle

import numpy as np
import pytest
import torch

from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import mesh_job
from repro_torch.models import api as tapi
from repro_torch.models.convert import from_jax_params
from test_torch_tp import PER_ROW_TOL, _cfg, _jcfg, _plain, _tokens

REQ_KW = dict(max_batch=4, max_seq=64, decode_chunk=4, prefill_chunk=16)
MESHES = pytest.mark.parametrize("model", [1, 2], ids=["2x1", "2x2"])
TOKENS = _tokens(512, (4, 20), 1)
FORWARDS = {  # name: (mode, table_quant)
    "fp16": ("fp16", None), "lut_xla": ("lut_xla", None),
    "per_row": ("lut_xla", "per_row"), "pallas_per_row": ("lut_pallas",
                                                          "per_row")}
SERVES = {  # name: (cfg args, engine kwargs beyond REQ_KW, request kwargs)
    "greedy": ((), {}, {}),
    "sample": ((), {"seed": 3}, dict(decoding="sample", temperature=0.9,
                                     top_k=40, top_p=0.9)),
    "beam": ((), {}, dict(decoding="beam:2")),
    "spec": ((), {"spec_draft_planes": 1, "spec_k": 2},
             dict(decoding="spec:draft1b")),
    "fp16": (("fp16",), {}, {}),
    "per_row": (("lut_pallas", "per_row"), {}, {}),
    "paged": ((), {"cache_block_size": 8, "prefix_cache": True}, None),
    "int8": (("lut_pallas", "per_row"), {"kv_cache_dtype": "int8"}, {}),
    # 2 data ranks do not divide 3 slots: every data rank owns every slot
    "odd_batch": ((), {"max_batch": 3}, {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as each rank has: a CPU GEMM's bits follow the
    thread count, and the control must run the ranks' arithmetic."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _requests(vocab):
    """Five requests sharing a 20-token prefix, 6 new tokens each."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, 20)
    return [dict(uid=i, prompt=np.concatenate(
        [shared, rng.integers(0, vocab, 3 + 2 * i)]), max_new_tokens=6)
        for i in range(5)]


def _paged_requests(vocab):
    """A 16-token prompt (two blocks of 8: its second is a pending
    divergence entry) in slot 0, two long fillers in slots 1 and 3, a
    short one in slot 2 (data rank 1) that frees it after the first chunk,
    then the first prompt plus 5 tokens, which lands in slot 2 and shares
    both blocks by reference."""
    rng = np.random.default_rng(8)
    head = rng.integers(0, vocab, 16)
    new = [8, 8, 2, 8]
    reqs = [dict(uid=i, prompt=head if i == 0 else rng.integers(
        0, vocab, 11), max_new_tokens=n) for i, n in enumerate(new)]
    reqs.append(dict(uid=4, prompt=np.concatenate(
        [head, rng.integers(0, vocab, 5)]), max_new_tokens=6))
    return reqs


def _serve_cfg(args):
    return _cfg("tinyllama-1.1b", *args)


def _serve_reqs(name):
    rkw = SERVES[name][2]
    if rkw is None:
        return _paged_requests(512)
    return [dict(r, **rkw) for r in _requests(512)]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's reduced trees (tinyllama packed and float, olmoe
    packed), as reference params and pickled plain numpy trees."""
    import jax
    from repro.models import api as japi
    from repro.models import quantized as jquant
    d = tmp_path_factory.mktemp("dp_weights")
    out = {}
    for name, arch in (("tiny", "tinyllama-1.1b"), ("olmoe", "olmoe-1b-7b")):
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


def _ocfg():
    """Reduced olmoe with capacity factor 1: tokens are dropped."""
    return _cfg("olmoe-1b-7b", "lut_xla").replace(capacity_factor=1.0)


def _moe_x(cfg):
    rng = np.random.default_rng(5)
    return [torch.from_numpy((rng.normal(size=(2, 16, cfg.d_model)) * 0.5)
                             .astype(np.float32))
            for _ in range(cfg.n_layers)]


def _jobs(weights, model):
    arch, _, _, _, path = weights["tiny"]
    tiny = dict(cfg=_cfg(arch), np_tree=path, forwards={
        n: (_cfg(arch, mode, tq), TOKENS)
        for n, (mode, tq) in FORWARDS.items()}, serves={
        name: (_serve_cfg(args), dict(REQ_KW, **ekw), _serve_reqs(name))
        for name, (args, ekw, _) in SERVES.items()},
        probes={"pool": (_pool_probe, ("paged",))})
    jobs = [tiny, dict(cfg=_cfg(arch, quantized=False),
                       np_tree=weights["tiny_float"][4], forwards={
                           "float": (_cfg(arch, quantized=False), TOKENS)})]
    if model == 2:
        ocfg = _ocfg()
        jobs.append(dict(cfg=ocfg, np_tree=weights["olmoe"][4], probes={
            "moe": (_moe_probe, (ocfg, _moe_x(ocfg)))}))
    return jobs


def _pool_probe(ctx, name):
    """A digest of each pool block the rank's ``name`` engine's prefix
    cache holds."""
    eng = ctx["engines"][name]
    out = {}
    for bid in sorted(set(eng._prefix._entries.values())):
        h = hashlib.sha256()
        for leaf in eng.caches:
            h.update(leaf[:, bid].contiguous().numpy().tobytes())
        out[bid] = h.hexdigest()
    return out


def _moe_probe(ctx, cfg, xs):
    """Each MoE layer on this data rank's rows of its input x_l: (its
    output rows, the whole batch's keep mask)."""
    from repro_torch.models import moe
    plan = ctx["plan"]
    rows = SH.local_rows(plan, xs[0].shape[0])
    out = []
    for lp, x in zip(ctx["params"]["layers"], xs):
        y, aux = moe.moe_mlp_apply(lp["moe"], x[rows], cfg, cfg.quant,
                                   aux=False, with_keep=True)
        out.append((y, aux["keep"]))
    return out


@pytest.fixture(scope="module")
def spawned(weights, tmp_path_factory):
    """model axis size -> every rank's job results on a 2 x model mesh,
    each mesh spawned once."""
    cache = {}

    def get(model):
        if model not in cache:
            init = tmp_path_factory.mktemp(f"dp_rdzv{model}") / "init"
            cache[model] = mesh_mod.spawn(
                mesh_job.run, 2 * model, device="cpu",
                init_method=f"file://{init}",
                args=(_jobs(weights, model), 2), threads=1)
        return cache[model]

    return get


def _plan_of(model):
    return SH.AxisPlan(mesh=SH.Mesh(("data", "model"), (2, model), (0, 0),
                                    {}))


def _single(weights, name, cfg):
    return from_jax_params(weights[name][3], cfg, "cpu")


def _engine_outputs(cfg, params, name, **kw):
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, **dict(REQ_KW, **SERVES[name][1], **kw))
    reqs = [Request(**r) for r in _serve_reqs(name)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs], [r.beams for r in reqs], eng.stats()


@pytest.fixture(scope="module")
def one_device(weights):
    """name -> the single-device engine's (outputs, beams, stats)."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = _serve_cfg(SERVES[name][0])
            cache[name] = _engine_outputs(cfg, _single(weights, "tiny", cfg),
                                          name)
        return cache[name]

    return get


@MESHES
def test_ranks_agree_and_split_the_slots(spawned, model):
    res = spawned(model)
    assert len(res) == 2 * model
    for r, ranks in enumerate(res):
        assert ranks[0]["coords"] == (r // model, r % model)
        mesh = ranks[0]["serves"]["greedy"]["stats"]["mesh"]
        assert mesh["shape"] == {"data": 2, "model": model}
        assert mesh["slots"] == [2 * (r // model), 2 * (r // model) + 2]
        odd = ranks[0]["serves"]["odd_batch"]["stats"]["mesh"]
        assert odd["slots"] == [0, 3]
        assert odd["collectives_by_axis"]["data"]["calls"] == 0
        by_axis = mesh["collectives_by_axis"]
        assert by_axis["data"]["calls"] > 0
        assert (by_axis["model"]["calls"] > 0) == (model > 1)
    for j in range(len(res[0])):
        first = res[0][j]
        for r in res[1:]:
            if r[j]["coords"][1] == first["coords"][1]:
                assert r[j]["replicated_digest"] == first[
                    "replicated_digest"]
            assert all(torch.equal(v, first["forwards"][k])
                       for k, v in r[j]["forwards"].items())
            assert {k: v["outputs"] for k, v in r[j]["serves"].items()} == {
                k: v["outputs"] for k, v in first["serves"].items()}


@MESHES
@pytest.mark.parametrize("name", ["lut_xla", "per_row", "pallas_per_row",
                                  "fp16"])
def test_logits_equal_the_one_device_control(spawned, weights, model, name):
    mode, tq = FORWARDS[name]
    cfg = _cfg("tinyllama-1.1b", mode, tq)
    ctl = SH.one_device_control(_single(weights, "tiny", cfg),
                                _plan_of(model), cfg)
    assert ctl["rows"] == 2
    want = tapi.forward(ctl, {"tokens": TOKENS}, cfg)[0]
    assert torch.equal(spawned(model)[0][0]["forwards"][name], want)


@MESHES
@pytest.mark.parametrize("name", ["fp16", "lut_xla", "float"])
def test_float_paths_match_single_device_and_reference(spawned, weights,
                                                       model, name):
    import jax.numpy as jnp
    from repro.models import api as japi
    job = 1 if name == "float" else 0
    wname = "tiny_float" if name == "float" else "tiny"
    mode, tq = FORWARDS.get(name, (None, None))
    cfg = _cfg("tinyllama-1.1b", mode, tq, quantized=name != "float")
    got = spawned(model)[0][job]["forwards"][name]
    single = tapi.forward(_single(weights, wname, cfg), {"tokens": TOKENS},
                          cfg)[0]
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-4,
                               atol=1e-4)
    jc = _jcfg("tinyllama-1.1b", mode, tq, quantized=name != "float")
    want, _, _ = japi.forward(weights[wname][2], {"tokens": jnp.asarray(
        TOKENS.numpy(), jnp.int32)}, jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-4, atol=1e-4)


@MESHES
@pytest.mark.parametrize("name", ["per_row", "pallas_per_row"])
def test_per_row_logits_within_the_tie_flip_allowance(spawned, weights,
                                                      model, name):
    mode, tq = FORWARDS[name]
    cfg = _cfg("tinyllama-1.1b", mode, tq)
    got = spawned(model)[0][0]["forwards"][name].numpy()
    want = tapi.forward(_single(weights, "tiny", cfg), {"tokens": TOKENS},
                        cfg)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=PER_ROW_TOL, atol=PER_ROW_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def _top2_margin(params, cfg, prompt, prefix):
    """The top-2 logit margin of one device's forward after ``prompt`` and
    the stream's agreed ``prefix``."""
    toks = torch.as_tensor(np.concatenate([prompt, prefix]))[None]
    top = torch.topk(tapi.forward(params, {"tokens": toks}, cfg)[0][0, -1],
                     2).values
    return float(top[0] - top[1])


@MESHES
@pytest.mark.parametrize("name", list(SERVES))
def test_streams_equal_the_control_and_one_device(spawned, weights,
                                                  one_device, model, name):
    """Tokens equal the control engine's (the one-device control served by
    a single-device engine: its decode forwards run the data ranks' row
    blocks) and, except per_row at a near tie, one device's; beam scores
    within 1e-5 of one device's; host syncs at most one a chunk."""
    got = spawned(model)[0][0]["serves"][name]
    cfg = _serve_cfg(SERVES[name][0])
    single = _single(weights, "tiny", cfg)
    ctl, _, _ = _engine_outputs(cfg, SH.one_device_control(
        single, _plan_of(model), cfg), name)
    assert got["outputs"] == ctl
    assert all(len(o) > 0 for o in got["outputs"])
    assert got["stats"]["host_syncs_per_token"] <= 1 / REQ_KW["decode_chunk"]
    want, beams, stats = one_device(name)
    if name == "per_row":
        margins = []
        for req, g, w in zip(_serve_reqs(name), got["outputs"], want):
            n = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                     None)
            if n is not None:
                margins.append(_top2_margin(single, cfg, req["prompt"],
                                            g[:n]))
        print(f"per_row streams parting from one device: top-2 margins "
              f"{margins}")
        assert all(m < 2 * PER_ROW_TOL for m in margins)
    else:
        assert got["outputs"] == want
    if name == "beam":
        for got_b, want_b in zip(got["beams"], beams):
            assert [t for t, _ in got_b] == [t for t, _ in want_b]
            np.testing.assert_allclose([s for _, s in got_b],
                                       [s for _, s in want_b], rtol=1e-5)
    if name == "paged":
        assert got["stats"]["prefill_tokens_reused"] == \
            stats["prefill_tokens_reused"] == 16 + 0


@MESHES
def test_shared_prefix_blocks_equal_on_every_data_rank(spawned, model):
    """The pending divergence block, written by data rank 0's slot in its
    first chunk, is the same on rank 1, which reads it by reference."""
    res = spawned(model)
    for m in range(model):  # a model rank's KV heads on each data rank
        pools = [r[0]["probes"]["pool"] for r in res
                 if r[0]["coords"][1] == m]
        assert len(pools) == 2 and len(pools[0]) >= 3
        assert pools[1] == pools[0]


def _reference_keep(jp, x, cfg):
    """The reference's keep mask [T, k] of ``moe_mlp_apply`` on x, from
    its routing lines (``src/repro/models/moe.py``)."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    t, k, e = x.shape[0] * x.shape[1], cfg.top_k, cfg.num_experts
    logits = jnp.dot(jnp.asarray(x.reshape(t, -1)), jp["router"]["w"])
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    eid = top_i.reshape(-1)
    order = jnp.argsort(eid)
    counts = jnp.bincount(eid, length=e)
    pos = jnp.arange(t * k) - (jnp.cumsum(counts) - counts)[eid[order]]
    keep = pos < jmoe._capacity(t, k, e, cfg.capacity_factor)
    return np.asarray(jnp.zeros(t * k, bool).at[order].set(keep)).reshape(
        t, k)


def test_moe_layers_route_the_whole_batch(spawned, weights):
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    res = spawned(2)
    cfg = _ocfg()
    xs = _moe_x(cfg)
    jc = _jcfg("olmoe-1b-7b", "lut_xla").replace(capacity_factor=1.0)
    params = _single(weights, "olmoe", cfg)
    dropped = 0
    for layer, (lp, x) in enumerate(zip(params["layers"], xs)):
        want, aux = moe.moe_mlp_apply(lp["moe"], x, cfg, cfg.quant,
                                      aux=False, with_keep=True)
        jp = jax.tree.map(lambda a: a[layer],
                          weights["olmoe"][2]["layers"])["moe"]
        ref = np.asarray(jmoe.moe_mlp_apply(jp, jnp.asarray(x.numpy()), jc,
                                            jc.quant)[0])
        assert np.array_equal(aux["keep"].numpy(),
                              _reference_keep(jp, x.numpy(), cfg))
        dropped += int((~aux["keep"]).sum())
        for r in res:  # rank (d, m) holds rows d of the batch
            y, keep = r[2]["probes"]["moe"][layer]
            d = r[2]["coords"][0]
            assert torch.equal(keep, aux["keep"])
            assert torch.equal(y, want[d:d + 1])
            np.testing.assert_allclose(y.numpy(), ref[d:d + 1], rtol=1e-4,
                                       atol=1e-4)
    assert dropped > 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 1)])
def test_init_params_with_a_plan_builds_the_ranks_blocks(arch, shape):
    """Each coordinate's per-rank build equals the whole build cut to its
    blocks, leaf for leaf."""
    cfg = _cfg(arch, "lut_pallas", "per_row")
    whole = tapi.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for d in range(shape[0]):
        for m in range(shape[1]):
            plan = SH.AxisPlan(mesh=SH.Mesh(("data", "model"), shape, (d, m),
                                            {}))
            got = tapi.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu", plan=plan)
            want = SH.shard_params(whole, plan, cfg)
            assert mesh_job.replicated_digest(got) == \
                mesh_job.replicated_digest(want)
            assert _leaves(got) == _leaves(want)


def _leaves(tree, path=""):
    """{path: (bytes digest, mark)} of every tensor, packed weight child
    and ``"tp"`` mark of a tree."""
    from repro_torch.core.quantize import QuantizedWeight
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}/{i}"))
    elif isinstance(tree, QuantizedWeight):
        for c in ("packed", "scale", "zero_prime", "cw"):
            if getattr(tree, c) is not None:
                out.update(_leaves(getattr(tree, c), f"{path}/{c}"))
        out[path] = (tree.n, tree.k_total)
    elif torch.is_tensor(tree):
        t = tree.contiguous()
        out[path] = (tuple(t.shape), str(t.dtype), hashlib.sha256(
            t.view(torch.uint8).numpy().tobytes()).hexdigest())
    else:
        out[path] = tree
    return out


def test_serve_entry_point_mesh_2x1_on_cpu(capfd):
    from repro_torch.launch import serve
    assert serve.main(["--reduced", "--device", "cpu", "--mesh", "2x1",
                       "--requests", "3", "--max-new", "4",
                       "--mode", "lut_pallas"]) == 0
    out = capfd.readouterr().out
    assert "serving mesh 2x1 (data x model) over 2 ranks, backend gloo" in out
    assert out.count("served 3 requests / 12 tokens") == 1  # rank (0, 0)
    assert "mesh: {'data': 2, 'model': 1}" in out
    assert "rank 0's slots [0, 2]" in out
