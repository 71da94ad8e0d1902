"""Port parity, the MoE family: reduced olmoe-1b-7b and kimi-k2-1t-a32b
from ``repro_torch`` against ``repro`` on the CPU.

The configs are the reference's reduced ones: olmoe (2 layers, 8 experts,
top-2, capacity factor 8, float attention) and kimi-k2 (a dense first
layer, then an MoE layer with a shared expert). A numpy generator draws
every float leaf of the reference's param tree (``test_torch_configs``'s
``_draw``); the reference packs it (``quantize_params``: the experts as
batched weights), and ``convert.from_jax_params`` loads the packed tree
into the port.

Tolerances (rtol = atol, on every output or logit):
  * fp16 (packed weights dequantized, f32 products) and lut_xla with float
    tables: 1e-4. The routing is the same f32 arithmetic, so the top-k
    picks agree and the last-bit differences of sums taken in another
    order pass through unchanged.
  * per_row INT8 tables, lut_xla against the reference's lut_xla and
    lut_pallas (the kernels' plain versions here) against its lut_pallas
    (Pallas in interpret mode): 0.15 on the logits, as for the dense
    archs (tests/test_torch_configs.py), and 1e-4 on one MoE layer's
    output, whose inputs hit no rounding tie. An INT8 table entry within a
    last-bit difference of a rounding boundary takes the neighbouring code
    and moves its row by about one step (XLA sums K = 4 entries pairwise,
    the port in order). In the full forward such a step in one layer's
    output also reaches the next layer's router; a top-k pick that flips
    there moves a token's output by much more than a code step. The tests
    count the picks that differ from the reference's (``_picks``) and hold
    them to MAX_FLIPS. Measured here: 0 flips in every case; the largest
    per_row logit difference 0.013 (olmoe, both modes: code steps, no
    flip) and under 1e-6 (kimi-k2); one MoE layer's output within 1.1e-7
    in every mode, with and without drops.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.core import quantize as jQ
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import quantized as jquant
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.engine import Request, ServingEngine

ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]
# (port mode, table_quant, the reference's mode, rtol = atol on logits,
# on one MoE layer's output)
MODES = [pytest.param("fp16", None, "fp16", 1e-4, 1e-4, id="fp16"),
         pytest.param("lut_xla", None, "lut_xla", 1e-4, 1e-4, id="lut_xla"),
         pytest.param("lut_xla", "per_row", "lut_xla", 0.15, 1e-4,
                      id="lut_xla-per_row"),
         pytest.param("lut_pallas", "per_row", "lut_pallas", 0.15, 1e-4,
                      id="lut_pallas-per_row")]
# top-k picks (of all tokens, layers and k) allowed to differ from the
# reference's: a flip follows only an INT8 code step at a router near-tie
MAX_FLIPS = 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, **kw):
    jc = jreg.get_reduced(arch).replace(activation_dtype=jnp.float32, **kw)
    tc = treg.get_reduced(arch).replace(activation_dtype=torch.float32, **kw)
    return jc, tc


def _draw(rng, path, leaf):
    """A float leaf of the reference's tree, drawn from ``rng``."""
    name = getattr(path[-1], "key", None)
    shape = leaf.shape
    if name == "g":
        out = 1.0 + 0.1 * rng.normal(size=shape)
    elif name == "table":
        out = 0.02 * rng.normal(size=shape)
    else:  # a projection or a router, [..., in, out]
        out = rng.normal(size=shape) / np.sqrt(shape[-2])
    return jnp.asarray(out.astype(np.float32), dtype=leaf.dtype)


@pytest.fixture(scope="module")
def packed():
    """arch -> (reference packed params, their numpy tree), drawn once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, _ = _cfgs(arch)
            shapes = jax.eval_shape(lambda: japi.init_params(
                jax.random.key(0), jc, serve_quantized=False))
            rng = np.random.default_rng(20 + ARCHS.index(arch))
            floats = jax.tree_util.tree_map_with_path(
                lambda p, leaf: _draw(rng, p, leaf), shapes)
            params = jax.jit(lambda tree: jquant.quantize_params(
                tree, jc.quant))(floats)
            cache[arch] = params, jax.tree.map(np.asarray, params)
        return cache[arch]

    return get


def _picks(x, router_w, k):
    """Top-k expert ids of each token of x [T, D] (numpy, f32 router)."""
    logits = x.astype(np.float32) @ router_w
    return np.argsort(-logits, axis=-1, kind="stable")[:, :k]


def _layer_inputs(params, cfg, toks):
    """The input of each MoE layer's router in the reference's forward
    (its mlp_norm output), numpy [T, D] a layer, with the router weights."""
    from repro.models import layers as jL
    from repro.models import transformer as jTR
    h = jTR.embed_apply(params["embed"], toks).astype(jnp.float32)
    nd = cfg.first_dense_layers
    for i in range(nd):
        lp = jax.tree.map(lambda a: a[i], params["dense_layers"])
        h, _ = jTR.block_apply(lp, h, cfg, quant=cfg.quant)
    out = []
    for i in range(cfg.n_layers - nd):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        a, _ = jL.attention_apply(lp["attn"], jL.rms_norm(
            lp["attn_norm"], h, cfg.norm_eps), cfg, quant=cfg.quant)
        h = h + a
        xin = jL.rms_norm(lp["mlp_norm"], h, cfg.norm_eps)
        out.append((np.asarray(xin).reshape(-1, cfg.d_model),
                    np.asarray(lp["moe"]["router"]["w"])))
        m, _ = jmoe.moe_mlp_apply(lp["moe"], xin, cfg, cfg.quant)
        h = h + m
    return out


def _port_layer_inputs(tparams, cfg, toks):
    """``_layer_inputs`` of the port's forward."""
    from repro_torch.models import layers as tL
    from repro_torch.models import transformer as tTR
    h = tTR.embed_apply(tparams["embed"], toks).to(torch.float32)
    for lp in tparams.get("dense_layers", []):
        h, _ = tTR.block_apply(lp, h, cfg, quant=cfg.quant)
    out = []
    for lp in tparams["layers"]:
        a, _ = tL.attention_apply(lp["attn"], tL.rms_norm(
            lp["attn_norm"], h, cfg.norm_eps), cfg, quant=cfg.quant)
        h = h + a
        xin = tL.rms_norm(lp["mlp_norm"], h, cfg.norm_eps)
        out.append(xin.reshape(-1, cfg.d_model).numpy())
        m, _ = tmoe.moe_mlp_apply(lp["moe"], xin, cfg, cfg.quant)
        h = h + m
    return out


@pytest.mark.parametrize("drops", [False, True], ids=["cf8", "cf1-drops"])
@pytest.mark.parametrize("mode,tq,ref_mode,_,tol", MODES)
def test_moe_mlp_apply_matches_reference(packed, mode, tq, ref_mode, _, tol,
                                         drops):
    """One MoE layer (reduced olmoe's first) on the same input: the output
    and both aux losses against the reference's ``moe_mlp_apply``; with
    ``capacity_factor=1.0`` tokens are dropped (asserted) and the dropped
    assignments match too."""
    params, np_tree = packed("olmoe-1b-7b")
    kw = dict(capacity_factor=1.0) if drops else {}
    jc, tc = _cfgs("olmoe-1b-7b", **kw)
    jq = dict(jc.quant, mpgemm_mode=ref_mode, table_quant=tq)
    tq_ = dict(tc.quant, mpgemm_mode=mode, table_quant=tq)
    x = (np.random.default_rng(5).normal(size=(2, 16, tc.d_model)) * 0.5
         ).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["layers"])["moe"]
    tp = from_jax_params(np_tree, tc, "cpu")["layers"][0]["moe"]
    want, waux = jmoe.moe_mlp_apply(jp, jnp.asarray(x), jc, jq)
    got, taux = tmoe.moe_mlp_apply(tp, torch.from_numpy(x), tc, tq_)
    counts = np.bincount(_picks(x.reshape(32, -1), np.asarray(
        jp["router"]["w"]), tc.top_k).ravel(), minlength=tc.num_experts)
    cap = tmoe._capacity(32, tc.top_k, tc.num_experts, tc.capacity_factor)
    assert (counts.max() > cap) == drops, (counts, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    for name in ("lb_loss", "router_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(waux[name]),
                                   rtol=1e-5)


@pytest.mark.parametrize("fusion", ["fused", "staged"])
@pytest.mark.parametrize("tq", [None, "per_row", "per_group"])
def test_expert_ops_match_the_vmapped_reference_kernels(tq, fusion):
    """The port's expert mpGEMM (``ops.lut_mpgemm_experts``: the batched
    wrappers' plain versions on the CPU) against the reference's
    ``jax.vmap`` of ``ops.lut_mpgemm`` over 3 experts, its Pallas kernels
    in interpret mode: per_row within 1e-5 of the largest output (the
    same integer sums, one f32 epilogue; INT8 codes may step at a rounding
    tie, which none of these inputs hits), float tables within 1e-4."""
    e, c, k, n = 3, 8, 64, 40
    rng = np.random.default_rng(7)
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    x[1, 5:] = 0.0  # expert 1's empty capacity
    w = rng.normal(size=(e, k, n)).astype(np.float32)
    jq = jax.vmap(lambda we: jQ.quantize(we.T, 2, k_group=4))(jnp.asarray(w))
    want = jax.vmap(lambda xe, qe: jops.lut_mpgemm(
        xe, qe, table_quant=tq, fusion=fusion, interpret=True))(
            jnp.asarray(x), jq)
    tqw = convert._qw(jax.tree.map(np.asarray, jq), "cpu")
    assert tqw.experts == e and tuple(tqw.packed.shape) == (e, n, k // 4)
    got = tops.lut_mpgemm_experts(torch.from_numpy(x), tqw, table_quant=tq,
                                  fusion=fusion)
    want = np.asarray(want)
    scale = np.abs(want).max()
    tol = 1e-5 if tq == "per_row" else 1e-4
    assert np.abs(got.numpy() - want).max() <= tol * scale
    assert not got[1, 5:].any()


@pytest.mark.parametrize("mode,tq,ref_mode,tol,_", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_reference(packed, arch, mode, tq,
                                               ref_mode, tol, _):
    """Reduced olmoe and kimi-k2 (a dense first layer, a shared expert)
    through ``api.forward``: logits within the mode's tolerance, the greedy
    token of >= 90% of the positions equal, the aux losses within 1e-5,
    and at most MAX_FLIPS top-k picks differing from the reference's."""
    params, np_tree = packed(arch)
    jc, tc = _cfgs(arch)
    jc = jc.with_quant(mpgemm_mode=ref_mode, table_quant=tq)
    tc = tc.with_quant(mpgemm_mode=mode, table_quant=tq)
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 24))
    want, _, waux = japi.forward(
        params, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    port = from_jax_params(np_tree, tc, "cpu")
    if arch == "kimi-k2-1t-a32b":
        assert len(port["dense_layers"]) == 1 and len(port["layers"]) == 1
        assert "qw" in port["layers"][0]["moe"]["shared_mlp"]["gate"]
    got, _, taux = tapi.forward(port, {"tokens": torch.from_numpy(toks)}, tc)
    assert got.shape == (2, 24, tc.vocab_size)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    for name in ("lb_loss", "router_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(waux[name]),
                                   rtol=1e-5)
    jt = jnp.asarray(toks, jnp.int32)
    flips = sum(int((_picks(a, rw, tc.top_k) != _picks(b, rw, tc.top_k))
                    .any(axis=-1).sum())
                for (a, rw), b in zip(_layer_inputs(params, jc, jt),
                                      _port_layer_inputs(
                                          port, tc, torch.from_numpy(toks))))
    assert flips <= MAX_FLIPS, f"{flips} tokens' top-k picks differ"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_consistent(packed, arch):
    """tests/test_archs_smoke.py's contract inside the port: prefill s
    tokens into a cache, decode the next one; its logits equal the full
    forward's at that position within 2e-2 (rtol = atol). Capacity follows
    the token count, so the two forwards route over different t."""
    _, np_tree = packed(arch)
    _, tc = _cfgs(arch)
    tc = tc.with_quant(mpgemm_mode="lut_pallas", table_quant="per_row")
    port = from_jax_params(np_tree, tc, "cpu")
    rng = np.random.default_rng(2)
    b, s = 2, 12
    toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (b, s + 1)))
    full, _, _ = tapi.forward(port, {"tokens": toks}, tc)
    caches = tapi.init_cache(tc, b, s + 1, dtype=torch.float32, device="cpu")
    tapi.forward(port, {"tokens": toks[:, :s]}, tc, caches=caches,
                 cache_pos=0)
    step, _, _ = tapi.forward(port, {"tokens": toks[:, s:]}, tc,
                              caches=caches, cache_pos=s)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, s].numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def olmoe_engine_params(packed):
    """Reduced olmoe with float tables for both engines (lut_xla in the
    reference, lut_pallas in the port: the batched wrappers' plain
    versions), so that every logit agrees within 1e-4 and greedy streams
    are equal."""
    params, np_tree = packed("olmoe-1b-7b")
    jc, tc = _cfgs("olmoe-1b-7b")
    jc = jc.with_quant(mpgemm_mode="lut_xla", table_quant=None)
    tc = tc.with_quant(mpgemm_mode="lut_pallas", table_quant=None)
    return jc, params, tc, from_jax_params(np_tree, tc, "cpu")


def test_engine_greedy_streams_equal_the_reference_engine(
        olmoe_engine_params):
    """One pool of five requests (prompts 3-40 tokens: single and two-chunk
    prefills, idle slots in the decode steps) through the reference's
    engine and the port's, dense and then block-paged: the greedy streams
    are equal, and each port engine syncs once a decode chunk."""
    jc, jparams, tc, tparams = olmoe_engine_params
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n) for n in (5, 40, 11, 3, 23)]
    news = [6, 8, 3, 7, 5]
    kw = dict(max_batch=2, max_seq=64, prefill_chunk=16, decode_chunk=4)
    jeng = JEngine(jc, jparams, **kw)
    jreqs = [JRequest(uid=i, prompt=p.astype(np.int32), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, news))]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_to_completion()
    want = [list(r.output) for r in jreqs]
    for paged in ({}, dict(cache_block_size=16)):
        eng = ServingEngine(tc, tparams, **kw, **paged)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(zip(prompts, news))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        assert [r.output for r in reqs] == want, paged
        assert eng.stats()["host_syncs_per_token"] <= 1 / 4 + 1 / sum(news)


def _serve(eng, req_cls, prompts, modes, n_new=8):
    reqs = [req_cls(uid=i, prompt=p, max_new_tokens=n_new, decoding=m)
            for i, (p, m) in enumerate(zip(prompts, modes))]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return reqs


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_beam_and_spec_on_moe_match_the_reference_engine(
        olmoe_engine_params, paged):
    """One pool holding a greedy, a ``spec:draft1b`` (spec_k 3) and a
    ``beam:2`` request, through the reference's engine and the port's on
    reduced olmoe (float tables; spec under lut_xla, as the kernels refuse
    plane-sliced views): the streams equal, every hypothesis equal in the
    same order, scores within 1e-4 relative. The verify burst routes B·4
    tokens with the capacity they set; at capacity factor 8 nothing drops,
    and the spec stream is the greedy one."""
    jc, jparams, tc, tparams = olmoe_engine_params
    tc = tc.with_quant(mpgemm_mode="lut_xla")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n) for n in (6, 19, 9)]
    modes = ["greedy", "spec:draft1b", "beam:2"]
    kw = dict(max_batch=4, max_seq=64, prefill_chunk=16, decode_chunk=4,
              spec_k=3, spec_draft_planes=1)
    jreqs = _serve(JEngine(jc, jparams, **kw), JRequest,
                   [p.astype(np.int32) for p in prompts], modes)
    paged_kw = dict(cache_block_size=16) if paged else {}
    eng = ServingEngine(tc, tparams, **kw, **paged_kw)
    reqs = _serve(eng, Request, prompts, modes)
    for r, jr in zip(reqs, jreqs):
        assert r.output == [int(t) for t in jr.output], r.decoding
    assert [t for t, _ in reqs[2].beams] == [[int(x) for x in t]
                                            for t, _ in jreqs[2].beams]
    np.testing.assert_allclose([sc for _, sc in reqs[2].beams],
                               [sc for _, sc in jreqs[2].beams], rtol=1e-4)
    assert eng.stats()["spec"]["draft_extra_hbm_bytes"] == 0
    assert reqs[1].spec_stats == jreqs[1].spec_stats
    # the greedy stream of the same prompt, from a pool of its own
    (solo,) = _serve(ServingEngine(tc, tparams, **kw, **paged_kw), Request,
                     prompts[1:2], ["greedy"])
    assert reqs[1].output == solo.output


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_width_one_beam_is_greedy_on_moe(olmoe_engine_params, paged):
    """beam:1 through the batched kernels' plain versions (lut_pallas)
    gives every request greedy decoding's tokens."""
    _, _, tc, tparams = olmoe_engine_params
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 512, n) for n in (7, 21)]
    kw = dict(max_batch=2, max_seq=64, prefill_chunk=16, decode_chunk=4)
    if paged:
        kw["cache_block_size"] = 16
    beam = _serve(ServingEngine(tc, tparams, **kw), Request, prompts,
                  ["beam:1"] * 2)
    greedy = _serve(ServingEngine(tc, tparams, **kw), Request, prompts,
                    ["greedy"] * 2)
    assert [r.output for r in beam] == [r.output for r in greedy]


def test_expert_weights_pack_as_the_reference_packs_them():
    """``quantize_params`` on a float MoE layer gives the reference's
    batched weights byte for byte (``gate_qw`` / ``up_qw`` / ``down_qw``,
    packed [E, N, K/4], scales [E, N]); the router stays f32."""
    from repro_torch.models.quantized import quantize_params
    jc, tc = _cfgs("olmoe-1b-7b")
    shapes = jax.eval_shape(lambda: jmoe.moe_mlp_init(jax.random.key(0), jc))
    rng = np.random.default_rng(9)
    floats = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(rng, p, leaf), shapes)
    want = jquant.quantize_params({"moe": floats}, jc.quant)["moe"]
    got = quantize_params({"moe": jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), floats)}, tc.quant)["moe"]
    assert set(got["experts"]) == {"gate_qw", "up_qw", "down_qw"}
    for name, qw in got["experts"].items():
        ref = want["experts"][name]
        assert qw.experts == tc.num_experts
        assert np.array_equal(qw.packed.numpy(), np.asarray(ref.packed))
        assert np.array_equal(qw.scale.numpy(), np.asarray(ref.scale))
    assert got["router"]["w"].dtype == torch.float32


def _port_experts(e, c, k, n, seed):
    """x [E, C, K] (expert 0's last rows zero: empty capacity) and E
    experts' W2 weights packed by the port."""
    from repro_torch.core.quantize import quantize_experts
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(e, c, k)).astype(np.float32))
    x[0, c // 2:] = 0.0
    w = torch.from_numpy(rng.normal(size=(e, k, n)).astype(np.float32))
    return x, quantize_experts(w, 2)


@pytest.mark.parametrize("fusion", ["auto", "fused", "staged", "tuned"])
def test_expert_dispatch_records_the_batched_plan(fusion):
    """An expert call records the plan of the one batched launch it makes:
    the key "e<E>." + the 2-D shape key, the tile C rows take alone and S
    planned over the E·Cp padded rows (``ops.kernel_plan(experts=E)``).
    Under "tuned" a cache entry of the 2-D shape (C, N, G) is not applied:
    the call runs and records the "auto" plan, with the same bits."""
    from repro_torch.core import autotune
    from repro_torch.core.autotune import TunedConfig
    from repro_torch.obs import dispatch as dispatch_obs
    e, c, k, n = 16, 3, 4096, 40  # S over 16 experts' rows: 9, not 16/32
    x, qw = _port_experts(e, c, k, n, seed=5)
    args = (c, qw.n, qw.g, qw.k_group, qw.num_planes)
    key = "e16." + autotune.shape_key(*args)
    auto = tops.resolve_dispatch(*args, experts=e).fusion
    try:
        autotune.configure(None).put(autotune.shape_key(*args),
                                     TunedConfig("staged", 1, 1))
        with dispatch_obs.recording() as rec:
            got = tops.lut_mpgemm_experts(x, qw, fusion=fusion)
    finally:
        autotune.deactivate()
    (r,) = rec.records("dispatch")
    runs = auto if fusion in ("auto", "tuned") else fusion
    assert r.key == key and r.fusion == runs and r.requested == fusion
    assert r.source == ("heuristic" if fusion in ("auto", "tuned")
                        else "forced")
    _, bm, bn, bg, s = tops.kernel_plan(*args, "per_row", runs, experts=e)
    assert (r.block_m, r.block_n, r.block_g, r.splits) == (bm, bn, bg, s)
    assert bm > c  # each expert's rows are padded to the tile's
    assert s != tops.kernel_plan(*args, "per_row", runs)[4]
    assert torch.equal(got, tops.lut_mpgemm_experts(x, qw, fusion=runs))


@pytest.mark.parametrize("tq", [None, "per_row", "per_group"])
def test_shared_expert_table_is_built_once_in_the_kernels_form(tq):
    """The table ``_expert_ffn`` shares between gate and up: under
    lut_pallas ``mp.precompute_expert_tables`` builds it over the E·Cp
    padded rows the batched staged kernel takes, and an expert call on it
    equals one that builds its own, bit for bit; a table over the E·C rows
    as they are is refused. Under lut_xla it is the E·C rows, and each
    expert's mpGEMM on its slice equals one without a table."""
    from repro_torch.core import mpgemm as tmp
    e, c, k, n = 4, 3, 64, 40
    x, qw = _port_experts(e, c, k, n, seed=6)
    tbl = tmp.precompute_expert_tables(x, 4, tq, "lut_pallas")
    assert tbl.values.shape[0] % e == 0 and tbl.values.shape[0] > e * c
    want = tops.lut_mpgemm_experts(x, qw, table_quant=tq, fusion="staged")
    assert torch.equal(tops.lut_mpgemm_experts(x, qw, table_quant=tq,
                                               table=tbl), want)
    with pytest.raises(ValueError, match="padded rows"):
        tops.lut_mpgemm_experts(x, qw, table_quant=tq,
                                table=tmp.precompute_tables(x, 4, tq))
    xla = tmp.precompute_expert_tables(x, 4, tq, "lut_xla")
    assert xla.values.shape[0] == e * c
    assert torch.equal(
        tmp.mpgemm(x, qw, mode="lut_xla", table_quant=tq, table=xla),
        tmp.mpgemm(x, qw, mode="lut_xla", table_quant=tq))


def test_float_attention_builds_no_table(packed, monkeypatch):
    """olmoe's attention stays float (``skip="attn"``): a staged-size
    prefill through its layer under lut_pallas precomputes one table, the
    experts' (shared by gate and up, over their E·Cp padded rows), and
    none for q, k and v, which read none."""
    _, np_tree = packed("olmoe-1b-7b")
    _, tc = _cfgs("olmoe-1b-7b")
    tc = tc.with_quant(mpgemm_mode="lut_pallas", table_quant="per_row")
    port = from_jax_params(np_tree, tc, "cpu")
    lp = port["layers"][0]
    assert "qw" not in lp["attn"]["wq"]
    rows = []
    real = tops.table_precompute
    monkeypatch.setattr(tops, "table_precompute",
                        lambda a, *r, **k: rows.append(a.shape[0]) or real(
                            a, *r, **k))
    t = 128
    h = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, t, tc.d_model)).astype(np.float32))
    out, _, _ = tmoe.block_apply(lp, h, tc, quant=tc.quant, aux=False)
    cap = tmoe._capacity(t, tc.top_k, tc.num_experts, tc.capacity_factor)
    assert len(rows) == 1 and rows[0] >= tc.num_experts * cap
    assert torch.isfinite(out).all()
