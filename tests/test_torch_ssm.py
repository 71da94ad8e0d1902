"""Port parity, the SSM and hybrid families: reduced falcon-mamba-7b
(Mamba1, attention-free) and zamba2-7b (Mamba2 groups and one shared
attention block) from ``repro_torch`` against ``repro`` on the CPU.

The configs are the reference's reduced ones (falcon-mamba: 2 layers,
d_model 64, d_inner 8192, dt_rank 256, ssm_state 4, chunk 4; zamba2: 5
layers in 2 groups of 2 and a tail of 1, d_model 64, d_inner 7168, 4 heads,
ssm_state 8, chunk 4, its Mamba2 in/out projections float). A numpy
generator draws every float leaf of the reference's param tree (``_draw``);
the reference packs it and ``convert.from_jax_params`` loads the packed
tree into the port.

Tolerances (rtol = atol unless said otherwise):
  * one Mamba1 / Mamba2 layer, float weights, f32 activations: outputs and
    new conv and SSM states within 1e-5 (the conv state holds in_proj's
    outputs, a GEMM summed in torch's order; the port's chunk scan sums in
    another order than XLA's associative scan); bf16 activations: 2e-2
    (one bf16 step of the projections' inputs);
  * ``_causal_dwconv``: bit-equal outputs and state (the same f32 taps in
    the same order);
  * teacher-forced logits: fp16 (packed weights dequantized, f32
    products) and lut_xla with float tables within 1e-4; per_row INT8
    tables, lut_xla against the reference's lut_xla and lut_pallas (the
    kernels' plain versions here) against its lut_pallas (Pallas in
    interpret mode), within 0.15, the dense archs' bound
    (tests/test_torch_configs.py: an INT8 entry within a last-bit
    difference of a rounding boundary takes the neighbouring code, and the
    recurrence carries the step), and the greedy token equal at >= 90% of
    the positions;
  * engines (float tables: lut_xla in the reference, lut_pallas in the
    port): greedy streams equal to the reference engine's, prefill chunk 3
    and one-shot; a beam:2 request's ranked beams equal to the reference
    engine's (scores within 1e-4 relative), dense and paged; block-paged
    streams equal to dense; chunked prefill state equal to one-shot within
    1e-5.
Measured here: one layer within 2.2e-6 (f32) and 7.8e-3 (bf16: the conv
state, one bf16 step); logits within 2.8e-5 (fp16, float-table lut_xla)
and 0.042 (per_row, both modes), the greedy token equal at every position.
"""

import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import hybrid as jhybrid
from repro.models import kvcache as jkv
from repro.models import quantized as jquant
from repro.models import ssm as jssm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.core.quantize import QuantizedWeight
from repro_torch.core.tree import tree_leaves
from repro_torch.models import api as tapi
from repro_torch.models import kvcache as tkv
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.quantized import quantize_params
from repro_torch.serving.engine import Request, ServingEngine

ARCHS = ["falcon-mamba-7b", "zamba2-7b"]
# (port mode, table_quant, the reference's mode, rtol = atol on logits)
MODES = [pytest.param("fp16", None, "fp16", 1e-4, id="fp16"),
         pytest.param("lut_xla", None, "lut_xla", 1e-4, id="lut_xla"),
         pytest.param("lut_xla", "per_row", "lut_xla", 0.15,
                      id="lut_xla-per_row"),
         pytest.param("lut_pallas", "per_row", "lut_pallas", 0.15,
                      id="lut_pallas-per_row")]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, dtype="f32", **kw):
    jd, td, _ = DTYPES[dtype]
    jc = jreg.get_reduced(arch).replace(activation_dtype=jd, **kw)
    tc = treg.get_reduced(arch).replace(activation_dtype=td, **kw)
    return jc, tc


def _draw(rng, path, leaf):
    """A float leaf of the reference's tree, drawn from ``rng`` at the
    scale of its role (decays of A = -exp(A_log) from -1 to -7.4)."""
    name = getattr(path[-1], "key", None)
    shape = leaf.shape
    if name in ("g", "norm_g", "D"):
        out = 1.0 + 0.1 * rng.normal(size=shape)
    elif name == "table":
        out = 0.02 * rng.normal(size=shape)
    elif name == "conv_w":
        out = 0.1 + 0.05 * rng.normal(size=shape)
    elif name in ("conv_b", "b", "dt_bias"):
        out = 0.1 * rng.normal(size=shape)
    elif name == "A_log":
        out = rng.uniform(0.0, 2.0, size=shape)
    else:  # a projection, [..., in, out]
        out = rng.normal(size=shape) / np.sqrt(shape[-2])
    return jnp.asarray(out.astype(np.float32), dtype=leaf.dtype)


def _draw_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(rng, p, leaf), shapes)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)


@pytest.fixture(scope="module")
def packed():
    """arch -> (reference packed params, their numpy tree), drawn once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, _ = _cfgs(arch)
            shapes = jax.eval_shape(lambda: japi.init_params(
                jax.random.key(0), jc, serve_quantized=False))
            floats = _draw_tree(shapes, 30 + ARCHS.index(arch))
            params = jax.jit(lambda tree: jquant.quantize_params(
                tree, jc.quant))(floats)
            cache[arch] = params, jax.tree.map(np.asarray, params)
        return cache[arch]

    return get


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("valid", [None, (3, 7)], ids=["all", "valid"])
def test_causal_dwconv_matches_reference(valid, state):
    """The depthwise causal conv on x [2, 7, 16], with and without a
    carried state and ``valid``: outputs and the new state bit-equal; with
    ``valid`` the state is the last W-1 real inputs of each row."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 16)).astype(np.float32) if state else None
    vl = None if valid is None else np.array(valid, np.int32)
    jy, jst = jssm._causal_dwconv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st),
        None if vl is None else jnp.asarray(vl))
    ty, tst = tssm._causal_dwconv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if st is None else torch.from_numpy(st),
        None if vl is None else torch.from_numpy(vl.astype(np.int64)))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    if valid is not None:
        xp = np.concatenate([np.zeros((2, 3, 16), np.float32)
                             if st is None else st, x], axis=1)
        for row, n in enumerate(valid):
            np.testing.assert_array_equal(tst[row].numpy(), xp[row, n:n + 3])


# (s, token_valid): a decode step, two whole chunks, a padded chunk
CASES = {"s1": (1, None), "chunked": (8, None), "padded": (7, (7, 4))}


def _layer_case(kind, dtype, case):
    """One reduced layer's float params, input, random cache and
    token_valid, for the reference and the port."""
    arch = "falcon-mamba-7b" if kind == "mamba1" else "zamba2-7b"
    jc, tc = _cfgs(arch, dtype)
    init = jssm.mamba_init if kind == "mamba1" else jssm.mamba2_init
    shapes = jax.eval_shape(lambda: init(jax.random.key(0), jc))
    jp = _draw_tree(shapes, 5)
    s, valid = CASES[case]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, s, jc.d_model)).astype(np.float32)
    if kind == "mamba1":
        cache = jkv.mamba_cache(1, 2, jc.d_inner, jc.ssm_state, jc.d_conv)
    else:
        cache = jkv.mamba2_cache(1, 2, jc.ssm_heads,
                                 jc.d_inner // jc.ssm_heads, jc.ssm_state,
                                 jc.d_inner, jc.d_conv)
    cache = {k: (rng.normal(size=v.shape[1:]) * 0.5).astype(np.float32)
             for k, v in cache.items()}
    return jc, tc, jp, x, cache, valid


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_mamba_layer_matches_reference(kind, case, dtype):
    """``mamba_apply`` / ``mamba2_apply`` with float weights from a carried
    random state, at s = 1 (the decode update), s = 2 chunks, and s = 7
    with ``token_valid`` (7, 4) (a padded chunk and a padded row):
    outputs at the real positions and the new states within the dtype's
    tolerance."""
    jc, tc, jp, x, cache, valid = _layer_case(kind, dtype, case)
    jd, td, tol = DTYPES[dtype]
    japply = jssm.mamba_apply if kind == "mamba1" else jssm.mamba2_apply
    tapply = tssm.mamba_apply if kind == "mamba1" else tssm.mamba2_apply
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)
    want, wcache = japply(jp, jnp.asarray(x, jd), jc,
                          cache={k: jnp.asarray(v) for k, v in cache.items()},
                          quant=None, token_valid=jv)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tv = None if valid is None else torch.tensor(valid)
    got, gcache = tapply(_to_torch(jp), torch.from_numpy(x).to(td), tc,
                         cache=tcache, quant=None, token_valid=tv)
    assert gcache is tcache  # updated in place
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    for row in range(2):
        n = x.shape[1] if valid is None else valid[row]
        np.testing.assert_allclose(got[row, :n], want[row, :n], rtol=tol,
                                   atol=tol)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tcache[k].numpy(),
                                   np.asarray(wcache[k], np.float32),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_padded_tail_leaves_the_state_of_the_real_tokens(kind):
    """A row's real tokens then padding, with ``token_valid``, leave the
    conv and SSM state the real tokens alone leave (within 1e-6): padding
    never touches state."""
    jc, tc, jp, x, cache, _ = _layer_case(kind, "f32", "padded")
    tp = _to_torch(jp)
    tapply = tssm.mamba_apply if kind == "mamba1" else tssm.mamba2_apply
    padded = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tapply(tp, torch.from_numpy(x), tc, cache=padded,
           token_valid=torch.tensor([5, 2]))
    for row, n in enumerate((5, 2)):
        alone = {k: torch.from_numpy(v[row:row + 1].copy())
                 for k, v in cache.items()}
        tapply(tp, torch.from_numpy(x[row:row + 1, :n]), tc, cache=alone)
        for k in alone:
            np.testing.assert_allclose(padded[k][row:row + 1].numpy(),
                                       alone[k].numpy(), rtol=1e-6,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,tq,ref_mode,tol", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_reference(packed, arch, mode, tq,
                                               ref_mode, tol):
    """Reduced falcon-mamba and zamba2 through ``api.forward`` (no cache:
    the chunked scan from zero state, s = 10 over chunks of 4): logits
    within the mode's tolerance, the greedy token of >= 90% of the
    positions equal."""
    params, np_tree = packed(arch)
    jc, tc = _cfgs(arch)
    jc = jc.with_quant(mpgemm_mode=ref_mode, table_quant=tq)
    tc = tc.with_quant(mpgemm_mode=mode, table_quant=tq)
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 10))
    want, _, _ = japi.forward(params, {"tokens": jnp.asarray(toks,
                                                             jnp.int32)}, jc)
    port = from_jax_params(np_tree, tc, "cpu")
    got, _, _ = tapi.forward(port, {"tokens": torch.from_numpy(toks)}, tc)
    assert got.shape == (2, 10, tc.vocab_size)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_then_decode_equals_one_shot(packed, arch):
    """Prefill 11 tokens into a cache in chunks of 3 (the tail of 2 right-
    padded to 3, with ``token_valid``) and in one shot: every cache leaf
    within 1e-5 (the attention K/V at the real positions), and the next
    token's decode logits within 1e-4 of the full forward's."""
    _, np_tree = packed(arch)
    _, tc = _cfgs(arch)
    tc = tc.with_quant(mpgemm_mode="lut_pallas", table_quant=None)
    port = from_jax_params(np_tree, tc, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab_size, (1, 12)))
    full, _, _ = tapi.forward(port, {"tokens": toks}, tc)
    one = tapi.init_cache(tc, 1, 16, dtype=torch.float32, device="cpu")
    tapi.forward(port, {"tokens": toks[:, :11]}, tc, caches=one, cache_pos=0,
                 head=False)
    chunked = tapi.init_cache(tc, 1, 16, dtype=torch.float32, device="cpu")
    for j in range(0, 11, 3):
        n = min(3, 11 - j)
        buf = torch.zeros((1, 3), dtype=torch.int64)
        buf[:, :n] = toks[:, j:j + n]
        tapi.forward(port, {"tokens": buf}, tc, caches=chunked, cache_pos=j,
                     head=False, token_valid=torch.tensor([n]))
    seq = tkv.seq_axes(tapi.init_cache(tc, 1, 16, device="meta"),
                       tapi.init_cache(tc, 1, 32, device="meta"))
    for a, b, sax in zip(tree_leaves(one), tree_leaves(chunked),
                         tree_leaves(seq)):
        if sax >= 0:
            a, b = a.narrow(sax, 0, 11), b.narrow(sax, 0, 11)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    step, _, _ = tapi.forward(port, {"tokens": toks[:, 11:]}, tc,
                              caches=chunked,
                              cache_pos=torch.tensor([11]))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 11].numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_params(packed):
    """arch -> reduced configs and params with float tables for both
    engines (lut_xla in the reference, lut_pallas in the port: the kernels'
    plain versions), so that greedy streams are equal."""
    def get(arch):
        params, np_tree = packed(arch)
        jc, tc = _cfgs(arch)
        jc = jc.with_quant(mpgemm_mode="lut_xla", table_quant=None)
        tc = tc.with_quant(mpgemm_mode="lut_pallas", table_quant=None)
        return jc, params, tc, from_jax_params(np_tree, tc, "cpu")
    return get


PROMPT_LENS, NEWS = (5, 17, 9, 2, 12), (6, 8, 3, 7, 5)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def _serve(cfg, params, **kw):
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=48,
                        decode_chunk=4, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(_prompts(cfg.vocab_size), NEWS))]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return eng, [r.output for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_streams_equal_the_reference_engine(engine_params,
                                                          arch):
    """Five requests (prompts 2-17 tokens, idle slots in decode steps,
    slots reused) through the reference's engine with one-shot prefill and
    the port's with prefill chunk 3 (right-padded tails) and one-shot:
    equal greedy streams, one sync a decode chunk."""
    jc, jparams, tc, tparams = engine_params(arch)
    jeng = JEngine(jc, jparams, max_batch=2, max_seq=48, decode_chunk=4,
                   prefill_chunk=48)
    jreqs = [JRequest(uid=i, prompt=p.astype(np.int32), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(_prompts(tc.vocab_size), NEWS))]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_to_completion()
    want = [list(r.output) for r in jreqs]
    for chunk in (3, 48):
        eng, got = _serve(tc, tparams, prefill_chunk=chunk)
        assert got == want, chunk
        assert eng.stats()["host_syncs_per_token"] <= 1 / 4 + 1 / sum(NEWS)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_streams_equal_dense(engine_params, arch):
    """The block-paged pool (block 16) gives the dense engine's streams:
    zamba2's shared-attention KV pooled, its Mamba state slot-resident;
    falcon-mamba has no pooled leaf and reserves no block."""
    _, _, tc, tparams = engine_params(arch)
    _, dense = _serve(tc, tparams, prefill_chunk=3)
    eng, paged = _serve(tc, tparams, prefill_chunk=3, cache_block_size=16)
    assert paged == dense
    st = eng.stats()
    assert st["blocks_in_use"] == 0
    if arch == "falcon-mamba-7b":
        assert not eng._has_pooled and eng._alloc.num_used == 0
        assert not any(tree_leaves(eng._pooled))
    else:
        assert eng.caches["kv"][0].shape[1] == eng.num_cache_blocks
        assert eng.caches["mamba"]["ssm"].shape[2] == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_is_turned_off_with_a_warning(engine_params, arch):
    _, _, tc, tparams = engine_params(arch)
    with pytest.warns(UserWarning, match="prefix caching needs every cache "
                      "leaf paged"):
        eng = ServingEngine(tc, tparams, max_batch=2, max_seq=48,
                            cache_block_size=16, prefix_cache=True)
    assert not eng.prefix_caching and eng.stats().get("prefix_cache") is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # dense: nothing to warn about
        ServingEngine(tc, tparams, max_batch=2, max_seq=48, prefix_cache=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_raises_value_error(engine_params, arch):
    """The reference's ``ValueError`` for self-speculation on cumulative
    state (with a draft view)."""
    _, _, tc, tparams = engine_params(arch)
    eng = ServingEngine(tc, tparams, max_batch=2, max_seq=48,
                        spec_draft_planes=1)
    with pytest.raises(ValueError, match="self-speculative decoding "
                       "unsupported for family .* cumulative"):
        eng.submit(Request(uid=0, prompt=np.arange(5), decoding="spec"))
    assert not eng.queue


def _beam_pool(cfg, params, engine, request, **kw):
    """A beam:2 request between two greedy ones, 6 new tokens each."""
    eng = engine(cfg, params, max_batch=4, max_seq=48, decode_chunk=4, **kw)
    prompts = _prompts(cfg.vocab_size)
    reqs = [request(uid=i, prompt=p, max_new_tokens=6,
                    decoding="beam:2" if i == 1 else "greedy")
            for i, p in enumerate(prompts[:3])]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return reqs


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_beam_equals_the_reference_engine(engine_params, arch, paged):
    """A beam:2 request beside two greedy ones, dense and paged (block
    16): the greedy streams and the ranked beams' tokens equal the
    reference engine's, their scores within 1e-4 relative. The Mamba
    state forks along its own batch axis (axis 2 in zamba2's groups), the
    shared attention's pooled K/V by block content."""
    jc, jparams, tc, tparams = engine_params(arch)
    kw = dict(cache_block_size=16) if paged else {}
    want = _beam_pool(jc, jparams, JEngine,
                      lambda prompt, **k: JRequest(
                          prompt=prompt.astype(np.int32), **k), **kw)
    got = _beam_pool(tc, tparams, ServingEngine, Request, prefill_chunk=3,
                     **kw)
    for g, w in zip(got, want):
        assert g.output == [int(t) for t in w.output]
    assert len(got[1].beams) == 2
    assert [t for t, _ in got[1].beams] == [[int(x) for x in t]
                                            for t, _ in want[1].beams]
    np.testing.assert_allclose([sc for _, sc in got[1].beams],
                               [sc for _, sc in want[1].beams], rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_reuse_leaks_no_state(engine_params, arch):
    """A request served in a slot that an earlier request used gives the
    stream it gives in a fresh engine (dense and paged): the retired
    request's SSM state does not leak into the next occupant."""
    _, _, tc, tparams = engine_params(arch)
    rng = np.random.default_rng(8)
    first, second = rng.integers(0, tc.vocab_size, (2, 9))
    for paged in ({}, dict(cache_block_size=16)):
        alone = ServingEngine(tc, tparams, max_batch=1, max_seq=48,
                              prefill_chunk=4, **paged)
        r = Request(uid=0, prompt=second, max_new_tokens=5)
        alone.submit(r)
        alone.run_to_completion()
        eng = ServingEngine(tc, tparams, max_batch=1, max_seq=48,
                            prefill_chunk=4, **paged)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate((first, second))]
        for q in reqs:
            eng.submit(q)
        eng.run_to_completion()
        assert reqs[1].output == r.output, paged


# ---------------------------------------------------------------------------
# layouts, conversion, packing
# ---------------------------------------------------------------------------

def test_zamba2_hybrid_layout_axes():
    """tests/test_kvcache_paged.py's layout contract inside the port,
    probed on the meta device: Mamba leaves [n_groups, attn_every, B, ...]
    carry batch at axis 2 and no sequence axis; the shared attention's KV
    [n_groups, B, S, KV, hd]; the tail [tail_layers, B, ...]. Shapes equal
    the reference's."""
    jc, tc = _cfgs("zamba2-7b")
    probe = lambda b, s: tapi.init_cache(tc, b, s, dtype=torch.float32,
                                         device="meta")
    baxes = tkv.batch_axes(probe(1, 32), probe(2, 32))
    saxes = tkv.seq_axes(probe(1, 32), probe(1, 64))
    assert baxes["kv"] == (1, 1) and saxes["kv"] == (2, 2)
    assert set(baxes["mamba"].values()) == {2}
    assert set(baxes["tail"].values()) == {1}
    for grp in ("mamba", "tail"):
        assert set(saxes[grp].values()) == {-1}
    want = jax.eval_shape(lambda: jhybrid.init_cache(jc, 2, 32,
                                                     dtype=jnp.float32))
    got = tapi.init_cache(tc, 2, 32, dtype=torch.float32, device="meta")
    assert set(got) == set(want)
    for grp in want:
        assert ([tuple(a.shape) for a in tree_leaves(got[grp])]
                == [tuple(a.shape) for a in jax.tree.leaves(want[grp])]), grp


def test_falcon_mamba_layout_axes():
    """The Mamba1 state {"conv": [L, B, d_conv-1, d_inner], "ssm": [L, B,
    d_inner, d_state]}, f32: batch axis 1, no sequence axis, the
    reference's shapes and dtype."""
    jc, tc = _cfgs("falcon-mamba-7b")
    probe = lambda b, s: tapi.init_cache(tc, b, s, device="meta")
    assert tkv.batch_axes(probe(1, 32), probe(2, 32)) == {"conv": 1, "ssm": 1}
    assert tkv.seq_axes(probe(1, 32), probe(1, 64)) == {"conv": -1,
                                                        "ssm": -1}
    want = japi.init_cache(jc, 2, 32)
    got = tapi.init_cache(tc, 2, 32, device="cpu")
    for k in ("conv", "ssm"):
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.float32 and not got[k].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_unstacks_the_layer_stacks(packed, arch):
    """falcon-mamba's ``layers`` [L, ...] become L layer dicts; zamba2's
    ``groups`` [G, A, ...] G lists of A, its ``tail`` [T, ...] a list of
    T; the shared block one dict. Every buffer equal to its slice."""
    _, np_tree = packed(arch)
    _, tc = _cfgs(arch)
    port = from_jax_params(np_tree, tc, "cpu")
    if arch == "falcon-mamba-7b":
        stacks = {"layers": [(i,) for i in range(tc.n_layers)]}
        get = lambda idx: port["layers"][idx[0]]
    else:
        g, t = divmod(tc.n_layers, tc.attn_every)
        assert len(port["groups"]) == g and len(port["tail"]) == t
        assert all(len(grp) == tc.attn_every for grp in port["groups"])
        stacks = {"groups": [(i, j) for i in range(g)
                             for j in range(tc.attn_every)],
                  "tail": [(i,) for i in range(t)]}
        get = None

    def check(ref, got, idx):
        if isinstance(ref, dict):
            assert set(ref) == set(got)
            for k in ref:
                check(ref[k], got[k], idx)
        elif hasattr(ref, "packed"):
            assert isinstance(got, QuantizedWeight)
            for name in ("packed", "scale"):
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(), getattr(ref, name)[idx])
        else:
            np.testing.assert_array_equal(got.numpy(), ref[idx])

    for key, idxs in stacks.items():
        for idx in idxs:
            node = port[key]
            for i in idx:
                node = node[i]
            if get is not None:
                assert node is get(idx)
            check(np_tree[key], node, idx)
    if arch == "zamba2-7b":
        check(np_tree["shared"], port["shared"], ())


def _packed_paths(tree, path=""):
    """Paths of the packed projections in a param tree: a list of layers
    adds no segment, as a stacked layer axis does not."""
    if isinstance(tree, list):
        return {p for v in tree for p in _packed_paths(v, path)}
    if not isinstance(tree, dict):
        return set()
    if "qw" in tree:
        return {path}
    return {p for k, v in tree.items() for p in _packed_paths(v, f"{path}/{k}")}


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_projections_are_the_references(packed, arch):
    """The port's ``quantize_params`` packs the set of projections the
    reference packs: every Mamba1 projection (``dt_proj`` keeping its
    bias) and the head; for zamba2 (``skip="ssm/(in_proj|out_proj)"``)
    the shared block's and the head, its Mamba2 projections float. The
    packed bytes equal the reference's."""
    params, np_tree = packed(arch)
    jc, tc = _cfgs(arch)
    ref_paths = _packed_paths(np_tree)
    shapes = jax.eval_shape(lambda: japi.init_params(
        jax.random.key(0), jc, serve_quantized=False))
    floats = _draw_tree(shapes, 30 + ARCHS.index(arch))
    tfloats = from_jax_params(jax.tree.map(np.asarray, floats), tc, "cpu")
    got = quantize_params(tfloats, tc.quant)
    assert _packed_paths(got) == ref_paths
    if arch == "falcon-mamba-7b":
        assert ref_paths == {"/layers/ssm/" + n for n in (
            "in_proj", "x_proj", "dt_proj", "out_proj")} | {"/lm_head"}
        lp = got["layers"][1]["ssm"]["dt_proj"]
        np.testing.assert_array_equal(
            lp["b"].numpy(), np_tree["layers"]["ssm"]["dt_proj"]["b"][1])
        qw, ref = lp["qw"], params["layers"]["ssm"]["dt_proj"]["qw"]
        np.testing.assert_array_equal(qw.packed.numpy(),
                                      np.asarray(ref.packed)[1])
    else:
        assert all("/shared/" in p or p == "/lm_head" for p in ref_paths)
        assert "w" in got["groups"][0][0]["ssm"]["in_proj"]
        assert "w" in got["tail"][0]["ssm"]["out_proj"]
