"""Port parity, the VLM and audio families (cross-attention): reduced
llama-3.2-vision-11b (4 layers in 2 groups of a self layer and a gated
cross layer, d_model 64, GQA 4/2, 16 image tokens) and whisper-tiny (2
encoder and 2 decoder layers, d_model 64, MHA 4/4, 24 audio frames, 128
learned positions) from ``repro_torch`` against ``repro`` on the CPU.

A numpy generator draws every float leaf of the reference's param tree
(``_draw``), the cross layers' scalar gates included: the reference
initialises them to 0, and a zero gate makes a cross layer add exactly
nothing, so a parity test on fresh params would pass with the cross path
wrong. The reference packs the tree and ``convert.from_jax_params`` loads
the packed tree into the port. Image embeddings and audio frames are
normal draws × 0.1 (tests/test_archs_smoke.py's scale).

Tolerances (rtol = atol):
  * ``layer_norm``, the GELU MLP, cross-attention over 1601 and 1500 keys
    (the full models' image and frame counts, at reduced width), the
    sinusoid, the encoder, the image / cross K/V: 1e-5 in f32 (sums taken
    in another order; the sinusoid's ``10000 ** x`` in torch's pow);
  * teacher-forced logits: fp16 and lut_xla with float tables within
    1e-4; per_row INT8 tables, lut_xla against the reference's lut_xla and
    lut_pallas (the kernels' plain versions here) against its lut_pallas
    (Pallas in interpret mode), within 0.15 with the greedy token equal at
    >= 90% of the positions (tests/test_torch_configs.py's bounds: an INT8
    entry at a rounding tie takes the neighbouring code);
  * chunked prefill then a decode step against one teacher-forced forward:
    1e-4 on the logits, 1e-5 on the cache;
  * engines (float tables: lut_xla in the reference, lut_pallas in the
    port): greedy streams and beam hypotheses equal to the reference
    engine's, beam scores within 1e-4 relative; block-paged streams equal
    to dense.
Measured here: every f32 block within 2e-6; logits within 4e-6 (fp16,
float tables) and 1e-6 (per_row), the greedy token equal everywhere.
"""

import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import audio as jaudio
from repro.models import layers as jL
from repro.models import quantized as jquant
from repro.models import vlm as jvlm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.core.quantize import QuantizedWeight
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models import audio as taudio
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tL
from repro_torch.models import vlm as tvlm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.quantized import quantize_params
from repro_torch.serving.engine import Request, ServingEngine

VLM, AUDIO = "llama-3.2-vision-11b", "whisper-tiny"
ARCHS = [VLM, AUDIO]
# (port mode, table_quant, the reference's mode, rtol = atol on logits)
MODES = [pytest.param("fp16", None, "fp16", 1e-4, id="fp16"),
         pytest.param("lut_xla", None, "lut_xla", 1e-4, id="lut_xla"),
         pytest.param("lut_xla", "per_row", "lut_xla", 0.15,
                      id="lut_xla-per_row"),
         pytest.param("lut_pallas", "per_row", "lut_pallas", 0.15,
                      id="lut_pallas-per_row")]
TOL = 1e-5


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
    """A float leaf of the reference's tree, drawn from ``rng`` at the
    scale of its role; the gates nonzero, of either sign."""
    name = getattr(path[-1], "key", None)
    shape = leaf.shape
    if name in ("gate_attn", "gate_mlp"):
        out = rng.choice([-1.0, 1.0], size=shape) * rng.uniform(
            0.3, 1.0, size=shape)
    elif name == "g":
        out = 1.0 + 0.1 * rng.normal(size=shape)
    elif name == "b":
        out = 0.1 * rng.normal(size=shape)
    elif name == "table":
        out = 0.02 * rng.normal(size=shape)
    elif name == "pos_embed":
        out = 0.01 * rng.normal(size=shape)
    else:  # a projection, [..., in, out]
        out = rng.normal(size=shape) / np.sqrt(shape[-2])
    return jnp.asarray(np.asarray(out, np.float32), dtype=leaf.dtype)


def _draw_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(rng, p, leaf), shapes)


def _float_tree(arch, seed=None):
    jc, _ = _cfgs(arch)
    shapes = jax.eval_shape(lambda: japi.init_params(
        jax.random.key(0), jc, serve_quantized=False))
    return _draw_tree(shapes, 40 + ARCHS.index(arch) if seed is None
                      else seed)


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
            params = jax.jit(lambda tree: jquant.quantize_params(
                tree, jc.quant))(_float_tree(arch))
            cache[arch] = params, jax.tree.map(np.asarray, params)
        return cache[arch]

    return get


def _inputs(cfg, b, rng):
    """The stub frontend's output: [B, n, d_model] × 0.1."""
    n = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    key = "image_embeds" if cfg.family == "vlm" else "audio_frames"
    return key, (0.1 * rng.normal(size=(b, n, cfg.d_model))).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
def test_layer_norm_matches_reference(bias):
    """LayerNorm in f32 with and without a bias (whisper's has one), on
    rows of mean 3 and scale 2."""
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.normal(size=(2, 5, 64))).astype(np.float32)
    p = {"g": (1.0 + 0.1 * rng.normal(size=64)).astype(np.float32)}
    if bias:
        p["b"] = (0.1 * rng.normal(size=64)).astype(np.float32)
    want = jL.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = tL.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert ("b" in tL.norm_init(8, bias=bias)) == bias


@pytest.mark.parametrize("mode", ["fp16", "lut_xla", "lut_pallas"])
def test_gelu_mlp_matches_reference(mode):
    """The non-gated MLP (up, the tanh GELU, down) with packed W2 weights,
    float tables; its init holds only ``up`` and ``down``. The erf GELU
    misses the reference by far more than the tolerance."""
    jc, tc = _cfgs(AUDIO)
    quant = dict(jc.quant, mpgemm_mode=mode, table_quant=None)
    shapes = jax.eval_shape(lambda: jL.mlp_init(
        jax.random.key(0), jc.d_model, jc.d_ff, gated=False))
    jp = jquant.quantize_params(_draw_tree(shapes, 1), quant)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu")
    x = np.random.default_rng(2).normal(size=(2, 6, jc.d_model)).astype(
        np.float32)
    want = np.asarray(jL.mlp_apply(jp, jnp.asarray(x), quant))
    got = tL.mlp_apply(tp, torch.from_numpy(x), dict(quant)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert set(tL.mlp_init(torch.Generator(), 8, 16, gated=False)) == {
        "up", "down"}
    h = tL.lut_dense(tp["up"], torch.from_numpy(x), dict(quant))
    erf = tL.lut_dense(tp["down"], torch.nn.functional.gelu(h), dict(quant))
    assert np.abs(erf.numpy() - want).max() > 10 * TOL


@pytest.mark.parametrize("n_keys", [1601, 1500], ids=["image", "audio"])
@pytest.mark.parametrize("per_slot", [False, True], ids=["chunk", "slot"])
def test_cross_attention_over_the_full_key_count(n_keys, per_slot):
    """Cross-attention (``xattn_kv``: only wq and wo run, no mask, no
    RoPE) at reduced width over the full models' key counts, 1601 image
    tokens and 1500 frames: ragged last chunks of attn_chunk 1024. A
    5-token chunk at offset 3, or a per-slot decode step (cache_pos [B],
    s = 1); the cache passes through untouched."""
    jc, tc = _cfgs(VLM)
    shapes = jax.eval_shape(lambda: jL.attention_init(
        jax.random.key(0), jc, cross=True))
    jp = _draw_tree(shapes, 3)
    rng = np.random.default_rng(4)
    s = 1 if per_slot else 5
    x = rng.normal(size=(2, s, jc.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(2, n_keys, jc.n_kv_heads, jc.head_dim))
            .astype(np.float32) for _ in range(2))
    jpos = jnp.asarray([7, 30]) if per_slot else 3
    tpos = torch.tensor([7, 30]) if per_slot else 3
    want, _ = jL.attention_apply(jp, jnp.asarray(x), jc, cache_pos=jpos,
                                 xattn_kv=(jnp.asarray(k), jnp.asarray(v)),
                                 causal=False, use_rope=False)
    sentinel = object()
    got, kept = tL.attention_apply(
        _to_torch(jp), torch.from_numpy(x), tc, cache_pos=tpos,
        kv_cache=sentinel, xattn_kv=(torch.from_numpy(k),
                                     torch.from_numpy(v)),
        causal=False, use_rope=False)
    assert kept is sentinel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("n_pos,d", [(24, 64), (1500, 384)])
def test_sinusoid_matches_reference(n_pos, d):
    """[sin | cos] concatenated, in f32: the reduced and the full
    whisper-tiny encoder's positions."""
    got = taudio._sinusoid(n_pos, d).numpy()
    want = np.asarray(jaudio._sinusoid(n_pos, d))
    assert got.shape == (n_pos, d)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["fp16", "lut_pallas"])
def test_encoder_and_cross_kv_match_reference(packed, mode):
    """whisper's encoder (bidirectional, LayerNorm, GELU) over 24 frames,
    then the decoder layers' cross K/V [L, B, F, KV, hd]; float tables."""
    params, np_tree = packed(AUDIO)
    jc, tc = _cfgs(AUDIO)
    jc = jc.with_quant(mpgemm_mode=mode, table_quant=None)
    tc = tc.with_quant(mpgemm_mode=mode, table_quant=None)
    _, frames = _inputs(tc, 2, np.random.default_rng(5))
    jenc = jaudio.encode(params, jnp.asarray(frames), jc)
    port = from_jax_params(np_tree, tc, "cpu")
    tenc = taudio.encode(port, torch.from_numpy(frames), tc)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=TOL,
                               atol=TOL)
    want = jaudio.compute_cross_kv(params, jenc, jc)
    got = taudio.compute_cross_kv(port, tenc, tc)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (tc.n_layers, 2, tc.n_audio_frames,
                                  tc.n_kv_heads, tc.head_dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("mode", ["fp16", "lut_pallas"])
def test_image_kv_matches_reference(packed, mode):
    """The VLM's image K/V [G, B, n_img, KV, hd]: one ``lut_dense`` of wk
    and wv per cross layer over the image embeddings; float tables."""
    params, np_tree = packed(VLM)
    jc, tc = _cfgs(VLM)
    jc = jc.with_quant(mpgemm_mode=mode, table_quant=None)
    tc = tc.with_quant(mpgemm_mode=mode, table_quant=None)
    _, emb = _inputs(tc, 2, np.random.default_rng(6))
    want = jvlm.compute_image_kv(params, jnp.asarray(emb), jc)
    got = tvlm.compute_image_kv(from_jax_params(np_tree, tc, "cpu"),
                                torch.from_numpy(emb), tc)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (tc.n_layers // tc.xattn_every, 2,
                                  tc.n_image_tokens, tc.n_kv_heads,
                                  tc.head_dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("mode,tq", [("lut_xla", "per_row"),
                                     ("lut_pallas", "per_row"),
                                     ("lut_pallas", None)])
def test_all_zero_row_through_lut_dense(mode, tq):
    """A zero activation row among nonzero ones (the engine's cross
    attention over a zero K/V gives one to ``wo``): its per_row scale
    clamps, the row comes out exactly zero (plus the bias), every output
    finite, the other rows as the reference's."""
    jc, tc = _cfgs(VLM)
    quant = dict(jc.quant, mpgemm_mode=mode, table_quant=tq)
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(64, 96)) / 8).astype(np.float32)
    b = (0.1 * rng.normal(size=96)).astype(np.float32)
    jp = jquant.quantize_params({"wo": {"w": jnp.asarray(w),
                                        "b": jnp.asarray(b)}}, quant)["wo"]
    tp = quantize_params({"wo": {"w": torch.from_numpy(w),
                                 "b": torch.from_numpy(b)}}, quant)["wo"]
    x = rng.normal(size=(3, 64)).astype(np.float32)
    x[1] = 0.0
    got = tL.lut_dense(tp, torch.from_numpy(x), quant).numpy()
    want = np.asarray(jL.lut_dense(jp, jnp.asarray(x), quant))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], b)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,tq,ref_mode,tol", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_reference(packed, arch, mode, tq,
                                               ref_mode, tol):
    """Reduced llama-3.2-vision-11b with image embeddings and whisper-tiny
    with audio frames through ``api.forward`` (no cache), nonzero gates:
    logits within the mode's tolerance, the greedy token of >= 90% of the
    positions equal. The cross path is live: zero gates (VLM) or a zero
    input (whisper's encoder) move the logits by more than 1e-2 and by
    more than 10× the port's distance from the reference."""
    params, np_tree = packed(arch)
    jc, tc = _cfgs(arch)
    jc = jc.with_quant(mpgemm_mode=ref_mode, table_quant=tq)
    tc = tc.with_quant(mpgemm_mode=mode, table_quant=tq)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tc.vocab_size, (2, 10))
    key, emb = _inputs(tc, 2, rng)
    want, _, _ = japi.forward(params, {"tokens": jnp.asarray(toks, jnp.int32),
                                       key: jnp.asarray(emb)}, jc)
    port = from_jax_params(np_tree, tc, "cpu")
    got, _, _ = tapi.forward(port, {"tokens": torch.from_numpy(toks),
                                    key: torch.from_numpy(emb)}, tc)
    assert got.shape == (2, 10, tc.vocab_size)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    if arch == VLM:
        for xp in port["xattn_layers"]:
            xp["gate_attn"], xp["gate_mlp"] = (torch.zeros(()),) * 2
    off, _, _ = tapi.forward(port, {"tokens": torch.from_numpy(toks),
                                    key: torch.zeros(emb.shape)}, tc)
    moved = np.abs(off.numpy() - got).max()
    assert moved > 1e-2 and moved > 10 * np.abs(got - want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_then_decode_equals_one_shot(packed, arch):
    """Prefill 11 tokens into a cache in chunks of 3 (the tail of 2 right-
    padded), the first chunk carrying the image embeddings or audio
    frames (their K/V written into the cache), and in one shot: the self
    K/V at the real positions and the cross K/V within 1e-5; the next
    token's decode step (per-slot, reading the cached cross K/V) within
    1e-4 of the teacher-forced forward's logits."""
    _, np_tree = packed(arch)
    _, tc = _cfgs(arch)
    tc = tc.with_quant(mpgemm_mode="lut_pallas", table_quant=None)
    port = from_jax_params(np_tree, tc, "cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (1, 12)))
    key, emb = _inputs(tc, 1, rng)
    emb = torch.from_numpy(emb)
    full, _, _ = tapi.forward(port, {"tokens": toks, key: emb}, tc)
    one = tapi.init_cache(tc, 1, 16, dtype=torch.float32, device="cpu")
    tapi.forward(port, {"tokens": toks[:, :11], key: emb}, tc, caches=one,
                 cache_pos=0, head=False)
    chunked = tapi.init_cache(tc, 1, 16, dtype=torch.float32, device="cpu")
    for j in range(0, 11, 3):
        n = min(3, 11 - j)
        buf = torch.zeros((1, 3), dtype=torch.int64)
        buf[:, :n] = toks[:, j:j + n]
        batch = {"tokens": buf, key: emb} if j == 0 else {"tokens": buf}
        tapi.forward(port, batch, tc, caches=chunked, cache_pos=j, head=False,
                     token_valid=torch.tensor([n]))
    seq = tkv.seq_axes(tapi.init_cache(tc, 1, 16, device="meta"),
                       tapi.init_cache(tc, 1, 32, device="meta"))
    cross = "image_kv" if arch == VLM else "cross_kv"
    assert tree_leaves(chunked[cross])[0].abs().max() > 0
    for a, b, sax in zip(tree_leaves(one), tree_leaves(chunked),
                         tree_leaves(seq)):
        if sax >= 0:
            a, b = a.narrow(sax, 0, 11), b.narrow(sax, 0, 11)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)
    step, _, _ = tapi.forward(port, {"tokens": toks[:, 11:]}, tc,
                              caches=chunked, cache_pos=torch.tensor([11]))
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
    """Five requests (prompts 2-17 tokens, slots reused) through the
    reference's engine with one-shot prefill and the port's with prefill
    chunk 3 (right-padded tails) and one-shot: equal greedy streams, one
    sync a decode chunk. Both engines prefill tokens only, so every slot
    attends to a zero cross K/V."""
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
    the self-attention K/V pooled, the cross K/V slot-resident."""
    _, _, tc, tparams = engine_params(arch)
    _, dense = _serve(tc, tparams, prefill_chunk=3)
    eng, paged = _serve(tc, tparams, prefill_chunk=3, cache_block_size=16)
    assert paged == dense
    assert eng.stats()["blocks_in_use"] == 0
    cross = "image_kv" if arch == VLM else "cross_kv"
    assert not any(tree_leaves(eng._pooled[cross]))
    assert all(tree_leaves(eng._pooled["kv"]))
    pool_axis = 2 if arch == VLM else 1
    assert eng.caches["kv"][0].shape[pool_axis] == eng.num_cache_blocks
    assert eng.caches[cross][0].shape[1] == 2


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
    reference engine's, their scores within 1e-4 relative. Every cache
    leaf forks along its own batch axis, the slot-resident cross K/V
    included."""
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
    """The reference's ``ValueError`` for self-speculation (with a draft
    view): the cross K/V has no sequence axis to rewind."""
    _, _, tc, tparams = engine_params(arch)
    eng = ServingEngine(tc, tparams, max_batch=2, max_seq=48,
                        spec_draft_planes=1)
    with pytest.raises(ValueError, match="self-speculative decoding "
                       "unsupported for family"):
        eng.submit(Request(uid=0, prompt=np.arange(5), decoding="spec"))
    assert not eng.queue


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_reuse_leaks_no_state(engine_params, arch):
    """A request served in a slot that an earlier request used gives the
    stream it gives in a fresh engine (dense and paged)."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_serves_through_the_entry_point(arch, capsys):
    """``launch/serve.py --arch`` serves each arch reduced on the CPU,
    greedy and beam."""
    for decoding in ("greedy", "beam:2"):
        assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "2", "--max-new", "3",
                           "--max-seq", "32", "--mode", "lut_pallas",
                           "--decoding", decoding]) == 0
        out = capsys.readouterr().out
        assert "(lut_pallas, W2 symmetric)" in out
        # a beam request's tokens count once a hypothesis
        tokens = 6 if decoding == "greedy" else 12
        assert f"served 2 requests / {tokens} tokens" in out


# ---------------------------------------------------------------------------
# layouts, conversion, packing, configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_axes(arch):
    """The VLM's self K/V [G, xattn_every - 1, B, S, KV, hd] (batch axis 2,
    sequence 3) and image K/V [G, B, n_img, KV, hd]; whisper's self K/V
    [L, B, S, KV, hd] and cross K/V [L, B, F, KV, hd]. The cross K/V has no
    sequence axis. Shapes equal the reference's."""
    jc, tc = _cfgs(arch)
    probe = lambda b, s: tapi.init_cache(tc, b, s, dtype=torch.float32,
                                         device="meta")
    baxes = tkv.batch_axes(probe(1, 32), probe(2, 32))
    saxes = tkv.seq_axes(probe(1, 32), probe(1, 64))
    cross = "image_kv" if arch == VLM else "cross_kv"
    self_axes = (2, 3) if arch == VLM else (1, 2)
    assert baxes == {"kv": (self_axes[0],) * 2, cross: (1, 1)}
    assert saxes == {"kv": (self_axes[1],) * 2, cross: (-1, -1)}
    mod = jvlm if arch == VLM else jaudio
    want = jax.eval_shape(lambda: mod.init_cache(jc, 2, 32,
                                                 dtype=jnp.float32))
    got = tapi.init_cache(tc, 2, 32, dtype=torch.float32, device="meta")
    assert set(got) == set(want)
    for grp in want:
        assert ([tuple(a.shape) for a in tree_leaves(got[grp])]
                == [tuple(a.shape) for a in jax.tree.leaves(want[grp])]), grp


@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_unstacks_the_layer_stacks(packed, arch):
    """The VLM's ``self_groups`` [G, A, ...] become G lists of A layer
    dicts, its ``xattn_layers`` [G, ...] G dicts whose gates are 0-dim
    tensors; whisper's ``enc_layers`` and ``dec_layers`` lists of layer
    dicts. Every buffer equal to its slice."""
    _, np_tree = packed(arch)
    _, tc = _cfgs(arch)
    port = from_jax_params(np_tree, tc, "cpu")
    if arch == VLM:
        g, a = tc.n_layers // tc.xattn_every, tc.xattn_every - 1
        assert len(port["self_groups"]) == g
        assert all(len(grp) == a for grp in port["self_groups"])
        stacks = {"self_groups": [(i, j) for i in range(g)
                                  for j in range(a)],
                  "xattn_layers": [(i,) for i in range(g)]}
        gate = port["xattn_layers"][1]["gate_attn"]
        assert gate.dim() == 0 and gate.item() == float(
            np_tree["xattn_layers"]["gate_attn"][1]) != 0.0
    else:
        stacks = {"enc_layers": [(i,) for i in range(tc.enc_layers)],
                  "dec_layers": [(i,) for i in range(tc.n_layers)]}
        np.testing.assert_array_equal(port["pos_embed"].numpy(),
                                      np_tree["pos_embed"])

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
            check(np_tree[key], node, idx)


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
    reference packs: the self and cross layers' attention (``xattn/wq`` ..
    ``wo``) and MLPs (whisper's non-gated ``up`` / ``down``) and the head;
    the gates, norms, embedding and ``pos_embed`` stay float. The packed
    bytes equal the reference's."""
    params, np_tree = packed(arch)
    _, tc = _cfgs(arch)
    ref_paths = _packed_paths(np_tree)
    tfloats = from_jax_params(jax.tree.map(np.asarray, _float_tree(arch)),
                              tc, "cpu")
    got = quantize_params(tfloats, tc.quant)
    assert _packed_paths(got) == ref_paths
    attn = {f"/{n}" for n in ("wq", "wk", "wv", "wo")}
    if arch == VLM:
        assert ref_paths == (
            {"/self_groups/attn" + p for p in attn}
            | {"/xattn_layers/xattn" + p for p in attn}
            | {f"/{s}/mlp/{n}" for s in ("self_groups", "xattn_layers")
               for n in ("gate", "up", "down")} | {"/lm_head"})
        xp = got["xattn_layers"][1]
        assert torch.is_tensor(xp["gate_mlp"]) and xp["gate_mlp"].dim() == 0
        qw, ref = xp["xattn"]["wk"]["qw"], params["xattn_layers"]["xattn"][
            "wk"]["qw"]
    else:
        assert ref_paths == (
            {f"/{s}/attn{p}" for s in ("enc_layers", "dec_layers")
             for p in attn} | {"/dec_layers/xattn" + p for p in attn}
            | {f"/{s}/mlp/{n}" for s in ("enc_layers", "dec_layers")
               for n in ("up", "down")} | {"/lm_head"})
        assert torch.is_tensor(got["pos_embed"])
        qw, ref = got["dec_layers"][1]["xattn"]["wk"]["qw"], params[
            "dec_layers"]["xattn"]["wk"]["qw"]
    np.testing.assert_array_equal(qw.packed.numpy(),
                                  np.asarray(ref.packed)[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_equals_the_reference(arch):
    """The port's random packed params at reduced size have the
    reference's tree: every leaf's path, shape and dtype (packed buffers
    included), the VLM's gates 0.0; a lut_pallas forward with inputs from
    the stub frontend gives finite logits."""
    jc, tc = _cfgs(arch)
    shapes = jax.eval_shape(lambda: japi.init_params(
        jax.random.key(0), jc, serve_quantized=True))
    want = from_jax_params(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), tc, "cpu")
    got = tapi.init_params(torch.Generator().manual_seed(0), tc, "cpu")

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        elif hasattr(tree, "packed"):
            yield path + ("packed",), tree.packed
            yield path + ("scale",), tree.scale
        else:
            yield path, tree

    got_leaves, want_leaves = dict(leaves(got)), dict(leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), path
    if arch == VLM:
        assert all(xp[k].item() == 0.0 for xp in got["xattn_layers"]
                   for k in ("gate_attn", "gate_mlp"))
    key, emb = _inputs(tc, 2, np.random.default_rng(9))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 8)))
    logits, _, _ = tapi.forward(got, {"tokens": toks,
                                      key: torch.from_numpy(emb)},
                                tc.with_quant(mpgemm_mode="lut_pallas",
                                              table_quant="per_row"))
    assert logits.shape == (2, 8, tc.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("family,field", [
    ("vlm", "xattn_every"), ("vlm", "n_image_tokens"),
    ("audio", "enc_layers"), ("audio", "n_audio_frames"),
    ("audio", "max_positions")])
def test_config_refuses_a_missing_family_field(family, field):
    arch = VLM if family == "vlm" else AUDIO
    with pytest.raises(ValueError, match=field):
        treg.get_reduced(arch).replace(**{field: 0})
