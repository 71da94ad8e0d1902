"""Port parity, the int8 KV cache (``kv_cache_dtype="int8"``): int8 codes
and one f32 absmax scale a (position, head), from ``repro_torch`` against
``repro`` on the CPU.

  * ``_quantize_kv_slice``: the reference's codes and scales, bit-equal,
    rounding ties included;
  * ``chunked_attention`` over int8 codes and scales: within 1e-5 of the
    reference's (f32 sums taken in another order);
  * the cache layout: four leaves, their dtypes and shapes, the scales at
    ones, the batch and sequence axes, the paged gather and scatter;
  * teacher-forced logits on int8 caches, reduced tinyllama, olmoe,
    zamba2 (its shared attention) and whisper, lut_xla with float tables:
    two prefill chunks, then per-slot decode steps. The reference is given
    array offsets, as its engine's traced prefill is: with the static int
    0 it attends over the chunk's unquantized K/V. Every cache code is
    compared with the reference's: a K/V element at a rounding tie can
    take the neighbouring code after a last-bit difference in its
    projection. Such flips are counted (at most MAX_CODE_FLIPS, each one
    step); the logits are within rtol = atol = 1e-4 where none flipped and
    1e-2 otherwise (one step of one element moves one score by a code
    step). Measured here: no flip; logits within 3e-6 (tinyllama, olmoe,
    whisper) and 1.5e-4 of logits up to ~3 (zamba2's second prefill chunk,
    after its f32 Mamba2 scan);
  * engines: one pool of a greedy, a ``spec:draft2b`` and a ``beam:2``
    request (tests/test_torch_decoding.py's reduced tinyllama, W4, float
    tables), dense and paged, against the reference engine: streams and
    hypotheses equal, beam scores within 1e-4 relative; a paged int8 pool
    with prefix caching equal to the dense int8 one; ``cache_hbm_bytes``
    equal to the layout's formula; the VLM refusing the int8 cache.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import kvcache as jkv
from repro.models import layers as jL
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.core.tree import tree_leaves
from repro_torch.models import api as tapi
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tL
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.engine import Request, ServingEngine

ARCHS = ["tinyllama-1.1b", "olmoe-1b-7b", "zamba2-7b", "whisper-tiny"]
MAX_CODE_FLIPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# quantizer, attention, layout
# ---------------------------------------------------------------------------

def test_quantize_kv_slice_is_the_reference_bit_for_bit():
    """Codes and scales equal on a seeded draw, on a row whose scale is
    exactly 1 (so x / scale lands on the halves 0.5, 2.5, -3.5: ties round
    to even in both packages) and on an all-zero row (scale 1e-8 / 127)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    x[0, 1, 0, :4] = [127.0, 0.5, 2.5, -3.5]
    x[0, 1, 0, 4:] = 1.0
    q, sc = tL._quantize_kv_slice(torch.from_numpy(x))
    jq, jsc = jL._quantize_kv_slice(jnp.asarray(x))
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    assert sc.shape == (2, 5, 3, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert q[0, 1, 0, :4].tolist() == [127, 0, 2, -4]


@pytest.mark.parametrize("vlen", ["none", "rows", "queries"])
def test_chunked_attention_with_scales_matches_reference(vlen):
    """GQA 4/2, 37 cache positions in chunks of 8 (a ragged last chunk),
    int8 codes with per-(position, head) scales; valid lengths none, one a
    row, or one a query (the speculative burst's form)."""
    rng = np.random.default_rng(1)
    b, sq, h, kvh, hd, skv = 2, 3, 4, 2, 16, 37
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k, v = (rng.integers(-127, 128, (b, skv, kvh, hd)).astype(np.int8)
            for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.05, (b, skv, kvh, 1)).astype(np.float32)
              for _ in range(2))
    kw, jkw = {}, {}
    if vlen == "rows":
        v_l = np.array([20, 37])
        kw["kv_valid_len"] = torch.from_numpy(v_l)
        jkw["kv_valid_len"] = jnp.asarray(v_l)
    elif vlen == "queries":
        v_l = np.array([[10, 11, 12], [30, 31, 32]])
        kw["kv_valid_len"] = torch.from_numpy(v_l)
        jkw["kv_valid_len"] = jnp.asarray(v_l)
    causal = vlen == "none"
    got = tL.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=30, causal=causal, chunk=8, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs), **kw)
    want = jL.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=30,
        causal=causal, chunk=8, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_int8_cache_layout_matches_reference():
    """(k, v, k_scale, v_scale): int8 codes [L, B, S, KV, hd] at zero, f32
    scales [L, B, S, KV, 1] at one, as the reference's; the batch and
    sequence axes of every leaf; a paged scatter then gather of all four
    leaves equal to the reference's."""
    got = tkv.attn_cache(2, 3, 16, 2, 4, "int8", device="cpu")
    want = jkv.attn_cache(2, 3, 16, 2, 4, "int8")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tkv.attn_cache(2, 3, 16, 2, 4, torch.int8)[2].dtype == torch.float32
    meta = lambda b, s: tkv.attn_cache(2, b, s, 2, 4, "int8", device="meta")
    shp = lambda b, s: jax.eval_shape(lambda: jkv.attn_cache(2, b, s, 2, 4,
                                                             "int8"))
    assert list(tkv.batch_axes(meta(1, 16), meta(2, 16))) == list(
        jkv.batch_axes(shp(1, 16), shp(2, 16)))
    assert list(tkv.seq_axes(meta(1, 16), meta(1, 32))) == list(
        jkv.seq_axes(shp(1, 16), shp(1, 32)))

    # one layer's pool: 6 blocks of 4; two slots' tables and positions
    rng = np.random.default_rng(2)
    pool = [leaf[0] for leaf in tkv.attn_cache(1, 6, 4, 2, 4, "int8")]
    jpool = [leaf[0] for leaf in jkv.attn_cache(1, 6, 4, 2, 4, "int8")]
    table = np.array([[3, 1, 0], [2, 5, 4]])
    pos = np.array([[1, 5, 13], [0, 6, 11]])  # 13: past the table's reach
    x = rng.normal(size=(2, 3, 2, 4)).astype(np.float32)
    codes, scales = tL._quantize_kv_slice(torch.from_numpy(x))
    for i, vals in enumerate((codes, codes, scales, scales)):
        tkv.paged_scatter(pool[i], vals, torch.from_numpy(table),
                          torch.from_numpy(pos))
        jpool[i] = jkv.paged_scatter(jpool[i], jnp.asarray(vals.numpy()),
                                     jnp.asarray(table), jnp.asarray(pos))
        np.testing.assert_array_equal(pool[i].numpy(), np.asarray(jpool[i]))
        np.testing.assert_array_equal(
            tkv.paged_gather(pool[i], torch.from_numpy(table)).numpy(),
            np.asarray(jkv.paged_gather(jpool[i], jnp.asarray(table))))


def test_vlm_refuses_the_int8_cache():
    tc = treg.get_reduced("llama-3.2-vision-11b").replace(
        activation_dtype=torch.float32)
    with pytest.raises(ValueError, match="int8 KV cache"):
        tapi.init_cache(tc, 1, 32, dtype="int8", device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tapi.init_params(gen, tc, "cpu")
    with pytest.raises(ValueError, match="int8 KV cache"):
        ServingEngine(tc, params, max_batch=2, max_seq=32,
                      kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="int8 KV cache"):
        ServingEngine(tc.replace(kv_cache_dtype="int8"), params,
                      max_batch=2, max_seq=32)


# ---------------------------------------------------------------------------
# teacher-forced logits, four families
# ---------------------------------------------------------------------------

def _attn_leaves(cache):
    """The int8 attention leaves (k, v, k_scale, v_scale) of a cache
    tree (the reference's or the port's)."""
    return tuple(cache["kv"]) if isinstance(cache, dict) else tuple(cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_on_int8_caches_match_reference(arch):
    jc = jreg.get_reduced(arch).replace(
        activation_dtype=jnp.float32, kv_cache_dtype="int8").with_quant(
            mpgemm_mode="lut_xla", table_quant=None)
    tc = treg.get_reduced(arch).replace(
        activation_dtype=torch.float32, kv_cache_dtype="int8").with_quant(
            mpgemm_mode="lut_xla", table_quant=None)
    jp = japi.init_params(jax.random.key(0), jc, serve_quantized=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu")
    rng = np.random.default_rng(3)
    b, s, n_dec = 2, 12, 3
    toks = rng.integers(0, tc.vocab_size, (b, s + n_dec))
    extra = {}
    if arch == "whisper-tiny":
        extra["audio_frames"] = (0.1 * rng.normal(
            size=(b, tc.n_audio_frames, tc.d_model))).astype(np.float32)
    jcache = japi.init_cache(jc, b, 32)
    tcache = tapi.init_cache(tc, b, 32, device="cpu")
    assert len(_attn_leaves(tcache)) == 4
    steps = []
    for off in (0, s // 2):  # two prefill chunks, the encoder in the first
        batch = {"tokens": toks[:, off:off + s // 2],
                 **(extra if off == 0 else {})}
        steps.append((batch, off, jnp.int32(off)))
    for j in range(n_dec):  # per-slot decode steps
        pos = np.full(b, s + j)
        steps.append(({"tokens": toks[:, s + j:s + j + 1]},
                      torch.from_numpy(pos), jnp.asarray(pos)))
    got, want = [], []
    for batch, tpos, jpos in steps:
        jl, jcache, _ = japi.forward(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc,
            caches=jcache, cache_pos=jpos)
        tl_, tcache, _ = tapi.forward(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
            caches=tcache, cache_pos=tpos)
        want.append(np.asarray(jl))
        got.append(tl_.numpy())
    flips = 0
    for g, w in zip(_attn_leaves(tcache), _attn_leaves(jcache)):
        g, w = g.numpy(), np.asarray(w)
        if w.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1
            flips += int((d > 0).sum())
        else:  # scales: an absmax carries no tie
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-9)
    assert flips <= MAX_CODE_FLIPS
    tol = 1e-4 if flips == 0 else 1e-2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _quant(cfg):
    return cfg.with_quant(mpgemm_mode="lut_xla", weight_bits=4,
                          store="packed", skip="lm_head")


@pytest.fixture(scope="module")
def tl():
    """(reference cfg, reference params, port cfg, port params): reduced
    tinyllama, W4, float tables, the same packed weights in both."""
    jc = _quant(jreg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=jnp.float32))
    jparams = japi.init_params(jax.random.key(0), jc, serve_quantized=True)
    tc = _quant(treg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=torch.float32))
    return jc, jparams, tc, from_jax_params(
        jax.tree.map(np.asarray, jparams), tc, "cpu")


def _serve(eng, req_cls, prompts, modes, n_new=8):
    reqs = [req_cls(uid=i, prompt=p, max_new_tokens=n_new, decoding=m)
            for i, (p, m) in enumerate(zip(prompts, modes))]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return reqs


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_engine_matches_reference_engine(tl, paged):
    """A greedy, a spec:draft2b (spec_k 3) and a beam:2 request in one
    pool, both engines on int8 caches: every stream and hypothesis equal,
    beam scores within 1e-4 relative, the spec counts equal."""
    jc, jparams, tc, params = tl
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tc.vocab_size, n) for n in (5, 11, 9)]
    modes = ["greedy", "spec:draft2b", "beam:2"]
    kw = dict(max_batch=4, max_seq=64, decode_chunk=4, prefill_chunk=4,
              spec_k=3, spec_draft_planes=2, kv_cache_dtype="int8")
    jreqs = _serve(JEngine(jc, jparams, **kw), JRequest,
                   [p.astype(np.int32) for p in prompts], modes)
    eng = ServingEngine(tc, params, **kw,
                        **(dict(cache_block_size=8) if paged else {}))
    reqs = _serve(eng, Request, prompts, modes)
    for r, jr in zip(reqs, jreqs):
        assert r.output == [int(t) for t in jr.output], r.decoding
    assert [t for t, _ in reqs[2].beams] == [[int(x) for x in t]
                                            for t, _ in jreqs[2].beams]
    np.testing.assert_allclose([sc for _, sc in reqs[2].beams],
                               [sc for _, sc in jreqs[2].beams], rtol=1e-4)
    assert reqs[1].spec_stats == jreqs[1].spec_stats
    assert len(tuple(eng.caches)) == 4
    assert eng.caches[0].dtype == torch.int8


def test_paged_int8_with_prefix_cache_equals_dense_int8(tl):
    """A 16-token shared prefix fanned out over 5 requests: the paged int8
    pool with prefix caching gives the dense int8 pool's streams and
    reuses the 16 shared positions of each follower; an int8 stream is not
    the f32 one's by construction, so the f32 engine only serves beside."""
    _, _, tc, params = tl
    sys_p = np.random.default_rng(4).integers(0, tc.vocab_size, 16)
    prompts = [np.concatenate([sys_p, [i, i + 1]]) for i in range(5)]
    kw = dict(max_batch=2, max_seq=64, decode_chunk=4, prefill_chunk=4,
              kv_cache_dtype="int8")
    dense = _serve(ServingEngine(tc, params, **kw), Request, prompts,
                   ["greedy"] * 5, n_new=6)
    eng = ServingEngine(tc, params, **kw, cache_block_size=8,
                        prefix_cache=True)
    paged = _serve(eng, Request, prompts, ["greedy"] * 5, n_new=6)
    assert [r.output for r in paged] == [r.output for r in dense]
    assert eng.stats()["prefill_tokens_reused"] == 4 * 16
    assert eng.stats()["blocks_in_use"] == eng.stats()["prefix_cache"][
        "entries"]


def _slot_resident(cache):
    """The leaves of a cache tree outside its self-attention KV."""
    if not isinstance(cache, dict):
        return []
    return tree_leaves({k: v for k, v in cache.items() if k != "kv"})


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b",
                                  "whisper-tiny"])
def test_cache_hbm_bytes_is_the_formula(arch):
    """Per attention layer and position: 2·KV·hd bytes of codes and 2·KV·4
    of scales (int8) against 2·KV·hd·4 (f32); slot-resident leaves (SSM
    state, whisper's cross K/V at one byte an element) as the layout
    gives them; the paged pool counts its blocks, the null one included."""
    tc = treg.get_reduced(arch).replace(activation_dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tapi.init_params(gen, tc, "cpu")
    n_attn = {"tinyllama-1.1b": tc.n_layers, "whisper-tiny": tc.n_layers,
              "zamba2-7b": tc.n_layers // tc.attn_every}[arch]
    per_pos = {"int8": 2 * tc.n_kv_heads * (tc.head_dim + 4),
               "bf16": 2 * tc.n_kv_heads * tc.head_dim * 4}
    b, seq, bs = 2, 32, 8
    nblk = b * seq // bs + 1
    for dt in ("int8", "bf16"):
        other = sum(leaf.numel() * leaf.element_size() for leaf in
                    _slot_resident(tapi.init_cache(
                        tc, b, seq, dtype="int8" if dt == "int8"
                        else torch.float32, device="cpu")))
        for paged, positions in ((False, b * seq), (True, nblk * bs)):
            eng = ServingEngine(tc, params, max_batch=b, max_seq=seq,
                                kv_cache_dtype=dt,
                                **(dict(cache_block_size=bs) if paged
                                   else {}))
            assert eng.stats()["cache_hbm_bytes"] == (
                n_attn * positions * per_pos[dt] + other), (dt, paged)

