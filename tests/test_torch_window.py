"""Port parity, sliding-window attention and the rolling KV cache, from
``repro_torch`` against ``repro`` on the CPU.

  * ``ArchConfig.shapes()``: the reference's four shapes for all 11 archs
    (``long_500k``'s 8192 window on the hybrid family, its skip reason on
    the full-attention ones);
  * the cache layout: ``attn_cache(window=)`` keeps min(s_cache, window)
    positions, a rolling leaf has no sequence axis (-1), as the
    reference's docstring says;
  * ``chunked_attention(window=)`` within 1e-5 of the reference's;
  * each family whose forward takes a window (dense, MoE, hybrid, VLM,
    audio), reduced, lut_xla with float tables: a windowed forward without
    a cache, and a rolling-cache decode (a 6-token prefill, then s = 1
    steps at positions 6..13, past the wrap of a window of 8) against the
    reference's logits within rtol = atol = 1e-4 (zamba2 5e-4: its Mamba2
    scan sums in another order, windowed or not), and against the port's
    own full-length cache with the window mask within 1e-4. The
    reference's whisper forward drops its ``window`` (it never passes it
    to the decoder's self-attention); the port applies it, and is held to
    the reference's layers with the window passed in;
  * the reference's chunk semantics on the rolling cache: a chunk that
    wraps overwrites keys its own earlier queries still need, in the port
    as in the reference;
  * the refusals, each beside the reference's wrong output: an int8
    rolling cache, per-slot decode with a window.
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
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tL
from repro_torch.models.convert import from_jax_params

WINDOW = 8
FAMILY_ARCHS = ["tinyllama-1.1b", "olmoe-1b-7b", "zamba2-7b",
                "llama-3.2-vision-11b", "whisper-tiny"]
TOL = 1e-4
# zamba2's Mamba2 scan sums in another order than the reference's (the
# unwindowed parity of tests/test_torch_ssm.py and tests/test_torch_kvint8.py
# sees the same): 1.7e-4 of logits up to ~2 measured at s = 16
HYBRID_TOL = 5e-4


def _tol(arch):
    return HYBRID_TOL if arch == "zamba2-7b" else TOL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# shapes, layout, the masked attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", treg.list_archs())
def test_shapes_are_the_reference_shapes(arch):
    got = treg.get_config(arch).shapes()
    want = jreg.get_config(arch).shapes()
    fields = ("name", "seq_len", "global_batch", "kind", "window", "skip")
    assert ([tuple(getattr(s, f) for f in fields) for s in got]
            == [tuple(getattr(s, f) for f in fields) for s in want])
    long = treg.get_config(arch).shape("long_500k")
    assert long == got[-1]
    with pytest.raises(KeyError):
        treg.get_config(arch).shape("no_such_shape")


def test_rolling_cache_layout_matches_reference():
    """min(s_cache, window) positions; the batch axes; the sequence axis
    -1 for a rolling leaf (both probes above the window) and the cache's
    own axis below it."""
    got = tkv.attn_cache(2, 3, 64, 2, 4, torch.float32, window=WINDOW)
    want = jkv.attn_cache(2, 3, 64, 2, 4, jnp.float32, window=WINDOW)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[0].shape[2] == WINDOW
    assert tkv.attn_cache(1, 1, 4, 1, 2, window=WINDOW)[0].shape[2] == 4
    meta = lambda b, s, w: tkv.attn_cache(2, b, s, 2, 4, window=w,
                                          device="meta")
    shp = lambda b, s, w: jax.eval_shape(
        lambda: jkv.attn_cache(2, b, s, 2, 4, window=w))
    for w in (WINDOW, None):
        assert list(tkv.batch_axes(meta(1, 16, w), meta(2, 16, w))) == list(
            jkv.batch_axes(shp(1, 16, w), shp(2, 16, w)))
        assert list(tkv.seq_axes(meta(1, 16, w), meta(1, 32, w))) == list(
            jkv.seq_axes(shp(1, 16, w), shp(1, 32, w)))
    assert list(tkv.seq_axes(meta(1, 16, WINDOW), meta(1, 32, WINDOW))) == [
        -1, -1]
    tc = treg.get_reduced("zamba2-7b")
    probe = lambda s: tapi.init_cache(tc, 1, s, window=WINDOW, device="meta")
    axes = tkv.seq_axes(probe(16), probe(32))
    assert list(axes["kv"]) == [-1, -1]


@pytest.mark.parametrize("q_offset", [0, 30])
def test_windowed_chunked_attention_matches_reference(q_offset):
    """GQA 4/2, 37 keys in chunks of 8 (a ragged last chunk), window 5,
    causal, with and without a valid length."""
    rng = np.random.default_rng(1)
    b, sq, h, kvh, hd, skv = 2, 7, 4, 2, 16, 37
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)
            for _ in range(2))
    for vl in (None, q_offset + sq):
        got = tL.chunked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            q_offset=q_offset, window=5, kv_valid_len=vl, chunk=8)
        want = jL.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_offset=q_offset, window=5, kv_valid_len=vl, chunk=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # the mask itself: a query sees exactly its 5 latest keys
    kk = np.zeros_like(k)
    vv = np.broadcast_to(np.arange(skv, dtype=np.float32)[None, :, None,
                                                          None],
                         v.shape).copy()
    out = tL.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(vv),
        q_offset=q_offset, window=5, chunk=8).numpy()
    for j in range(sq):
        pos = q_offset + j
        lo = max(0, pos - 4)
        np.testing.assert_allclose(out[:, j], (lo + pos) / 2.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# families: windowed forward, rolling decode past the wrap
# ---------------------------------------------------------------------------

_PAIRS = {}


def _pair(arch):
    """(reference cfg, reference params, port cfg, port params), reduced,
    lut_xla with float tables, the same packed weights in both."""
    if arch not in _PAIRS:
        jc = jreg.get_reduced(arch).replace(
            activation_dtype=jnp.float32).with_quant(
                mpgemm_mode="lut_xla", table_quant=None)
        tc = treg.get_reduced(arch).replace(
            activation_dtype=torch.float32).with_quant(
                mpgemm_mode="lut_xla", table_quant=None)
        jp = japi.init_params(jax.random.key(0), jc, serve_quantized=True)
        _PAIRS[arch] = (jc, jp, tc,
                        from_jax_params(jax.tree.map(np.asarray, jp), tc,
                                        "cpu"))
    return _PAIRS[arch]


def _frontend(tc, rng, b):
    """The stub frontend's input a prefill of the VLM or whisper carries."""
    if tc.family == "vlm":
        return {"image_embeds": (0.1 * rng.normal(
            size=(b, tc.n_image_tokens, tc.d_model))).astype(np.float32)}
    if tc.family == "audio":
        return {"audio_frames": (0.1 * rng.normal(
            size=(b, tc.n_audio_frames, tc.d_model))).astype(np.float32)}
    return {}


@pytest.fixture
def reference_window(monkeypatch):
    """``reference_window(arch, w)``: for whisper, whose reference forward
    drops ``window``, the reference's layers are given it (the decoder's
    self-attention: no ``xattn_kv``, causal); every other family's
    reference forward passes it itself."""
    def apply(arch, w):
        if arch != "whisper-tiny":
            return {"window": w}
        orig = jL.attention_apply

        def with_window(*a, **kw):
            if kw.get("xattn_kv") is None and kw.get("causal", True):
                kw["window"] = w
            return orig(*a, **kw)
        monkeypatch.setattr(jL, "attention_apply", with_window)
        return {}
    return apply


def _run(fwd, params, cfg, steps, cache, window_kw):
    out = []
    for batch, pos in steps:
        logits, cache, _ = fwd(params, batch, cfg, caches=cache,
                               cache_pos=pos, **window_kw)
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_windowed_forward_without_cache_matches_reference(
        arch, reference_window):
    jc, jp, tc, tp = _pair(arch)
    rng = np.random.default_rng(4)
    b, s, w = 2, 16, 5
    batch = {"tokens": rng.integers(0, tc.vocab_size, (b, s)),
             **_frontend(tc, rng, b)}
    got = tapi.forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                       tc, window=w)[0].numpy()
    full = tapi.forward(tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, tc)[0].numpy()
    want = np.asarray(japi.forward(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc,
        **reference_window(arch, w))[0])
    np.testing.assert_allclose(got, want, rtol=_tol(arch), atol=_tol(arch))
    # the window changes the answer past its reach (and not before)
    np.testing.assert_allclose(got[:, :w], full[:, :w], rtol=TOL, atol=TOL)
    assert np.abs(got[:, w:] - full[:, w:]).max() > 1e-3


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_rolling_decode_past_the_wrap_matches_reference(
        arch, reference_window):
    """A 6-token prefill into a rolling cache of 8 (s_cache 32), then
    s = 1 steps at positions 6..13: logits against the reference's at
    every step, and against the port's full-length cache under the window
    mask."""
    jc, jp, tc, tp = _pair(arch)
    tol = _tol(arch)
    rng = np.random.default_rng(5)
    b, pre, n_dec = 2, 6, 8
    toks = rng.integers(0, tc.vocab_size, (b, pre + n_dec))
    extra = _frontend(tc, rng, b)
    steps = [({"tokens": toks[:, :pre], **extra}, 0)] + [
        ({"tokens": toks[:, p:p + 1]}, p) for p in range(pre, pre + n_dec)]
    tsteps = [({k: torch.from_numpy(v) for k, v in bt.items()}, p)
              for bt, p in steps]
    # the reference takes array offsets: its static int 0 attends over the
    # chunk's fresh K/V, which writes the same slots here (6 <= window)
    jsteps = [({k: jnp.asarray(v) for k, v in bt.items()}, jnp.int32(p))
              for bt, p in steps]
    # f32 caches (the engine's): a bf16 cache rounds K/V elements whose
    # last bits differ between the packages to neighbouring bf16 values
    tcache = tapi.init_cache(tc, b, 32, torch.float32, window=WINDOW,
                             device="cpu")
    kv = tcache["kv"] if isinstance(tcache, dict) else tcache
    assert kv[0].shape[-3] == WINDOW
    got = _run(tapi.forward, tp, tc, tsteps, tcache, {"window": WINDOW})
    full = _run(tapi.forward, tp, tc, tsteps,
                tapi.init_cache(tc, b, 32, torch.float32, device="cpu"),
                {"window": WINDOW})
    want = _run(japi.forward, jp, jc, jsteps,
                japi.init_cache(jc, b, 32, window=WINDOW, dtype=jnp.float32),
                reference_window(arch, WINDOW))
    for g, f, wnt in zip(got, full, want):
        np.testing.assert_allclose(g, wnt, rtol=tol, atol=tol)
        np.testing.assert_allclose(g, f, rtol=TOL, atol=TOL)


def test_reference_whisper_forward_drops_the_window():
    """Why whisper's parity runs on the reference's layers: its forward
    with ``window`` gives its forward without one."""
    jc, jp, tc, _ = _pair("whisper-tiny")
    rng = np.random.default_rng(6)
    batch = {"tokens": jnp.asarray(rng.integers(0, tc.vocab_size, (1, 12))),
             **{k: jnp.asarray(v) for k, v in _frontend(tc, rng, 1).items()}}
    a = np.asarray(japi.forward(jp, batch, jc, window=3)[0])
    np.testing.assert_array_equal(a, np.asarray(japi.forward(jp, batch,
                                                             jc)[0]))


def test_ssm_family_accepts_and_ignores_a_window():
    tc =treg.get_reduced("falcon-mamba-7b").replace(
        activation_dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tapi.init_params(gen, tc, "cpu")
    toks = {"tokens": torch.arange(10)[None] % tc.vocab_size}
    a = tapi.forward(tp, toks, tc, window=3)[0]
    torch.testing.assert_close(a, tapi.forward(tp, toks, tc)[0], rtol=0,
                               atol=0)
    c = tapi.init_cache(tc, 1, 16, window=3, device="cpu")
    assert set(c) == {"conv", "ssm"}


# ---------------------------------------------------------------------------
# the chunk that wraps, and the refusals
# ---------------------------------------------------------------------------

def _layer(arch="tinyllama-1.1b"):
    jc, jp, tc, tp = _pair(arch)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])["attn"]
    return jc, jlp, tc, tp["layers"][0]["attn"]


def test_wrapping_chunk_matches_the_reference_quirk():
    """Window 8, chunks (0, 6) then (6, 6) on a rolling cache: the second
    chunk's slots 0-3 take positions 8-11 before its queries at 6-10 read
    positions 0-3 (which they still need), in the port as in the reference.
    So positions 6-10 differ from full windowed attention, and 0-5 and 11
    agree with it."""
    jc, jlp, tc, tlp = _layer()
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 12, tc.d_model)).astype(np.float32)
    tcache = tuple(leaf[0] for leaf in tkv.attn_cache(
        1, 1, 32, tc.n_kv_heads, tc.head_dim, torch.float32, window=WINDOW))
    jcache = tuple(leaf[0] for leaf in jkv.attn_cache(
        1, 1, 32, jc.n_kv_heads, jc.head_dim, jnp.float32, window=WINDOW))
    got, want = [], []
    for off in (0, 6):
        xs = x[:, off:off + 6]
        o, _ = tL.attention_apply(tlp, torch.from_numpy(xs), tc,
                                  kv_cache=tcache, cache_pos=off,
                                  quant=tc.quant, window=WINDOW)
        jo, jcache = jL.attention_apply(jlp, jnp.asarray(xs), jc,
                                        kv_cache=jcache,
                                        cache_pos=jnp.int32(off),
                                        quant=jc.quant, window=WINDOW)
        got.append(o.numpy())
        want.append(np.asarray(jo))
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for t, j in zip(tcache, jcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    ideal = tL.attention_apply(tlp, torch.from_numpy(x), tc, quant=tc.quant,
                               window=WINDOW)[0].numpy()
    diff = np.abs(got - ideal).max(axis=(0, 2))
    assert (diff[[0, 1, 2, 3, 4, 5, 11]] < 1e-5).all(), diff
    assert (diff[6:11] > 1e-2).all(), diff


def test_int8_rolling_cache_is_refused_where_the_reference_is_wrong():
    """The reference's int8 branch runs before its rolling branch and
    writes at the position itself, so past the wrap its dynamic update
    clamps onto the last slot: its int8 rolling decode leaves its own
    int8 full-cache windowed decode once a write passes the window. The
    port refuses the cache, and an int8 cache written past its end."""
    jc, jlp, tc, tlp = _layer()
    jc8 = jc.replace(kv_cache_dtype="int8")
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 12, jc.d_model)).astype(np.float32)

    def decode(s_cache, window):
        cache = tuple(leaf[0] for leaf in jkv.attn_cache(
            1, 1, s_cache, jc.n_kv_heads, jc.head_dim, "int8",
            window=window))
        outs = []
        for p in range(12):
            o, cache = jL.attention_apply(
                jlp, jnp.asarray(x[:, p:p + 1]), jc8, kv_cache=cache,
                cache_pos=jnp.int32(p), quant=jc.quant, window=WINDOW)
            outs.append(np.asarray(o))
        return np.concatenate(outs, 1)

    rolling, full = decode(32, WINDOW), decode(32, None)
    diff = np.abs(rolling - full).max(axis=(0, 2))
    assert (diff[:WINDOW] == 0).all(), diff
    assert diff[WINDOW:].max() > 1e-2, diff
    with pytest.raises(ValueError, match="int8 KV cache cannot be a rolling"):
        tkv.attn_cache(1, 1, 32, tc.n_kv_heads, tc.head_dim, "int8",
                       window=WINDOW)
    with pytest.raises(ValueError, match="int8 KV cache cannot be a rolling"):
        tapi.init_cache(tc.replace(kv_cache_dtype="int8"), 1, 32,
                        window=WINDOW, device="cpu")
    cache = tuple(leaf[0] for leaf in tkv.attn_cache(
        1, 1, WINDOW, tc.n_kv_heads, tc.head_dim, "int8"))
    with pytest.raises(ValueError, match="does not roll"):
        tL.attention_apply(tlp, torch.from_numpy(x[:, :1]), tc,
                           kv_cache=cache, cache_pos=WINDOW, quant=tc.quant,
                           window=WINDOW)


def test_per_slot_window_is_refused_where_the_reference_ignores_it():
    """The reference's per-slot branch (cache_pos [B]) never reads the
    window: its windowed per-slot step equals its unwindowed one, and
    leaves its own scalar-offset windowed step. The port raises."""
    jc, jlp, tc, tlp = _layer()
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, 13, jc.d_model)).astype(np.float32)
    cache = tuple(leaf[0] for leaf in jkv.attn_cache(
        1, 1, 32, jc.n_kv_heads, jc.head_dim, jnp.float32))
    _, cache = jL.attention_apply(jlp, jnp.asarray(x[:, :12]), jc,
                                  kv_cache=cache, cache_pos=jnp.int32(0),
                                  quant=jc.quant)
    step = lambda pos, **kw: np.asarray(jL.attention_apply(
        jlp, jnp.asarray(x[:, 12:]), jc, kv_cache=cache, cache_pos=pos,
        quant=jc.quant, **kw)[0])
    per_slot = step(jnp.array([12]), window=4)
    np.testing.assert_array_equal(per_slot, step(jnp.array([12])))
    assert np.abs(per_slot - step(jnp.int32(12), window=4)).max() > 1e-2
    tcache = tuple(leaf[0] for leaf in tkv.attn_cache(
        1, 1, 32, tc.n_kv_heads, tc.head_dim, torch.float32))
    with pytest.raises(ValueError, match="per-slot"):
        tL.attention_apply(tlp, torch.from_numpy(x[:, 12:]), tc,
                           kv_cache=tcache,
                           cache_pos=torch.tensor([12]), quant=tc.quant,
                           window=4)
