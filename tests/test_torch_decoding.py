"""Port parity, decoding modes: beam search and bit-plane self-speculation
in the port's engine (CPU), tests/test_decoding.py's contracts run inside
the port, and the port against the reference on the same inputs.

Reduced tinyllama-1.1b, W4 symmetric, packed weights, float LM head
(``skip="lm_head"``), lut_xla with float tables (``table_quant`` auto on
the CPU), as in tests/test_decoding.py; the port loads the reference's
packed weights (``from_jax_params``). Inside the port greedy speculation
and width-1 beams give plain greedy decoding's tokens exactly. Against the
reference engine (float tables, so logits agree to f32 rounding): tokens
equal, beam scores within 1e-4 relative. The step functions, fed the same
numpy inputs: parents and tokens equal, scores within 1e-6.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.serving import decoding as jdec
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.core import quantize as Q
from repro_torch.core import reinterpret
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import kvcache, layers
from repro_torch.models.convert import from_jax_params
from repro_torch.models.quantized import extra_hbm_bytes, plane_sliced_params
from repro_torch.serving import blockpool, decoding
from repro_torch.serving.engine import Request, ServingEngine

from test_torch_serving import _one_torch_thread  # noqa: F401 (autouse)


def _quant(cfg):
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


def _run(tc, params, prompts, n_new, *, decoding_str="greedy",
         engine_kw=None, req_kw=None):
    kw = dict(max_batch=2, max_seq=64, decode_chunk=4, prefill_chunk=4)
    kw.update(engine_kw or {})
    eng = ServingEngine(tc, params, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new,
                    decoding=decoding_str, **(req_kw or {}))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return eng, reqs


def _one_sync_per_chunk(eng):
    st = eng.stats()
    return st["host_syncs_per_token"] <= 1 / eng.decode_chunk


# ---------------------------------------------------------------------------
# self-speculation inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft_planes", [1, 2, 4])
def test_spec_greedy_equals_greedy_dense(tl, draft_planes):
    """Greedy spec == plain greedy, token for token, for sliced drafts and
    for the draft that keeps every plane (the target itself)."""
    _, _, tc, params = tl
    prompts = _prompts(tc.vocab_size, 3)
    _, g = _run(tc, params, prompts, 10)
    eng, s = _run(tc, params, prompts, 10,
                  decoding_str=f"spec:draft{draft_planes}b",
                  engine_kw=dict(spec_k=4, spec_draft_planes=draft_planes))
    for a, b in zip(g, s):
        assert b.done and b.output == a.output
        assert b.spec_stats["verify_steps"] > 0
        assert b.spec_stats["accepted_draft_tokens"] >= 0
    assert _one_sync_per_chunk(eng)


def test_spec_greedy_equals_greedy_paged(tl):
    _, _, tc, params = tl
    prompts = _prompts(tc.vocab_size, 3, seed=1)
    paged = dict(cache_block_size=8, num_cache_blocks=17)
    _, g = _run(tc, params, prompts, 8, engine_kw=paged)
    _, s = _run(tc, params, prompts, 8, decoding_str="spec:draft2b",
                engine_kw=dict(paged, spec_k=3, spec_draft_planes=2))
    assert [r.output for r in s] == [r.output for r in g]


def test_spec_all_planes_accepts_every_draft(tl):
    """Draft == target: every draft is accepted, so a verify round emits
    K + 1 tokens until the budget clips the last one."""
    _, _, tc, params = tl
    eng, _ = _run(tc, params, _prompts(tc.vocab_size, 2), 10,
                  decoding_str="spec:draft4b",
                  engine_kw=dict(spec_k=4, spec_draft_planes=4))
    sp = eng.stats()["spec"]
    assert sp["mean_accepted_per_step"] >= 3.0
    assert sp["mean_emitted_per_step"] == pytest.approx(
        sp["mean_accepted_per_step"] + 1.0)
    assert sp["draft_extra_hbm_bytes"] == 0


def test_spec_stochastic_stays_within_its_counts(tl):
    _, _, tc, params = tl
    eng, reqs = _run(tc, params, _prompts(tc.vocab_size, 2, seed=3), 12,
                     decoding_str="spec:draft2b",
                     engine_kw=dict(spec_k=4, spec_draft_planes=2),
                     req_kw=dict(temperature=0.9, top_k=40, top_p=0.95))
    for r in reqs:
        assert r.done and len(r.output) == 12
        assert all(0 <= t < tc.vocab_size for t in r.output)
        vs, at = (r.spec_stats["verify_steps"],
                  r.spec_stats["accepted_draft_tokens"])
        assert vs > 0 and 0 <= at <= 4 * vs
    assert _one_sync_per_chunk(eng)


# ---------------------------------------------------------------------------
# beam search inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_beam_width1_equals_greedy(tl, paged):
    _, _, tc, params = tl
    prompts = _prompts(tc.vocab_size, 2, seed=2)
    kw = dict(cache_block_size=8, num_cache_blocks=17) if paged else {}
    _, g = _run(tc, params, prompts, 8, engine_kw=kw)
    _, b = _run(tc, params, prompts, 8, decoding_str="beam:1", engine_kw=kw)
    for a, r in zip(g, b):
        assert r.done and r.output == a.output
        assert len(r.beams) == 1 and r.beams[0][0] == a.output


@pytest.mark.parametrize("paged", [False, True])
def test_beam_hypotheses_ranked(tl, paged):
    _, _, tc, params = tl
    kw = dict(max_batch=3)
    if paged:
        kw.update(cache_block_size=8, num_cache_blocks=25)
    eng, (r,) = _run(tc, params, _prompts(tc.vocab_size, 1, seed=4), 8,
                     decoding_str="beam:3", engine_kw=kw)
    assert r.done and len(r.beams) == 3
    scores = [sc for _, sc in r.beams]
    assert scores == sorted(scores, reverse=True)
    assert r.output == r.beams[0][0]
    assert all(len(t) <= 8 for t, _ in r.beams)
    assert len({tuple(t) for t, _ in r.beams}) > 1
    assert _one_sync_per_chunk(eng)


def test_paged_beam_forks_share_prefix_blocks(tl):
    """Members share the prompt blocks below plen - 1 by reference and own
    disjoint blocks from the divergence block on; the group's retirement
    gives every block back."""
    _, _, tc, params = tl
    bs = 4
    eng = ServingEngine(tc, params, max_batch=3, max_seq=64, decode_chunk=4,
                        prefill_chunk=4, cache_block_size=bs,
                        num_cache_blocks=49)
    plen = 9
    req = Request(uid=0, prompt=np.arange(plen) % tc.vocab_size,
                  max_new_tokens=6, decoding="beam:3")
    eng.submit(req)
    eng._admit()
    (group,) = eng._beam_groups.values()
    rows = [eng._slot_blocks[i] for i in group["slots"]]
    m_share = (plen - 1) // bs
    for row in rows[1:]:
        assert row[:m_share] == rows[0][:m_share]
    for bid in rows[0][:m_share]:
        assert eng._alloc.refs[bid] == len(rows)
    tails = [set(row[m_share:]) for row in rows]
    for i in range(len(tails)):
        for j in range(i + 1, len(tails)):
            assert not tails[i] & tails[j]
    eng.run_to_completion()
    assert req.done and len(req.beams) == 3
    assert eng._alloc.num_used == 0


def test_mixed_pool_gives_each_request_its_own_modes_tokens(tl):
    """normal + beam:2 + spec slots in one decode loop: each request gets
    the tokens a pool of its own mode gives it."""
    _, _, tc, params = tl
    prompts = _prompts(tc.vocab_size, 3, seed=5)
    eng = ServingEngine(tc, params, max_batch=4, max_seq=64, decode_chunk=4,
                        prefill_chunk=4, spec_k=3, spec_draft_planes=2)
    reqs = [Request(uid=0, prompt=prompts[0], max_new_tokens=8),
            Request(uid=1, prompt=prompts[1], max_new_tokens=8,
                    decoding="beam:2"),
            Request(uid=2, prompt=prompts[2], max_new_tokens=8,
                    decoding="spec:draft2b")]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    _, (solo_n,) = _run(tc, params, [prompts[0]], 8)
    _, (solo_b,) = _run(tc, params, [prompts[1]], 8, decoding_str="beam:2")
    _, (solo_s,) = _run(tc, params, [prompts[2]], 8,
                        decoding_str="spec:draft2b",
                        engine_kw=dict(max_batch=1, spec_k=3,
                                       spec_draft_planes=2))
    assert reqs[0].output == solo_n.output
    assert reqs[1].output == solo_b.output
    assert [t for t, _ in reqs[1].beams] == [t for t, _ in solo_b.beams]
    assert reqs[2].output == solo_s.output
    assert _one_sync_per_chunk(eng)


def test_engine_matches_reference_engine(tl):
    """One pool holding a greedy spec request and a beam:2 request, through
    both engines on the same packed weights: the spec stream and every
    hypothesis equal, scores within 1e-4 relative."""
    jc, jparams, tc, params = tl
    prompts = _prompts(tc.vocab_size, 2, seed=8)
    ekw = dict(max_batch=3, max_seq=64, decode_chunk=4, prefill_chunk=4,
               spec_k=3, spec_draft_planes=2)
    out = []
    for eng_cls, req_cls, p in ((JEngine, JRequest, jparams),
                                (ServingEngine, Request, params)):
        eng = eng_cls(jc if eng_cls is JEngine else tc, p, **ekw)
        reqs = [req_cls(uid=0, prompt=prompts[0].astype(np.int32),
                        max_new_tokens=8, decoding="spec:draft2b"),
                req_cls(uid=1, prompt=prompts[1].astype(np.int32),
                        max_new_tokens=8, decoding="beam:2")]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out.append(reqs)
    (jspec, jbeam), (tspec, tbeam) = out
    assert tspec.output == [int(t) for t in jspec.output]
    assert [t for t, _ in tbeam.beams] == [[int(x) for x in t]
                                          for t, _ in jbeam.beams]
    np.testing.assert_allclose([sc for _, sc in tbeam.beams],
                               [sc for _, sc in jbeam.beams], rtol=1e-4)


def test_stats_are_finite(tl):
    _, _, tc, params = tl

    def finite(obj):
        if isinstance(obj, dict):
            return all(finite(v) for v in obj.values())
        if isinstance(obj, (int, float)) and not isinstance(obj, bool):
            return bool(np.isfinite(obj))
        return True

    fresh = ServingEngine(tc, params, max_batch=2, max_seq=64,
                          cache_block_size=8, num_cache_blocks=17,
                          spec_draft_planes=2)
    assert finite(fresh.stats()) and fresh.stats()["spec"]["verify_steps"] == 0
    eng, _ = _run(tc, params, _prompts(tc.vocab_size, 2, seed=6), 6,
                  decoding_str="spec:draft2b",
                  engine_kw=dict(spec_k=2, spec_draft_planes=2))
    assert finite(eng.stats())
    eng, _ = _run(tc, params, _prompts(tc.vocab_size, 1, seed=7), 6,
                  decoding_str="beam:2")
    assert finite(eng.stats())


def test_submit_refuses_what_the_pool_cannot_serve(tl):
    _, _, tc, params = tl
    eng = ServingEngine(tc, params, max_batch=2, max_seq=64)
    for bad in ("spec:draft2b", "beam:3", "wat"):
        with pytest.raises(ValueError):
            eng.submit(Request(uid=0, prompt=np.arange(4), decoding=bad))


# ---------------------------------------------------------------------------
# registry and plane-sliced views
# ---------------------------------------------------------------------------

def test_decoding_parse_matches_reference():
    for spec in ("greedy", "sample", "beam", "beam:2", "spec",
                 "spec:draft1b", "spec:3", " Beam:5 "):
        got, want = decoding.parse(spec), jdec.parse(spec)
        assert (got.kind, got.name, got.beam_width, got.draft_planes) == (
            want.kind, want.name, want.beam_width, want.draft_planes)
    for bad in ("beam:0", "spec:0b", "greedy:x", "wat", "spec:draftb"):
        with pytest.raises(ValueError):
            decoding.parse(bad)


def test_plane_slice_dequantizes_to_its_top_planes():
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(8, 16)).astype(np.float32))
    qw = Q.quantize(w, 4, k_group=4)
    sign, idx = qw.sign_idx()
    planes = reinterpret.unfold_group_codes(sign, idx, qw.k_group)
    sigma = 2.0 * planes.to(torch.float64) - 1.0          # [N, K, 4]
    ps = torch.tensor(qw.plane_scales, dtype=torch.float64)
    for keep in (1, 2, 3):
        view = qw.plane_slice(keep)
        assert view.plane_scales == qw.plane_scales[4 - keep:]
        assert view.packed is qw.packed and view.scale is qw.scale
        want = qw.scale.double()[:, None] * (sigma[..., 4 - keep:]
                                             @ ps[4 - keep:])
        np.testing.assert_allclose(Q.dequantize(view).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6)
        # the dropped planes bound the truncation error
        bound = float(sum(qw.plane_scales[:4 - keep]))
        err = (Q.dequantize(qw) - Q.dequantize(view)).abs()
        assert (err <= qw.scale[:, None] * bound + 1e-5).all()
    assert qw.plane_slice(4) is qw
    with pytest.raises(ValueError):
        qw.plane_slice(0)


def test_plane_sliced_params_cost_no_extra_bytes(tl):
    _, _, _, params = tl
    draft = plane_sliced_params(params, 2)
    assert extra_hbm_bytes(draft, params) == 0
    views = [lp[blk][name]["qw"] for lp in draft["layers"]
             for blk in ("attn", "mlp") for name in lp[blk]]
    assert views and all(v.num_planes == 2 and v.is_plane_sliced
                         for v in views)
    assert draft["lm_head"]["w"] is params["lm_head"]["w"]  # float head
    # a copied buffer counts
    copy = dict(draft, final_norm={"g": params["final_norm"]["g"].clone()})
    assert extra_hbm_bytes(copy, params) == 4 * tl[2].d_model


def test_kernel_wrappers_refuse_sliced_views():
    """The kernels stride the packed stream by num_planes fields a group: a
    sliced view would decode the wrong bytes, so they refuse it, as the
    reference's kernels do."""
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(16, 32)).astype(np.float32))
    view = Q.quantize(w, 4, k_group=4).plane_slice(2)
    x = torch.ones(2, 32)
    for fn in (ops.lut_mpgemm, ops.fused_lut_mpgemm, ops.dequant_mpgemm):
        with pytest.raises(NotImplementedError):
            fn(x, view)


# ---------------------------------------------------------------------------
# the step functions against the reference's
# ---------------------------------------------------------------------------

def test_beam_select_matches_reference():
    """Same inputs, ties included: new members' scores are NEG, so NEG +
    logp rounds to NEG for every candidate, and logp sits on a coarse grid
    so equal candidates compete."""
    rng = np.random.default_rng(0)
    b, v = 7, 12
    logp = (np.round(rng.normal(size=(b, v)) * 4) / 4).astype(np.float32)
    logp -= 3.0
    cum = np.array([0.0, jdec._NEG, jdec._NEG, -2.5, -2.5, -1.0, 0.0],
                   np.float32)
    live = np.array([1, 1, 1, 1, 1, 0, 1], bool)
    group = np.array([0, 0, 0, 3, 3, -1, -1], np.int32)
    want = [np.asarray(t) for t in jdec.beam_select(
        jnp.asarray(cum), jnp.asarray(logp), jnp.asarray(live),
        jnp.asarray(group))]
    got = [t.numpy() for t in decoding.beam_select(
        torch.from_numpy(cum), torch.from_numpy(logp),
        torch.from_numpy(live), torch.from_numpy(group).long())]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)


def test_stable_topk_puts_the_lower_index_first_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e30, 3.0, -1e30]])
    vals, idx = decoding.stable_topk(x, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]
    assert torch.equal(vals, x[:, [1, 2, 4, 0, 3]])


def test_speculative_accept_matches_reference_on_greedy_rows():
    rng = np.random.default_rng(1)
    b, k, v = 5, 3, 9
    p = rng.normal(size=(b, k + 1, v)).astype(np.float32)
    q = rng.normal(size=(b, k, v)).astype(np.float32)
    tgt = p.argmax(-1).astype(np.int32)
    draft = np.where(rng.random((b, k)) < 0.6, tgt[:, :k],
                     rng.integers(0, v, (b, k))).astype(np.int32)
    for greedy in (np.ones(b, bool), np.array([1, 0, 1, 0, 1], bool)):
        want = [np.asarray(t) for t in jdec.speculative_accept(
            jax.random.key(0), jnp.asarray(draft), jnp.asarray(q),
            jnp.asarray(p), jnp.asarray(tgt), jnp.asarray(greedy))]
        gen = torch.Generator()
        gen.manual_seed(0)
        got = [t.numpy() for t in decoding.speculative_accept(
            gen, torch.from_numpy(draft).long(), torch.from_numpy(q),
            torch.from_numpy(p), torch.from_numpy(tgt).long(),
            torch.from_numpy(greedy), sampling=not greedy.all())]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[greedy], w[greedy])


def test_rank_hypotheses_matches_reference():
    scores, lengths = [-3.0, -2.5, -7.25, -1.0], [4, 1, 9, 0]
    for alpha in (0.0, 0.6, 1.0):
        np.testing.assert_allclose(
            decoding.rank_hypotheses(scores, lengths, alpha),
            jdec.rank_hypotheses(scores, lengths, alpha), rtol=1e-12)


def test_speculative_accept_emits_the_target_distribution():
    """The first emitted token of a sampling row (the draft if accepted,
    else the residual draw) is distributed as softmax(p): 20000 rows with
    V = 8, each frequency within 4 standard errors."""
    n, k, v = 20000, 2, 8
    gen = torch.Generator()
    gen.manual_seed(3)
    p_row = torch.tensor([1.2, -0.3, 0.4, 2.0, -1.5, 0.0, 0.9, -0.7])
    q_row = torch.tensor([0.1, 1.1, -0.2, 1.4, 0.3, -1.0, 0.0, 0.6])
    p = p_row.expand(n, k + 1, v).contiguous()
    q = q_row.expand(n, k, v).contiguous()
    draft = torch.multinomial(torch.softmax(q_row, 0), n * k,
                              replacement=True, generator=gen).view(n, k)
    accept, repl, _ = decoding.speculative_accept(
        gen, draft, q, p, p.argmax(-1), torch.zeros(n, dtype=torch.bool),
        sampling=True)
    first = torch.where(accept[:, 0], draft[:, 0], repl[:, 0])
    freq = torch.bincount(first, minlength=v).double() / n
    want = torch.softmax(p_row.double(), 0)
    sigma = (want * (1 - want) / n).sqrt()
    assert ((freq - want).abs() <= 4 * sigma).all(), (freq, want)


# ---------------------------------------------------------------------------
# the verify burst at the end of the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_burst_near_max_seq_writes_nothing_out_of_range(tl, paged):
    """An s = 5 burst at positions [S-2, S-5] of an S = 16 cache: the
    positions before each slot's start keep their values, the in-range
    positions get what a cache with room for the whole burst gets, and
    nothing past the cache is written (paged: to the null block only)."""
    _, _, tc, params = tl
    lp = params["layers"][0]
    s_cache, s, b = 16, 5, 2
    gen = torch.Generator()
    gen.manual_seed(0)
    x = torch.randn(b, s, tc.d_model, generator=gen)
    cp = torch.tensor([s_cache - 2, s_cache - 5])
    big = tapi.init_cache(tc, b, s_cache + 8, dtype=torch.float32,
                          device="cpu")
    for leaf in big:
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    big_cache = (big[0][0], big[1][0])
    before = [leaf[:, :s_cache].clone() for leaf in big_cache]
    want, _ = layers.attention_apply(lp["attn"], x, tc, kv_cache=big_cache,
                                     cache_pos=cp, quant=tc.quant)
    if paged:
        bs, nb = 4, s_cache // 4
        pool = [torch.zeros((1 + b * nb, bs) + leaf.shape[2:])
                for leaf in before]
        table = 1 + torch.arange(b * nb).view(b, nb)
        for leaf, dense in zip(pool, before):
            leaf[table.reshape(-1)] = dense.reshape((b * nb, bs)
                                                    + dense.shape[2:])
        got, _ = layers.attention_apply(lp["attn"], x, tc,
                                        kv_cache=tuple(pool), cache_pos=cp,
                                        quant=tc.quant, page_table=table)
        after = [kvcache.paged_gather(leaf, table) for leaf in pool]
    else:
        small = tuple(leaf.clone() for leaf in before)
        got, _ = layers.attention_apply(lp["attn"], x, tc, kv_cache=small,
                                        cache_pos=cp, quant=tc.quant)
        after = list(small)
    for a, bef, full in zip(after, before, big_cache):
        for i in range(b):
            c = int(cp[i])
            assert torch.equal(a[i, :c], bef[i, :c])           # live prefix
            assert torch.equal(a[i, c:], full[i, c:s_cache])   # the burst
    # queries whose positions fit read exactly what the big cache's read
    for i in range(b):
        fit = s_cache - int(cp[i])
        torch.testing.assert_close(got[i, :fit], want[i, :fit], rtol=1e-6,
                                   atol=1e-6)


def test_spec_request_at_the_cache_end_equals_greedy(tl):
    """plen + max_new_tokens = max_seq: the last rounds draft past the
    cache, and the slot retires at max_seq - 1 while a longer spec request
    keeps drafting over it; a third spec request follows on the same
    engine. Every stream is plain greedy's."""
    _, _, tc, params = tl
    max_seq = 32
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tc.vocab_size, n) for n in (22, 5, 7)]
    n_new = [max_seq - 22, 20, 12]
    want = []
    for p, n in zip(prompts, n_new):
        _, (g,) = _run(tc, params, [p], n, engine_kw=dict(max_seq=max_seq))
        want.append(g.output)
    eng = ServingEngine(tc, params, max_batch=2, max_seq=max_seq,
                        decode_chunk=4, prefill_chunk=4, spec_k=4,
                        spec_draft_planes=2)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n,
                    decoding="spec:draft2b")
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    for r in reqs[:2]:
        eng.submit(r)
    eng.run_to_completion()
    assert int(eng.pos[0]) == max_seq - 1
    eng.submit(reqs[2])
    eng.run_to_completion()
    assert [r.output for r in reqs] == want
    assert len(reqs[0].output) == max_seq - 22
    assert _one_sync_per_chunk(eng)


def test_paged_beam_rollback_leaves_no_unwritten_block_shared(tl):
    """A beam:2 request whose member cannot get blocks rolls its leader
    back after the leader registered its divergence block (position
    plen - 1 still unwritten) in the prefix cache. The failed allocation
    evicted every entry, so a later prompt that extends this one reuses
    only written blocks and decodes as the dense engine does."""
    _, _, tc, params = tl
    bs, max_seq = 8, 64
    rng = np.random.default_rng(11)
    blocker = Request(uid=0, prompt=rng.integers(0, tc.vocab_size, 20),
                      max_new_tokens=20)
    beam_prompt = rng.integers(0, tc.vocab_size, 2 * bs)  # ends a block
    longer = np.concatenate([beam_prompt,
                             rng.integers(0, tc.vocab_size, 12)])
    kw = dict(max_batch=3, max_seq=max_seq, decode_chunk=4, prefill_chunk=4)
    # 9 usable blocks: the blocker holds 5, the leader takes 3, the member's
    # 2 private blocks do not fit
    eng = ServingEngine(tc, params, cache_block_size=bs, num_cache_blocks=10,
                        prefix_cache=True, **kw)
    beam = Request(uid=1, prompt=beam_prompt, max_new_tokens=4,
                   decoding="beam:2")
    eng.submit(blocker)
    eng.submit(beam)
    eng.step()
    assert eng.admit_blocked == 1 and not beam.done
    assert eng._prefix.get(blockpool.chain_key(beam_prompt)) is None
    eng.run_to_completion()
    assert blocker.done and beam.done and len(beam.beams) == 2
    follow = Request(uid=2, prompt=longer, max_new_tokens=8)
    eng.submit(follow)
    eng.run_to_completion()
    assert eng.prefill_tokens_reused >= 2 * bs
    dense = ServingEngine(tc, params, **kw)
    want = [Request(uid=i, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    decoding=r.decoding)
            for i, r in enumerate((blocker, beam, follow))]
    for r in want:
        dense.submit(r)
    dense.run_to_completion()
    assert [r.output for r in (blocker, beam, follow)] == [
        r.output for r in want]
    assert beam.beams == want[1].beams
