"""Port parity, serving: the port's engine against the reference engine on
reduced tinyllama-1.1b (CPU), and the engine contracts inside the port.

The reference serves with mpgemm_mode lut_xla, the port with lut_pallas
(its kernels' plain versions here), both with per_row tables pinned, on the
same packed weights. Greedy streams must be equal up to the first position
where the top-2 logit margin is within MARGIN: per_row tables can move a
logit by up to ~0.07 between the packages (see test_torch_model), so a
closer race may go either way; the rest of that stream is then conditioned
on a different token and is not compared.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.serving import sampler as jsampler
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import kvcache
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import sampler as tsampler
from repro_torch.serving.engine import Request, ServingEngine

MARGIN = 0.15


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def served():
    jc = jreg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=jnp.float32).with_quant(mpgemm_mode="lut_xla",
                                                 table_quant="per_row")
    params = japi.init_params(jax.random.key(0), jc, serve_quantized=True)
    tc = treg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode="lut_pallas",
                                                   table_quant="per_row")
    return jc, params, tc, from_jax_params(jax.tree.map(np.asarray, params),
                                           tc, "cpu")


PLENS, NEW = [5, 19, 11, 3, 17], [6, 8, 3, 7, 5]


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, p) for p in PLENS]


def _serve(tc, tparams, prompts, news, **kw):
    kw = {"max_batch": 2, "max_seq": 64, "prefill_chunk": 16, **kw}
    eng = ServingEngine(tc, tparams, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, news))]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return eng, reqs


def test_greedy_streams_match_reference_engine(served):
    jc, jparams, tc, tparams = served
    prompts = _prompts()
    jeng = JEngine(jc, jparams, max_batch=2, max_seq=64, prefill_chunk=16,
                   decode_chunk=4)
    jreqs = [JRequest(uid=i, prompt=p.astype(np.int32), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, NEW))]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_to_completion()
    _, treqs = _serve(tc, tparams, prompts, NEW, decode_chunk=4)
    compared = 0
    for p, jr, tr in zip(prompts, jreqs, treqs):
        assert tr.done and len(tr.output) == len(jr.output)
        for j, (a, b) in enumerate(zip(tr.output, jr.output)):
            if a == b:
                compared += 1
                continue
            # a divergence is allowed only on a near tie of the top two
            seq = np.concatenate([p, jr.output[:j]])[None]
            logits = tapi.forward(tparams, {"tokens": torch.from_numpy(seq)},
                                  tc)[0][0, -1]
            top2 = torch.topk(logits, 2).values
            assert (top2[0] - top2[1]).item() <= MARGIN, (tr.uid, j)
            break
    assert compared >= sum(NEW) // 2


def test_chunked_decode_equals_per_token_decode(served):
    """decode_chunk=8 (one sync per 8 steps) == decode_chunk=1, and the
    host syncs once per chunk."""
    _, _, tc, tparams = served
    prompts = _prompts(seed=1)
    e1, r1 = _serve(tc, tparams, prompts, NEW, decode_chunk=1)
    e8, r8 = _serve(tc, tparams, prompts, NEW, decode_chunk=8)
    assert [r.output for r in r1] == [r.output for r in r8]
    assert all(len(r.output) == n for r, n in zip(r8, NEW))
    st = e8.stats()
    assert st["decode_tokens"] == sum(NEW)
    assert st["host_syncs_per_token"] <= 1 / 8 + 1 / st["decode_tokens"]
    assert e1.stats()["decode_syncs"] > st["decode_syncs"]


def test_engine_matches_sequential_greedy(served):
    """Batched, chunked serving == one request at a time through the plain
    model API with a cache."""
    _, _, tc, tparams = served
    prompt = _prompts(seed=2)[1]
    _, (req,) = _serve(tc, tparams, [prompt], [6], decode_chunk=4)
    caches = tapi.init_cache(tc, 1, 64, dtype=torch.float32, device="cpu")
    tapi.forward(tparams, {"tokens": torch.from_numpy(prompt[None, :-1])}, tc,
                 caches=caches, cache_pos=0, head=False)
    tok, pos, out = int(prompt[-1]), len(prompt) - 1, []
    for _ in range(6):
        logits, _, _ = tapi.forward(tparams, {"tokens": torch.tensor([[tok]])},
                                    tc, caches=caches,
                                    cache_pos=torch.tensor([pos]))
        tok = int(logits[0, -1].argmax())
        out.append(tok)
        pos += 1
    assert req.output == out


def test_eos_truncation_and_max_seq(served):
    _, _, tc, tparams = served
    prompts = _prompts(seed=3)
    _, (free,) = _serve(tc, tparams, prompts[:1], [6])
    eos = free.output[2]
    eng, (stopped,) = _serve(tc, tparams, prompts[:1], [6], eos_id=eos)
    assert stopped.output == free.output[:free.output.index(eos) + 1]
    # a prompt longer than max_seq keeps its last max_seq - max_new tokens
    long_prompt = np.random.default_rng(4).integers(0, 512, 80)
    _, (a,) = _serve(tc, tparams, [long_prompt], [5], max_seq=32)
    _, (b,) = _serve(tc, tparams, [long_prompt[-27:]], [5], max_seq=32)
    assert a.output == b.output and len(a.output) == 5
    # the cache caps generation: a 30-token prompt in a 32-slot cache writes
    # positions 29 and 30 only, so it yields 2 tokens
    _, (c,) = _serve(tc, tparams, [long_prompt[:30]], [10], max_seq=32)
    assert c.done and len(c.output) == 2
    # nothing to generate: done at admission
    _, (d,) = _serve(tc, tparams, [long_prompt[:4]], [0])
    assert d.done and d.output == []


def test_kvcache_slot_views_roundtrip():
    """slice_batch is a view of one slot; merge_batch writes a batch-1 cache
    into its slot and leaves the others alone."""
    caches = kvcache.attn_cache(2, 3, 8, 2, 4, dtype=torch.float32)
    slot = tuple(torch.randn_like(c[:, :1]) for c in caches)
    kvcache.merge_batch(caches, slot, 1)
    view = kvcache.slice_batch(caches, 1)
    assert all(torch.equal(v, s) for v, s in zip(view, slot))
    assert not caches[0][:, 0].any() and not caches[1][:, 2].any()
    view[0].zero_()  # a view: writes reach the pool
    assert not caches[0][:, 1].any() and kvcache.cache_len(caches) == 8


def test_mask_logits_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 50)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    top_k = np.array([0, 5, 0, 60], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.5], np.float32)
    want = np.asarray(jsampler.mask_logits(
        jnp.asarray(logits), temperature=jnp.asarray(temp),
        top_k=jnp.asarray(top_k), top_p=jnp.asarray(top_p)))
    got = tsampler.mask_logits(torch.from_numpy(logits),
                               temperature=torch.from_numpy(temp),
                               top_k=torch.from_numpy(top_k).long(),
                               top_p=torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = ~np.isinf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-6)


def test_sampling_distribution():
    """Temperature sampling draws from softmax(logits / T): 20k draws agree
    with the probabilities to within 0.015 (about 5 standard errors)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(20000, 1)
    gen = torch.Generator()
    gen.manual_seed(0)
    toks = tsampler.sample(gen, logits, temperature=torch.full((20000,), 0.8))
    freq = torch.bincount(toks, minlength=4).double() / 20000
    want = torch.softmax(logits[0].double() / 0.8, -1)
    assert (freq - want).abs().max().item() < 0.015
    greedy = tsampler.sample(gen, logits[:3], temperature=0.0)
    assert greedy.tolist() == [0, 0, 0]


class _Stop(Exception):
    pass


def _cli_requests(monkeypatch, main, engine_cls, argv):
    """The requests ``main(argv)`` submits to ``engine_cls``, the serve
    itself cut off."""
    got = []
    monkeypatch.setattr(engine_cls, "submit", lambda self, r: got.append(r))

    def stop(self, *a, **k):
        raise _Stop

    monkeypatch.setattr(engine_cls, "run_to_completion", stop)
    with pytest.raises(_Stop):
        main(argv)
    return got


def test_serve_cli_passes_top_k_and_top_p_as_the_reference(monkeypatch):
    """``launch/serve.py --top-k --top-p`` set every request's top_k and
    top_p; the port's CLI submits the reference CLI's requests (prompts,
    lengths, sampling fields) for the same arguments."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    argv = ["--reduced", "--requests", "3", "--max-new", "2",
            "--temperature", "0.8", "--top-k", "5", "--top-p", "0.9",
            "--decoding", "sample"]
    want = _cli_requests(monkeypatch, jserve.main, JEngine, argv)
    got = _cli_requests(monkeypatch, tserve.main, ServingEngine,
                        argv + ["--device", "cpu"])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.prompt),
                                      np.asarray(w.prompt))
        for f in ("uid", "max_new_tokens", "temperature", "top_k", "top_p",
                  "decoding"):
            assert getattr(g, f) == getattr(w, f), f
        assert (g.top_k, g.top_p) == (5, 0.9)
    # the defaults disable both filters, as the reference's do
    got = _cli_requests(monkeypatch, tserve.main, ServingEngine,
                        ["--reduced", "--device", "cpu", "--requests", "1"])
    assert (got[0].top_k, got[0].top_p) == (0, 1.0)
