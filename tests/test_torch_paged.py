"""Port parity, block-paged KV cache: the pool helpers and the block pool
against the reference's on the same inputs, and the port's paged engine
against its own dense engine on reduced tinyllama-1.1b (CPU).

Paged == dense is bit-exact: the gathered view is exactly max_seq long and
the masked positions get exactly zero weight, so the paged engine runs the
dense engine's arithmetic on the same values (per_row tables, the kernels'
plain versions, the same prefill chunk boundaries).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.models import kvcache as jkv
from repro.serving import blockpool as jbp
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models import kvcache as tkv
from repro_torch.models.layers import attention_apply
from repro_torch.serving import blockpool as tbp
from repro_torch.serving.engine import Request, ServingEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# pool views against the reference
# ---------------------------------------------------------------------------

def _scatter_both(pool, table, pos, vals):
    want = np.asarray(jkv.paged_scatter(jnp.asarray(pool), jnp.asarray(vals),
                                        jnp.asarray(table, jnp.int32),
                                        jnp.asarray(pos, jnp.int32)))
    got = torch.from_numpy(pool.copy())
    out = tkv.paged_scatter(got, torch.from_numpy(vals),
                            torch.from_numpy(table).long(),
                            torch.from_numpy(pos).long())
    assert out is got  # written in place
    return got.numpy(), want


def test_paged_scatter_gather_match_reference():
    """Writes through an arbitrary block permutation land where the
    reference puts them, and the gathered views are equal."""
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(7, 4, 3)).astype(np.float32)
    table = np.array([[5, 2, 6], [1, 4, 3]], np.int64)  # [B=2, nb=3]
    pos = np.array([[0, 5, 11], [3, 4, 10]], np.int64)
    vals = rng.normal(size=(2, 3, 3)).astype(np.float32)
    got, want = _scatter_both(pool, table, pos, vals)
    np.testing.assert_array_equal(got, want)
    view = tkv.paged_gather(torch.from_numpy(got),
                            torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(
        view, np.asarray(jkv.paged_gather(jnp.asarray(want),
                                          jnp.asarray(table, jnp.int32))))
    assert view.shape == (2, 12, 3)
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(view[i, pos[i, j]], vals[i, j])


def test_paged_scatter_out_of_reach_goes_to_null_block():
    """Positions past the table's reach land in block 0, never clamped
    onto the last real block, exactly as in the reference."""
    pool = np.zeros((4, 2, 1), np.float32)
    table = np.array([[3, 2]], np.int64)             # reach = 4 positions
    pos = np.array([[1, 4, 7]], np.int64)            # 4 and 7 are past it
    got, want = _scatter_both(pool, table, pos, np.ones((1, 3, 1), np.float32))
    np.testing.assert_array_equal(got, want)
    assert got[3, 1, 0] == 1.0 and not got[2].any() and got[0].any()


def test_null_rows_gather_the_null_block():
    pool = np.arange(6, dtype=np.float32).reshape(3, 2, 1)
    table = np.zeros((1, 3), np.int64)
    view = tkv.paged_gather(torch.from_numpy(pool), torch.from_numpy(table))
    np.testing.assert_array_equal(
        view.numpy(), np.asarray(jkv.paged_gather(
            jnp.asarray(pool), jnp.asarray(table, jnp.int32))))


# ---------------------------------------------------------------------------
# block pool against the reference
# ---------------------------------------------------------------------------

def _pool_trace(bp):
    """One fixed sequence of allocator and prefix-cache calls; returns
    everything observable along the way."""
    alloc = bp.BlockAllocator(8)
    cache = bp.PrefixCache(alloc)
    k = [bp.chain_key(np.arange(n)) for n in (4, 8, 12, 16)]
    out = [alloc.alloc(3), alloc.alloc(5), alloc.alloc(2)]
    a, b = out[0], out[2]
    cache.put(k[0], a[0])
    cache.put(k[1], a[1])
    cache.put(k[1], a[1])                  # refresh, no second ref
    out.append(cache.get(k[0]))            # hit: k[0] becomes most recent
    out.append(cache.get(k[2]))            # miss
    alloc.incref(a[0])
    for bid in a + b:
        alloc.decref(bid)
    alloc.decref(a[0])
    out.append((alloc.num_free, alloc.num_used, dict(alloc.refs)))
    cache.put(k[3], alloc.alloc(1)[0])
    out.append(cache.evict_until(alloc.num_free + 2))  # drops k[1], k[0]
    out.append(alloc.alloc(4))
    out.append((alloc.num_free, alloc.num_used, dict(alloc.refs), len(cache),
                cache.hits, cache.misses, cache.evictions))
    alloc.decref(0)                        # the null block is never counted
    with pytest.raises(KeyError):
        alloc.decref(99)
    return out


def test_blockpool_matches_reference():
    assert _pool_trace(tbp) == _pool_trace(jbp)
    with pytest.raises(ValueError):
        tbp.BlockAllocator(1)
    for toks in ([], [3], list(range(40)), np.arange(7, dtype=np.int64)):
        assert tbp.chain_key(toks) == jbp.chain_key(toks)
    assert tbp.NULL_BLOCK == jbp.NULL_BLOCK == 0


# ---------------------------------------------------------------------------
# paged == dense inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tl():
    cfg = treg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode="lut_pallas",
                                                   table_quant="per_row")
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, tapi.init_params(gen, cfg, "cpu")


def _run(tl, prompts, n_new, *, temperature=0.0, seed=0, **kw):
    cfg, params = tl
    kw = {"max_batch": 2, "max_seq": 64, "prefill_chunk": 4, **kw}
    eng = ServingEngine(cfg, params, seed=seed, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n,
                    temperature=temperature, top_k=5 if temperature else 0)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return eng, [r.output for r in reqs]


def _ragged(seed, plens=(5, 8, 11, 3, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, p) for p in plens]


@pytest.mark.parametrize("decode_chunk", [1, 8])
def test_paged_matches_dense_greedy(tl, decode_chunk):
    """5 ragged requests over 2 slots (retire and refill mid-stream)."""
    prompts, n_new = _ragged(0), [4, 6, 3, 5, 4]
    _, dense = _run(tl, prompts, n_new, decode_chunk=decode_chunk)
    eng, paged = _run(tl, prompts, n_new, decode_chunk=decode_chunk,
                      cache_block_size=8)
    assert paged == dense
    st = eng.stats()
    assert st["paged"] and st["blocks_in_use"] == 0


def test_paged_matches_dense_sampled(tl):
    """The same generator seed and admission order give the same sampled
    streams: sampling consumes logits that must match exactly."""
    prompts, n_new = _ragged(1), [4, 6, 3, 5, 4]
    kw = dict(decode_chunk=8, temperature=1.3, seed=11)
    _, dense = _run(tl, prompts, n_new, **kw)
    _, paged = _run(tl, prompts, n_new, cache_block_size=8, **kw)
    assert paged == dense


def test_prefix_fanout_skips_prefill_and_stays_exact(tl):
    """A 32-token system prompt (4 blocks) fanned out over 6 requests with
    distinct 1-token suffixes: followers share its blocks by reference."""
    sys_p = np.random.default_rng(4).integers(0, 512, 32)
    prompts = [np.concatenate([sys_p, [i]]) for i in range(6)]
    e0, base = _run(tl, prompts, [4] * 6, cache_block_size=8)
    e1, shared = _run(tl, prompts, [4] * 6, cache_block_size=8,
                      prefix_cache=True)
    assert shared == base
    s0, s1 = e0.stats(), e1.stats()
    assert s1["prefill_dispatches"] < s0["prefill_dispatches"] / 2
    assert s1["prefill_tokens_reused"] == 5 * 32  # followers skip 32 each
    assert s1["prefix_cache"]["hits"] > 0
    assert s1["blocks_in_use"] == s1["prefix_cache"]["entries"]


def test_prefix_cow_identical_prompts(tl):
    """Identical prompts of an exact block multiple: the block ending at
    plen is copied on write, and the outputs still equal dense."""
    p = np.random.default_rng(5).integers(0, 512, 32)  # 4 blocks of 8
    prompts = [p.copy() for _ in range(4)]
    _, dense = _run(tl, prompts, [4] * 4)
    eng, cow = _run(tl, prompts, [4] * 4, cache_block_size=8,
                    prefix_cache=True)
    assert cow == dense
    st = eng.stats()
    assert st["prefix_cache"]["hits"] > 0
    assert st["prefill_tokens_reused"] == 3 * 31  # no prefill after the 1st


def test_blocked_admission_defers_then_completes(tl):
    """A pool that holds one reservation at a time serializes admission
    through blocked attempts; every request completes, equal to dense."""
    prompts = _ragged(6, (20, 20, 20))
    # need = ceil((20 + 40) / 8) = 8 blocks = the whole usable pool
    eng, out = _run(tl, prompts, [40] * 3, decode_chunk=4,
                    cache_block_size=8, num_cache_blocks=9)
    assert all(len(o) == 40 for o in out)
    st = eng.stats()
    assert st["admit_blocked"] > 0 and st["admission_blocked_rate"] > 0
    assert st["blocks_in_use"] == 0
    _, dense = _run(tl, prompts, [40] * 3, decode_chunk=4)
    assert out == dense


def test_infeasible_reservation_raises(tl):
    cfg, params = tl
    with pytest.raises(ValueError, match="cache_block_size"):
        ServingEngine(cfg, params, max_batch=2, max_seq=64,
                      cache_block_size=7)  # does not divide max_seq
    with pytest.raises(ValueError, match="num_cache_blocks"):
        ServingEngine(cfg, params, max_batch=2, max_seq=64,
                      cache_block_size=8, num_cache_blocks=4)
    # a zero-budget request gives its reservation back at admission
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=16,
                        cache_block_size=8, num_cache_blocks=3)
    eng.submit(Request(uid=0, prompt=np.arange(15), max_new_tokens=0))
    eng.run_to_completion()
    assert eng.stats()["blocks_in_use"] == 0
    # with 2 of 4 usable blocks held and no live slot to free more, a
    # 4-block reservation can never be granted
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=32,
                        cache_block_size=8, num_cache_blocks=5)
    eng._alloc.alloc(2)
    eng.submit(Request(uid=1, prompt=np.arange(20), max_new_tokens=10))
    with pytest.raises(RuntimeError, match="more cache blocks"):
        eng.run_to_completion()


def test_window_is_refused_on_the_paged_path(tl):
    cfg, params = tl
    lp = params["layers"][0]["attn"]
    pool = tkv.attn_cache(1, 3, 8, cfg.n_kv_heads, cfg.head_dim,
                          dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        attention_apply(lp, torch.zeros(1, 1, cfg.d_model), cfg,
                        kv_cache=(pool[0][0], pool[1][0]),
                        cache_pos=torch.zeros(1, dtype=torch.int64),
                        page_table=torch.zeros(1, 2, dtype=torch.int64),
                        window=4)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_serve_paged_with_prefix_cache_on_cpu(capsys):
    assert serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                       "--max-new", "3", "--max-seq", "32",
                       "--mode", "lut_pallas", "--cache-block-size", "16",
                       "--prefix-cache"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out
    assert "paged cache: 9 blocks of 16" in out
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--prefix-cache"])
