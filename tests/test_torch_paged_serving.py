"""Port parity, paged serving: the port's block-paged engine against the
reference's on the same packed weights (reduced tinyllama-1.1b, CPU).

Admission, prefix sharing, copy-on-write, eviction and retirement depend
only on the prompts, the budgets and the pool, so every pool counter must
be equal. Greedy streams follow test_torch_serving's rule: equal up to the
first position whose top-2 logit margin is within MARGIN (per_row tables
can move a logit by up to ~0.07 between the packages).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.engine import Request, ServingEngine

from test_torch_serving import MARGIN

COUNTERS = ("admit_attempts", "admit_blocked", "prefill_tokens_reused",
            "blocks_in_use", "prefill_dispatches", "decode_tokens")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompts():
    """Three prompts sharing a 16-token (2-block) system prompt, two equal
    24-token (3-block) prompts for copy-on-write, one more sharer."""
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, 512, 16)
    share = [np.concatenate([sys_p, rng.integers(0, 512, n)])
             for n in (3, 9, 5)]
    cow = rng.integers(0, 512, 24)
    return share + [cow, cow.copy(),
                    np.concatenate([sys_p, rng.integers(0, 512, 12)])]


# the second request reserves 7 of the 8 usable blocks: later admissions
# evict prefix entries and wait for blocks
NEW = [5, 30, 6, 3, 5, 4]
ENGINE = dict(max_batch=2, max_seq=64, prefill_chunk=16, decode_chunk=4,
              cache_block_size=8, num_cache_blocks=9, prefix_cache=True)


def test_paged_engine_matches_reference_engine():
    jc = jreg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=jnp.float32).with_quant(mpgemm_mode="lut_xla",
                                                 table_quant="per_row")
    jparams = japi.init_params(jax.random.key(0), jc, serve_quantized=True)
    tc = treg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode="lut_pallas",
                                                   table_quant="per_row")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tc, "cpu")
    prompts = _prompts()

    jeng = JEngine(jc, jparams, **ENGINE)
    jreqs = [JRequest(uid=i, prompt=p.astype(np.int32), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, NEW))]
    teng = ServingEngine(tc, tparams, **ENGINE)
    treqs = [Request(uid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, NEW))]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()

    js, ts = jeng.stats(), teng.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["prefix_cache"] == js["prefix_cache"]
    # the scenario exercises what it claims to
    assert ts["admit_blocked"] > 0 and ts["prefill_tokens_reused"] > 0
    assert ts["prefix_cache"]["evictions"] > 0
    assert ts["prefix_cache"]["hits"] > 0

    compared = 0
    for p, jr, tr in zip(prompts, jreqs, treqs):
        assert tr.done and len(tr.output) == len(jr.output)
        for j, (a, b) in enumerate(zip(tr.output, jr.output)):
            if a == b:
                compared += 1
                continue
            seq = np.concatenate([p, jr.output[:j]])[None]
            logits = tapi.forward(tparams, {"tokens": torch.from_numpy(seq)},
                                  tc)[0][0, -1]
            top2 = torch.topk(logits, 2).values
            assert (top2[0] - top2[1]).item() <= MARGIN, (tr.uid, j)
            break
    assert compared >= sum(NEW) // 2
