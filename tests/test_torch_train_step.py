"""Port parity, one QAT train step: reduced tinyllama-1.1b and reduced
olmoe-1b-7b through ``repro_torch.training.train_loop.make_train_step``
against ``repro``'s (jitted) on the CPU, f32 activations, batch 4, seq 32,
``SyntheticLM(seed=0)``'s batch 0: with and without int8 gradient
compression, and in two microbatches of 2 (microbatch 0, then the scan over
the rest added to it, and grads and metrics scaled by 1/2).

The reference's float params (``api.init_params``) load into the port
through ``convert.from_jax_params``. Tolerances: ``loss``, ``lm_loss``,
``lb_loss`` and ``router_z_loss`` within 1e-5 relative, ``grad_norm``
within 1e-4, and the params after one **momentum** step within rtol =
atol = 1e-5. (AdamW's first step is close to sign(g), so it amplifies the
last-bit differences of near-zero gradients summed in another order; its
parity is held at the optimizer level in ``test_torch_training.py``.)
Momentum's first m is the gradient the optimizer was given, so each leaf's
gradient is held too, within 1e-4 of that leaf's own largest |gradient|:
a leaf whose gradient is zero, transposed, misplaced or of the wrong sign
misses that by orders of magnitude, where the param check at lr 1e-2
could not see it.
Under int8 compression a gradient at a rounding tie of its block can take
the neighbouring code: its residual then moves by one code step (checked,
and at most 1e-4 of the elements; 4 and 6 here), its param by the step
times the learning rate, inside the same atol, and its gradient by the
step, which the per-leaf gradient check leaves out for these elements only.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.distributed import compression as jcomp
from repro.models import api as japi
from repro.training import optimizer as jO
from repro.training import train_loop as jT
from repro_torch.configs import registry as treg
from repro_torch.distributed import compression as tcomp
from repro_torch.models.convert import from_jax_params
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as T
from repro_torch.training.data import SyntheticLM
from repro_torch.core.tree import tree_leaves, tree_paths

ARCHS = ["tinyllama-1.1b", "olmoe-1b-7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref_params():
    """{arch: the reference's float params}, made once per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jreg.get_reduced(arch).replace(activation_dtype=jnp.float32)
            cache[arch] = japi.init_params(jax.random.key(0), cfg)
        return cache[arch]
    return get


@pytest.mark.parametrize("compression,microbatches",
                         [(None, 1), ("int8", 1), (None, 2)],
                         ids=["plain", "int8", "microbatches2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_qat_train_step_matches_reference(arch, compression,
                                              microbatches, ref_params):
    jc = jreg.get_reduced(arch).replace(activation_dtype=jnp.float32)
    tc = treg.get_reduced(arch).replace(activation_dtype=torch.float32)
    jp = ref_params(arch)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu")
    jopt = jO.make_optimizer("momentum", lr=1e-2)
    topt = O.make_optimizer("momentum", lr=1e-2)
    js = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    ts = {"params": tp, "opt": topt.init(tp),
          "step": torch.zeros((), dtype=torch.int32)}
    if compression:
        js["ef"] = jcomp.init_error_feedback(jp)
        ts["ef"] = tcomp.init_error_feedback(tp)
    batch = SyntheticLM(jc.vocab_size, 4, 32, seed=0).batch_at(0)
    jstep = jax.jit(jT.make_train_step(jc, jopt, qat=True,
                                       microbatches=microbatches,
                                       grad_compression=compression))
    js2, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
    ts2, tm = T.make_train_step(tc, topt, qat=True, microbatches=microbatches,
                                grad_compression=compression)(ts, batch)

    want_keys = {"loss", "lm_loss", "grad_norm"} | (
        {"lb_loss", "router_z_loss"} if arch == "olmoe-1b-7b" else set())
    assert set(tm) == set(jm) == want_keys
    for k in want_keys:
        tol = 1e-4 if k == "grad_norm" else 1e-5
        want, got = float(jm[k]), float(tm[k])
        assert np.isfinite(got) and abs(got - want) <= tol * abs(want), k
    assert int(ts2["step"]) == 1 and int(ts2["opt"]["step"]) == 1
    # the input state is left as it was
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ts["params"]),
                                                 tree_leaves(tp)))
    want_p = from_jax_params(jax.tree.map(np.asarray, js2["params"]), tc,
                             "cpu")
    for (name, got), want in zip(tree_paths(ts2["params"]),
                                 tree_leaves(want_p)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    flipped = [np.zeros(p.shape, bool) for p in tree_leaves(tp)]
    if compression:
        # the residual g + e − deq: equal within 1e-5 except where a code
        # flipped at a tie, and there it moved by exactly one code step
        want_ef = from_jax_params(jax.tree.map(np.asarray, js2["ef"]), tc,
                                  "cpu")
        for got, want, m, far in zip(tree_leaves(ts2["ef"]),
                                     tree_leaves(want_ef),
                                     tree_leaves(ts2["opt"]["m"]), flipped):
            d = np.abs(got.numpy() - want.numpy())
            far |= d > 1e-5
            if far.any():
                # momentum's first m is the compressed gradient: m + e = g
                step = _code_steps((m + got).numpy())
                np.testing.assert_allclose(d[far], step[far], rtol=1e-3)
        n = sum(p.numel() for p in tree_leaves(tp))
        flips = sum(int(f.sum()) for f in flipped)
        assert flips <= 1e-4 * n, flips
    # each leaf's gradient (momentum's first m), against its own scale
    want_m = from_jax_params(jax.tree.map(np.asarray, js2["opt"]["m"]), tc,
                             "cpu")
    for (name, got), want, far in zip(tree_paths(ts2["opt"]["m"]),
                                      tree_leaves(want_m), flipped):
        got, want = got.numpy(), want.numpy()
        scale = np.abs(want).max()
        assert scale > 0, name
        assert np.abs(got - want)[~far].max() <= 1e-4 * scale, name

def _code_steps(g):
    """One int8 code step (absmax / 127) of each element's block of 1024,
    the compression's blocks."""
    flat = g.reshape(-1)
    blk = np.pad(flat, (0, (-flat.size) % 1024)).reshape(-1, 1024)
    s = np.maximum(np.abs(blk).max(axis=1, keepdims=True), 1e-12) / 127.0
    return np.broadcast_to(s, blk.shape).reshape(-1)[:flat.size].reshape(
        g.shape)
