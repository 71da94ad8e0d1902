"""Port parity, model: teacher-forced logits of reduced tinyllama-1.1b from
``repro_torch`` against ``repro`` on the same packed weights (loaded with
``from_jax_params``), for every mpGEMM mode, on the CPU. The reference runs
its Pallas kernels in interpret mode; the port runs its kernels' plain
versions. The 130-token prompt makes the port's fusion rule stage the
tables (M ≥ 128), while the reference stays fused: per_row must agree all
the same.

Tolerances. The two packages compute norms, RoPE and sums in different
orders, so a layer's input differs from the reference's in its last bits.
Float paths (fp16, and the LUT with float tables) pass that through
unchanged: rtol/atol 1e-4. Every path that rounds an activation is
discontinuous: the dequant mode rounds activations to bf16 (atol 1e-2);
INT8 tables round each entry to one of 255 steps, so the rare entry that
sits within a last-bit difference of a rounding boundary takes the
neighbouring code, and the token row that reads it moves by about one
quantization step. Measured on this input: per_group max 0.023, per_row
max 0.073 on logits of magnitude up to 4, bf16 activations 0.125. Bounds:
per_group atol 5e-2, per_row atol 0.15, per_row with bf16 activations
atol 0.25, and the greedy token of at least 90% of the positions equal.
That a per_row projection is exact given equal codes is checked by
test_torch_kernels, and by the port's kernel path equalling its plain
path bit for bit below.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import quantized as tquant
from repro_torch.models.convert import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """Reference packed serving params (W2 symmetric K=4) and numpy tree."""
    cfg = jreg.get_reduced("tinyllama-1.1b")
    params = japi.init_params(jax.random.key(0), cfg, serve_quantized=True)
    return params, jax.tree.map(np.asarray, params)


def _cfgs(mode, tq, act="f32"):
    jdt, tdt = ((jnp.float32, torch.float32) if act == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jc = jreg.get_reduced("tinyllama-1.1b").replace(activation_dtype=jdt)
    tc = treg.get_reduced("tinyllama-1.1b").replace(activation_dtype=tdt)
    return (jc.with_quant(mpgemm_mode=mode, table_quant=tq),
            tc.with_quant(mpgemm_mode=mode, table_quant=tq))


def _tokens(b=1, s=130, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s))


@pytest.mark.parametrize("mode,tq,act,tol", [
    ("fp16", None, "f32", 1e-4),
    ("dequant", None, "f32", 1e-2),
    ("lut_xla", None, "f32", 1e-4),
    ("lut_xla", "per_row", "f32", 0.15),
    ("lut_pallas", None, "f32", 1e-4),
    ("lut_pallas", "per_row", "f32", 0.15),
    ("lut_pallas", "per_group", "f32", 5e-2),
    ("lut_pallas", "per_row", "bf16", 0.25),
])
def test_teacher_forced_logits_match_reference(weights, mode, tq, act, tol):
    params, np_tree = weights
    jc, tc = _cfgs(mode, tq, act)
    toks = _tokens()
    want, _, _ = japi.forward(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                              jc)
    got, _, _ = tapi.forward(from_jax_params(np_tree, tc, "cpu"),
                             {"tokens": torch.from_numpy(toks)}, tc)
    assert got.shape == (1, 130, tc.vocab_size)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_kernel_path_equals_plain_lut_path_per_row(weights):
    """Inside the port, lut_pallas (the kernels' wrappers) and lut_xla (the
    plain T @ CW path) give bit-identical per_row logits."""
    _, np_tree = weights
    toks = {"tokens": torch.from_numpy(_tokens(s=130, seed=2))}
    out = []
    for mode in ("lut_pallas", "lut_xla"):
        _, tc = _cfgs(mode, "per_row")
        out.append(tapi.forward(from_jax_params(np_tree, tc, "cpu"), toks,
                                tc)[0])
    assert torch.equal(out[0], out[1])


def test_cached_chunks_equal_one_pass(weights):
    """Prefill in chunks at offsets through the cache, then decode one token
    per slot, gives the logits of one full pass (same port, same modes)."""
    _, np_tree = weights
    _, tc = _cfgs("lut_pallas", "per_row")
    params = from_jax_params(np_tree, tc, "cpu")
    toks = torch.from_numpy(_tokens(b=2, s=24, seed=1))
    full, _, _ = tapi.forward(params, {"tokens": toks}, tc)
    caches = tapi.init_cache(tc, 2, 32, dtype=torch.float32, device="cpu")
    for off in (0, 8):
        tapi.forward(params, {"tokens": toks[:, off:off + 8]}, tc,
                     caches=caches, cache_pos=off, head=False)
    chunk, _, _ = tapi.forward(params, {"tokens": toks[:, 16:23]}, tc,
                               caches=caches, cache_pos=16)
    np.testing.assert_allclose(chunk.numpy(), full[:, 16:23].numpy(),
                               rtol=2e-3, atol=2e-3)
    step, _, _ = tapi.forward(params, {"tokens": toks[:, 23:24]}, tc,
                              caches=caches,
                              cache_pos=torch.tensor([23, 23]))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 23].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_quantize_params_matches_reference_and_skips(weights):
    """The port's quantize_params packs the same bytes as the reference from
    the same float weights, honours quant["skip"], and counts bytes."""
    cfg = jreg.get_reduced("tinyllama-1.1b")
    fparams = japi.init_params(jax.random.key(1), cfg, serve_quantized=False)
    np_float = jax.tree.map(np.asarray, fparams)
    qcfg = treg.get_reduced("tinyllama-1.1b")
    port_float = from_jax_params(np_float, qcfg, "cpu")
    want = from_jax_params(jax.tree.map(np.asarray, japi.init_params(
        jax.random.key(1), cfg, serve_quantized=True)), qcfg, "cpu")
    got = tquant.quantize_params(port_float, qcfg.quant)
    for path in (("layers", 0, "attn", "wq"), ("layers", 1, "mlp", "down"),
                 ("lm_head",)):
        g, w = got, want
        for key in path:
            g, w = g[key], w[key]
        assert torch.equal(g["qw"].packed, w["qw"].packed), path
    skipped = tquant.quantize_params(port_float,
                                     dict(qcfg.quant, skip=r"mlp/down$"))
    assert "w" in skipped["layers"][0]["mlp"]["down"]
    assert "qw" in skipped["layers"][0]["mlp"]["up"]
    assert tquant.quantized_bytes(got) < tquant.quantized_bytes(port_float)
    with pytest.raises(ValueError):
        tquant.quantize_params(port_float, dict(qcfg.quant, fusion="tuned"))
