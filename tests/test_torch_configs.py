"""Port parity, configs: the dense archs the port serves beside
tinyllama-1.1b, reduced, from ``repro_torch`` against ``repro`` on the CPU,
and each served through the port's serve entry point.

The archs: paper-bitnet-3b (ternary weights), qwen1.5-0.5b and qwen2-72b
(QKV bias; qwen2-72b also rope_theta 1e6 and bf16 params at full width),
llama3.2-3b (rope_theta 5e5, GQA 24/8). Two more cases: reduced
paper-bitnet-3b widened to d_model 200 with 2 heads (head_dim 100, the
full model's, whose RoPE halves are 50 wide), and reduced qwen2-72b with
its full-width bf16 params (the embedding, norms and biases stay bf16;
activations f32).

Weights: a numpy generator seeded per case draws every float leaf of the
reference's param tree: the embedding, the norms' gains, the projections
and, for the QKV-bias archs, nonzero biases (the reference initialises
biases to zero, which would test nothing). The reference packs the
projections with its own scheme per arch (``quantize_params``: W2
symmetric, or ternary), and ``convert.from_jax_params`` loads the packed
tree into the port.

Tolerances, on every teacher-forced logit (rtol = atol), and the greedy
token of at least 90% of the positions equal:
  * fp16 (the packed weights dequantized, f32 GEMMs): 1e-4;
  * lut_xla with float tables (``table_quant=None``): 1e-4;
  * per_row INT8 tables, lut_xla against the reference's lut_xla and
    lut_pallas (the kernels' plain versions here) against the reference's
    lut_pallas (its Pallas kernels in interpret mode): 0.15, as in
    tests/test_torch_model.py.
The float paths pass the last-bit difference of norms, RoPE and sums
computed in other orders through unchanged. INT8 tables round each entry
to one of 255 steps, so an entry within a last-bit difference of a
rounding boundary takes the neighbouring code and moves its token row by
about one step. Measured maxima over logits of magnitude up to 5: fp16
and float tables at most 4.5e-6 in every case; per_row (lut_xla /
lut_pallas) paper-bitnet-3b 6.0e-7 / 7.2e-7, qwen1.5-0.5b 0.014 /
9.5e-7, llama3.2-3b 9.5e-7 / 1.2e-6, qwen2-72b 0.0059 / 0.0059,
head_dim 100 0.021 / 0.021, qwen2-72b with bf16 params 9.5e-7 / 9.5e-7.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import quantized as jquant
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models.convert import from_jax_params

ARCHS = ["paper-bitnet-3b", "qwen1.5-0.5b", "llama3.2-3b", "qwen2-72b"]
MOE_ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]
SSM_ARCHS = ["falcon-mamba-7b", "zamba2-7b"]
XATTN_ARCHS = ["llama-3.2-vision-11b", "whisper-tiny"]
# (arch, variant): None, "head_dim100" (widened) or "bf16" (params as at
# full width)
CASES = ([(arch, None) for arch in ARCHS]
         + [("paper-bitnet-3b", "head_dim100"), ("qwen2-72b", "bf16")])
CASE_IDS = [a + (f"-{v}" if v else "") for a, v in CASES]
# (port mode, table_quant, the reference's mode, rtol = atol)
MODES = [pytest.param("fp16", None, "fp16", 1e-4, id="fp16"),
         pytest.param("lut_xla", None, "lut_xla", 1e-4, id="lut_xla"),
         pytest.param("lut_xla", "per_row", "lut_xla", 0.15,
                      id="lut_xla-per_row"),
         pytest.param("lut_pallas", "per_row", "lut_pallas", 0.15,
                      id="lut_pallas-per_row")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, variant=None):
    jc = jreg.get_reduced(arch).replace(activation_dtype=jnp.float32)
    tc = treg.get_reduced(arch).replace(activation_dtype=torch.float32)
    if variant == "head_dim100":
        kw = dict(d_model=200, n_heads=2, n_kv_heads=2, head_dim=0)
        jc, tc = jc.replace(**kw), tc.replace(**kw)
        assert jc.head_dim == tc.head_dim == 100
    elif variant == "bf16":
        assert treg.get_config(arch).param_dtype == torch.bfloat16
        jc = jc.replace(param_dtype=jnp.bfloat16)
        tc = tc.replace(param_dtype=torch.bfloat16)
    return jc, tc


def _draw(rng, path, leaf):
    """A float leaf of the reference's tree, drawn from ``rng``."""
    name = path[-1].key
    shape = leaf.shape
    if name == "g":
        out = 1.0 + 0.1 * rng.normal(size=shape)
    elif name == "b":
        out = 0.1 * rng.normal(size=shape)
    elif name == "table":
        out = 0.02 * rng.normal(size=shape)
    else:  # a projection, [..., in, out]
        out = rng.normal(size=shape) / np.sqrt(shape[-2])
    return jnp.asarray(out.astype(np.float32), dtype=leaf.dtype)


@pytest.fixture(scope="module")
def packed():
    """(arch, variant) -> (reference packed params, their numpy tree),
    drawn once per case."""
    cache = {}

    def get(arch, variant):
        if (arch, variant) not in cache:
            jc, _ = _cfgs(arch, variant)
            shapes = jax.eval_shape(lambda: japi.init_params(
                jax.random.key(0), jc, serve_quantized=False))
            rng = np.random.default_rng(ARCHS.index(arch) + 10 * CASES.index(
                (arch, variant)))
            floats = jax.tree_util.tree_map_with_path(
                lambda p, leaf: _draw(rng, p, leaf), shapes)
            # one jitted program: the eager op-by-op packing takes ~10x longer
            params = jax.jit(lambda tree: jquant.quantize_params(
                tree, jc.quant))(floats)
            cache[arch, variant] = params, jax.tree.map(np.asarray, params)
        return cache[arch, variant]

    return get


@pytest.mark.parametrize("mode,tq,ref_mode,tol", MODES)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_teacher_forced_logits_match_reference(packed, case, mode, tq,
                                               ref_mode, tol):
    params, np_tree = packed(*case)
    jc, tc = _cfgs(*case)
    jc = jc.with_quant(mpgemm_mode=ref_mode, table_quant=tq)
    tc = tc.with_quant(mpgemm_mode=mode, table_quant=tq)
    if tc.qkv_bias:
        bias = np_tree["layers"]["attn"]["wq"]["b"]
        assert np.abs(bias).min() > 0
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 24))
    want, _, _ = japi.forward(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                              jc)
    port = from_jax_params(np_tree, tc, "cpu")
    assert port["embed"]["table"].dtype == tc.param_dtype
    got, _, _ = tapi.forward(port, {"tokens": torch.from_numpy(toks)}, tc)
    assert got.shape == (2, 24, tc.vocab_size)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kernel_path_equals_plain_lut_path_per_row(packed, case):
    """Inside the port, lut_pallas (the kernels' wrappers) and lut_xla (the
    plain T @ CW path) give bit-identical per_row logits over a 130-token
    prompt, which stages the tables (M >= 128), as chip_smoke.py requires
    of the full-width model on the card."""
    _, np_tree = packed(*case)
    toks = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (1, 130)))}
    out = []
    for mode in ("lut_pallas", "lut_xla"):
        tc = _cfgs(*case)[1].with_quant(mpgemm_mode=mode,
                                        table_quant="per_row")
        out.append(tapi.forward(from_jax_params(np_tree, tc, "cpu"), toks,
                                tc)[0])
    assert torch.equal(out[0], out[1])


def test_bf16_init_params_match_the_reference_tree():
    """qwen2-72b's full-width param dtype, bf16, through the port's
    ``init_params`` (reduced widths): every leaf has the shape and dtype of
    the reference's ``init_params`` leaf (the embedding, norms and biases
    bf16; the packed codes uint8 and their scales f32), and the serving
    forward gives finite logits of the expected shape."""
    jc, tc = _cfgs("qwen2-72b", "bf16")
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
    assert got["embed"]["table"].dtype == torch.bfloat16
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 24)))
    logits, _, _ = tapi.forward(got, {"tokens": toks}, tc.with_quant(
        mpgemm_mode="lut_pallas", table_quant="per_row"))
    assert logits.shape == (2, 24, tc.vocab_size)
    assert torch.isfinite(logits).all()


def test_registry_lists_the_dense_archs():
    """The port's archs: the dense ones, then the MoE family's
    (tests/test_torch_moe.py), the SSM and hybrid families'
    (tests/test_torch_ssm.py), then the VLM and audio families'
    (tests/test_torch_xattn.py): the reference's 11 archs. Its families
    are the reference's six, in the reference's order."""
    assert treg.list_archs() == (["tinyllama-1.1b"] + ARCHS + MOE_ARCHS
                                 + SSM_ARCHS + XATTN_ARCHS)
    assert sorted(treg.list_archs()) == sorted(jreg.list_archs())
    assert treg.FAMILIES == jreg.FAMILIES == (
        "dense", "moe", "ssm", "hybrid", "vlm", "audio")


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + SSM_ARCHS
                         + XATTN_ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_configs_equal_the_reference(arch, size):
    """Every field the dense, MoE, SSM, hybrid, VLM and audio forwards
    read, the quant dict, and the parameter counts, as the reference's
    config gives them, at full width and reduced."""
    get = "get_config" if size == "full" else "get_reduced"
    jc, tc = getattr(jreg, get)(arch), getattr(treg, get)(arch)
    for field in ("arch_id", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "head_dim", "qkv_bias",
                  "rope_theta", "norm_eps", "attn_chunk", "quant", "source",
                  "num_experts", "top_k", "capacity_factor",
                  "n_shared_experts", "first_dense_layers", "dense_d_ff",
                  "ssm_state", "d_conv", "expand", "d_inner", "dt_rank",
                  "ssm_heads", "ssm_chunk", "attn_every", "xattn_every",
                  "n_image_tokens", "enc_layers", "n_audio_frames",
                  "max_positions"):
        assert getattr(tc, field) == getattr(jc, field), field
    assert str(tc.param_dtype).split(".")[-1] == jnp.dtype(
        jc.param_dtype).name
    assert tc.num_params() == jc.num_params()
    assert tc.active_params() == jc.active_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_serves_on_cpu(arch, capsys):
    """The reduced engine serves each arch through the entry point, with
    the kernels' plain versions (lut_pallas on CPU tensors), and names the
    arch's weight scheme."""
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "2", "--max-new", "3", "--max-seq", "32",
                       "--mode", "lut_pallas"]) == 0
    out = capsys.readouterr().out
    scheme = "ternary" if arch == "paper-bitnet-3b" else "W2 symmetric"
    assert f"(lut_pallas, {scheme})" in out
    assert "served 2 requests / 6 tokens" in out


def test_weight_bits_cannot_override_ternary(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "paper-bitnet-3b", "--reduced", "--device",
                    "cpu", "--weight-bits", "4"])
    assert "ternary" in capsys.readouterr().err
    assert serve.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                       "cpu", "--requests", "1", "--max-new", "2",
                       "--max-seq", "32", "--weight-bits", "4",
                       "--mode", "lut_pallas"]) == 0
    assert "(lut_pallas, W4 symmetric)" in capsys.readouterr().out
