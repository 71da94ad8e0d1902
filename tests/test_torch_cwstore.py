"""Port parity, the offline-CW weight store (``QuantizedWeight.cw``: the
combined-lookup matrix int8 [G·E, N] kept in place of the packed codes),
from ``repro_torch`` against ``repro`` on the CPU.

  * ``to_cw_format``: CW entries equal to the reference's, every scheme,
    W2 and W4, an expert stack;
  * ``lut_xla`` on a CW weight bit-equal to the packed weight in every
    table mode; what needs the codes refuses it (``sign_idx``,
    ``plane_slice``, ``dequantize``, the fp16 / dequant / lut_pallas
    modes);
  * trees: ``quantize_params(store="cw")`` = ``to_cw_params``;
    ``quantized_bytes`` counts ``cw`` (equal to the reference's count of
    its CW tree); ``plane_sliced_params`` refuses CW leaves;
  * a reference engine's CPU-expanded params load through
    ``from_jax_params`` and give the packed tree's logits bit for bit
    under per_row lut_xla, reduced tinyllama and olmoe (expert stacks);
  * the engine's expansion: the port's engine expands exactly where the
    reference's does (CPU, lut_xla, no ``store``, no self-speculation);
    ``store="packed"`` and spec keep the planes; streams of the expanded
    engine equal the packed engine's; a CW tree under lut_pallas, fp16 or
    dequant is refused at engine build.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.core import quantize as JQ
from repro.models import api as japi
from repro.models import quantized as jqz
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.core import mpgemm as mp
from repro_torch.core import quantize as Q
from repro_torch.models import api as tapi
from repro_torch.models import quantized as qz
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.engine import Request, ServingEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# one weight
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme,bits", [("symmetric", 2), ("symmetric", 4),
                                         ("ternary", 2), ("asymmetric", 3)])
def test_to_cw_format_is_the_reference(scheme, bits):
    w = np.random.default_rng(0).normal(size=(24, 64)).astype(np.float32)
    qw = Q.quantize(torch.from_numpy(w), bits, k_group=4, scheme=scheme)
    got = Q.to_cw_format(qw)
    want = JQ.to_cw_format(JQ.quantize(jnp.asarray(w), bits, k_group=4,
                                       scheme=scheme))
    assert got.packed is None and want.packed is None and got.is_cw
    assert got.cw.dtype == torch.int8 and tuple(got.cw.shape) == (16 * 8, 24)
    np.testing.assert_array_equal(got.cw.numpy(), np.asarray(want.cw))
    assert torch.equal(got.scale, qw.scale)
    assert Q.to_cw_format(got) is got
    assert got.storage_bits_per_weight() == 8 * 16 * 8 / 64
    assert "store=cw" in repr(got)


def test_expert_stack_to_cw_format_is_the_reference():
    w = np.random.default_rng(1).normal(size=(3, 32, 16)).astype(np.float32)
    qw = Q.quantize_experts(torch.from_numpy(w), 2)
    got = Q.to_cw_format(qw)
    want = jax.vmap(lambda we: JQ.to_cw_format(JQ.quantize(we.T, 2)))(
        jnp.asarray(w))
    assert got.experts == 3 and tuple(got.cw.shape) == (3, 8 * 8, 16)
    np.testing.assert_array_equal(got.cw.numpy(), np.asarray(want.cw))
    e1 = got.expert(1)
    assert e1.experts is None and torch.equal(e1.cw, got.cw[1])
    assert got.to("cpu").cw.data_ptr() == got.cw.data_ptr()


@pytest.mark.parametrize("tq", [None, "per_row", "per_group"])
def test_lut_xla_on_cw_is_bit_equal_to_packed(tq):
    rng = np.random.default_rng(2)
    qw = Q.quantize(torch.from_numpy(rng.normal(size=(40, 128)).astype(
        np.float32)), 2)
    cw = Q.to_cw_format(qw)
    x = torch.from_numpy(rng.normal(size=(5, 128)).astype(np.float32))
    a = mp.mpgemm(x, qw, mode="lut_xla", table_quant=tq)
    b = mp.mpgemm(x, cw, mode="lut_xla", table_quant=tq)
    assert torch.equal(a, b)
    qe = Q.quantize_experts(torch.from_numpy(rng.normal(
        size=(3, 128, 24)).astype(np.float32)), 2)
    xe = torch.from_numpy(rng.normal(size=(3, 4, 128)).astype(np.float32))
    assert torch.equal(mp.mpgemm(xe, qe, mode="lut_xla", table_quant=tq),
                       mp.mpgemm(xe, Q.to_cw_format(qe), mode="lut_xla",
                                 table_quant=tq))


def test_cw_weight_refuses_what_needs_codes():
    qw = Q.to_cw_format(Q.quantize(torch.randn(16, 32), 2))
    x = torch.randn(2, 32)
    for call in (qw.sign_idx, lambda: qw.plane_slice(1),
                 lambda: Q.dequantize(qw), lambda: Q.plane_codes(qw)):
        with pytest.raises(ValueError, match="packed store"):
            call()
    assert qw.plane_slice(2) is qw  # every plane: no slicing, as reference
    for mode in ("fp16", "dequant", "lut_pallas"):
        with pytest.raises(ValueError, match="offline-CW"):
            mp.mpgemm(x, qw, mode=mode)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _cfgs(arch, **quant):
    q = dict(dict(mpgemm_mode="lut_xla", table_quant="per_row"), **quant)
    jc = jreg.get_reduced(arch).replace(
        activation_dtype=jnp.float32).with_quant(**q)
    tc = treg.get_reduced(arch).replace(
        activation_dtype=torch.float32).with_quant(**q)
    return jc, tc


def _qws(tree):
    out = []
    qz._map_qw(tree, out.append)
    return out


def test_store_cw_quantizes_into_the_cw_store():
    _, tc = _cfgs("olmoe-1b-7b")
    gen = torch.Generator()
    gen.manual_seed(0)
    flt = tapi.init_params(gen, tc, "cpu", serve_quantized=False)
    packed = qz.quantize_params(flt, tc.quant)
    cw = qz.quantize_params(flt, dict(tc.quant, store="cw"))
    conv = qz.to_cw_params(packed)
    assert not qz.has_cw(packed) and qz.has_cw(cw)
    assert all(q.is_cw for q in _qws(cw))
    assert any(q.experts for q in _qws(cw))
    for a, b in zip(_qws(cw), _qws(conv)):
        assert torch.equal(a.cw, b.cw) and torch.equal(a.scale, b.scale)
    with pytest.raises(ValueError, match="plane-sliced"):
        qz.plane_sliced_params(cw, 1)
    # float leaves are shared, not copied
    assert conv["embed"]["table"] is packed["embed"]["table"]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_quantized_bytes_counts_cw_as_the_reference(arch):
    jc, tc = _cfgs(arch)
    jp = japi.init_params(jax.random.key(0), jc, serve_quantized=True)
    jcw = jqz.to_cw_params(jp)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu")
    tcw = qz.to_cw_params(tp)
    assert qz.quantized_bytes(tp) == jqz.quantized_bytes(jp)
    assert qz.quantized_bytes(tcw) == jqz.quantized_bytes(jcw)
    cw_bytes = sum(q.cw.numel() for q in _qws(tcw))
    packed_bytes = sum(q.packed.numel() for q in _qws(tp))
    assert (qz.quantized_bytes(tcw) - qz.quantized_bytes(tp)
            == cw_bytes - packed_bytes > 0)


# ---------------------------------------------------------------------------
# a reference engine's CPU-expanded params, served by the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_reference_engine_cw_params_serve_the_packed_logits(arch):
    """The reference engine expands its packed params on the CPU; its
    ``params`` load through ``from_jax_params`` as CW weights (stacked per
    layer, and per expert for olmoe), and the port's forward on them gives
    the packed tree's logits, and the reference's CW forward's within its
    packed parity bound, under per_row lut_xla."""
    jc, tc = _cfgs(arch)
    jp = japi.init_params(jax.random.key(0), jc, serve_quantized=True)
    jeng = JEngine(jc, jp, max_batch=2, max_seq=32)
    assert all(q.packed is None and q.cw is not None
               for q in jax.tree_util.tree_leaves(
                   jeng.params,
                   is_leaf=lambda n: isinstance(n, JQ.QuantizedWeight))
               if isinstance(q, JQ.QuantizedWeight))
    cw = from_jax_params(jax.tree.map(np.asarray, jeng.params), tc, "cpu")
    packed = from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu")
    assert qz.has_cw(cw) and all(q.is_cw for q in _qws(cw))
    if arch == "olmoe-1b-7b":
        assert any(q.experts for q in _qws(cw))
    for a, b in zip(_qws(cw), _qws(qz.to_cw_params(packed))):
        assert torch.equal(a.cw, b.cw)
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 10))
    batch = {"tokens": torch.from_numpy(toks)}
    got = tapi.forward(cw, batch, tc)[0]
    assert torch.equal(got, tapi.forward(packed, batch, tc)[0])
    # float tables too: the loaded matrices keep build_cw's layout
    ft = tc.with_quant(table_quant=None)
    assert torch.equal(tapi.forward(cw, batch, ft)[0],
                       tapi.forward(packed, batch, ft)[0])
    want = np.asarray(japi.forward(jeng.params,
                                   {"tokens": jnp.asarray(toks)}, jc)[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=0.15, atol=0.15)


def _serve(eng, prompts, n_new=6, decoding="greedy"):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new, decoding=decoding)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs]


def _expands(eng_params) -> bool:
    return any(q.packed is None for q in jax.tree_util.tree_leaves(
        eng_params, is_leaf=lambda n: isinstance(n, JQ.QuantizedWeight))
        if isinstance(q, JQ.QuantizedWeight))


@pytest.mark.parametrize("case", [
    dict(), dict(store="packed"), dict(spec=2), dict(mode="lut_pallas"),
    dict(mode="dequant")],
    ids=["lut_xla", "store_packed", "spec", "lut_pallas", "dequant"])
def test_engine_expands_where_the_reference_engine_does(case):
    quant = {"weight_bits": 4}
    if "store" in case:
        quant["store"] = case["store"]
    if "mode" in case:
        quant["mpgemm_mode"] = case["mode"]
    jc, tc = _cfgs("tinyllama-1.1b", **quant)
    jp = japi.init_params(jax.random.key(0), jc, serve_quantized=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu")
    kw = dict(max_batch=2, max_seq=32)
    if "spec" in case:
        kw["spec_draft_planes"] = case["spec"]
    eng = ServingEngine(tc, tp, **kw)
    assert qz.has_cw(eng.params) == _expands(JEngine(jc, jp, **kw).params)
    assert qz.has_cw(eng.params) == (case == {})


def test_expanded_engine_streams_equal_the_packed_engine():
    """Greedy streams and a beam:2 request's hypotheses of the expanded
    engine equal a ``store="packed"`` engine's (per_row lut_xla)."""
    _, tc = _cfgs("tinyllama-1.1b")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tapi.init_params(gen, tc, "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tc.vocab_size, n) for n in (7, 12, 9)]
    kw = dict(max_batch=4, max_seq=32, prefill_chunk=4, decode_chunk=3)
    eng = ServingEngine(tc, tp, **kw)
    ref = ServingEngine(tc.with_quant(store="packed"), tp, **kw)
    assert qz.has_cw(eng.params) and not qz.has_cw(ref.params)
    assert _serve(eng, prompts) == _serve(ref, prompts)
    assert (_serve(eng, prompts[:1], decoding="beam:2")
            == _serve(ref, prompts[:1], decoding="beam:2"))


def test_cw_tree_is_refused_outside_lut_xla():
    _, tc = _cfgs("tinyllama-1.1b")
    gen = torch.Generator()
    gen.manual_seed(0)
    cw = qz.to_cw_params(tapi.init_params(gen, tc, "cpu"))
    for mode in ("lut_pallas", "fp16", "dequant"):
        with pytest.raises(ValueError, match="offline-CW"):
            ServingEngine(tc.with_quant(mpgemm_mode=mode), cw, max_batch=1,
                          max_seq=16)
    with pytest.raises(ValueError, match="offline-CW"):
        ServingEngine(tc.with_quant(mpgemm_mode="lut_pallas", store="cw"),
                      tapi.init_params(gen, tc, "cpu"), max_batch=1,
                      max_seq=16)
    with pytest.raises(ValueError, match="plane-sliced"):
        ServingEngine(tc, cw, max_batch=1, max_seq=16, spec_draft_planes=1)
