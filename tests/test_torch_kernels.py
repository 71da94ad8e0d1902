"""Port parity, kernels: each kernel wrapper of ``repro_torch`` on the CPU
(where it runs its plain version) against the reference's Pallas wrapper in
interpret mode, for every table_quant mode, on the same numpy inputs and the
same packed weights.

Tolerances: per_row is exact integer arithmetic with the same closed-form
row scale and epilogue, so given the same INT8 table codes it must be
bit-exact with the reference. The codes themselves may differ at a rounding
tie (the two packages sum a group's entries in different orders; see
test_torch_core.assert_codes_match), so the per_row check (1) feeds the
reference's table to the port's kernel path and requires bit-equality, and
(2) requires the port's own output to be bit-exact on every row whose codes
all agree (to rtol/atol 1e-5 with asymmetric weights, whose zero-point
correction uses Σ_k x summed in another order). None and per_group sum
floats in another order too and hold rtol/atol 1e-4, the reference's own
kernel contract; a per_group scale (a sum of |a|) holds 2 ulp.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import quantize as JQ
from repro.core import table as JT
from repro.kernels import ops as jops
from repro_torch.core import quantize as TQ
from repro_torch.core import table as TT
from repro_torch.kernels import fused_lut_mpgemm as tfused
from repro_torch.kernels import lut_mpgemm as tlut
from repro_torch.kernels import ops as tops
from repro_torch.kernels import table_precompute as ttp
from repro_torch.models.convert import _qw as to_port_qw

from test_torch_core import assert_codes_match

MODES = [None, "per_row", "per_group"]
# (M, K, N, bits, scheme, k_group): aligned, unaligned (13, 72, 130), an odd
# group count (g = 3, one plane), ternary, asymmetric (zero point), K=2 groups
CASES = [(8, 64, 128, 2, "symmetric", 4), (13, 72, 130, 2, "symmetric", 4),
         (8, 12, 16, 1, "symmetric", 4), (16, 128, 96, 2, "ternary", 4),
         (8, 64, 128, 4, "asymmetric", 4), (9, 64, 40, 2, "symmetric", 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)  # one reference quantization per case
def _inputs(m, k, n, bits, scheme, k_group):
    rng = np.random.default_rng(m * 1000 + k + n)
    a = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(n, k)).astype(np.float32)
    jq = JQ.quantize(jnp.asarray(w), bits, k_group=k_group, scheme=scheme)
    return a, jq, to_port_qw(jax.tree.map(np.asarray, jq), "cpu")


def _assert_out(got, want, tq, a, jq, tq_w):
    if tq != "per_row":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    x = torch.from_numpy(a)
    kg = jq.k_group
    jt = JT.precompute_table(jnp.asarray(a), kg, "per_row")
    ref_table = TT.Table(*(torch.from_numpy(np.array(v)) for v in jt[:3]),
                         kg)
    np.testing.assert_array_equal(
        tops.lut_mpgemm(x, tq_w, table=ref_table).numpy(), want)
    tt = TT.precompute_table(x, kg, "per_row")
    entries = TT.table_entries(x.reshape(x.shape[0], -1, kg), kg).numpy()
    assert_codes_match(tt.values.numpy(), np.asarray(jt.values), entries,
                       tt.scale.numpy())
    same = (tt.values.numpy() == np.asarray(jt.values)).all(axis=(1, 2))
    if jq.zero_prime is None:
        np.testing.assert_array_equal(got[same], want[same])
    else:
        np.testing.assert_allclose(got[same], want[same], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("tq", MODES)
@pytest.mark.parametrize("case", CASES[:3] + CASES[5:], ids=str)
def test_table_precompute_matches_reference(case, tq):
    m, k, _, _, _, k_group = case
    a = np.random.default_rng(m + k).normal(size=(m, k)).astype(np.float32)
    want = jops.table_precompute(jnp.asarray(a), k_group, tq, block_m=8,
                                 block_g=min(8, k // k_group), interpret=True)
    got = tops.table_precompute(torch.from_numpy(a), k_group, tq)
    np.testing.assert_allclose(got.rowsum.numpy(), np.asarray(want.rowsum),
                               rtol=1e-6, atol=1e-6)
    if tq is None:
        np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                                   rtol=0, atol=1e-6)
        return
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=2.4e-7, atol=0)
    entries = TT.table_entries(torch.from_numpy(a).reshape(m, -1, k_group),
                               k_group).numpy()
    assert_codes_match(got.values.numpy(), np.asarray(want.values), entries,
                       got.scale.numpy())


@pytest.mark.parametrize("tq", MODES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_staged_lut_mpgemm_matches_reference(case, tq):
    a, jq, tq_w = _inputs(*case)
    want = jops.lut_mpgemm(jnp.asarray(a), jq, table_quant=tq,
                           fusion="staged", interpret=True)
    got = tops.lut_mpgemm(torch.from_numpy(a), tq_w, table_quant=tq,
                          fusion="staged")
    _assert_out(got.numpy(), np.asarray(want), tq, a, jq, tq_w)


@pytest.mark.parametrize("tq", MODES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_fused_lut_mpgemm_matches_reference(case, tq):
    a, jq, tq_w = _inputs(*case)
    want = jops.fused_lut_mpgemm(jnp.asarray(a), jq, table_quant=tq,
                                 interpret=True)
    got = tops.fused_lut_mpgemm(torch.from_numpy(a), tq_w, table_quant=tq)
    _assert_out(got.numpy(), np.asarray(want), tq, a, jq, tq_w)
    if tq == "per_row":  # and bit-exact with the port's staged pair
        staged = tops.lut_mpgemm(torch.from_numpy(a), tq_w, table_quant=tq,
                                 fusion="staged")
        np.testing.assert_array_equal(got.numpy(), staged.numpy())


def test_shared_table_and_refusals():
    """A supplied table runs staged; a per-row f32 table and a plane-sliced
    view are refused, as by the reference kernels."""
    a, jq, tq_w = _inputs(*CASES[0])
    x = torch.from_numpy(a)
    t = tops.table_precompute(x, 4, "per_row")
    np.testing.assert_array_equal(
        tops.lut_mpgemm(x, tq_w, table=t).numpy(),
        tops.lut_mpgemm(x, tq_w, table_quant="per_row",
                        fusion="fused").numpy())
    f32_rows = TT.Table(t.values.float() * t.scale, t.scale, t.rowsum, 4)
    with pytest.raises(ValueError, match="per-row"):
        tops.lut_mpgemm(x, tq_w, table=f32_rows)
    with pytest.raises(NotImplementedError, match="plane-sliced"):
        tops.lut_mpgemm(x, tq_w.plane_slice(1), table_quant="per_row")


def test_fusion_rule_on_the_h100_budget():
    """auto picks fused at decode M and staged at a 128-token prefill chunk
    for tinyllama's shapes; the reference's 64 MiB VMEM rule is always
    fused there."""
    for n, k in ((2048, 2048), (5632, 2048), (2048, 5632), (32000, 2048)):
        for m in (1, 4, 8, 32, 64):
            assert tops.resolve_dispatch(m, n, k // 4, 4, 2) == "fused"
            assert jops.resolve_dispatch(m, n, k // 4, 4, 2)[0] == "fused"
        assert tops.resolve_dispatch(128, n, k // 4, 4, 2) == "staged"
        assert jops.resolve_dispatch(128, n, k // 4, 4, 2)[0] == "fused"
    with pytest.raises(ValueError):
        tops.resolve_dispatch(8, 128, 16, 4, 2, fusion="tuned")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_wrappers_pad_to_the_kernel_tiles(case, monkeypatch):
    """ops pads rows to BM, K-groups to bg and channels to BN: every shape
    it hands a kernel wrapper passes the card path's launch checks."""
    m, k, n, bits, scheme, k_group = case
    rng = np.random.default_rng(m + k)
    a = rng.normal(size=(m, k)).astype(np.float32)
    tq_w = TQ.quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
        np.float32)), bits, k_group=k_group, scheme=scheme)
    seen = []

    def spy(plain, rows_of):
        def run(*args, **kw):
            rows, packed = args[0], args[2]
            gp = packed.shape[1] * 8 // (kw["planes"] * kw["k_group"])
            seen.append(tlut.launch_args(kw["k_group"], kw["planes"],
                                         kw["plane_scales"], rows.shape[0],
                                         packed.shape[0], gp))
            assert rows_of(rows, kw["k_group"]) == gp
            return plain(*args, **kw)
        return run

    monkeypatch.setattr(tlut, "lut_mpgemm_plain", spy(
        tlut.lut_mpgemm_plain, lambda t, kg: t.shape[1] >> (kg - 1)))
    monkeypatch.setattr(tfused, "fused_lut_mpgemm_plain", spy(
        tfused.fused_lut_mpgemm_plain, lambda t, kg: t.shape[1] // kg))
    x = torch.from_numpy(a)
    for fusion in ("fused", "staged"):
        tops.lut_mpgemm(x, tq_w, table_quant="per_row", fusion=fusion)
    assert len(seen) == 2
    with pytest.raises(ValueError, match="padded"):
        tlut.launch_args(4, 2, (1.0, 2.0), 5, 64, 32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU "
                    "(tests/test_torch_cuda.py holds them against their "
                    "plain versions there)")
    return torch.device("cuda")


def test_kernel_wrappers_launch_on_cuda_tensors(cuda_device):
    """On a CUDA tensor each wrapper launches its kernel (never the plain
    version) and counts the launch."""
    _, _, tq_w = _inputs(*CASES[0])
    x = torch.randn(8, 64, device=cuda_device)
    qw = tq_w.to(cuda_device)
    before = (ttp.launches, tlut.launches, tfused.launches)
    tops.lut_mpgemm(x, qw, table_quant="per_row", fusion="staged")
    tops.lut_mpgemm(x, qw, table_quant="per_row", fusion="fused")
    assert (ttp.launches, tlut.launches, tfused.launches) == tuple(
        b + 1 for b in before)
