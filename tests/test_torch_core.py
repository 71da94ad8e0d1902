"""Port parity, core: the packed weight format, dequantization and the
lookup tables of ``repro_torch`` against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: packed bytes, unpacked codes and INT8 table codes must be
equal, and so must every scale computed from a max or min. Two values are
sums whose order differs between XLA and torch, and may differ in their
last bits: the ternary scale (a row mean: 2 ulp, rtol 3e-7) and float
table entries (a sum of K ±a_i with cancellation: atol 1e-6, below one
ulp of the largest entry). The last allowance is an INT8 code that sits on a rounding tie: the reference sums a
group's entries in the order XLA picks, the port in k order, so an entry
may differ in its last bit, and a quotient within 1 ulp of .5 may round to
the neighbouring code. Those codes are counted, and only they may differ,
by 1.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import quantize as JQ
from repro.core import table as JT
from repro_torch.core import packing as TP
from repro_torch.core import quantize as TQ
from repro_torch.core import table as TT
from repro_torch.models.convert import _qw as to_port_qw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SCHEMES = [("symmetric", 1), ("symmetric", 2), ("symmetric", 4),
           ("asymmetric", 1), ("asymmetric", 2), ("asymmetric", 4),
           ("ternary", 2)]


def _weights(n, k, seed):
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)


@pytest.mark.parametrize("k_group", [1, 2, 4, 8])
@pytest.mark.parametrize("scheme,bits", SCHEMES)
def test_packed_bytes_equal_reference(scheme, bits, k_group):
    w = _weights(24, 64, seed=bits * 10 + k_group)
    jq = JQ.quantize(jnp.asarray(w), bits, k_group=k_group, scheme=scheme)
    tq = TQ.quantize(torch.from_numpy(w), bits, k_group=k_group, scheme=scheme)
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    # the ternary scale is a mean (summation order); the others are exact
    scale_tol = dict(rtol=3e-7, atol=0) if scheme == "ternary" else dict(
        rtol=0, atol=0)
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               **scale_tol)
    if jq.zero_prime is None:
        assert tq.zero_prime is None
    else:
        np.testing.assert_array_equal(tq.zero_prime.numpy(),
                                      np.asarray(jq.zero_prime))
    assert tq.plane_scales == jq.plane_scales
    for got, want in zip(tq.sign_idx(), jq.sign_idx()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(TQ.dequantize(tq).numpy(),
                               np.asarray(JQ.dequantize(jq)), **scale_tol)


def test_pack_unpack_roundtrip_and_plane_slice():
    rng = np.random.default_rng(1)
    for k_group in (1, 2, 4, 8):
        sign = torch.from_numpy(rng.integers(0, 2, (5, 6, 3), dtype=np.uint8))
        idx = torch.from_numpy(rng.integers(0, 1 << (k_group - 1), (5, 6, 3),
                                            dtype=np.uint8))
        packed = TP.pack_group_codes(sign, idx, k_group)
        assert packed.shape[1] == TP.packed_bytes_per_channel(6 * k_group, 3)
        s2, i2 = TP.unpack_group_codes(packed, k_group, 6, 3)
        assert torch.equal(s2, sign) and torch.equal(i2, idx)
    # a plane-sliced view decodes the reference view's planes
    w = _weights(8, 32, seed=2)
    jq = JQ.quantize(jnp.asarray(w), 4, k_group=4).plane_slice(2)
    tq = TQ.quantize(torch.from_numpy(w), 4, k_group=4).plane_slice(2)
    assert tq.is_plane_sliced and tq.plane_scales == jq.plane_scales
    np.testing.assert_array_equal(TQ.dequantize(tq).numpy(),
                                  np.asarray(JQ.dequantize(jq)))


def test_convert_loads_reference_weight_unchanged():
    w = _weights(16, 32, seed=3)
    jq = JQ.quantize(jnp.asarray(w), 2, k_group=4, scheme="asymmetric")
    tq = to_port_qw(jax.tree.map(np.asarray, jq), "cpu")
    np.testing.assert_array_equal(TQ.dequantize(tq).numpy(),
                                  np.asarray(JQ.dequantize(jq)))


def assert_codes_match(got, want, entries, scale):
    """INT8 codes equal, except ±1 where entry/scale lies within a few ulp
    of a rounding tie (see module docstring)."""
    got = got.astype(np.int32)
    want = want.astype(np.int32)
    diff = got != want
    if diff.any():
        q = (entries / scale)[diff]
        frac = np.abs(np.abs(q) - np.floor(np.abs(q)) - 0.5)
        assert np.all(np.abs(got - want)[diff] == 1), "codes differ by > 1"
        assert np.all(frac <= 4 * np.spacing(np.abs(q).astype(np.float32))), (
            f"{diff.sum()} codes differ away from a rounding tie")


@pytest.mark.parametrize("k_group", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", [None, "per_row", "per_group"])
def test_table_matches_reference(mode, k_group):
    a = np.random.default_rng(k_group).normal(size=(9, 64)).astype(np.float32)
    jt = JT.precompute_table(jnp.asarray(a), k_group, mode)
    tt = TT.precompute_table(torch.from_numpy(a), k_group, mode)
    np.testing.assert_allclose(tt.rowsum.numpy(), np.asarray(jt.rowsum),
                               rtol=1e-6, atol=1e-6)
    if mode is None:
        np.testing.assert_allclose(tt.values.numpy(), np.asarray(jt.values),
                                   rtol=0, atol=1e-6)
        return
    np.testing.assert_array_equal(tt.scale.numpy(), np.asarray(jt.scale))
    entries = TT.table_entries(torch.from_numpy(a).reshape(9, -1, k_group),
                               k_group).numpy()
    assert_codes_match(tt.values.numpy(), np.asarray(jt.values), entries,
                       tt.scale.numpy())
    np.testing.assert_array_equal(
        TT.group_absmax(torch.from_numpy(a).reshape(9, -1, k_group)).numpy(),
        np.asarray(JT.group_absmax(jnp.asarray(a).reshape(9, -1, k_group))))
