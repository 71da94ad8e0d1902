"""Port parity, dequant_mpgemm: the port's op (``kernels.ops``; on the CPU
its kernel wrapper runs the plain version) against the reference's Pallas
op in interpret mode, on the same numpy inputs and packed weights. Then a
plain torch emulation of the CUDA kernel's arithmetic (bf16 q', the
activations split into bf16 terms, f32 sums over the split-K ranges, ws in
the epilogue) against both, and the kernel's split-K plan.

Both sides compute in f32 and sum in another order: rtol/atol 1e-4, the
reference kernel's own contract (tests/test_kernels.py).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import quantize as JQ
from repro.kernels import ops as jops
from repro_torch.core.quantize import QuantizedWeight, dequantize, plane_codes
from repro_torch.kernels import dequant_mpgemm as tdq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.lut_mpgemm import MIN_STEPS, SMS, k_ranges
from repro_torch.models.convert import _qw as to_port_qw

# (M, K, N, bits, scheme, k_group): the reference's own cases, run with its
# block sizes there, then shapes that exercise the port's padding (odd M,
# N off the tile, an odd group count) at the reference's default blocks
CASES = [(24, 128, 256, bits, scheme, 4) for scheme, bits in (
    ("symmetric", 1), ("symmetric", 2), ("symmetric", 4), ("asymmetric", 4),
    ("ternary", 2))] + [(8, 64, 128, 2, "symmetric", kg) for kg in (1, 2, 4, 8)]
PAD_CASES = [(13, 76, 130, 2, "symmetric", 4), (5, 12, 40, 1, "symmetric", 4),
             (9, 88, 72, 4, "asymmetric", 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)  # one reference quantization per case
def _inputs(m, k, n, bits, scheme, k_group):
    rng = np.random.default_rng(m * 1000 + k + n + k_group)
    a = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(n, k)).astype(np.float32)
    jq = JQ.quantize(jnp.asarray(w), bits, k_group=k_group, scheme=scheme)
    return a, jq, to_port_qw(jax.tree.map(np.asarray, jq), "cpu")


@pytest.mark.parametrize("case", CASES + PAD_CASES, ids=str)
def test_dequant_mpgemm_matches_reference(case):
    a, jq, tq_w = _inputs(*case)
    blocks = dict(block_m=8, block_n=128, block_g=8) if case in CASES else {}
    want = jops.dequant_mpgemm(jnp.asarray(a), jq, interpret=True, **blocks)
    got = tops.dequant_mpgemm(torch.from_numpy(a), tq_w)
    assert got.shape == (case[0], case[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", CASES[3:4] + PAD_CASES, ids=str)
def test_dequant_op_is_the_f32_dequantized_product(case):
    """Inside the port: the op equals ``a @ dequantize(qw).T`` in f32 (the
    zero point applied outside the kernel's plain version)."""
    a, _, tq_w = _inputs(*case)
    x = torch.from_numpy(a)
    np.testing.assert_allclose(tops.dequant_mpgemm(x, tq_w).numpy(),
                               (x @ dequantize(tq_w).T).numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", CASES[:1] + PAD_CASES, ids=str)
def test_dequant_wrapper_pads_to_the_kernel_tile(case, monkeypatch):
    """ops pads K-groups to bg and channels to BN and leaves x's rows as
    they are, and a K-step starts on a byte of the packed row: what the
    card path's launch checks (``tile_for``, ``plan``,
    csrc/dequant_mpgemm.cu) require."""
    a, _, tq_w = _inputs(*case)
    plain, seen = tdq.dequant_mpgemm_plain, []

    def spy(x, packed, wscale, *, k_group, planes, plane_scales):
        _, _, bn, bg = tdq.tile_for(x.shape[0], k_group)
        gp = x.shape[1] // k_group
        tdq.plan(x.shape[0], packed.shape[0], gp, k_group)  # raises if not
        seen.append((x.shape[0], packed.shape[0] % bn, gp % bg,
                     (bg * planes * k_group) % 8))
        return plain(x, packed, wscale, k_group=k_group, planes=planes,
                     plane_scales=plane_scales)

    monkeypatch.setattr(tdq, "dequant_mpgemm_plain", spy)
    tops.dequant_mpgemm(torch.from_numpy(a), tq_w)
    assert seen == [(case[0], 0, 0, 0)]


def test_dequant_refusals():
    """A plane-sliced view is refused, as by the reference kernel; a tensor
    on neither the CPU nor a CUDA card raises instead of falling back."""
    a, _, tq_w = _inputs(*CASES[2])
    with pytest.raises(NotImplementedError, match="plane-sliced"):
        tops.dequant_mpgemm(torch.from_numpy(a), tq_w.plane_slice(1))
    _, _, bn, bg = tdq.tile_for(24, 4)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdq.dequant_mpgemm(
            torch.empty(24, bg * 4, **meta),
            torch.empty(bn, bg * 4 * 4 // 8, dtype=torch.uint8, **meta),
            torch.empty(bn, **meta), k_group=4, planes=4,
            plane_scales=(1.0, 2.0, 4.0, 8.0))


def test_dequant_empty_shapes():
    """No rows or no channels give an empty product of the right shape,
    without a launch, through the op and the wrapper."""
    a, _, tq_w = _inputs(*CASES[0])
    before = tdq.launches
    assert tops.dequant_mpgemm(torch.from_numpy(a)[:0], tq_w).shape == (
        0, tq_w.n)
    _, _, _, bg = tdq.tile_for(4, 4)
    pw = dict(k_group=4, planes=2, plane_scales=(1.0, 2.0))
    got = tdq.dequant_mpgemm(torch.zeros(4, bg * 4),
                             torch.zeros(0, bg, dtype=torch.uint8),
                             torch.zeros(0), **pw)
    assert got.shape == (4, 0) and got.dtype == torch.float32
    assert tdq.launches == before


def _bf16_terms(a, terms):
    """The kernel's split of f32 activations: t_j is the remainder a − t_0 −
    … − t_{j−1} with its low 16 bits cleared (a bf16 value, exact), each
    remainder exact in f32."""
    out, rest = [], a
    for _ in range(terms):
        t = (rest.view(torch.int32) & -65536).view(torch.float32)
        out.append(t.to(torch.bfloat16))
        assert torch.equal(out[-1].to(torch.float32), t)
        rest = rest - t
    return out


def _emulated_op(x, qw, terms=tdq.PASSES):
    """``ops.dequant_mpgemm`` with the CUDA kernel's arithmetic emulated in
    plain torch: the operands padded as ops pads them, q' in bf16 (exact),
    x split into ``terms`` bf16 terms whose products (exact in f32) are
    summed in f32 over each K-range of the kernel's split-K plan, the ranges'
    sums added in split order, times ws; then the zero point, as ops
    applies it."""
    m, kg = x.shape[0], qw.k_group
    _, bm, bn, bg = tdq.tile_for(m, kg)
    xp = tops._pad_to(x, bg * kg, 1)
    gp = xp.shape[1] // kg
    pk, ws = tops._pad_packed(qw, gp, bn)
    ranges = k_ranges(gp, bg, tdq.plan(m, pk.shape[0], gp, kg)[1])
    q = plane_codes(QuantizedWeight(pk, ws, None, qw.plane_scales,
                                    bits=qw.num_planes, k_group=kg,
                                    k_total=gp * kg, n=pk.shape[0]))
    qb = q.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(qb, q)  # q' is exact in bf16
    split = [t.to(torch.float32) for t in _bf16_terms(xp, terms)]
    acc = None
    for a, b in ranges:
        part = sum(t[:, a * kg:b * kg] @ qb[:, a * kg:b * kg].T for t in split)
        acc = part if acc is None else acc + part
    out = (acc * ws[None, :])[:m, :qw.n]
    return ref.zero_point_correction(out, qw, x.sum(-1))


@functools.lru_cache(maxsize=None)  # one reference run per case
def _reference(case):
    _, jq, _ = _inputs(*case)
    blocks = dict(block_m=8, block_n=128, block_g=8) if case in CASES else {}
    a = _inputs(*case)[0]
    return np.asarray(jops.dequant_mpgemm(jnp.asarray(a), jq, interpret=True,
                                          **blocks))


def _within_tolerance(got, want):
    return np.allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES + PAD_CASES, ids=str)
def test_kernel_arithmetic_matches_reference_and_plain(case):
    """The emulated kernel arithmetic (PASSES bf16 terms, split-K) against
    the reference's Pallas op and the port's plain op, to rtol/atol 1e-4."""
    a, _, tq_w = _inputs(*case)
    x = torch.from_numpy(a)
    got = _emulated_op(x, tq_w).numpy()
    np.testing.assert_allclose(got, _reference(case), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, tops.dequant_mpgemm(x, tq_w).numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("terms", range(1, tdq.PASSES))
def test_fewer_terms_miss_the_tolerance(terms):
    """With fewer bf16 terms than the kernel takes, the same emulation
    misses the 1e-4 tolerance against the reference on at least one case:
    the kernel needs all PASSES terms."""
    misses = [case for case in CASES + PAD_CASES
              if not _within_tolerance(
                  _emulated_op(torch.from_numpy(_inputs(*case)[0]),
                               _inputs(*case)[2], terms).numpy(),
                  _reference(case))]
    assert misses


# tinyllama-1.1b's projections and head (N, K), W2 K=4
SERVE_SHAPES = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632),
                (32000, 2048)]


@pytest.mark.parametrize("shape", [(m, n, k, 4) for m in (1, 4, 17, 64, 128)
                                   for n, k in SERVE_SHAPES]
                         + [(c[0], c[2], c[1], c[5]) for c in CASES + PAD_CASES],
                         ids=str)
def test_split_plan_covers_the_k_steps_once_in_order(shape):
    """The kernel's split-K plan: S contiguous, non-empty, bg-aligned
    ranges, in the kernel's own order (the first steps % S ranges one step
    longer), that cover [0, Gp) exactly once; S the most that keeps the
    grid within one wave of BLOCKS_PER_SM blocks an SM, with at least
    MIN_STEPS steps a range."""
    m, n, k, kg = shape
    _, bm, bn, bg = tdq.tile_for(m, kg)
    np_, gp = -(-n // bn) * bn, -(-(k // kg) // bg) * bg
    (_, bm2, bn2, bg2), s, tiles = tdq.plan(m, np_, gp, kg)
    assert (bm2, bn2, bg2) == (bm, bn, bg) and tiles == -(-m // bm) * np_ // bn
    ranges = k_ranges(gp, bg, s)
    assert len(ranges) == s >= 1
    covered = [g for a, b in ranges for g in range(a, b)]
    assert covered == list(range(gp))
    assert all(b > a and a % bg == 0 and b % bg == 0 for a, b in ranges)
    steps = gp // bg
    q, r = divmod(steps, s)  # csrc/dequant_mpgemm.cu: first, count
    assert ranges == [(bg * (z * q + min(z, r)),
                       bg * (z * q + min(z, r) + q + (z < r)))
                      for z in range(s)]
    slots = SMS * tdq.BLOCKS_PER_SM
    assert s == max(1, min(slots // tiles, steps // MIN_STEPS))
    assert s == 1 or (tiles * s <= slots and steps // s >= MIN_STEPS)
    with pytest.raises(ValueError, match="padded"):
        tdq.plan(m, np_ + 8, gp, kg)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only on the GPU "
                    "(tests/test_torch_cuda.py holds it against its plain "
                    "version there)")
    return torch.device("cuda")


def test_dequant_wrapper_launches_on_cuda_tensors(cuda_device):
    """On a CUDA tensor the op launches the kernel and counts the launch."""
    _, _, tq_w = _inputs(*CASES[0])
    before = tdq.launches
    out = tops.dequant_mpgemm(torch.randn(24, 128, device=cuda_device),
                              tq_w.to(cuda_device))
    assert out.is_cuda and tdq.launches == before + 1
