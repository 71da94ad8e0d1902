"""Port parity, dequant_mpgemm: the port's op (``kernels.ops``; on the CPU
its kernel wrapper runs the plain version) against the reference's Pallas
op in interpret mode, on the same numpy inputs and packed weights.

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
from repro_torch.core.quantize import dequantize
from repro_torch.kernels import dequant_mpgemm as tdq
from repro_torch.kernels import ops as tops
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
    """ops pads rows to BM, K-groups to bg and channels to BN, and a K-step
    starts on a byte of the packed row: what the card path's launch checks
    (``tile_for``, csrc/dequant_mpgemm.cu) require."""
    a, _, tq_w = _inputs(*case)
    plain, seen = tdq.dequant_mpgemm_plain, []

    def spy(x, packed, wscale, *, k_group, planes, plane_scales):
        _, bm, bn, bg = tdq.tile_for(x.shape[0], k_group)
        gp = x.shape[1] // k_group
        seen.append((x.shape[0] % bm, packed.shape[0] % bn, gp % bg,
                     (bg * planes * k_group) % 8))
        return plain(x, packed, wscale, k_group=k_group, planes=planes,
                     plane_scales=plane_scales)

    monkeypatch.setattr(tdq, "dequant_mpgemm_plain", spy)
    tops.dequant_mpgemm(torch.from_numpy(a), tq_w)
    assert seen == [(0, 0, 0, 0)]


def test_dequant_refusals():
    """A plane-sliced view is refused, as by the reference kernel; a tensor
    on neither the CPU nor a CUDA card raises instead of falling back."""
    a, _, tq_w = _inputs(*CASES[2])
    with pytest.raises(NotImplementedError, match="plane-sliced"):
        tops.dequant_mpgemm(torch.from_numpy(a), tq_w.plane_slice(1))
    _, bm, bn, bg = tdq.tile_for(24, 4)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdq.dequant_mpgemm(
            torch.empty(bm, bg * 4, **meta),
            torch.empty(bn, bg * 4 * 4 // 8, dtype=torch.uint8, **meta),
            torch.empty(bn, **meta), k_group=4, planes=4,
            plane_scales=(1.0, 2.0, 4.0, 8.0))


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
