"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA card (this file imports no JAX):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a card every test skips. Tolerances as in chip_smoke.py: per_row
bit-exact (exact int32 sums, same codes and epilogue), None / per_group
within 1e-4 relative (fp32 sums in another order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.quantize import quantize
from repro_torch.kernels import fused_lut_mpgemm as fk
from repro_torch.kernels import lut_mpgemm as lk
from repro_torch.kernels import ops
from repro_torch.kernels import table_precompute as tk

MODES = [None, "per_row", "per_group"]
# (M, K, N, bits, scheme, k_group): decode and prefill rows, unaligned
# shapes, an odd group count, ternary, asymmetric, k_group 2 and 8
CASES = [(4, 256, 256, 2, "symmetric", 4), (128, 512, 320, 2, "symmetric", 4),
         (13, 72, 130, 2, "symmetric", 4), (8, 12, 16, 1, "symmetric", 4),
         (16, 128, 96, 2, "ternary", 4), (9, 256, 128, 4, "asymmetric", 4),
         (20, 64, 64, 2, "symmetric", 2), (6, 64, 64, 2, "symmetric", 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tq):
    if tq == "per_row":
        assert torch.equal(got, want)
    else:
        scale = want.abs().max().clamp_min(1e-30)
        assert ((got - want).abs().max() / scale).item() <= 1e-4


@pytest.mark.parametrize("tq", MODES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernels_match_plain_versions(cuda, case, tq):
    m, k, n, bits, scheme, kg = case
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    qw = quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
        np.float32)), bits, k_group=kg, scheme=scheme).to(cuda)
    g = k // kg
    _, bm, bn, bg = lk.tile_for(m, kg)
    xp = ops._pad_to(ops._pad_to(x, bm, 0), bg * kg, 1).contiguous()
    pkp, wsp = ops._pad_packed(qw, xp.shape[1] // kg, bn)
    rs = (ops._padded_row_scale(x, g, kg, bm).contiguous()
          if tq == "per_row" else None)
    pw = dict(k_group=kg, planes=qw.num_planes, plane_scales=qw.plane_scales)

    got = tk.table_precompute(xp, kg, tq, rs)
    want = tk.table_precompute_plain(xp, kg, tq, rs)
    assert torch.equal(got[0], want[0])
    if tq == "per_group":
        assert torch.equal(got[1], want[1])
    tv, ts = want
    _close(lk.lut_mpgemm(tv, ts, pkp, wsp, **pw),
           lk.lut_mpgemm_plain(tv, ts, pkp, wsp, **pw), tq)
    fused = fk.fused_lut_mpgemm(xp, rs, pkp, wsp, table_quant=tq, **pw)
    _close(fused, fk.fused_lut_mpgemm_plain(xp, rs, pkp, wsp, table_quant=tq,
                                            **pw), tq)
    if tq == "per_row":  # fused == staged, bit for bit
        assert torch.equal(fused, lk.lut_mpgemm(tv, ts, pkp, wsp, **pw))


def test_launch_counts_and_no_fallback(cuda):
    x = torch.randn(4, 256, device=cuda)
    qw = quantize(torch.randn(64, 256), 2).to(cuda)
    before = (tk.launches, lk.launches, fk.launches)
    ops.lut_mpgemm(x, qw, table_quant="per_row", fusion="staged")
    ops.lut_mpgemm(x, qw, table_quant="per_row", fusion="fused")
    assert (tk.launches, lk.launches, fk.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    with pytest.raises(ValueError):  # a per-row f32 table is refused
        lk.lut_mpgemm(torch.zeros(8, 64, device=cuda),
                      torch.ones(8, 1, device=cuda),
                      torch.zeros(32, 16, dtype=torch.uint8, device=cuda),
                      torch.ones(32, device=cuda), k_group=4, planes=2,
                      plane_scales=(1.0, 2.0))
