"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA card (this file imports no JAX):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a card every test skips. Tolerances as in chip_smoke.py: per_row
bit-exact (exact int32 sums, same codes and epilogue); the bf16
tensor-core paths (the LUT kernels' None / per_group tables and
dequant_mpgemm: values split into three bf16 terms that sum to them
exactly, f32 sums) within 1e-4 of the largest output and within rtol =
atol = 1e-4 of every output, the reference kernels' contract; the plain
versions' matmuls run with TF32 off.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mpgemm as mp
from repro_torch.core.quantize import QuantizedWeight, dequantize, quantize
from repro_torch.core.table import Table
from repro_torch.kernels import _build
from repro_torch.kernels import dequant_mpgemm as dk
from repro_torch.kernels import fused_lut_mpgemm as fk
from repro_torch.kernels import lut_mpgemm as lk
from repro_torch.kernels import ops
from repro_torch.kernels import table_precompute as tk
from repro_torch.models import layers

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
        assert _elementwise(got, want)


def _elementwise(got, want):
    """The reference kernels' contract for f32 sums: each output within
    rtol = atol = 1e-4 (tests/test_kernels.py)."""
    return torch.allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tq", MODES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernels_match_plain_versions(cuda, case, tq):
    m, k, n, bits, scheme, kg = case
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    qw = quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
        np.float32)), bits, k_group=kg, scheme=scheme).to(cuda)
    pw = dict(k_group=kg, planes=qw.num_planes, plane_scales=qw.plane_scales)
    xp, rs, pkp, wsp = _fused_operands(x, qw, tq)

    got = tk.table_precompute(xp, kg, tq, rs)
    want = tk.table_precompute_plain(xp, kg, tq, rs)
    assert torch.equal(got[0], want[0])
    if tq == "per_group":
        assert torch.equal(got[1], want[1])
    staged = _staged_operands(x, qw, tq)
    got = lk.lut_mpgemm(*staged, **pw)
    _close(got, lk.lut_mpgemm_plain(*staged, **pw), tq)
    fused = fk.fused_lut_mpgemm(xp, rs, pkp, wsp, table_quant=tq, **pw)
    _close(fused, fk.fused_lut_mpgemm_plain(xp, rs, pkp, wsp, table_quant=tq,
                                            **pw), tq)
    if tq == "per_row":  # fused == staged, bit for bit
        assert torch.equal(fused[:m, :n], got[:m, :n])
    else:  # the f32 paths take the rows as they are
        assert got.shape[0] == fused.shape[0] == m


def _fused_operands(x, qw, tq):
    """(x, row scale, packed, wscale) of the fused kernel, padded as
    ``ops.fused_lut_mpgemm`` pads them, x's rows as they are: per_row to
    the int path's tile (``fused_lut_mpgemm.int_tile``), None and per_group
    to the f32 paths' (``lut_mpgemm.f32_tile_for``)."""
    m, k = x.shape
    kg = qw.k_group
    g = k // kg
    if tq == "per_row":
        _, _, bn, bg = fk.int_tile(m, kg, qw.num_planes)
        rs = ops._closed_form_row_scale(x, g, kg).contiguous()
    else:
        _, _, bn, bg = lk.f32_tile_for(m, kg, qw.num_planes)
        rs = None
    xp = ops._pad_to(x, bg * kg, 1).contiguous()
    return (xp, rs) + ops._pad_packed(qw, xp.shape[1] // kg, bn)


def _staged_operands(x, qw, tq):
    """The plain table of x, padded with the weights to the staged kernel's
    own tile (``ops.staged_operands``: the int path's for per_row, rows
    padded; the f32 paths' otherwise, rows as they are)."""
    m, k = x.shape
    kg = qw.k_group
    g, e = k // kg, 1 << (kg - 1)
    rs = (ops._closed_form_row_scale(x, g, kg).contiguous()
          if tq == "per_row" else None)
    tv, ts = tk.table_precompute_plain(x, kg, tq, rs)
    table = Table(tv.reshape(m, g, e),
                  None if ts is None else ts.reshape(m, -1, 1), None, kg)
    return ops.staged_operands(table, qw)


# tinyllama-1.1b's projections and head (N, K) at a 128-token prefill
# chunk, W2 K=4, and (640, 1600), whose 25 K-steps split 3, 2, ..., 2
SERVE_SHAPES = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632),
                (32000, 2048), (640, 1600)]


@pytest.mark.parametrize("nk", SERVE_SHAPES, ids=str)
def test_int_path_is_bit_exact_at_the_serve_shapes(cuda, nk):
    """The tensor-core int path with split-K against its plain version,
    bit for bit, at M = 128."""
    n, k = nk
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.normal(size=(128, k)).astype(np.float32)
                         ).to(cuda)
    qw = _random_w2(rng, n, k, cuda)
    staged = _staged_operands(x, qw, "per_row")
    pw = dict(k_group=4, planes=2, plane_scales=qw.plane_scales)
    splits, ranges = lk.split_for(128, n, k // 4,
                                  *lk.int_tile_for(128, 4, 2)[1:])
    assert (splits == 1) == (n == 32000)
    if nk == (640, 1600):
        assert ranges[-1][1] - ranges[-1][0] < ranges[0][1] - ranges[0][0]
    before = lk.launches
    got = lk.lut_mpgemm(*staged, **pw)
    assert lk.launches == before + 1
    assert torch.equal(got, lk.lut_mpgemm_plain(*staged, **pw))


def _random_w2(rng, n, k, device):
    return QuantizedWeight(
        torch.from_numpy(rng.integers(0, 256, (n, k // 4), dtype=np.uint8)
                         ).to(device),
        torch.from_numpy(rng.uniform(1e-3, 1.1e-2, n).astype(np.float32)
                         ).to(device),
        None, (1.0, 2.0), bits=2, k_group=4, k_total=k, n=n)


@pytest.mark.parametrize("nk", SERVE_SHAPES, ids=str)
@pytest.mark.parametrize("m", (1, 3, 4, 16, 17, 64))
def test_fused_int_path_is_bit_exact_at_the_serve_shapes(cuda, m, nk):
    """The fused per_row path (tensor cores, split-K summed inside the one
    launch) against its plain version and the staged kernel, bit for bit,
    across the row tiles' edges (16 x 128 up to 16 rows, 64 x 64 up to 64);
    each call launches once."""
    n, k = nk
    rng = np.random.default_rng(m * 7 + n + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    qw = _random_w2(rng, n, k, cuda)
    pw = dict(k_group=4, planes=2, plane_scales=qw.plane_scales)
    xp, rs, pkp, wsp = _fused_operands(x, qw, "per_row")
    before = fk.launches
    got = fk.fused_lut_mpgemm(xp, rs, pkp, wsp, table_quant="per_row", **pw)
    assert fk.launches == before + 1
    assert got.shape == (m, n)
    assert torch.equal(got, fk.fused_lut_mpgemm_plain(
        xp, rs, pkp, wsp, table_quant="per_row", **pw))
    staged = lk.lut_mpgemm(*_staged_operands(x, qw, "per_row"), **pw)
    assert torch.equal(got, staged[:m, :n])


def test_fused_workspace_is_left_zeroed(cuda):
    """Split-K calls in a row on different shapes (sharing the device's
    workspace and arrival counts) give the bits of each call alone."""
    rng = np.random.default_rng(11)
    cases = []
    for m, (n, k) in ((4, (2048, 2048)), (17, (640, 1600)), (4, (256, 2048)),
                      (64, (2048, 5632))):
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                             ).to(cuda)
        cases.append(_fused_operands(x, _random_w2(rng, n, k, cuda),
                                     "per_row"))
    pw = dict(k_group=4, planes=2, plane_scales=(1.0, 2.0),
              table_quant="per_row")
    alone = []
    for ops_ in cases:
        alone.append(fk.fused_lut_mpgemm(*ops_, **pw))
        torch.cuda.synchronize()
    in_a_row = [fk.fused_lut_mpgemm(*ops_, **pw) for ops_ in cases * 2]
    torch.cuda.synchronize()
    for i, got in enumerate(in_a_row):
        assert torch.equal(got, alone[i % len(cases)])
    for work in fk._workspaces[torch.cuda.current_device()]:
        assert not work.any()


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


def _f32_call(kernel, x, qw, tq):
    """(call, plain call) of one LUT kernel's f32 path on operands padded
    as ops pads them."""
    pw = dict(k_group=qw.k_group, planes=qw.num_planes,
              plane_scales=qw.plane_scales)
    if kernel == "staged":
        staged = _staged_operands(x, qw, tq)
        return (lambda: lk.lut_mpgemm(*staged, **pw),
                lambda: lk.lut_mpgemm_plain(*staged, **pw))
    xp, rs, pkp, wsp = _fused_operands(x, qw, tq)
    pw["table_quant"] = tq
    return (lambda: fk.fused_lut_mpgemm(xp, rs, pkp, wsp, **pw),
            lambda: fk.fused_lut_mpgemm_plain(xp, rs, pkp, wsp, **pw))


@pytest.mark.parametrize("nk", SERVE_SHAPES, ids=str)
@pytest.mark.parametrize("m", (1, 3, 4, 16, 17, 64, 128))
@pytest.mark.parametrize("tq", (None, "per_group"))
@pytest.mark.parametrize("kernel", ("staged", "fused"))
def test_f32_paths_at_the_serve_shapes(cuda, kernel, tq, m, nk):
    """Both LUT kernels' float-table paths (bf16 tensor cores, three terms,
    split-K summed in split order inside the one launch) at tinyllama's
    shapes, across the row tiles' edges: every output within rtol = atol =
    1e-4 of the plain version, one launch a call, two calls the same bits,
    and the arrival counts left zero."""
    n, k = nk
    rng = np.random.default_rng(m * 3 + n + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    qw = _random_w2(rng, n, k, cuda)
    call, plain = _f32_call(kernel, x, qw, tq)
    mod = lk if kernel == "staged" else fk
    before = mod.launches
    got, again = call(), call()
    assert mod.launches == before + 2 and got.shape[0] == m
    assert torch.equal(got, again)
    _close(got, plain(), tq)
    workspace = lk._f32_workspaces.get(torch.cuda.current_device())
    assert workspace is None or not workspace[1].any()


def test_two_lut_terms_miss_the_elementwise_bound(cuda, monkeypatch):
    """Why the f32 paths take three bf16 terms: builds with two
    (-DLUT_TERMS=2) miss the elementwise 1e-4 bound on some case of CASES
    (as tests/test_torch_lut_f32.py's CPU emulation shows they should),
    where the three-term kernels meet it on every case."""
    two = {name: _build.launcher(name, ("-DLUT_TERMS=2",))
           for name in ("lut_mpgemm", "fused_lut_mpgemm")}

    def within(case, kernel, tq):
        m, k, n, bits, scheme, kg = case
        rng = np.random.default_rng(m + k + n)
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                             ).to(cuda)
        qw = quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
            np.float32)), bits, k_group=kg, scheme=scheme).to(cuda)
        call, plain = _f32_call(kernel, x, qw, tq)
        return _elementwise(call(), plain())

    runs = [(case, kernel, tq) for case in CASES
            for kernel in ("staged", "fused") for tq in (None, "per_group")]
    assert all(within(*run) for run in runs)
    with monkeypatch.context() as patch:
        patch.setattr(_build, "launcher", lambda name: two[name])
        misses = {kernel for case, kernel, tq in runs
                  if not within(case, kernel, tq)}
    assert misses == {"staged", "fused"}, (
        "two bf16 terms met the elementwise bound on every case of a kernel")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_dequant_kernel_matches_plain_version(cuda, case):
    """Every scheme and k_group of CASES: the bf16 tensor-core kernel within
    1e-4 of its IEEE f32 plain version, the same bits from a second call,
    and the op (x's rows as they are, padding sliced off, zero point
    outside the kernel) within 1e-4 of the f32 dequantized product."""
    m, k, n, bits, scheme, kg = case
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    qw = quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
        np.float32)), bits, k_group=kg, scheme=scheme).to(cuda)
    _, _, bn, bg = dk.tile_for(m, kg)
    xp = ops._pad_to(x, bg * kg, 1).contiguous()
    pkp, wsp = ops._pad_packed(qw, xp.shape[1] // kg, bn)
    pw = dict(k_group=kg, planes=qw.num_planes, plane_scales=qw.plane_scales)
    before = dk.launches
    got = dk.dequant_mpgemm(xp, pkp, wsp, **pw)
    want = dk.dequant_mpgemm_plain(xp, pkp, wsp, **pw)
    _close(got, want, None)
    assert _elementwise(got, want)
    assert torch.equal(dk.dequant_mpgemm(xp, pkp, wsp, **pw), got)
    # the op: padding sliced off, zero point applied outside the kernel
    _close(ops.dequant_mpgemm(x, qw), x @ dequantize(qw).T, None)
    assert dk.launches == before + 3


@pytest.mark.parametrize("nk", SERVE_SHAPES, ids=str)
@pytest.mark.parametrize("m", (1, 3, 4, 16, 17, 64, 128))
def test_dequant_kernel_at_the_serve_shapes(cuda, m, nk):
    """W2 K=4 (the byte-table decode) at tinyllama's shapes, across the row
    tiles' edges: within 1e-4 of the plain version, one launch a call, and
    back-to-back calls give equal bits, with split-K (S > 1) and without
    (the head)."""
    n, k = nk
    rng = np.random.default_rng(m * 5 + n + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    qw = _random_w2(rng, n, k, cuda)
    pw = dict(k_group=4, planes=2, plane_scales=qw.plane_scales)
    _, _, bn, bg = dk.tile_for(m, 4)
    xp = ops._pad_to(x, bg * 4, 1).contiguous()
    pkp, wsp = ops._pad_packed(qw, xp.shape[1] // 4, bn)
    _, splits, _ = dk.plan(m, pkp.shape[0], xp.shape[1] // 4, 4)
    assert (splits == 1) == (n == 32000)
    before = dk.launches
    got = dk.dequant_mpgemm(xp, pkp, wsp, **pw)
    again = dk.dequant_mpgemm(xp, pkp, wsp, **pw)
    assert dk.launches == before + 2 and got.shape == (m, pkp.shape[0])
    assert torch.equal(got, again)
    want = dk.dequant_mpgemm_plain(xp, pkp, wsp, **pw)
    _close(got, want, None)
    assert _elementwise(got, want)


def test_two_dequant_terms_miss_the_elementwise_bound(cuda, monkeypatch):
    """Why the kernel takes three bf16 terms: a build with two
    (-DDEQUANT_TERMS=2) misses the elementwise 1e-4 bound on some case of
    CASES, where the three-term kernel meets it on every case."""
    two = _build.launcher("dequant_mpgemm", ("-DDEQUANT_TERMS=2",))

    def within(case):
        m, k, n, bits, scheme, kg = case
        rng = np.random.default_rng(m + k + n)
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                             ).to(cuda)
        qw = quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
            np.float32)), bits, k_group=kg, scheme=scheme).to(cuda)
        _, _, bn, bg = dk.tile_for(m, kg)
        xp = ops._pad_to(x, bg * kg, 1).contiguous()
        pkp, wsp = ops._pad_packed(qw, xp.shape[1] // kg, bn)
        pw = dict(k_group=kg, planes=qw.num_planes,
                  plane_scales=qw.plane_scales)
        return _elementwise(dk.dequant_mpgemm(xp, pkp, wsp, **pw),
                            dk.dequant_mpgemm_plain(xp, pkp, wsp, **pw))

    assert all(within(case) for case in CASES)
    with monkeypatch.context() as patch:
        patch.setattr(_build, "launcher", lambda name: two)
        misses = [case for case in CASES if not within(case)]
    assert misses, "two bf16 terms met the elementwise bound on every case"


def test_dequant_op_takes_empty_and_unaligned_inputs(cuda):
    """No rows gives an empty product without a launch; activations that
    start off a 16-byte boundary are copied by the op, not refused."""
    rng = np.random.default_rng(7)
    qw = _random_w2(rng, 256, 512, cuda)
    before = dk.launches
    assert ops.dequant_mpgemm(torch.zeros(0, 512, device=cuda),
                              qw).shape == (0, 256)
    assert dk.launches == before
    x = torch.from_numpy(rng.normal(size=(4 * 512 + 1,)).astype(np.float32)
                         ).to(cuda)[1:].view(4, 512)
    assert x.data_ptr() % 16
    got = ops.dequant_mpgemm(x, qw)
    assert dk.launches == before + 1
    _close(got, x @ dequantize(qw).T, None)


# table_precompute's variants: (table_quant, row scale given)
PRECOMPUTE = [(None, False), ("per_row", True), ("per_row", False),
              ("per_group", False)]
PRECOMPUTE_ROWS = (1, 3, 4, 16, 17, 64, 128, 130)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _precompute_equal(a, kg, tq, given):
    """One table_precompute call on the card against the plain version,
    values and scale bit for bit, one launch counted on its counter only."""
    g = a.shape[1] // kg
    rs = ops._closed_form_row_scale(a, g, kg).contiguous() if given else None
    before = (tk.launches, tk.row_scale_launches)
    values, scale = tk.table_precompute(a, kg, tq, rs)
    assert (tk.launches, tk.row_scale_launches) == (before[0] + 1, before[1])
    want_v, want_s = tk.table_precompute_plain(a, kg, tq, rs)
    assert torch.equal(values, want_v)
    assert (scale is None) == (want_s is None)
    if want_s is not None:
        assert scale.shape == want_s.shape
        assert torch.equal(_bits(scale), _bits(want_s))
    if given:
        assert scale is rs


@pytest.mark.parametrize("variant", PRECOMPUTE, ids=str)
@pytest.mark.parametrize("m", PRECOMPUTE_ROWS)
@pytest.mark.parametrize("k", (2048, 5632))
def test_table_precompute_is_bit_equal_at_the_serve_shapes(cuda, k, m,
                                                           variant):
    """The precompute kernel at the K of SERVE_SHAPES, across one block a
    row at few and many rows: values and scales bit-equal to the plain
    version in every mode, per_row with its scale given or computed in the
    same launch; one launch a call."""
    rng = np.random.default_rng(m * 11 + k)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    _precompute_equal(a, 4, *variant)


@pytest.mark.parametrize("m", PRECOMPUTE_ROWS)
@pytest.mark.parametrize("k", (2048, 5632))
def test_row_scale_is_bit_equal_at_the_serve_shapes(cuda, k, m):
    """The row-scale entry equals the closed form's eight torch kernels on
    the card, bit for bit, in one launch on its own counter."""
    rng = np.random.default_rng(m * 13 + k)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    before = (tk.launches, tk.row_scale_launches)
    got = tk.row_scale(a, 4)
    assert (tk.launches, tk.row_scale_launches) == (before[0], before[1] + 1)
    assert got.shape == (m, 1)
    assert torch.equal(_bits(got), _bits(ops._closed_form_row_scale(
        a, k // 4, 4)))


@pytest.mark.parametrize("case", [(5, 2048, 4), (4, 4000, 4), (6, 64, 2),
                                  (7, 64, 8), (3, 24, 1), (3, 12000, 4),
                                  (3, 20000, 4)], ids=str)
def test_precompute_edge_rows_and_unaligned_activations(cuda, case):
    """An all-zero row (the 1e-30 clamp) and a row whose groups tie, on the
    vector path (one, two and six groups a thread) and on the scalar path
    (k_group 1, 2 and 8, more than 8 groups a thread), from aligned
    activations and from a pointer 4 bytes
    off a 16-byte boundary: every variant and the row scale bit-equal to
    the plain versions."""
    m, k, kg = case
    rng = np.random.default_rng(m + k + kg)
    host = rng.normal(size=(m * k + 1,)).astype(np.float32)
    flat = torch.from_numpy(host).to(cuda)
    for a in (flat[:m * k].view(m, k), flat[1:].view(m, k)):
        a = a.clone() if a.data_ptr() % 16 == 0 else a
        a[0] = 0.0
        a[1] = a[1, :kg].repeat(k // kg)
        for variant in PRECOMPUTE:
            _precompute_equal(a, kg, *variant)
        assert torch.equal(_bits(tk.row_scale(a, kg)), _bits(
            ops._closed_form_row_scale(a, k // kg, kg)))
    assert flat[1:].data_ptr() % 16


def test_precompute_takes_zero_rows(cuda):
    """An activation of no rows (a null data pointer on the card): every
    mode and the row scale return empty results of the right widths with
    no launch counted, and both C entries accept null pointers when there
    is nothing to compute."""
    a = torch.zeros(0, 2048, device=cuda)
    before = (tk.launches, tk.row_scale_launches)
    assert tk.row_scale(a, 4).shape == (0, 1)
    for tq, given in PRECOMPUTE:
        rs = torch.zeros(0, 1, device=cuda) if given else None
        values, scale = tk.table_precompute(a, 4, tq, rs)
        want_v, want_s = tk.table_precompute_plain(a, 4, tq, rs)
        assert values.shape == want_v.shape == (0, 512 * 8)
        assert (scale is None) == (want_s is None)
        if want_s is not None:
            assert scale.shape == want_s.shape
        table = ops.table_precompute(a, 4, tq)
        assert table.values.shape == (0, 512, 8)
    assert (tk.launches, tk.row_scale_launches) == before
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for mode in tk.MODES.values():
        assert _build.launcher("table_precompute")(
            None, None, None, None, 0, 512, 4, mode, stream) == 0
    assert _build.launcher("row_scale")(None, None, 0, 512, 4, stream) == 0


@pytest.mark.parametrize("kg", (2, 4))
def test_precompute_non_finite_rows(cuda, kg):
    """A row holding a NaN gets a NaN scale, one holding an inf (and no
    NaN) an inf scale, from the kernel as from the plain version; the
    finite rows keep their bits and codes."""
    rng = np.random.default_rng(kg)
    a = torch.from_numpy(rng.normal(size=(5, 16 * kg)).astype(np.float32))
    a[1, 3], a[2, 5] = float("nan"), float("inf")
    a[3, 0], a[3, 7] = float("-inf"), float("nan")
    a = a.to(cuda)
    finite = [0, 4]
    want_v, want_s = tk.table_precompute_plain(a, kg, "per_row")
    for rs in (tk.row_scale(a, kg), tk.table_precompute(a, kg, "per_row")[1]):
        assert torch.isnan(rs[1, 0]) and torch.isnan(rs[3, 0])
        assert torch.isinf(rs[2, 0]) and rs[2, 0] > 0
        assert torch.equal(_bits(rs[finite]), _bits(want_s[finite]))
    values = tk.table_precompute(a, kg, "per_row")[0]
    assert torch.equal(values[finite], want_v[finite])
    sg = tk.table_precompute(a, kg, "per_group")[1]
    want_g = tk.table_precompute_plain(a, kg, "per_group")[1]
    assert torch.equal(torch.isnan(sg), torch.isnan(want_g))
    assert torch.equal(torch.isinf(sg), torch.isinf(want_g))
    fin = torch.isfinite(want_g)
    assert torch.equal(sg[fin], want_g[fin])


def test_ops_precompute_and_fused_row_scale_launch_once(cuda):
    """``ops.table_precompute`` per_row is one table launch (the scale
    inside it) plus rowsum's sum; the fused per_row op is one row-scale
    launch and one fused launch; both give the plain paths' bits."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(size=(4, 2048)).astype(np.float32)
                         ).to(cuda)
    qw = _random_w2(rng, 256, 2048, cuda)
    before = (tk.launches, tk.row_scale_launches, fk.launches)
    table = ops.table_precompute(x, 4, "per_row")
    assert (tk.launches, tk.row_scale_launches, fk.launches) == (
        before[0] + 1, before[1], before[2])
    want = mp.precompute_tables(x, 4, "per_row")
    assert torch.equal(table.values, want.values)
    assert torch.equal(_bits(table.scale), _bits(want.scale))
    out = ops.fused_lut_mpgemm(x, qw)
    assert (tk.launches, tk.row_scale_launches, fk.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    xp, rs, pkp, wsp = _fused_operands(x, qw, "per_row")
    assert torch.equal(out, fk.fused_lut_mpgemm_plain(
        xp, rs, pkp, wsp, table_quant="per_row", k_group=4, planes=2,
        plane_scales=qw.plane_scales)[:, :256])


@pytest.mark.parametrize("tq", ("auto", None, "per_row", "per_group"))
def test_make_table_launches_the_kernel(cuda, tq):
    """A shared table of the serve path (staged, "auto" resolved to
    per_row on the card) is one precompute launch with the plain path's
    bits: values, scale and rowsum."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 128, 2048)).astype(np.float32)).to(cuda)
    quant = dict(mpgemm_mode="lut_pallas", table_quant=tq, fusion="staged",
                 k_group=4)
    before = tk.launches
    got = layers.make_table(x, quant)
    assert tk.launches == before + 1
    want = mp.precompute_tables(x, 4, tq)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.rowsum, want.rowsum)
    assert (got.scale is None) == (want.scale is None)
    if want.scale is not None:
        assert torch.equal(_bits(got.scale), _bits(want.scale))


# paper-bitnet-3b's projections and head (N, K): wq/wk/wv/wo, gate/up, down,
# lm_head. K = 8640 is 2160 K-groups: 67.5 of the fused kernel's K-steps of
# 32 groups (padded to 68), 135 of the staged kernel's 16; N = 8640 is 67.5
# tiles of 128 channels (padded to 68)
BITNET_SHAPES = [(3200, 3200), (8640, 3200), (3200, 8640), (32000, 3200)]


@pytest.mark.parametrize("nk", BITNET_SHAPES, ids=str)
@pytest.mark.parametrize("m", (1, 4, 128))
def test_ternary_int_paths_are_bit_exact_at_bitnet_shapes(cuda, m, nk):
    """Ternary weights (BitNet b1.58 absmean, plane scales [1, 1], the
    byte-table CW decode) on both int paths, per_row tables: the fused and
    the staged kernel each equal their plain version and each other bit for
    bit, and the op path (``ops.lut_mpgemm``, fusion auto) gives the same
    bits with one launch of the kernel the fusion rule picks."""
    n, k = nk
    rng = np.random.default_rng(m * 5 + n + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    qw = quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
        np.float32)).to(cuda), 2, scheme="ternary")
    assert tuple(float(s) for s in qw.plane_scales) == (1.0, 1.0)
    pw = dict(k_group=4, planes=2, plane_scales=qw.plane_scales)
    xp, rs, pkp, wsp = _fused_operands(x, qw, "per_row")
    fused = fk.fused_lut_mpgemm(xp, rs, pkp, wsp, table_quant="per_row", **pw)
    assert torch.equal(fused, fk.fused_lut_mpgemm_plain(
        xp, rs, pkp, wsp, table_quant="per_row", **pw))
    staged_ops = _staged_operands(x, qw, "per_row")
    staged = lk.lut_mpgemm(*staged_ops, **pw)
    assert torch.equal(staged, lk.lut_mpgemm_plain(*staged_ops, **pw))
    assert torch.equal(fused[:m, :n], staged[:m, :n])
    before = (fk.launches, lk.launches)
    out = ops.lut_mpgemm(x, qw, table_quant="per_row")
    fused_rule = ops.resolve_dispatch(m, n, k // 4, 4,
                                      2).fusion == "fused"
    assert (fk.launches, lk.launches) == (before[0] + fused_rule,
                                          before[1] + (not fused_rule))
    assert torch.equal(out, fused[:m, :n])


@pytest.mark.parametrize("variant", PRECOMPUTE, ids=str)
@pytest.mark.parametrize("m", (1, 4, 128, 130))
@pytest.mark.parametrize("k", (3200, 8640))
def test_table_precompute_is_bit_equal_at_bitnet_k(cuda, k, m, variant):
    """The precompute kernel at paper-bitnet-3b's K: 800 and 2160 groups
    (the float4 path's <8> instance, 1.6 and 4.2 groups a thread), values and scales bit-equal to the plain version in every mode; one
    launch a call."""
    rng = np.random.default_rng(m * 17 + k)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    _precompute_equal(a, 4, *variant)


@pytest.mark.parametrize("m", (1, 4, 128, 130))
@pytest.mark.parametrize("k", (3200, 8640))
def test_row_scale_is_bit_equal_at_bitnet_k(cuda, k, m):
    """The row-scale entry at paper-bitnet-3b's K equals the closed form bit
    for bit, in one launch on its own counter."""
    rng = np.random.default_rng(m * 19 + k)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    before = (tk.launches, tk.row_scale_launches)
    got = tk.row_scale(a, 4)
    assert (tk.launches, tk.row_scale_launches) == (before[0], before[1] + 1)
    assert torch.equal(_bits(got), _bits(ops._closed_form_row_scale(
        a, k // 4, 4)))



def _reduced_engine(cuda, mode, **kw):
    from repro_torch.configs import registry
    from repro_torch.models import api
    from repro_torch.serving.engine import ServingEngine
    cfg = registry.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode=mode,
                                                   table_quant="per_row")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = api.init_params(gen, cfg, cuda)
    return cfg, params, ServingEngine(cfg, params, max_batch=4, max_seq=64,
                                      decode_chunk=4, prefill_chunk=16, **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_mixed_beam_pool_through_the_kernels_equals_lut_xla(cuda, paged):
    """A beam:2 request and two greedy ones in one pool, through the kernels
    (lut_pallas) and through the plain LUT path (lut_xla), per_row: every
    output, hypothesis and score equal (per_row logits of the two paths are
    bit-equal)."""
    from repro_torch.serving.engine import Request
    kw = dict(cache_block_size=16, prefix_cache=True) if paged else {}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in (9, 21, 16)]
    out = []
    for mode in ("lut_pallas", "lut_xla"):
        _, _, eng = _reduced_engine(cuda, mode, **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=10, decoding=d)
                for i, (p, d) in enumerate(zip(prompts, ("beam:2", "greedy",
                                                         "greedy")))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        assert eng.stats()["host_syncs_per_token"] <= 1 / eng.decode_chunk
        out.append(([r.output for r in reqs], reqs[0].beams))
    assert out[0] == out[1]
    assert len(out[0][1]) == 2


def test_burst_at_the_cache_end_stays_in_range(cuda):
    """A speculative burst of 5 at positions max_seq - 2 and max_seq - 5 on
    the card: no device-side assert, the live prefix untouched, and the
    in-range positions written."""
    from repro_torch.models import layers
    cfg, params, eng = _reduced_engine(cuda, "lut_xla")
    lp = params["layers"][0]["attn"]
    s_cache = eng.max_seq
    leaves = tuple(leaf[0] for leaf in eng.caches)
    for leaf in leaves:
        leaf.normal_()
    before = [leaf.clone() for leaf in leaves]
    cp = torch.tensor([s_cache - 2, s_cache - 5, 3, 0], device=cuda)
    x = torch.randn(4, 5, cfg.d_model, device=cuda)
    layers.attention_apply(lp, x, cfg, kv_cache=leaves, cache_pos=cp,
                           quant=cfg.quant)
    torch.cuda.synchronize()
    for leaf, old in zip(leaves, before):
        for i, c in enumerate(cp.tolist()):
            assert torch.equal(leaf[i, :c], old[i, :c])
            end = min(c + 5, s_cache)
            assert not torch.equal(leaf[i, c:end], old[i, c:end])
            assert torch.equal(leaf[i, end:], old[i, end:])


def test_spec_request_at_the_cache_end_equals_greedy(cuda):
    """plen + max_new_tokens = max_seq under lut_xla on the card: the last
    rounds draft past the cache (no device-side assert), the slot retires
    at max_seq - 1 while a longer spec request drafts over it, and a third
    spec request follows on the same engine; every stream is plain
    greedy's."""
    from repro_torch.serving.engine import Request, ServingEngine
    cfg, params, plain = _reduced_engine(cuda, "lut_xla")
    max_seq = plain.max_seq
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (50, 9, 13)]
    n_new = [max_seq - 50, 24, 12]
    want = []
    for p, n in zip(prompts, n_new):
        r = Request(uid=0, prompt=p, max_new_tokens=n)
        plain.submit(r)
        plain.run_to_completion()
        want.append(r.output)
    eng = ServingEngine(cfg, params, max_batch=4, max_seq=max_seq,
                        decode_chunk=4, prefill_chunk=16, spec_k=4,
                        spec_draft_planes=2)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n,
                    decoding="spec:draft2b")
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    for r in reqs[:2]:
        eng.submit(r)
    eng.run_to_completion()
    assert int(eng.pos[0]) == max_seq - 1
    eng.submit(reqs[2])
    eng.run_to_completion()
    torch.cuda.synchronize()
    assert [r.output for r in reqs] == want
    assert eng.stats()["host_syncs_per_token"] <= 1 / eng.decode_chunk


def test_verify_burst_position_zero_has_the_decode_steps_bits(cuda):
    """Under lut_xla on the card, position 0 of a per-slot s = 5 forward
    (the speculative verify burst) gives the logits of an s = 1 forward
    bit for bit: greedy speculation is plain greedy decoding only so."""
    from repro_torch.serving.engine import Request
    cfg, params, eng = _reduced_engine(cuda, "lut_xla")
    rng = np.random.default_rng(2)
    for i, n in enumerate((9, 21, 16, 30)):
        eng.submit(Request(uid=i, prompt=rng.integers(0, 512, n),
                           max_new_tokens=8))
    eng._admit()
    drafts = torch.as_tensor(rng.integers(0, 512, (4, 4)), device=cuda)
    one = eng._forward(params, eng.last_tok[:, None], eng.pos)[:, 0]
    burst = eng._forward(params, torch.cat([eng.last_tok[:, None], drafts],
                                           dim=1), eng.pos)
    assert torch.equal(one, burst[:, 0])


# (M, N, K, fusion, tile, S): tuned plans whose tile and S differ from
# the heuristic's (per_row, tinyllama's widths): decode M 4 fused on the
# 64x64 tile with S 3 and staged on the 16x128 tile with S 1; prefill M 128
# staged on the 64x64 tile with S 5 and fused on the 128x128 tile with S 2
TUNED_PLANS = [(4, 2048, 2048, "fused", 1, 3), (4, 256, 2048, "staged", 0, 1),
               (128, 5632, 2048, "staged", 1, 5),
               (128, 2048, 5632, "fused", 2, 2)]


@pytest.mark.parametrize("plan", TUNED_PLANS, ids=str)
def test_tuned_plan_launches_once_and_matches_the_heuristic(cuda, plan):
    """A tuned plan (cache hit) launches its kernel once a call, each
    counter once, and gives the heuristic plan's bits on per_row (exact
    int32 sums); within 1e-4 on float tables."""
    from repro_torch.core import autotune
    m, n, k, fusion, tile, splits = plan
    rng = np.random.default_rng(m + n + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    qw = _random_w2(rng, n, k, cuda)
    heur = ops.resolve_dispatch(m, n, k // 4, 4, 2)
    assert (heur.source, heur.tile, heur.splits) == ("heuristic", None, None)
    assert ops.kernel_plan(m, n, k // 4, 4, 2, "per_row", fusion)[::4] != (
        tile, splits)
    for tq in ("per_row", None):
        want = ops.lut_mpgemm(x, qw, table_quant=tq)
        cache = autotune.configure(None)
        try:
            cache.put(autotune.shape_key(m, n, k // 4, 4, 2, table_quant=tq),
                      autotune.TunedConfig(fusion, tile, splits))
            assert ops.resolve_dispatch(m, n, k // 4, 4, 2, fusion="tuned",
                                    table_quant=tq).source == "tuned"
            before = (tk.launches, tk.row_scale_launches, lk.launches,
                      fk.launches)
            got = ops.lut_mpgemm(x, qw, table_quant=tq, fusion="tuned")
            after = (tk.launches, tk.row_scale_launches, lk.launches,
                     fk.launches)
        finally:
            autotune.deactivate()
        fused = fusion == "fused"
        assert tuple(a - b for a, b in zip(after, before)) == (
            int(not fused), int(fused and tq == "per_row"), int(not fused),
            int(fused))
        _close(got, want, tq)


def test_traced_serve_keeps_one_sync_per_chunk(cuda):
    """A serve with a tracer (torch.profiler annotation on) and a dispatch
    recorder gives the untraced serve's tokens and syncs: one decode_chunk
    span per sync, balanced request spans, every dispatch recorded."""
    from repro_torch.obs import dispatch as dispatch_obs
    from repro_torch.obs.trace import Tracer, validate_chrome_trace
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (9, 21, 16, 5, 30)]
    runs = []
    for traced in (False, True):
        tracer = Tracer() if traced else None
        _, _, eng = _reduced_engine(cuda, "lut_pallas", tracer=tracer)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=10)
                for i, p in enumerate(prompts)]
        with dispatch_obs.recording() as rec:
            for r in reqs:
                eng.submit(r)
            eng.run_to_completion()
        st = eng.stats()
        assert st["host_syncs_per_token"] <= 1 / eng.decode_chunk
        runs.append(([r.output for r in reqs], st["decode_syncs"]))
        if traced:
            evs = tracer.chrome_trace()["traceEvents"]
            summary = validate_chrome_trace(evs)
            assert summary["by_phase"]["b"] == summary["by_phase"]["e"] == 5
            assert sum(e["name"] == "decode_chunk" for e in evs) == \
                st["decode_syncs"]
            assert sum(r.count for r in rec.records("dispatch")) > 0
    assert runs[0] == runs[1]


# (E, C, K, N) of the expert-batched kernels: split-K over few experts, an
# odd C with channels padded, C rows at decode (8) and prefill (24) sizes,
# and C past the largest row tile
EXPERT_CASES = [(2, 8, 2048, 128), (6, 24, 256, 320), (5, 3, 512, 256),
                (3, 130, 256, 128)]


def _expert_weights(rng, e, n, k, device):
    from repro_torch.core.quantize import quantize_experts
    w = torch.from_numpy(rng.normal(size=(e, k, n)).astype(np.float32))
    return quantize_experts(w, 2).to(device)


@pytest.mark.parametrize("fusion", ("fused", "staged"))
@pytest.mark.parametrize("tq", MODES)
@pytest.mark.parametrize("case", EXPERT_CASES, ids=str)
def test_batched_kernels_equal_per_expert_launches(cuda, case, tq, fusion):
    """The expert axis of both LUT kernels: x [E, C, K] against E experts'
    weights in one launch of the batched wrapper (and one table or row
    scale launch over the E·Cp rows), equal to E launches of the 2-D
    kernel, one an expert: per_row bit for bit; the bf16 paths within the
    plain version's 1e-4 (their split-K count differs with the rows);
    expert rows with no token (zero rows) give zero outputs."""
    e, c, k, n = case
    rng = np.random.default_rng(e * 100 + c + k + n)
    x = torch.from_numpy(rng.normal(size=(e, c, k)).astype(np.float32)
                         ).to(cuda)
    x[0, c // 2:] = 0.0  # expert 0's empty capacity
    qw = _expert_weights(rng, e, n, k, cuda)
    mod = fk if fusion == "fused" else lk
    before = (mod.launches, mod.batched_launches, tk.launches,
              tk.row_scale_launches)
    got = ops.lut_mpgemm_experts(x, qw, table_quant=tq, fusion=fusion)
    after = (mod.launches, mod.batched_launches, tk.launches,
             tk.row_scale_launches)
    assert after[1] == before[1] + 1 and after[0] == before[0]
    if fusion == "staged":
        assert after[2:] == (before[2] + 1, before[3])
    else:
        assert after[2:] == (before[2], before[3] + (tq == "per_row"))
    assert got.shape == (e, c, n)
    assert not got[0, c // 2:].any()
    per_expert = torch.stack([ops.lut_mpgemm(x[i], qw.expert(i),
                                             table_quant=tq, fusion=fusion)
                              for i in range(e)])
    _close(got, per_expert, tq)
    assert torch.equal(ops.lut_mpgemm_experts(x, qw, table_quant=tq,
                                              fusion=fusion), got)


def test_reduced_olmoe_serve_through_the_kernels_equals_lut_xla(cuda):
    """Reduced olmoe-1b-7b (8 experts, top-2, float attention), per_row:
    the engine's greedy streams through the batched kernels (lut_pallas)
    equal the plain LUT path's (lut_xla), dense and paged, with every
    expert projection a batched launch."""
    from repro_torch.configs import registry
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in (9, 40, 17)]
    out = []
    for mode, kw in (("lut_pallas", {}), ("lut_xla", {}),
                     ("lut_pallas", dict(cache_block_size=16))):
        cfg = registry.get_reduced("olmoe-1b-7b").replace(
            activation_dtype=torch.float32).with_quant(
                mpgemm_mode=mode, table_quant="per_row")
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        params = api.init_params(gen, cfg, cuda)
        eng = ServingEngine(cfg, params, max_batch=4, max_seq=64,
                            decode_chunk=4, prefill_chunk=16, **kw)
        before = fk.batched_launches + lk.batched_launches
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        assert eng.stats()["host_syncs_per_token"] <= 1 / eng.decode_chunk
        launched = fk.batched_launches + lk.batched_launches - before
        assert (launched > 0) == (mode == "lut_pallas")
        out.append([r.output for r in reqs])
    assert out[0] == out[1] == out[2]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_reduced_ssm_forward_through_the_kernels_equals_plain(cuda, arch):
    """Reduced falcon-mamba-7b (Mamba1: in_proj, x_proj with N = 264,
    dt_proj with K = 256 and a bias, out_proj with K = 8192) and zamba2-7b
    (Mamba2, float in/out projections, shared attention), per_row: the
    teacher-forced logits through the kernels (lut_pallas) equal the plain
    LUT path's (lut_xla) bit for bit, a prefill of 10 tokens (chunked scan)
    then a decode step from the caches too."""
    from repro_torch.configs import registry
    from repro_torch.models import api
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, 256, (2, 11)), device=cuda)
    out = {}
    for mode in ("lut_pallas", "lut_xla"):
        cfg = registry.get_reduced(arch).replace(
            activation_dtype=torch.float32).with_quant(
                mpgemm_mode=mode, table_quant="per_row")
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        params = api.init_params(gen, cfg, cuda)
        before = fk.launches + lk.launches
        full = api.forward(params, {"tokens": toks}, cfg)[0]
        caches = api.init_cache(cfg, 2, 16, dtype=torch.float32,
                                device=cuda)
        api.forward(params, {"tokens": toks[:, :10]}, cfg, caches=caches,
                    head=False)
        step = api.forward(params, {"tokens": toks[:, 10:]}, cfg,
                           caches=caches,
                           cache_pos=torch.full((2,), 10, device=cuda))[0]
        assert ((fk.launches + lk.launches - before) > 0) == (
            mode == "lut_pallas")
        assert torch.isfinite(full).all()
        out[mode] = (full, step)
    assert torch.equal(out["lut_pallas"][0], out["lut_xla"][0])
    assert torch.equal(out["lut_pallas"][1], out["lut_xla"][1])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_reduced_ssm_serve_paged_equals_dense_on_the_card(cuda, arch):
    """Reduced falcon-mamba-7b and zamba2-7b served through the kernels
    (per_row) with prefill chunk 4 (right-padded tails): the block-paged
    pool's greedy streams equal the dense engine's, the chunked prefill's
    equal a one-shot prefill's, one sync a decode chunk."""
    from repro_torch.configs import registry
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = registry.get_reduced(arch).replace(
        activation_dtype=torch.float32).with_quant(
            mpgemm_mode="lut_pallas", table_quant="per_row")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = api.init_params(gen, cfg, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n) for n in (9, 30, 17)]
    out = []
    for kw in (dict(prefill_chunk=4), dict(prefill_chunk=4,
                                           cache_block_size=16),
               dict(prefill_chunk=64)):
        eng = ServingEngine(cfg, params, max_batch=2, max_seq=64,
                            decode_chunk=4, **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        assert eng.stats()["host_syncs_per_token"] <= 1 / eng.decode_chunk
        out.append([r.output for r in reqs])
    assert out[0] == out[1]
    assert out[0] == out[2]


def _reduced_cfg(arch, mode):
    from repro_torch.configs import registry
    return registry.get_reduced(arch).replace(
        activation_dtype=torch.float32).with_quant(
            mpgemm_mode=mode, table_quant="per_row")


def _reduced_params(arch, cfg, device):
    """Reduced params from seed 0, a VLM's cross gates set to 0.5 (the
    init leaves them at 0, where a cross layer adds nothing)."""
    from repro_torch.models import api
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = api.init_params(gen, cfg, device)
    for xp in params.get("xattn_layers", []):
        xp["gate_attn"].fill_(0.5)
        xp["gate_mlp"].fill_(0.5)
    return params


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_reduced_xattn_forward_through_the_kernels_equals_plain(cuda, arch):
    """Reduced llama-3.2-vision-11b with image embeddings and whisper-tiny
    with audio frames, per_row: the teacher-forced logits through the
    kernels (lut_pallas) equal the plain LUT path's (lut_xla) bit for bit;
    so do a prefill that carries the inputs into the cache and a decode
    step that reads the cached cross K/V; with tokens only over a zero
    cross K/V (the engine's case) the logits are finite and equal too."""
    from repro_torch.models import api
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, 512, (2, 11)), device=cuda)
    out = {}
    for mode in ("lut_pallas", "lut_xla"):
        cfg = _reduced_cfg(arch, mode)
        params = _reduced_params(arch, cfg, cuda)
        vlm = cfg.family == "vlm"
        key = "image_embeds" if vlm else "audio_frames"
        n = cfg.n_image_tokens if vlm else cfg.n_audio_frames
        gen = torch.Generator(device=cuda)
        gen.manual_seed(4)
        emb = 0.1 * torch.randn(2, n, cfg.d_model, generator=gen,
                                device=cuda)
        before = fk.launches + lk.launches
        full = api.forward(params, {"tokens": toks, key: emb}, cfg)[0]
        caches = api.init_cache(cfg, 2, 16, dtype=torch.float32,
                                device=cuda)
        api.forward(params, {"tokens": toks[:, :10], key: emb}, cfg,
                    caches=caches, head=False)
        step = api.forward(params, {"tokens": toks[:, 10:]}, cfg,
                           caches=caches,
                           cache_pos=torch.full((2,), 10, device=cuda))[0]
        zero_kv = api.init_cache(cfg, 2, 16, dtype=torch.float32,
                                 device=cuda)
        zero = api.forward(params, {"tokens": toks}, cfg, caches=zero_kv)[0]
        assert ((fk.launches + lk.launches - before) > 0) == (
            mode == "lut_pallas")
        assert torch.isfinite(full).all() and torch.isfinite(zero).all()
        out[mode] = (full, step, zero)
    for a, b in zip(out["lut_pallas"], out["lut_xla"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny",
                                  "falcon-mamba-7b", "zamba2-7b"])
def test_reduced_beam_through_the_kernels_equals_plain(cuda, arch):
    """A beam:2 request beside two greedy ones, reduced, per_row: through
    the kernels (lut_pallas) dense and paged (block 16), and through the
    plain LUT path (lut_xla) dense, the greedy streams and the ranked
    hypotheses equal, one sync a decode chunk. Every cache leaf forks
    along its own batch axis (slot-resident cross K/V and SSM state
    included)."""
    from repro_torch.serving.engine import Request, ServingEngine
    rng = np.random.default_rng(0)
    vocab = 256 if arch in ("falcon-mamba-7b", "zamba2-7b") else 512
    prompts = [rng.integers(0, vocab, n) for n in (9, 30, 17)]
    out = []
    for mode, kw in (("lut_pallas", {}),
                     ("lut_pallas", dict(cache_block_size=16)),
                     ("lut_xla", {})):
        cfg = _reduced_cfg(arch, mode)
        params = _reduced_params(arch, cfg, cuda)
        eng = ServingEngine(cfg, params, max_batch=4, max_seq=64,
                            decode_chunk=4, prefill_chunk=8, **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6,
                        decoding="beam:2" if i == 0 else "greedy")
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        assert eng.stats()["host_syncs_per_token"] <= 1 / eng.decode_chunk
        assert len(reqs[0].beams) == 2
        out.append(([r.output for r in reqs[1:]], reqs[0].beams))
    assert out[0] == out[1] == out[2]


def test_int8_cache_decode_step_launches_as_an_f32_one(cuda):
    """The int8 KV cache adds only plain torch ops (quantize, dequantize):
    a decode chunk of reduced tinyllama on CUDA tensors launches the same
    fused lookups and row scales on an int8 cache as on an f32 one, and
    nothing else of the kernels, with no hidden host sync."""
    from repro_torch.serving.engine import Request
    prompts = [np.random.default_rng(0).integers(0, 512, n)
               for n in (9, 21, 16, 5)]
    counts = []
    for dt in ("bf16", "int8"):
        _, _, eng = _reduced_engine(cuda, "lut_pallas", kv_cache_dtype=dt)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
        eng._admit()
        assert len(tuple(eng.caches)) == (4 if dt == "int8" else 2)
        torch.cuda.synchronize()
        before = (fk.launches, tk.row_scale_launches, lk.launches,
                  tk.launches, dk.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._decode_chunk(sampling=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        counts.append(tuple(a - b for a, b in zip(
            (fk.launches, tk.row_scale_launches, lk.launches, tk.launches,
             dk.launches), before)))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][0] == counts[0][1]
    assert counts[0][2:] == (0, 0, 0)


def test_reduced_int8_beam_and_olmoe_spec_on_the_card(cuda):
    """On int8 caches: reduced tinyllama's beam:2 pool through the kernels
    equals lut_xla's; reduced olmoe's beam:1 equals its greedy stream (the
    same s = 1 forwards), and its spec:draft1b (lut_xla) finishes every
    request on a draft of zero extra bytes. Greedy spec is not held to
    greedy here: olmoe's attention projections and router are f32 GEMMs,
    whose bits on the card follow the row count of the burst."""
    from repro_torch.configs import registry
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (9, 21, 16)]
    out = []
    for mode in ("lut_pallas", "lut_xla"):
        _, _, eng = _reduced_engine(cuda, mode, kv_cache_dtype="int8")
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8, decoding=d)
                for i, (p, d) in enumerate(zip(prompts, ("beam:2", "greedy",
                                                         "greedy")))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out.append(([r.output for r in reqs], reqs[0].beams))
    assert out[0] == out[1]
    cfg = registry.get_reduced("olmoe-1b-7b").replace(
        activation_dtype=torch.float32, kv_cache_dtype="int8").with_quant(
            mpgemm_mode="lut_xla", table_quant="per_row")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = api.init_params(gen, cfg, cuda)
    streams, extra = {}, None
    for d in ("greedy", "spec:draft1b", "beam:1"):
        eng = ServingEngine(cfg, params, max_batch=4, max_seq=64,
                            decode_chunk=4, prefill_chunk=16, spec_k=3,
                            spec_draft_planes=1)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8, decoding=d)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        assert all(r.done and len(r.output) == 8 for r in reqs)
        streams[d] = [r.output for r in reqs]
        if d.startswith("spec"):
            extra = eng.stats()["spec"]["draft_extra_hbm_bytes"]
    assert streams["beam:1"] == streams["greedy"] and extra == 0


# the scans' own leaves: their gradients reach them through the recurrence
TRAIN_SCAN_LEAVES = ("A_log", "D", "conv_w", "conv_b", "dt_proj")


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_train_family_step_on_the_card_equals_the_cpu(cuda, arch):
    """One QAT momentum step (lr 1e-2) of each reduced training family on
    the card against the same step on the CPU, same float params (made on
    the CPU, the VLM's gates 0.5) and batch (2 × 8 tokens, the frontends'
    inputs normal × 0.1): losses within 1e-5 relative, the grad norm
    within 1e-4, each leaf's gradient within 1e-4 of its largest
    |gradient| (the scans' own leaves 1e-3; tests/test_torch_train_
    families.py's bounds). The step moves a param by lr × its gradient,
    so the params are held to rtol = atol = 1e-5 plus lr × the leaf's
    gradient bound (zamba2's embedding gradient is large enough that
    its bound moves a param by more than 1e-5)."""
    from repro_torch.configs import registry
    from repro_torch.core.tree import tree_map, tree_paths
    from repro_torch.models import api
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_loop import make_train_step
    cfg = registry.get_reduced(arch).replace(activation_dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(2)
    params = api.init_params(gen, cfg, "cpu", serve_quantized=False)
    for xp in params.get("xattn_layers", []):
        xp["gate_attn"].fill_(0.5)
        xp["gate_mlp"].fill_(0.5)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 8))
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    for fam, key, n in (("vlm", "image_embeds", cfg.n_image_tokens),
                        ("audio", "audio_frames", cfg.n_audio_frames)):
        if cfg.family == fam:
            batch[key] = (rng.normal(size=(2, n, cfg.d_model))
                          * 0.1).astype(np.float32)
    opt = O.make_optimizer("momentum", lr=1e-2)
    step = make_train_step(cfg, opt, qat=True)
    def run(dev):
        p = tree_map(lambda t: t.to(dev), params)
        return step({"params": p, "opt": opt.init(p),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=dev)}, batch)

    (cs, cm), (gs, gm) = run("cpu"), run(cuda)
    for k in cm:
        tol = 1e-4 if k == "grad_norm" else 1e-5
        assert abs(float(gm[k]) - float(cm[k])) <= tol * abs(float(cm[k])), k
    bound = {}
    for (name, got), (_, want) in zip(tree_paths(gs["opt"]["m"]),
                                      tree_paths(cs["opt"]["m"])):
        tol = (1e-3 if any(f"['{k}']" in name for k in TRAIN_SCAN_LEAVES)
               else 1e-4)
        scale = want.abs().max().item()
        assert scale > 0, name
        err = (got.cpu() - want).abs().max().item()
        assert err <= tol * scale, (name, err / scale)
        bound[name] = tol * scale
    for (name, got), (_, want) in zip(tree_paths(gs["params"]),
                                      tree_paths(cs["params"])):
        assert torch.allclose(got.cpu(), want, rtol=1e-5,
                              atol=1e-5 + 1e-2 * bound[name]), name


def test_train_family_adamw8bit_on_the_card_equals_the_cpu(cuda):
    """The 8-bit AdamW (lr 1e-3; m and v of leaves of 2048 or more as INT8
    codes in blocks of 2048 with f32 scales) applied on the card and on
    the CPU to the same two steps of reduced falcon-mamba-7b: its float
    params and its QAT gradients of two batches of 2 × 8 tokens, computed
    on the CPU, the second batch without the first's half of the
    vocabulary (embedding rows with no gradient, where the reference's
    INT8 v of 0 makes the update lr · m / eps). Every m and v code equal,
    their scales and the params within rtol = atol = 1e-5, after each
    step. The gradients are given, not taken on each device, and clipping
    is off: where v's code is 0, lr · m / sqrt(v) turns a gradient's last
    bits (the card sums in another order; the momentum test holds its
    gradients and norm) into a large move, and a code one off into a
    move of a sizeable share of the param."""
    from repro_torch.configs import registry
    from repro_torch.core.tree import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)
    from repro_torch.models import api
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_loop import make_loss_fn
    cfg = registry.get_reduced("falcon-mamba-7b").replace(
        activation_dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(2)
    params = api.init_params(gen, cfg, "cpu", serve_quantized=False)
    rng = np.random.default_rng(3)
    half = cfg.vocab_size // 2
    loss_fn = make_loss_fn(cfg.with_quant(qat=True))
    opt = O.make_optimizer("adamw8bit", lr=1e-3, grad_clip=None)
    state = opt.init(params)
    card = tree_map(lambda t: t.to(cuda), (params, state))
    n_codes = 0
    for lo in (0, half):
        tokens = torch.as_tensor(rng.integers(lo, lo + half, size=(2, 9)))
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = loss_fn(tree_unflatten(params, leaves),
                          {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
        grads = tree_unflatten(params, list(torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)))
        params, state = opt.update(grads, state, params)
        card = opt.update(tree_map(lambda t: t.to(cuda), grads), card[1],
                          card[0])
        for mv in ("m", "v"):
            for (name, got), (_, want) in zip(tree_paths(card[1][mv]),
                                              tree_paths(state[mv])):
                if got.dtype == torch.int8:
                    n_codes += got.numel()
                    assert torch.equal(got.cpu(), want), (lo, mv, name)
                else:
                    assert torch.allclose(got.cpu(), want, rtol=1e-5,
                                          atol=1e-5), (lo, mv, name)
        for (name, got), (_, want) in zip(tree_paths(card[0]),
                                          tree_paths(params)):
            assert torch.allclose(got.cpu(), want, rtol=1e-5,
                                  atol=1e-5), (lo, name)
    assert n_codes > 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b"])
def test_rolling_cache_decode_through_the_kernels_equals_lut_xla(cuda, arch):
    """A rolling window cache (window 8, s_cache 32) past the wrap: a
    6-token prefill, then s = 1 steps at positions 6..12 through the
    kernels (lut_pallas, per_row) and through lut_xla, from one cache
    state: logits equal bit for bit at every step, the kernels launched."""
    from repro_torch.configs import registry
    from repro_torch.core.tree import tree_map
    from repro_torch.models import api
    cfg = registry.get_reduced(arch).replace(
        activation_dtype=torch.float32).with_quant(table_quant="per_row")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = api.init_params(gen, cfg, cuda)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, 256, (2, 13)), device=cuda)
    cache = api.init_cache(cfg, 2, 32, torch.float32, cuda, window=8)
    c_x = cfg.with_quant(mpgemm_mode="lut_xla")
    api.forward(params, {"tokens": toks[:, :6]}, c_x, caches=cache,
                window=8)
    for p in range(6, 13):
        outs = {}
        for mode in ("lut_pallas", "lut_xla"):
            clone = tree_map(lambda t: t.clone(), cache)
            before = fk.launches
            outs[mode] = api.forward(
                params, {"tokens": toks[:, p:p + 1]},
                cfg.with_quant(mpgemm_mode=mode), caches=clone,
                cache_pos=p, window=8)[0]
            assert (fk.launches > before) == (mode == "lut_pallas")
        assert torch.isfinite(outs["lut_xla"]).all()
        assert torch.equal(outs["lut_pallas"], outs["lut_xla"]), p
        api.forward(params, {"tokens": toks[:, p:p + 1]}, c_x, caches=cache,
                    cache_pos=p, window=8)


def test_cw_tree_is_refused_by_the_kernels_on_the_card(cuda):
    """A CW-store tree on the card: lut_xla serves it with the packed
    tree's logits; an engine under lut_pallas refuses it, and so does the
    mpGEMM op."""
    from repro_torch.configs import registry
    from repro_torch.models import api
    from repro_torch.models import quantized as qz
    from repro_torch.serving.engine import ServingEngine
    cfg = registry.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode="lut_xla",
                                                   table_quant="per_row")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = api.init_params(gen, cfg, cuda)
    cw = qz.to_cw_params(params)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, 256, (2, 9)), device=cuda)
    assert torch.equal(api.forward(cw, {"tokens": toks}, cfg)[0],
                       api.forward(params, {"tokens": toks}, cfg)[0])
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=32)
    assert not qz.has_cw(eng.params)  # nothing converted on the card
    with pytest.raises(ValueError, match="offline-CW"):
        ServingEngine(cfg.with_quant(mpgemm_mode="lut_pallas"), cw,
                      max_batch=2, max_seq=32)
    qw = cw["layers"][0]["attn"]["wq"]["qw"]
    with pytest.raises(ValueError, match="offline-CW"):
        mp.mpgemm(torch.randn(2, qw.k_total, device=cuda), qw,
                  mode="lut_pallas")


def _collectives_probe(ctx):
    """Every op of ``distributed.collectives`` on this rank's device, of
    values that say which rank sent them."""
    from repro_torch.distributed import collectives
    r, out = ctx["plan"].rank_along("model"), {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((5,), float(r + 1), dtype=dtype, device=ctx["device"])
        for op in ("sum", "max"):
            out[f"all_reduce_{op}_{dtype}"] = collectives.all_reduce(x, op)
    for dtype in (torch.float32, torch.int64):
        x = torch.full((2, 3), r + 1, dtype=dtype, device=ctx["device"])
        out[f"all_gather_{dtype}"] = collectives.all_gather(x, dim=0)
    return {k: v.cpu() for k, v in out.items()}, collectives.counters()


def test_gloo_collectives_take_card_tensors(cuda, monkeypatch):
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    card; the ranks see only the first card): all_reduce (sum and max, f32
    and bf16) and all_gather (f32 and int64) of tensors on the card give
    every rank the right values."""
    import os
    from repro_torch.launch import mesh, mesh_job
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    res = mesh.spawn(mesh_job.run, 2, args=([{"probes": {
        "collectives": (_collectives_probe, ())}}],))
    for (out,) in res:
        assert out["backend"] == "gloo" and out["device"] == "cuda:0"
        c, counters = out["probes"]["collectives"]
        for dtype in (torch.float32, torch.bfloat16):
            assert c[f"all_reduce_sum_{dtype}"].tolist() == [3.0] * 5
            assert c[f"all_reduce_max_{dtype}"].tolist() == [2.0] * 5
        for dtype in (torch.float32, torch.int64):
            assert c[f"all_gather_{dtype}"].tolist() == [[1] * 3] * 2 + [
                [2] * 3] * 2
        assert counters["calls"] == 4 + 2


def _data_collectives_probe(ctx):
    """The data axis's ops on this rank's card tensors, of values that say
    which data rank sent them."""
    from repro_torch.distributed import collectives
    d, out = ctx["plan"].rank_along("batch"), {}
    for dtype in (torch.float32, torch.int64):
        x = torch.full((2, 3), d + 1, dtype=dtype, device=ctx["device"])
        out[f"all_gather_{dtype}"] = collectives.all_gather(x, dim=0,
                                                            axis="data")
        out[f"all_reduce_{dtype}"] = collectives.all_reduce(x, axis="data")
    return {k: v.cpu() for k, v in out.items()}, collectives.counters()


def test_gloo_train_mesh_on_the_card(cuda, monkeypatch):
    """Two ranks on one card over gloo train reduced tinyllama
    (tests/test_torch_train_mesh.py's rank worker): 3 AdamW steps at 2x1
    with and without FSDP equal bit for bit (deterministic kernels), and
    a 1x2 step's gathered gradients within 1e-4 of each leaf's largest
    |g| of one device's on the card. A card's backward runs on autograd's
    own thread, away from the plan: every collective's backward must
    reach its group."""
    import os
    import test_torch_train_mesh as TM
    from repro_torch.core.tree import tree_map, tree_paths
    from repro_torch.launch import mesh
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as T
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    jobs = [(f"adamw_{on}", 2, on, "adamw", 3, None, None, False, None)
            for on in (False, True)]
    jobs.append(("grads", 1, True, "momentum", 1, None, None, True, None))
    res = mesh.spawn(TM._rank_train, 2, args=(jobs,))
    for r in res:
        assert r["adamw_True"]["metrics"] == r["adamw_False"]["metrics"]
        assert TM._equal(r["adamw_True"]["state"], r["adamw_False"]["state"])
    cfg = TM._cfg()
    opt = O.make_optimizer("momentum", lr=TM.LR["momentum"])
    state = tree_map(lambda t: t.to(cuda), TM._whole_state(cfg, opt))
    want, _ = T.make_train_step(cfg, opt).grads(state, TM._batch(0, cfg))
    for (path, w), g in zip(tree_paths(want), res[0]["grads"]["grads"]):
        w = w.cpu()
        assert (g - w).abs().max() <= 1e-4 * w.abs().max(), path


def test_gloo_data_axis_collectives_and_a_2x1_forward(cuda, monkeypatch):
    """Two data ranks on one card over gloo: the data axis's all_gather
    and all_reduce of f32 and int64 card tensors (blocks in data order,
    counted under "data"), and a per_row forward of reduced tinyllama
    through the kernels, each rank building its own blocks
    (``mesh_job``'s ``build``) and running its row of the batch, equal
    bit for bit to the 2x1 one-device control's."""
    import os
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh, mesh_job, serve
    from repro_torch.models import api
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    cfg = registry.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode="lut_pallas",
                                                   table_quant="per_row")
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 12)))
    res = mesh.spawn(mesh_job.run, 2, args=([
        {"probes": {"collectives": (_data_collectives_probe, ())}},
        {"cfg": cfg, "build": True, "forwards": {"per_row": (cfg, toks)}}],
        2))
    for out, fwd in res:
        assert out["backend"] == "gloo" and out["device"] == "cuda:0"
        c, counters = out["probes"]["collectives"]
        for dtype in (torch.float32, torch.int64):
            assert c[f"all_gather_{dtype}"].tolist() == [[1] * 3] * 2 + [
                [2] * 3] * 2
            assert c[f"all_reduce_{dtype}"].tolist() == [[3] * 3] * 2
        assert counters["by_axis"]["data"]["calls"] == 4
        assert counters["by_axis"]["model"]["calls"] == 0
        assert torch.equal(fwd["forwards"]["per_row"],
                           res[0][1]["forwards"]["per_row"])
    params = serve.build_params(cfg, cuda, True)
    plan = sharding.AxisPlan(sharding.Mesh(("data", "model"), (2, 1), (0, 0),
                                           {}))
    want = api.forward(sharding.one_device_control(params, plan, cfg),
                       {"tokens": toks.to(cuda)}, cfg)[0]
    assert torch.equal(res[0][1]["forwards"]["per_row"], want.cpu())
