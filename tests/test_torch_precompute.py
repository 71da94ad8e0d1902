"""The table precompute with its row scale in one launch, on the CPU: the
plain versions the CUDA kernel (``csrc/table_precompute.cu``) is held to,
an emulation of the kernel's row-scale reduction, the serve path's shared
tables, and the per_row precompute with no given scale against the
reference's Pallas wrapper in interpret mode.

Tolerances: the port's own versions must agree bit for bit (the same sums
in the same order; a max is exact in any order). Against the reference the
scale holds 2.4e-7 relative and the codes may differ by one at a rounding
tie, as in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.core import mpgemm as mp
from repro_torch.core import table as TT
from repro_torch.core.quantize import quantize
from repro_torch.kernels import fused_lut_mpgemm as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import table_precompute as ttp
from repro_torch.models import layers

from test_torch_core import assert_codes_match

MODES = [None, "per_row", "per_group"]
# (M, K, k_group): aligned, unaligned, one group a row, every k_group
SHAPES = [(8, 64, 4), (13, 72, 4), (5, 4, 4), (9, 64, 2), (6, 24, 1),
          (7, 64, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _acts(m, k, seed=0):
    return torch.from_numpy(np.random.default_rng(seed + m * 100 + k).normal(
        size=(m, k)).astype(np.float32))


def _with_edge_rows(a, k_group):
    """a with an all-zero row and a row whose groups tie on Σ|a|."""
    a = a.clone()
    a[0] = 0.0
    if a.shape[0] > 1:
        a[1] = a[1, :k_group].repeat(a.shape[1] // k_group)
    return a


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_per_row_computes_the_closed_form_scale(shape):
    """No given scale: the plain precompute uses ``_closed_form_row_scale``
    and returns it, values and scale bit for bit."""
    m, k, kg = shape
    a = _with_edge_rows(_acts(m, k), kg)
    rs = tops._closed_form_row_scale(a, k // kg, kg)
    got_v, got_s = ttp.table_precompute_plain(a, kg, "per_row")
    want_v, want_s = ttp.table_precompute_plain(a, kg, "per_row", rs)
    assert torch.equal(got_v, want_v)
    assert torch.equal(_bits(got_s), _bits(want_s))
    assert got_s.shape == (m, 1)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cpu_wrappers_run_the_plain_versions(shape):
    """On a CPU tensor ``row_scale`` and ``table_precompute`` (no scale
    given) give the plain versions' bits and count no launch."""
    m, k, kg = shape
    a = _with_edge_rows(_acts(m, k, 1), kg)
    before = (ttp.launches, ttp.row_scale_launches)
    rs = ttp.row_scale(a, kg)
    assert torch.equal(_bits(rs), _bits(tops._closed_form_row_scale(
        a, k // kg, kg)))
    for tq in MODES:
        got = ttp.table_precompute(a, kg, tq)
        want = ttp.table_precompute_plain(a, kg, tq)
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert (ttp.launches, ttp.row_scale_launches) == before


def _max_nan(a, b):
    """The kernel's max: a NaN on either side wins (csrc: max_nan)."""
    return torch.where(torch.isnan(a) | (a > b), a, b)


def _emulated_row_scale(a, k_group, threads, warp, order):
    """The kernel's reduction in torch: thread t takes groups t, t+T, ...
    (a group's Σ|a| summed in order), keeps a max from 0, the warps reduce
    by xor shuffles, and the warp maxes merge in ``order``; then
    max(·, 1e-30) / 127 with a NaN kept."""
    m, k = a.shape
    g = k // k_group
    sums = TT.group_absmax(a.reshape(m, g, k_group))  # [M, G], in order
    pad = -g % threads
    sums = torch.cat([sums, torch.zeros(m, pad)], 1)
    part = torch.zeros(m, threads)
    for i in range(sums.shape[1] // threads):
        part = _max_nan(part, sums[:, i * threads:(i + 1) * threads])
    lanes = part.reshape(m, threads // warp, warp)
    o = warp // 2
    while o:
        idx = torch.arange(warp) ^ o
        lanes = _max_nan(lanes, lanes[:, :, idx])
        o //= 2
    warps = lanes[:, :, 0]
    v = warps[:, order[0]]
    for w in order[1:]:
        v = _max_nan(v, warps[:, w])
    v = torch.where(v < 1e-30, torch.full_like(v, 1e-30), v)
    return TT.true_divide(v, 127.0)[:, None]


@pytest.mark.parametrize("shape", SHAPES + [(4, 5632, 4), (3, 2048, 4)],
                         ids=str)
def test_kernel_reduction_equals_the_closed_form(shape):
    """Per-thread maxes, warp shuffles and the warps merged in order,
    reversed or shuffled give the closed form's bits, zero rows (the 1e-30
    clamp) and ties included."""
    m, k, kg = shape
    a = _with_edge_rows(_acts(m, k, 2), kg)
    want = _bits(tops._closed_form_row_scale(a, k // kg, kg))
    rng = np.random.default_rng(k)
    for threads, warp in ((8, 4), (64, 32), (512, 32)):
        w = threads // warp
        for order in (list(range(w)), list(reversed(range(w))),
                      list(rng.permutation(w))):
            got = _emulated_row_scale(a, kg, threads, warp, order)
            assert torch.equal(_bits(got), want)


def _non_finite(k_group):
    a = _acts(5, 16 * k_group, 3)
    a[1, 3] = float("nan")
    a[2, 5] = float("inf")
    a[3, 0], a[3, 7] = float("-inf"), float("nan")
    return a


@pytest.mark.parametrize("kg", [2, 4])
def test_non_finite_rows_give_nan_and_inf_scales(kg):
    """A row holding a NaN gets a NaN scale, one holding an inf (and no
    NaN) an inf scale, in the plain version and in the emulated kernel
    reduction; the finite rows keep the bits they have alone, and their
    codes are unchanged."""
    a = _non_finite(kg)
    g = a.shape[1] // kg
    finite = [0, 4]
    alone_v, alone_s = ttp.table_precompute_plain(a[finite], kg, "per_row")
    for rs in (ttp.row_scale(a, kg),
               _emulated_row_scale(a, kg, 8, 4, [1, 0]),
               ttp.table_precompute(a, kg, "per_row")[1]):
        assert torch.isnan(rs[1, 0]) and torch.isnan(rs[3, 0])
        assert torch.isinf(rs[2, 0]) and rs[2, 0] > 0
        assert torch.equal(_bits(rs[finite]), _bits(alone_s))
    values, _ = ttp.table_precompute(a, kg, "per_row")
    assert torch.equal(values[finite], alone_v)
    _, sg = ttp.table_precompute(a, kg, "per_group")
    assert torch.isnan(sg[1, 3 // kg]) and torch.isnan(sg[3, 7 // kg])
    assert torch.isinf(sg[2, 5 // kg]) and torch.isinf(sg[3, 0])
    assert int(torch.isnan(sg).sum()) == 2 and int(torch.isinf(sg).sum()) == 2
    assert torch.isfinite(sg[finite]).all() and sg.shape == (5, g)


@pytest.mark.parametrize("tq", ["auto", None, "per_row", "per_group"])
@pytest.mark.parametrize("lead", [(1, 9), (2, 5), (4, 1)], ids=str)
def test_make_table_through_the_kernel_wrapper(lead, tq, monkeypatch):
    """``make_table`` under lut_pallas (staged) goes through
    ``ops.table_precompute`` once, on x flattened to [M, K], with
    ``table_quant`` resolved ("auto" is no kernel mode); on the CPU its
    Table equals ``mp.precompute_tables``' bit for bit: values, scale and
    rowsum."""
    x = torch.from_numpy(np.random.default_rng(len(lead)).normal(
        size=lead + (64,)).astype(np.float32))
    quant = dict(mpgemm_mode="lut_pallas", table_quant=tq, fusion="staged",
                 k_group=4)
    calls = []
    orig = tops.table_precompute

    def spy(a, k_group, table_quant):
        calls.append((tuple(a.shape), k_group, table_quant))
        return orig(a, k_group, table_quant)

    monkeypatch.setattr(tops, "table_precompute", spy)
    before = ttp.launches
    got = layers.make_table(x, quant)
    want = mp.precompute_tables(x, 4, tq)
    assert calls == [((int(np.prod(lead)), 64), 4,
                      mp.resolve_table_quant(tq, x.device))]
    assert torch.equal(got.values, want.values)
    assert torch.equal(_bits(got.rowsum), _bits(want.rowsum))
    assert (got.scale is None) == (want.scale is None)
    if want.scale is not None:
        assert got.scale.shape == want.scale.shape
        assert torch.equal(_bits(got.scale), _bits(want.scale))
    assert got.k_group == want.k_group and ttp.launches == before
    xla = layers.make_table(x, dict(quant, mpgemm_mode="lut_xla"))
    assert torch.equal(xla.values, want.values)


def test_make_table_skips_the_fused_path():
    """No shared table where the fused kernel runs (it builds its own)."""
    x = torch.zeros(1, 4, 64)
    assert layers.make_table(x, dict(mpgemm_mode="lut_pallas",
                                     fusion="fused")) is None


@pytest.mark.parametrize("m", [1, 4, 13])
def test_fused_row_scale_of_the_padded_rows(m):
    """The fused path takes the row scale of x padded to its tile: the
    zero groups leave the closed form of x alone unchanged, bit for bit,
    and the op's output equals the plain fused path on that scale."""
    k = 72
    x = _with_edge_rows(_acts(m, k, 4), 4) if m > 1 else _acts(m, k, 4)
    qw = quantize(torch.from_numpy(np.random.default_rng(m).normal(
        size=(40, k)).astype(np.float32)), 2)
    _, _, bn, bg = tfused.int_tile(m, 4, 2)
    xp = tops._pad_to(x, bg * 4, 1).contiguous()
    assert xp.shape[1] > k
    rs = tops._closed_form_row_scale(x, k // 4, 4)
    assert torch.equal(_bits(ttp.row_scale(xp, 4)), _bits(rs))
    pk, ws = tops._pad_packed(qw, xp.shape[1] // 4, bn)
    want = tfused.fused_lut_mpgemm_plain(
        xp, rs, pk, ws, k_group=4, table_quant="per_row", planes=2,
        plane_scales=qw.plane_scales)[:m, :40]
    assert torch.equal(tops.fused_lut_mpgemm(x, qw), want)


def test_wrappers_refuse_other_devices_and_bad_operands():
    """No quiet fallback: a device that is neither CPU nor CUDA raises, as
    do operands the kernels do not take; the fused kernel still needs its
    row scale."""
    meta = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ttp.row_scale(meta, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        ttp.table_precompute(meta, 4, "per_row")
    with pytest.raises(ValueError, match="divisible"):
        ttp.row_scale(torch.zeros(4, 6), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ttp.row_scale(torch.zeros(64, 4).T, 4)
    with pytest.raises(ValueError, match="row scale"):
        ttp.table_precompute(torch.zeros(4, 64), 4, "per_row",
                             torch.zeros(3, 1))
    with pytest.raises(ValueError, match="row scale"):
        tfused.fused_lut_mpgemm(torch.zeros(4, 64), None,
                                torch.zeros(8, 32, dtype=torch.uint8),
                                torch.ones(8), k_group=4,
                                table_quant="per_row", planes=2,
                                plane_scales=(1.0, 2.0))


@pytest.mark.parametrize("case", [(8, 64, 4), (13, 72, 4), (8, 12, 4),
                                  (9, 64, 2)], ids=str)
def test_per_row_without_a_scale_matches_reference(case):
    """The one-launch per_row precompute (no scale given) against the
    reference's wrapper, which computes the closed-form scale before its
    Pallas kernel (interpret mode)."""
    m, k, kg = case
    a = np.random.default_rng(m + k).normal(size=(m, k)).astype(np.float32)
    want = jops.table_precompute(jnp.asarray(a), kg, "per_row", block_m=8,
                                 block_g=min(8, k // kg), interpret=True)
    values, scale = ttp.table_precompute(torch.from_numpy(a), kg, "per_row")
    np.testing.assert_allclose(scale.numpy(),
                               np.asarray(want.scale).reshape(m, 1),
                               rtol=2.4e-7, atol=0)
    entries = TT.table_entries(torch.from_numpy(a).reshape(m, -1, kg),
                               kg).numpy()
    assert_codes_match(values.numpy().reshape(m, -1, 1 << (kg - 1)),
                       np.asarray(want.values), entries,
                       scale.numpy()[:, :, None])


@pytest.mark.parametrize("kg", [2, 4])
def test_zero_rows_give_empty_tables(kg):
    """An activation of no rows gives empty values and scales of the right
    widths in every mode, from the plain versions, the wrappers (no launch
    counted), the op and the shared-table entry, as from the plain
    ``mp.precompute_tables``."""
    k = 16 * kg
    g, e = k // kg, 1 << (kg - 1)
    a = torch.zeros(0, k)
    before = (ttp.launches, ttp.row_scale_launches)
    assert ttp.row_scale(a, kg).shape == (0, 1)
    assert tops._closed_form_row_scale(a, g, kg).shape == (0, 1)
    widths = {None: None, "per_row": 1, "per_group": g}
    for tq in MODES:
        for values, scale in (ttp.table_precompute_plain(a, kg, tq),
                              ttp.table_precompute(a, kg, tq)):
            assert values.shape == (0, g * e)
            assert (None if scale is None else scale.shape[1]) == widths[tq]
        want = mp.precompute_tables(a, kg, tq)
        got = mp.precompute_tables(a, kg, tq, "lut_pallas")
        assert got.values.shape == want.values.shape == (0, g, e)
        assert got.rowsum.shape == (0,)
        assert (got.scale is None) == (want.scale is None)
        if want.scale is not None:
            assert got.scale.shape == want.scale.shape
    assert (ttp.launches, ttp.row_scale_launches) == before
