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
from repro_torch.core import reinterpret as TR
from repro_torch.core import table as TT
from repro_torch.kernels import fused_lut_mpgemm as tfused
from repro_torch.kernels import lut_mpgemm as tlut
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
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
            assert tops.resolve_dispatch(m, n, k // 4, 4,
                                         2).fusion == "fused"
            assert jops.resolve_dispatch(m, n, k // 4, 4, 2)[0] == "fused"
        assert tops.resolve_dispatch(128, n, k // 4, 4,
                                     2).fusion == "staged"
        assert jops.resolve_dispatch(128, n, k // 4, 4, 2)[0] == "fused"
    with pytest.raises(ValueError):
        tops.resolve_dispatch(8, 128, 16, 4, 2, fusion="bogus")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_wrappers_pad_to_the_kernel_tiles(case, monkeypatch):
    """ops pads K-groups to bg and channels to BN of each kernel's own
    tile, and rows to BM only where the kernel needs it: the int paths
    (per_row) (``lut_mpgemm.int_tile_for``; ``fused_lut_mpgemm.int_tile``,
    its K-steps twice as wide) — the staged one with rows padded, the fused
    one with x's rows as they are — and the f32 paths (None, per_group) of
    both kernels to ``lut_mpgemm.f32_tile_for``, rows as they are. Every
    shape it hands a kernel wrapper passes the card path's launch checks
    and is padded no further than the tile needs."""
    m, k, n, bits, scheme, k_group = case
    g = k // k_group
    rng = np.random.default_rng(m + k)
    a = rng.normal(size=(m, k)).astype(np.float32)
    tq_w = TQ.quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
        np.float32)), bits, k_group=k_group, scheme=scheme)
    seen = []

    def up(x, mult):
        return -(-x // mult) * mult

    def spy(plain, name, rows_of):
        def run(*args, **kw):
            rows, scale, packed = args[:3]
            gp = packed.shape[1] * 8 // (kw["planes"] * kw["k_group"])
            int_path = scale is not None and scale.shape[1] == 1
            tile = (tlut.f32_tile_for(m, k_group, bits) if not int_path
                    else tfused.int_tile(m, k_group, bits) if name == "fused"
                    else tlut.int_tile_for(m, k_group, bits))
            _, bm, bn, bg = tile
            if not int_path:
                assert tlut.f32_plan(rows.shape[0], packed.shape[0], gp,
                                     kw["k_group"], kw["planes"])[0] == tile
                bm = 1  # the f32 paths take the rows as they are
            elif name == "fused":
                assert tfused.int_plan(rows.shape[0], packed.shape[0], gp,
                                       kw["k_group"], kw["planes"])[0] == tile
                bm = 1  # the fused int path takes x's rows as they are
            else:
                assert tlut.staged_plan(1, rows.shape[0], packed.shape[0],
                                        gp, kw["k_group"],
                                        kw["planes"])[0] == tile
            assert (rows.shape[0], packed.shape[0], gp) == (
                up(m, bm), up(n, bn), up(g, bg))
            assert rows_of(rows, kw["k_group"]) == gp
            seen.append((name, int_path, rows.shape[0]))
            return plain(*args, **kw)
        return run

    monkeypatch.setattr(tlut, "lut_mpgemm_plain", spy(
        tlut.lut_mpgemm_plain, "staged",
        lambda t, kg: t.shape[1] >> (kg - 1)))
    monkeypatch.setattr(tfused, "fused_lut_mpgemm_plain", spy(
        tfused.fused_lut_mpgemm_plain, "fused",
        lambda t, kg: t.shape[1] // kg))
    x = torch.from_numpy(a)
    for fusion in ("staged", "fused"):
        for tq in MODES:
            tops.lut_mpgemm(x, tq_w, table_quant=tq, fusion=fusion)
    int_rows = up(m, tlut.int_tile_for(m, k_group, bits)[1])
    assert seen == [(name, tq == "per_row",
                     int_rows if (name, tq) == ("staged", "per_row") else m)
                    for name in ("staged", "fused") for tq in MODES]
    assert tfused.int_tile(m, k_group, bits)[3] > tlut.int_tile_for(
        m, k_group, bits)[3]
    with pytest.raises(ValueError, match="padded"):
        tlut.staged_plan(1, 5, 64, 32, 4, 2)
    with pytest.raises(ValueError, match="padded"):
        tlut.f32_plan(5, 64, 32, 4, 2)


# tinyllama-1.1b's projections and head, (N, K), at W2 K=4
MAIN_SHAPES = ((2048, 2048), (256, 2048), (5632, 2048), (2048, 5632),
               (32000, 2048))
# a shape whose last split is shorter than the others (25 K-steps in 12)
RAGGED = (16, 1600, 256, 2, "symmetric", 4)
SPLIT_PLANS = ([(m, k, n, bits, kg) for m, k, n, bits, _, kg in CASES]
               + [(m, k, n, 2, 4) for m in (4, 128) for n, k in MAIN_SHAPES]
               + [RAGGED[:4] + RAGGED[5:]])


def _padded_plan(m, k, n, bits, kg, tile_of=tlut.int_tile_for):
    _, bm, bn, bg = tile_of(m, kg, bits)
    mp, np_, gp = (-(-x // y) * y for x, y in ((m, bm), (n, bn),
                                               (k // kg, bg)))
    return (mp, np_, gp, bm, bn, bg) + tlut.split_for(mp, np_, gp, bm, bn, bg)


@pytest.mark.parametrize("plan", SPLIT_PLANS, ids=str)
def test_split_plan_partitions_the_k_steps(plan):
    """The int path's split-K plan: S contiguous, non-empty, bg-aligned
    ranges that cover [0, Gp) exactly, in the kernel's own order (the
    first steps % S ranges one step longer), with >= 132 blocks wherever
    the K-steps allow MIN_STEPS per range."""
    mp, np_, gp, bm, bn, bg, s, ranges = _padded_plan(*plan)
    assert len(ranges) == s >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == gp
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    assert all(b > a and a % bg == 0 and b % bg == 0 for a, b in ranges)
    steps, tiles = gp // bg, (mp // bm) * (np_ // bn)
    if (steps // tlut.MIN_STEPS) * tiles >= tlut.SMS:
        assert tiles * s >= tlut.SMS
    if s > 1:
        assert min(b - a for a, b in ranges) >= tlut.MIN_STEPS * bg
    q, r = divmod(steps, s)  # csrc/lut_mpgemm.cu: first, count
    assert ranges == [(bg * (z * q + min(z, r)),
                       bg * (z * q + min(z, r) + q + (z < r)))
                      for z in range(s)]


def test_split_plans_of_the_serve_shapes():
    """At a 128-token prefill chunk every projection but the head splits
    K, and the ragged case's last range is shorter than the others."""
    for n, k in MAIN_SHAPES:
        s = _padded_plan(128, k, n, 2, 4)[6]
        assert (s == 1) == (n == 32000)
    ranges = _padded_plan(*RAGGED[:4], RAGGED[5])[7]
    assert ranges[-1][1] - ranges[-1][0] < ranges[0][1] - ranges[0][0]


@pytest.mark.parametrize("case", CASES + [RAGGED], ids=str)
def test_split_sums_equal_the_unsplit_contraction(case):
    """A plain int64 emulation of the int path's split-K: Σ over the plan's
    ranges of table x CW, each range's sum exact, then the epilogue
    (float(acc)·ts)·ws, equals the unsplit plain version bit for bit; every
    sum fits the kernel's int32 accumulator."""
    m, k, n, bits, scheme, k_group = case
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    qw = TQ.quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
        np.float32)), bits, k_group=k_group, scheme=scheme)
    tv, ts, pk, ws = tops.staged_operands(
        tops.table_precompute(x, k_group, "per_row"), qw)
    pw = dict(k_group=k_group, planes=bits, plane_scales=qw.plane_scales)
    want = tlut.lut_mpgemm_plain(tv, ts, pk, ws, **pw)
    e = 1 << (k_group - 1)
    mp, np_, gp = tv.shape[0], pk.shape[0], tv.shape[1] // e
    _, bm, bn, bg = tlut.int_tile_for(m, k_group, bits)
    s, ranges = tlut.split_for(mp, np_, gp, bm, bn, bg)
    qwp = TQ.QuantizedWeight(pk, ws, None, qw.plane_scales, bits=bits,
                             k_group=k_group, k_total=gp * k_group, n=np_)
    cw = ref.build_cw(qwp, torch.int64)
    parts = [tv[:, a * e:b * e].to(torch.int64) @ cw[a * e:b * e]
             for a, b in ranges]
    acc = torch.stack(parts).sum(0)
    assert acc.abs().max().item() < 2 ** 31
    got = (acc.to(torch.float32) * ts[:, :1]) * ws[None, :]
    assert torch.equal(got, want)
    assert torch.equal(acc, tv.to(torch.int64) @ cw)


# the fused per_row plan at M = 4: (N, K) -> (tiles, S, blocks)
FUSED_M4_PLANS = {(2048, 2048): (16, 8, 128), (256, 2048): (2, 8, 16),
                  (5632, 2048): (44, 3, 132), (2048, 5632): (16, 9, 144),
                  (32000, 2048): (250, 1, 250)}


@pytest.mark.parametrize("nk", MAIN_SHAPES, ids=str)
@pytest.mark.parametrize("m", (1, 4, 16, 64))
def test_fused_decode_plans_fill_the_card(m, nk):
    """The fused per_row path at decode M: the staged int path's row and
    channel tile with K-steps twice as wide, and the split-K plan of that
    tile on x's own rows, with tiles x S >= 132 blocks wherever the K-steps
    allow MIN_STEPS per range."""
    n, k = nk
    tile, s, tiles = tfused.int_plan(m, n, k // 4, 4, 2)
    mp, np_, gp, bm, bn, bg, s_staged, _ = _padded_plan(m, k, n, 2, 4,
                                                        tfused.int_tile)
    staged = tlut.int_tile_for(m, 4, 2)
    assert tile == staged[:3] + (2 * staged[3],) and (mp, np_, gp) == (
        -(-m // bm) * bm, n, k // 4)
    assert (s, tiles) == (s_staged, (mp // bm) * (np_ // bn))
    if (gp // bg // tlut.MIN_STEPS) * tiles >= tlut.SMS:
        assert tiles * s >= tlut.SMS
    else:
        assert s == gp // bg // tlut.MIN_STEPS
    if m == 4:
        assert (tiles, s, tiles * s) == FUSED_M4_PLANS[nk]
    with pytest.raises(ValueError, match="padded"):
        tfused.int_plan(m, n + 8, k // 4, 4, 2)


@pytest.mark.parametrize("case", CASES + [RAGGED, (4, 2048, 256, 2,
                                                    "symmetric", 4)], ids=str)
def test_fused_split_tables_equal_the_unsplit_contraction(case):
    """A plain int64 emulation of the fused per_row path with split-K: for
    each range of the plan, the table tile built from that range of x
    alone, contracted with the range's CW, the ranges' sums added in any
    order, then the epilogue (float(acc)·rs)·ws, equals the unsplit
    ``fused_lut_mpgemm_plain`` bit for bit."""
    m, k, n, bits, scheme, k_group = case
    rng = np.random.default_rng(m + k + n + 1)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    qw = TQ.quantize(torch.from_numpy(rng.normal(size=(n, k)).astype(
        np.float32)), bits, k_group=k_group, scheme=scheme)
    _, bm, bn, bg = tfused.int_tile(m, k_group, bits)
    g = k // k_group
    rs = tops._closed_form_row_scale(x, g, k_group).contiguous()
    xp = tops._pad_to(x, bg * k_group, 1).contiguous()
    gp = xp.shape[1] // k_group
    pk, ws = tops._pad_packed(qw, gp, bn)
    pw = dict(k_group=k_group, planes=bits, plane_scales=qw.plane_scales)
    want = tfused.fused_lut_mpgemm_plain(xp, rs, pk, ws,
                                         table_quant="per_row", **pw)
    s, ranges = tlut.split_for(-(-m // bm) * bm, pk.shape[0], gp, bm, bn, bg)
    assert tfused.int_plan(m, pk.shape[0], gp, k_group, bits)[1] == s
    e = 1 << (k_group - 1)
    cw = ref.build_cw(TQ.QuantizedWeight(
        pk, ws, None, qw.plane_scales, bits=bits, k_group=k_group,
        k_total=gp * k_group, n=pk.shape[0]), torch.int64)
    parts = []
    for a, b in ranges:
        tv, _ = ttp.table_precompute_plain(
            xp[:, a * k_group:b * k_group].contiguous(), k_group, "per_row",
            rs)
        parts.append(tv.to(torch.int64) @ cw[a * e:b * e])
    full = ttp.table_precompute_plain(xp, k_group, "per_row", rs)[0]
    assert torch.equal(torch.cat([ttp.table_precompute_plain(
        xp[:, a * k_group:b * k_group].contiguous(), k_group, "per_row",
        rs)[0] for a, b in ranges], 1), full)
    for order in (range(s), reversed(range(s)), rng.permutation(s)):
        acc = torch.zeros_like(parts[0])
        for z in order:
            acc = acc + parts[z]
        assert acc.abs().max().item() < 2 ** 31
        got = (acc.to(torch.float32) * rs) * ws[None, :]
        assert torch.equal(got, want)


@pytest.mark.parametrize("scales", [(1.0, 2.5), (0.5,), (1.0, float("nan")),
                                    (1.0, float("inf"))], ids=str)
def test_plane_args_refuses_non_integer_scales(scales):
    """A plane scale that is not an integer is refused, not truncated: the
    kernels take C ints and would compute another function."""
    with pytest.raises(ValueError, match="integers"):
        tlut.plane_args(len(scales), scales)


def test_plane_args_refuses_sums_above_255():
    """Σ|ps_b| <= 255 keeps every q' exact in dequant_mpgemm's bf16 tiles;
    one more is refused, whatever the signs."""
    assert list(tlut.plane_args(2, (127.0, 128.0))) == [127, 128]
    for scales in ((128.0, 128.0), (-128.0, 128.0), (1.0,) * 256):
        with pytest.raises(ValueError, match="exceeds 255"):
            tlut.plane_args(len(scales), scales)


@pytest.mark.parametrize("scheme", [(bits, False) for bits in range(1, 9)]
                         + [(2, True)], ids=str)
def test_plane_args_takes_every_schemes_scales(scheme):
    """Every scheme's plane scales ([1, 2, 4, ...] for 1-8 bits, [1, 1] for
    ternary) pass, as the same C ints."""
    scales = TR.plane_scales_for(*scheme)
    assert list(tlut.plane_args(len(scales), scales)) == [int(s)
                                                          for s in scales]


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
