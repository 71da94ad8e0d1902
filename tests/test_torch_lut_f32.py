"""Port parity, the LUT kernels' float-table paths (None and per_group
tables): a plain torch emulation of the CUDA kernels' arithmetic (the table
values split into bf16 terms by truncation, the CW entries in bf16, f32
sums over the split-K ranges added in split order, then ws) against the
reference's ``ref_lut_mpgemm_matmul`` and the port's plain op, on the same
numpy inputs and packed weights; whether fewer terms would do; the split
plan; and the ops wrappers' padding (K-groups and channels only, rows as
they are).

Tolerance: rtol = atol = 1e-4 at every output, the reference kernel's own
contract for float tables (tests/test_kernels.py).
"""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import quantize as JQ
from repro.kernels import ref as jref
from repro_torch.core import quantize as TQ
from repro_torch.core import table as TT
from repro_torch.core.quantize import QuantizedWeight
from repro_torch.kernels import fused_lut_mpgemm as tfused
from repro_torch.kernels import lut_mpgemm as tlut
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

# (M, K, N, bits, scheme, k_group): tests/test_torch_cuda.py's CASES, with
# the same seeds: decode and prefill rows, unaligned shapes, an odd group
# count, ternary, asymmetric, k_group 2 and 8
CASES = [(4, 256, 256, 2, "symmetric", 4), (128, 512, 320, 2, "symmetric", 4),
         (13, 72, 130, 2, "symmetric", 4), (8, 12, 16, 1, "symmetric", 4),
         (16, 128, 96, 2, "ternary", 4), (9, 256, 128, 4, "asymmetric", 4),
         (20, 64, 64, 2, "symmetric", 2), (6, 64, 64, 2, "symmetric", 8)]
FLOAT_MODES = [None, "per_group"]
# tinyllama-1.1b's projections and head (N, K), W2 K=4
SERVE_SHAPES = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632),
                (32000, 2048)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)  # one quantization per case
def _inputs(m, k, n, bits, scheme, k_group):
    """x, and the weights quantized as the card test quantizes them (the
    port's ``quantize``, bit-identical to the reference's) and handed to the
    reference as the same packed arrays."""
    rng = np.random.default_rng(m + k + n)
    a = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(n, k)).astype(np.float32)
    qw = TQ.quantize(torch.from_numpy(w), bits, k_group=k_group, scheme=scheme)
    jq = JQ.QuantizedWeight(
        *(None if t is None else jnp.asarray(t.numpy())
          for t in (qw.packed, qw.scale, qw.zero_prime)),
        qw.plane_scales, bits=qw.num_planes, k_group=k_group, k_total=k, n=n)
    return a, jq, qw


@functools.lru_cache(maxsize=None)  # one reference run per case and mode
def _reference(case, tq):
    a, jq, _ = _inputs(*case)
    return np.asarray(jref.ref_lut_mpgemm_matmul(jnp.asarray(a), jq,
                                                 table_quant=tq))


def _bf16_terms(v, terms):
    """The kernels' split of f32 values: t_j is the remainder v − t_0 − …
    − t_{j−1} with its low 16 bits cleared (a bf16 value, exact), each
    remainder exact in f32."""
    out, rest = [], v
    for _ in range(terms):
        t = (rest.view(torch.int32) & -65536).view(torch.float32)
        assert torch.equal(t.to(torch.bfloat16).to(torch.float32), t)
        out.append(t)
        rest = rest - t
    return out


def _emulated_op(x, qw, tq, terms=tlut.F32_PASSES):
    """``ops.lut_mpgemm`` on a float table, staged or fused, with the CUDA
    kernels' arithmetic emulated in plain torch: K-groups and channels
    padded as ops pads them (rows as they are); the table values as both
    kernels see them (None: the f32 entries; per_group: code · scale, one
    f32 product); each split into ``terms`` bf16 terms, whose products with
    the bf16 CW entries (exact in f32) are summed in f32 over each K-range
    of the split-K plan; the ranges' sums added in split order, times ws;
    then the zero point, as ops applies it."""
    m, kg, planes = x.shape[0], qw.k_group, qw.num_planes
    e = 1 << (kg - 1)
    _, _, bn, bg = tlut.f32_tile_for(m, kg, planes)
    xp = tops._pad_to(x, bg * kg, 1)
    gp = xp.shape[1] // kg
    pk, ws = tops._pad_packed(qw, gp, bn)
    ranges = tlut.k_ranges(gp, bg, tlut.f32_plan(m, pk.shape[0], gp, kg,
                                                 planes)[1])
    values = TT.dequantize_table(TT.precompute_table(xp, kg, tq))
    cw = ref.build_cw(QuantizedWeight(pk, ws, None, qw.plane_scales,
                                      bits=planes, k_group=kg,
                                      k_total=gp * kg, n=pk.shape[0]),
                      torch.float32)
    assert torch.equal(cw.to(torch.bfloat16).to(torch.float32), cw)
    split = _bf16_terms(values.reshape(m, gp * e), terms)
    acc = None
    for a, b in ranges:
        part = sum(t[:, a * e:b * e] @ cw[a * e:b * e] for t in split)
        acc = part if acc is None else acc + part
    out = (acc * ws[None, :])[:, :qw.n]
    return ref.zero_point_correction(out, qw, x.sum(-1))


def _within(got, want):
    return np.allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tq", FLOAT_MODES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernel_arithmetic_matches_reference_and_plain(case, tq):
    """The emulated arithmetic (F32_PASSES bf16 terms, split-K) against the
    reference's T @ CW and the port's plain staged and fused ops, every
    output within rtol = atol = 1e-4."""
    a, _, tq_w = _inputs(*case)
    x = torch.from_numpy(a)
    got = _emulated_op(x, tq_w, tq).numpy()
    np.testing.assert_allclose(got, _reference(case, tq), rtol=1e-4,
                               atol=1e-4)
    for fusion in ("staged", "fused"):
        np.testing.assert_allclose(
            got, tops.lut_mpgemm(x, tq_w, table_quant=tq,
                                 fusion=fusion).numpy(), rtol=1e-4, atol=1e-4)


# (case, table_quant) where the emulation with two terms meets the bound:
# the 1-bit case in both modes (outputs below 8) and k_group 2 per_group;
# on every other pair two terms miss by up to 4.9e-4
TWO_TERMS_MEET = {(CASES[3], None), (CASES[3], "per_group"),
                  (CASES[6], "per_group")}


@pytest.mark.parametrize("terms", range(1, tlut.F32_PASSES))
def test_fewer_terms_miss_the_elementwise_bound(terms):
    """With fewer bf16 terms than the kernels take, the same emulation
    misses the 1e-4 bound against the reference: one term on every case and
    mode, two on all but TWO_TERMS_MEET. The kernels need all F32_PASSES
    terms."""
    meets = {(case, tq) for case in CASES for tq in FLOAT_MODES
             if _within(_emulated_op(torch.from_numpy(_inputs(*case)[0]),
                                     _inputs(*case)[2], tq, terms).numpy(),
                        _reference(case, tq))}
    assert meets == (TWO_TERMS_MEET if terms == 2 else set())


@pytest.mark.parametrize("shape", [(m, n, k, 4, 2) for m in (1, 4, 17, 64, 128)
                                   for n, k in SERVE_SHAPES]
                         + [(c[0], c[2], c[1], c[5], c[3]) for c in CASES],
                         ids=str)
def test_split_plan_covers_the_k_steps_once_in_order(shape):
    """The f32 paths' split-K plan: S contiguous, non-empty, bg-aligned
    ranges, in the kernels' own order (the first steps % S ranges one step
    longer, csrc/bf16_mma.cuh: bf16_block), that cover [0, Gp) exactly
    once; S the most that keeps the grid within one wave of BLOCKS_PER_SM
    blocks an SM, with at least MIN_STEPS steps a range; the rows are not
    padded."""
    m, n, k, kg, planes = shape
    _, bm, bn, bg = tlut.f32_tile_for(m, kg, planes)
    np_, gp = -(-n // bn) * bn, -(-(k // kg) // bg) * bg
    (_, bm2, bn2, bg2), s, tiles = tlut.f32_plan(m, np_, gp, kg, planes)
    assert (bm2, bn2, bg2) == (bm, bn, bg) and tiles == -(-m // bm) * np_ // bn
    ranges = tlut.k_ranges(gp, bg, s)
    assert len(ranges) == s >= 1
    assert [g for a, b in ranges for g in range(a, b)] == list(range(gp))
    steps = gp // bg
    q, r = divmod(steps, s)
    assert ranges == [(bg * (z * q + min(z, r)),
                       bg * (z * q + min(z, r) + q + (z < r)))
                      for z in range(s)]
    slots = tlut.SMS * tlut.BLOCKS_PER_SM
    assert s == max(1, min(slots // tiles, steps // tlut.MIN_STEPS))
    assert s == 1 or (tiles * s <= slots and steps // s >= tlut.MIN_STEPS)
    with pytest.raises(ValueError, match="padded"):
        tlut.f32_plan(m, np_ + 8, gp, kg, planes)


@pytest.mark.parametrize("k_group", (1, 2, 4, 8))
@pytest.mark.parametrize("planes", (1, 2, 3, 4))
def test_f32_tile_takes_what_the_launch_checks(k_group, planes):
    """Every (planes, k_group): the tile's K-step of bg groups is a power of
    two, a whole number of 16-value MMA slices, starts each channel's
    packed row on a 4-byte word, and holds whole 16-byte rows of
    activations for the fused kernel (csrc/*_lut_mpgemm.cu: launch_f32)."""
    for m in (1, 16, 17, 64, 65, 128, 300):
        config, bm, bn, bg = tlut.f32_tile_for(m, k_group, planes)
        assert (bm, bn) == tlut.BF16_TILES[config][:2]
        assert m <= bm or config == len(tlut.BF16_TILES) - 1
        kt = bg << (k_group - 1)
        assert bg & (bg - 1) == 0 and kt % 16 == 0 and kt >= 32
        assert (bg * planes * k_group) % 32 == 0
        assert (bg * k_group) % 4 == 0


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ops_do_not_pad_rows_for_the_f32_paths(case, monkeypatch):
    """ops hands both kernels' f32 paths the table or x with its own rows
    (and per_group scales [M, Gp]), K-groups padded to bg and channels to
    BN of ``f32_tile_for``, starting on a 16-byte boundary."""
    m, k, n, bits, scheme, kg = case
    _, _, tq_w = _inputs(*case)
    _, _, bn, bg = tlut.f32_tile_for(m, kg, tq_w.num_planes)
    gp = -(-(k // kg) // bg) * bg
    seen = []

    def spy(plain, name):
        def run(rows, scale, packed, wscale, **kw):
            assert rows.shape[0] == m and rows.data_ptr() % 16 == 0
            assert packed.shape == (-(-n // bn) * bn, gp * bits * kg // 8)
            if name == "staged" and scale is not None:
                assert scale.shape == (m, gp)
            seen.append((name, kw.get("table_quant", scale is None)))
            return plain(rows, scale, packed, wscale, **kw)
        return run

    monkeypatch.setattr(tlut, "lut_mpgemm_plain",
                        spy(tlut.lut_mpgemm_plain, "staged"))
    monkeypatch.setattr(tfused, "fused_lut_mpgemm_plain",
                        spy(tfused.fused_lut_mpgemm_plain, "fused"))
    x = torch.from_numpy(_inputs(*case)[0])
    for tq in FLOAT_MODES:
        for fusion in ("staged", "fused"):
            out = tops.lut_mpgemm(x, tq_w, table_quant=tq, fusion=fusion)
            assert out.shape == (m, n)
    assert seen == [("staged", True), ("fused", None),
                    ("staged", False), ("fused", "per_group")]


def test_f32_workspace_is_shared_and_grows():
    """The bf16 kernels (both LUT kernels' f32 paths and dequant_mpgemm)
    take one workspace and one set of arrival counts per device, made zero
    and grown only when a call needs more."""
    dev = torch.device("cpu")
    saved = dict(tlut._f32_workspaces)
    tlut._f32_workspaces.clear()
    try:
        work, arrivals = tlut.f32_workspace(dev, 100, 8)
        assert work.dtype == torch.float32 and arrivals.dtype == torch.int32
        assert not work.any() and not arrivals.any()
        again = tlut.f32_workspace(dev, 60, 4)
        assert again[0] is work and again[1] is arrivals
        grown = tlut.f32_workspace(dev, 200, 4)
        assert grown[0].numel() >= 200 and grown[1] is arrivals
    finally:
        tlut._f32_workspaces.clear()
        tlut._f32_workspaces.update(saved)
