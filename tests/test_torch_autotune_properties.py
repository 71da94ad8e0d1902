"""Property-based tests (hypothesis) of the port's tuned dispatch, as
tests/test_autotune_properties.py holds the reference's:

  * ``ops.kernel_plan`` gives a plan the kernels accept (a tile that
    exists, K-steps of whole 4-byte words of packed codes, 1 <= S <=
    max_splits) for odd shapes, non-power-of-two k_group included;
  * any cache entry, with junk fields (``inf`` and NaN included), is
    sanitized into such a plan or dropped, and ``fusion="tuned"`` against
    such a cache resolves without raising.
"""

import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis; "
    "pip install -r requirements.txt")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import autotune  # noqa: E402
from repro_torch.core.autotune import TunedConfig  # noqa: E402
from repro_torch.kernels import lut_mpgemm as lut_kernel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from test_torch_serving import _one_torch_thread  # noqa: F401,E402

m_st = st.integers(1, 300)
n_st = st.integers(1, 4096)
g_st = st.integers(1, 1024)
kg_st = st.sampled_from([1, 2, 3, 4, 5, 8])
planes_st = st.integers(1, 4)
tq_st = st.sampled_from(["per_row", "per_group", None])
adversarial_field = st.one_of(
    st.none(), st.booleans(), st.integers(-10, 10_000_000),
    st.floats(allow_nan=True, allow_infinity=True), st.text(max_size=8),
    st.sampled_from(["fused", "staged", "auto", "tuned", ""]))
# inf and NaN in every draw of the block fields, not only now and then
bad_number = st.sampled_from([float("inf"), float("-inf"), float("nan")])
PROFILE = settings(max_examples=25, deadline=None)


def _assert_valid_plan(m, n, g, kg, planes, tq, fusion, tile, splits):
    config, bm, bn, bg, s = ops.kernel_plan(m, n, g, kg, planes, tq, fusion,
                                            tile, splits)
    tiles = (lut_kernel.INT_TILES if tq == "per_row"
             else lut_kernel.BF16_TILES)
    assert 0 <= config < len(tiles) and (bm, bn) == tuple(tiles[config][:2])
    assert bg >= 1 and (bg * planes * kg) % 32 == 0
    assert 1 <= s <= lut_kernel.max_splits(-(-g // bg))


@PROFILE
@given(m=m_st, n=n_st, g=g_st, kg=kg_st, planes=planes_st, tq=tq_st,
       fusion=st.sampled_from(["fused", "staged"]))
def test_kernel_plan_always_valid(m, n, g, kg, planes, tq, fusion):
    _assert_valid_plan(m, n, g, kg, planes, tq, fusion, None, None)
    assert ops.auto_fusion(m, n, g, kg, planes) in ("fused", "staged")


@PROFILE
@given(m=m_st, n=n_st, g=g_st, kg=kg_st, planes=planes_st, tq=tq_st,
       fusion=adversarial_field, tile=adversarial_field,
       splits=adversarial_field)
def test_sanitize_foreign_entry_never_invalid(m, n, g, kg, planes, tq,
                                              fusion, tile, splits):
    cfg = TunedConfig(fusion=fusion, tile=tile, splits=splits)
    out = autotune.sanitize_config(cfg, m, n, g, kg, planes, tq)
    if out is not None:
        assert out.fusion in ("fused", "staged")
        _assert_valid_plan(m, n, g, kg, planes, tq, out.fusion, out.tile,
                           out.splits)


@PROFILE
@given(m=m_st, n=n_st, g=g_st, kg=kg_st, planes=planes_st, tq=tq_st,
       fusion=st.sampled_from(["fused", "staged"]), tile=bad_number,
       splits=st.one_of(bad_number, st.integers(-3, 3)))
def test_sanitize_drops_inf_and_nan(m, n, g, kg, planes, tq, fusion, tile,
                                    splits):
    """int(inf) raises OverflowError and int(nan) ValueError: both drop
    the entry instead of raising."""
    cfg = TunedConfig(fusion=fusion, tile=tile, splits=splits)
    assert autotune.sanitize_config(cfg, m, n, g, kg, planes, tq) is None


@PROFILE
@given(m=st.integers(1, 64), n=st.integers(1, 1024), g=st.integers(1, 256),
       kg=kg_st, planes=planes_st, tq=tq_st, fusion=adversarial_field,
       tile=adversarial_field, splits=adversarial_field)
def test_tuned_dispatch_never_crashes_on_bad_cache(m, n, g, kg, planes, tq,
                                                   fusion, tile, splits):
    cache = autotune.configure(None)
    try:
        cache.put(autotune.shape_key(m, n, g, kg, planes, table_quant=tq),
                  TunedConfig(fusion=fusion, tile=tile, splits=splits))
        plan = ops.resolve_dispatch(m, n, g, kg, planes, fusion="tuned",
                                table_quant=tq)
        assert plan.fusion in ("fused", "staged")
        _assert_valid_plan(m, n, g, kg, planes, tq, plan.fusion, plan.tile,
                           plan.splits)
    finally:
        autotune.deactivate()
