"""The port's roofline (``repro_torch.roofline``): ``Roofline`` against the
reference's at the same terms and the reference's constants; the bounds
``chip_smoke.py`` prints (``PERF.md`` §6's bound column) from
``cost.bound`` / ``cost.mpgemm_cost``; ``step_cost`` against hand counts
from the configs; ``chip_smoke.py`` taking its bounds from the package.
"""

import ast
from pathlib import Path

import pytest
import torch

from repro.roofline import analysis as janalysis
from repro.roofline import hw as jhw
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import quantized as qz
from repro_torch.roofline import analysis, cost, hw

ROOT = Path(__file__).resolve().parents[1]
TINYLLAMA = ((2048, 2048), (256, 2048), (5632, 2048), (2048, 5632),
             (32000, 2048))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TERMS = [
    # flops, bytes, coll, devices, t_compute, t_memory, t_coll, model,
    # min_bytes
    (4.0e12, 2.0e9, {}, 1, 0.02, 0.0024, 0.0, 3.0e12, 1.5e9),
    (1.0e9, 8.0e10, {"all-reduce": 10}, 4, 5e-6, 0.1, 4e-7, 1.0e9, 6.0e10),
    (2.0e10, 1.0e8, {"all-gather": 5e9}, 8, 1e-4, 1e-4, 0.1, 1.6e11, 0.0),
    (0.0, 0.0, {}, 1, 0.0, 0.0, 0.0, 0.0, 0.0),
]


@pytest.mark.parametrize("terms", TERMS)
def test_roofline_properties_are_the_reference_at_its_constants(terms):
    fl, by, coll, nd, tc, tm, tcl, mf, mb = terms
    want = janalysis.Roofline(fl, by, coll, nd, t_compute=tc, t_memory=tm,
                              t_collective=tcl, model_flops=mf,
                              peak_flops=jhw.PEAK_BF16_FLOPS, min_bytes=mb)
    got = analysis.Roofline(fl, by, coll, nd, t_compute=tc, t_memory=tm,
                            t_collective=tcl, model_flops=mf,
                            peak_flops=jhw.PEAK_BF16_FLOPS, min_bytes=mb,
                            hbm_bw=jhw.HBM_BW)
    for name in ("dominant", "t_bound", "useful_flops_ratio",
                 "roofline_fraction", "memory_efficiency"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.to_dict() == want.to_dict()
    # the port's defaults are the H100's
    h100 = analysis.Roofline(fl, by, coll, nd)
    assert (h100.peak_flops, h100.hbm_bw) == (hw.PEAK_BF16_FLOPS, hw.HBM_BW)


def test_analyze_sums_each_type_at_its_peak():
    r = analysis.analyze({"int8": 1979e9, "f32": 67e9}, 3.35e9,
                         min_bytes=1.675e9, coll_bytes={"all-reduce": 9e8})
    assert r.t_compute == pytest.approx(2e-3)
    assert r.t_memory == pytest.approx(1e-3)
    assert r.t_collective == pytest.approx(2 * 9e8 / hw.NVLINK_BW)
    assert r.dominant == "compute" and r.peak_flops == pytest.approx(
        (1979e9 + 67e9) / 2e-3)
    assert r.model_flops == 1979e9 + 67e9
    assert r.roofline_fraction == pytest.approx(1.0)
    assert r.fraction_of(4e-3) == pytest.approx(0.5)
    assert r.memory_efficiency == pytest.approx(0.5)
    assert (hw.PEAK_OPS["int8"], hw.PEAK_OPS["bf16"], hw.PEAK_OPS["f32"],
            hw.HBM_BW, hw.HBM_BYTES) == (1979e12, 989e12, 67e12, 3.35e12,
                                         80e9)


def _bounds(kernel, m, shapes, **kw):
    out = [cost.bound(*cost.mpgemm_cost(kernel, m, n, k, **kw))
           for n, k in shapes]
    return [round(ms, 5) for ms, _ in out], [by for _, by in out]


def test_bounds_reproduce_the_perf_bound_column():
    """PERF.md §6 (chip_smoke.py phase 3 at tinyllama-1.1b's shapes)."""
    assert _bounds("fused_lut_mpgemm", 4, TINYLLAMA) == (
        [0.00034, 0.00005, 0.00090, 0.00090, 0.00509], ["bytes"] * 5)
    assert _bounds("lut_mpgemm", 128, TINYLLAMA) == (
        [0.00079, 0.00024, 0.00188, 0.00161, 0.00998], ["bytes"] * 5)
    assert _bounds("lut_mpgemm", 4, TINYLLAMA, table_quant="per_group")[0] \
        == [0.00033, 0.00005, 0.00090, 0.00089, 0.00509]
    assert _bounds("dequant_mpgemm", 128, TINYLLAMA) == (
        [0.00326, 0.00041, 0.00896, 0.00896, 0.05089], ["operations"] * 5)
    assert _bounds("table_precompute", 128, ((None, 2048), (None, 5632)),
                   row_scale_given=False) == ([0.00047, 0.00129],
                                              ["bytes"] * 2)
    assert _bounds("row_scale", 4, ((None, 2048), (None, 5632))) == (
        [0.00001, 0.00003], ["bytes"] * 2)
    # bitnet's head at M = 128 is bound by its int8 operations
    assert _bounds("lut_mpgemm", 128, ((32000, 3200),)) == (
        [0.01325], ["operations"])
    with pytest.raises(ValueError):
        cost.mpgemm_cost("no_such_kernel", 1, 1, 4)


def test_chip_smoke_takes_its_bounds_from_the_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    assigned = {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
                for t in node.targets if isinstance(t, ast.Name)}
    assert not assigned & {"HBM_BYTES_S", "PEAK_OPS_S"}
    imported = {node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)}
    assert "repro_torch.roofline.cost" in imported


def _params(arch, **quant):
    cfg = treg.get_reduced(arch).replace(activation_dtype=torch.float32)
    if quant:
        cfg = cfg.with_quant(**quant)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, tapi.init_params(gen, cfg, "cpu")


def _attn_weights(cfg):
    d, hd = cfg.d_model, cfg.head_dim
    return 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd


def test_step_cost_is_exact_for_the_dense_family():
    cfg, params = _params("tinyllama-1.1b")
    d, hd, kvh = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    weights = (cfg.n_layers * (_attn_weights(cfg) + 3 * d * cfg.d_ff)
               + d * cfg.vocab_size)
    ctx = [5, 9, 0]
    c = cost.step_cost(cfg, params, 3, ctx, "decode")
    assert c["weights_per_token"] == weights
    keys = sum(x + 1 for x in ctx)
    attn = 4 * cfg.n_layers * keys * cfg.n_heads * hd
    assert c["ops"] == {"int8": 2 * weights * 3, "f32": attn}
    table = params["embed"]["table"]
    param_bytes = (qz.quantized_bytes(params)
                   - table.numel() * 4 + 3 * d * 4)
    assert c["param_bytes"] == param_bytes
    assert c["kv_read_bytes"] == cfg.n_layers * keys * 2 * kvh * hd * 4
    assert c["kv_write_bytes"] == cfg.n_layers * 3 * 2 * kvh * hd * 4
    assert c["min_bytes"] == (param_bytes + c["kv_read_bytes"]
                              + c["kv_write_bytes"])
    # a prefill chunk: its queries attend causally, K/V read once
    p = cost.step_cost(cfg, params, 1, 4, "prefill", chunk=3,
                       table_quant=None)
    assert p["tokens"] == 3 and p["ops"]["bf16"] == 2 * weights * 3
    assert p["ops"]["f32"] == 4 * cfg.n_layers * (5 + 6 + 7) * cfg.n_heads * hd
    assert p["kv_read_bytes"] == cfg.n_layers * 7 * 2 * kvh * hd * 4
    r = analysis.analyze(c["ops"], c["min_bytes"], min_bytes=c["min_bytes"])
    assert r.dominant == "memory" and r.roofline_fraction == 1.0


def test_step_cost_other_families_from_their_param_trees():
    """Hand counts: olmoe's experts at top_k of num_experts and its float
    attention as f32; zamba2's shared block once per invocation, its float
    Mamba2 projections as f32 and its state read and written; the VLM and
    whisper read no cross K/V projection and no encoder in a decode step."""
    cfg, params = _params("olmoe-1b-7b")
    d = cfg.d_model
    c = cost.step_cost(cfg, params, 2, 3)
    moe = cfg.n_layers * (cfg.top_k * 3 * d * cfg.d_ff)
    assert c["ops"]["int8"] == 2 * 2 * (moe + d * cfg.vocab_size)
    f32_w = cfg.n_layers * (_attn_weights(cfg) + d * cfg.num_experts)
    assert c["weights_per_token"] == moe + d * cfg.vocab_size + f32_w

    cfg, params = _params("zamba2-7b")
    c = cost.step_cost(cfg, params, 1, 0)
    groups = cfg.n_layers // cfg.attn_every
    shared = _attn_weights(cfg) + 3 * cfg.d_model * cfg.d_ff
    assert c["ops"]["int8"] == 2 * (groups * shared
                                    + cfg.d_model * cfg.vocab_size)
    assert c["state_bytes"] > 0 and c["ops"]["f32"] > 0

    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        cfg, params = _params(arch)
        c = cost.step_cost(cfg, params, 1, 0)
        d = cfg.d_model
        dq = d * cfg.n_heads * cfg.head_dim  # wq, and wo
        if arch == "whisper-tiny":
            per = _attn_weights(cfg) + 2 * dq + 2 * d * cfg.d_ff
            want = cfg.n_layers * per + d * cfg.vocab_size
        else:
            n_cross = cfg.n_layers // cfg.xattn_every
            want = ((cfg.n_layers - n_cross) * (_attn_weights(cfg)
                                                + 3 * d * cfg.d_ff)
                    + n_cross * (2 * dq + 3 * d * cfg.d_ff)
                    + d * cfg.vocab_size)
        assert c["weights_per_token"] == want, arch
    with pytest.raises(ValueError):
        cost.step_cost(cfg, params, 2, [1], "decode")
