"""Port parity, the training modules: ``repro_torch``'s fake-quant, loss,
optimizers, gradient compression, data, checkpoints and fault-tolerance
policy against ``repro``'s on the CPU, and the reference's own contracts
run inside the port.

Same inputs from numpy seeds through both packages; the reference's
functions are called eagerly (op by op), as the port runs. Tolerances:
  * ``fake_quant`` symmetric (W2, W4): bit-equal forward. Ternary: the
    row scale is a mean, which XLA and torch sum in other orders, so it
    can differ in the last bit: on inputs whose sums are exact (multiples
    of 1/64) the forward is bit-equal; on normal draws the codes may flip
    only at a near tie (|w|/s within 1e-6 of 0.5; counted, 0 here) and
    a value differs by at most the two scales' difference times its code
    plus 2 ulps of the larger of |w| and |value| (the forward is
    ``w + (wq − w)``). The gradient of Σ c·fake_quant(w) is c
    exactly in both packages.
  * ``lm_loss``, with and without a mask: 1e-6 relative.
  * each optimizer, three updates (an lr schedule, grad clipping on):
    rtol 1e-6 / atol 1e-7 on the params. The 8-bit state's codes equal;
    its block scales within rtol 1e-6 (the global norm of the clipping sums
    its leaves in another order, so m and v, and their absmax, can differ
    in the last bit);
    ``lr_schedule`` at steps 0, 10, 50, 100 equal.
  * ``compress_decompress_tree``: bit-equal to the reference, a layer
    stack compressed as the reference's stacked array; compressed +
    residual == the signal within rtol 1e-5 / atol 1e-6.
  * ``SyntheticLM`` / ``PackedCorpus`` batches: bit-equal.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core.quantize import fake_quant as jfake_quant
from repro.distributed import compression as jcomp
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro.models.transformer import lm_loss as jlm_loss
from repro.training import data as jdata
from repro.training import optimizer as jO
from repro_torch.core import mpgemm as tmp
from repro_torch.core.quantize import fake_quant
from repro_torch.distributed import compression as tcomp
from repro_torch.models import layers as tL
from repro_torch.models import moe as tmoe
from repro_torch.models import quantized as tqz
from repro_torch.models.transformer import lm_loss
from repro_torch.training import checkpoint as C
from repro_torch.training import data as tdata
from repro_torch.training import fault_tolerance as ft
from repro_torch.training import optimizer as O
from repro_torch.training.fault_tolerance import Action, FaultToleranceManager


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# fake_quant (STE)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4])
def test_fake_quant_symmetric_forward_is_the_reference(bits):
    w = np.random.default_rng(bits).normal(size=(64, 256)).astype(np.float32)
    want = np.asarray(jfake_quant(jnp.asarray(w), bits, "symmetric"))
    got = fake_quant(_t(w), bits, "symmetric").numpy()
    np.testing.assert_array_equal(got, want)
    # w + (wq - w): the grid s·(2q − qmax) up to the rounding of that sum
    qmax = (1 << bits) - 1
    s = np.abs(w).max(axis=-1, keepdims=True) / qmax
    grid = s * (2 * np.clip(np.round((w / s + qmax) / 2), 0, qmax) - qmax)
    assert (np.abs(got - grid) <= 2 * np.spacing(np.maximum(
        np.abs(w), np.abs(grid)))).all()


def test_fake_quant_ternary_forward_exact_sums_are_the_reference():
    """Multiples of 1/64 sum exactly in f32 in any order: the absmean scale,
    and so the whole forward, equals the reference's bit for bit."""
    w = (np.random.default_rng(7).integers(-128, 129, (32, 256))
         / 64.0).astype(np.float32)
    want = np.asarray(jfake_quant(jnp.asarray(w), 2, "ternary"))
    np.testing.assert_array_equal(fake_quant(_t(w), 2, "ternary").numpy(),
                                  want)


def test_fake_quant_ternary_forward_codes_flip_only_at_ties():
    w = np.random.default_rng(8).normal(size=(64, 256)).astype(np.float32)
    want = np.asarray(jfake_quant(jnp.asarray(w), 2, "ternary"))
    got = fake_quant(_t(w), 2, "ternary").numpy()
    s_ref = np.asarray(jnp.mean(jnp.abs(jnp.asarray(w)), axis=-1,
                                keepdims=True))
    s_port = _t(w).abs().mean(dim=-1, keepdim=True).numpy()
    codes = lambda s: np.clip(np.round(w / s), -1, 1)
    flips = codes(s_ref) != codes(s_port)
    near_tie = np.abs(np.abs(w / s_ref) - 0.5) < 1e-6
    assert not (flips & ~near_tie).any()
    # the scales' own difference carried by the code, plus the rounding of
    # w + (wq - w) at the scale of the larger of |w| and |wq|
    bound = (np.abs(s_port - s_ref) * np.abs(codes(s_ref))
             + 2 * np.spacing(np.maximum(np.abs(w), np.abs(want))))
    keep = ~flips
    assert (np.abs(got - want)[keep] <= bound[keep]).all()
    # the codes the values carry are the reference's
    assert (codes(s_port)[keep] == np.round(want / s_ref)[keep]).all()


@pytest.mark.parametrize("bits,scheme", [(2, "symmetric"), (4, "symmetric"),
                                         (2, "ternary")])
def test_fake_quant_gradient_passes_straight_through(bits, scheme):
    rng = np.random.default_rng(11)
    w = rng.normal(size=(16, 64)).astype(np.float32)
    c = rng.normal(size=(16, 64)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jnp.asarray(c)
                                    * jfake_quant(x, bits, scheme)))(
        jnp.asarray(w))
    wt = _t(w).requires_grad_()
    (_t(c) * fake_quant(wt, bits, scheme)).sum().backward()
    np.testing.assert_array_equal(np.asarray(jg), c)
    np.testing.assert_array_equal(wt.grad.numpy(), c)


def test_lut_dense_qat_forward_and_grads_match_reference():
    """The QAT branch of lut_dense: W fake-quantized per output channel
    along the input axis, then the f32 product; forward and both
    gradients against the reference's."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 48)).astype(np.float32) / 8
    b = rng.normal(size=(48,)).astype(np.float32)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    quant = {"qat": True, "weight_bits": 2, "scheme": "symmetric",
             "mpgemm_mode": "lut_xla"}

    def jf(w_, x_):
        return jnp.sum(jnp.sin(jL.lut_dense({"w": w_, "b": jnp.asarray(b)},
                                            x_, quant)))
    jy = jL.lut_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                      jnp.asarray(x), quant)
    jgw, jgx = jax.grad(jf, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    wt, xt = _t(w).requires_grad_(), _t(x).requires_grad_()
    y = tL.lut_dense({"w": wt, "b": _t(b)}, xt, quant)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    # without qat the branch is the plain product
    plain = tL.lut_dense({"w": _t(w)}, _t(x), dict(quant, qat=False))
    np.testing.assert_allclose(plain.numpy(), x @ w, rtol=1e-5, atol=1e-5)



@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_float_mlp_builds_no_table(gated, monkeypatch):
    """An MLP with float weights (the training forward) reads no lookup
    table, so it builds none: under lut_pallas a staged-size prefill would
    otherwise precompute one (a table_precompute launch on the card) that
    no product reads. Its output is the plain float MLP's. The same MLP
    packed builds its table, which gate and up share."""
    gen = torch.Generator()
    gen.manual_seed(0)
    p = tL.mlp_init(gen, 64, 128, gated=gated)
    quant = {"mpgemm_mode": "lut_pallas", "table_quant": "per_row",
             "fusion": "staged", "weight_bits": 2, "k_group": 4}
    built = []
    real = tmp.precompute_tables
    monkeypatch.setattr(tmp, "precompute_tables",
                        lambda *a, **k: built.append(a[0].shape) or real(
                            *a, **k))
    x = _t(np.random.default_rng(5).normal(size=(1, 128, 64)).astype(
        np.float32))
    y = tL.mlp_apply(p, x, quant)
    assert built == []
    assert torch.equal(y, tL.mlp_apply(p, x, None))
    packed = tqz.quantize_params({"mlp": p}, quant)["mlp"]
    assert "qw" in packed["up"]
    assert torch.isfinite(tL.mlp_apply(packed, x, quant)).all()
    assert tuple(built[0]) == (1, 128, 64)

def test_expert_ffn_qat_matches_reference():
    """QAT on the float experts: gate, up and down fake-quantized along
    their contraction axis, per expert and per output channel."""
    rng = np.random.default_rng(4)
    e, c, d, f = 4, 6, 32, 24
    ws = {"gate": rng.normal(size=(e, d, f)), "up": rng.normal(size=(e, d, f)),
          "down": rng.normal(size=(e, f, d))}
    ws = {k: (v / 4).astype(np.float32) for k, v in ws.items()}
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    quant = {"qat": True, "weight_bits": 2, "scheme": "symmetric"}
    want = jmoe._expert_ffn({k: jnp.asarray(v) for k, v in ws.items()},
                            jnp.asarray(x), quant)
    got = tmoe._expert_ffn({k: _t(v) for k, v in ws.items()}, _t(x), quant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain = tmoe._expert_ffn({k: _t(v) for k, v in ws.items()}, _t(x), None)
    assert (plain - got).abs().max() > 1e-2  # the fake-quant did something


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = float(jlm_loss(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask)))
    got = float(lm_loss(_t(logits), _t(labels),
                        None if mask is None else _t(mask)))
    assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

# w: 4096 elements (>= the 8-bit block of 2048); f: >= 128 x 128 (factored)
SHAPES = {"w": (64, 64), "f": (128, 256), "b": (8,)}


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor",
                                  "momentum"])
def test_optimizer_updates_match_reference(name):
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 1))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    jo = jO.make_optimizer(name, lr=jO.lr_schedule(1e-2, 2, 10))
    to = O.make_optimizer(name, lr=O.lr_schedule(1e-2, 2, 10))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update({k: _t(v) for k, v in g.items()}, ts, tp)
        if name == "adamw8bit":  # int8 m and v
            for mv in ("m", "v"):
                for k in ("w", "f"):
                    np.testing.assert_array_equal(ts[mv][k]["q"].numpy(),
                                                  np.asarray(js[mv][k]["q"]))
                    np.testing.assert_allclose(ts[mv][k]["s"].numpy(),
                                               np.asarray(js[mv][k]["s"]),
                                               rtol=1e-6, atol=0)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_lr_schedule_matches_reference():
    jf, tf = jO.lr_schedule(1.0, warmup=10, total=100), O.lr_schedule(
        1.0, warmup=10, total=100)
    for s in (0, 10, 50, 100):
        want = float(jf(jnp.asarray(s)))
        assert float(tf(torch.tensor(s, dtype=torch.int32))) == want, s
    assert float(tf(torch.tensor(0))) == 0.0
    assert abs(float(tf(torch.tensor(10))) - 1.0) < 1e-6
    assert float(tf(torch.tensor(100))) < 1e-6


def _rosenbrockish(params):
    x, y = params["x"], params["y"]
    return torch.sum((1 - x) ** 2) + 5 * torch.sum((y - x ** 2) ** 2)


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor",
                                  "momentum"])
def test_optimizer_converges(name):
    """The reference's own contract (tests/test_training.py), in the port."""
    opt = O.make_optimizer(name, lr=3e-2 if name != "momentum" else 1e-3)
    params = {"x": torch.zeros(4), "y": torch.zeros(4)}
    state = opt.init(params)
    loss0 = float(_rosenbrockish(params))
    for _ in range(300):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        g = torch.autograd.grad(_rosenbrockish(leaves),
                                [leaves["x"], leaves["y"]])
        params, state = opt.update({"x": g[0], "y": g[1]}, state, params)
    assert float(_rosenbrockish(params)) < 0.1 * loss0


def test_adamw8bit_state_is_int8():
    opt = O.make_optimizer("adamw8bit", lr=1e-3)
    params = {"w": torch.ones(64, 64)}  # 4096 >= block size
    state = opt.init(params)
    assert state["m"]["w"]["q"].dtype == torch.int8
    _, state = opt.update({"w": torch.full((64, 64), 0.1)}, state, params)
    assert state["m"]["w"]["q"].dtype == torch.int8
    assert state["v"]["w"]["s"].dtype == torch.float32


def test_adafactor_state_is_factored():
    opt = O.make_optimizer("adafactor", lr=1e-3)
    params = {"w": torch.ones(256, 512), "b": torch.ones(8),
              "layers": [{"e": torch.ones(2, 128, 256)}]}
    state = opt.init(params)
    assert state["v"]["w"]["vr"].shape == (256,)
    assert state["v"]["w"]["vc"].shape == (512,)
    assert state["v"]["b"]["v"].shape == (8,)  # small tensors unfactored
    assert state["v"]["layers"][0]["e"]["vr"].shape == (2, 128)
    assert state["v"]["layers"][0]["e"]["vc"].shape == (2, 256)


def test_update_leaves_its_inputs_untouched():
    opt = O.make_optimizer("adamw", lr=1e-2)
    params = {"w": torch.ones(4, 4)}
    state = opt.init(params)
    new_p, new_s = opt.update({"w": torch.full((4, 4), 0.5)}, state, params)
    assert (params["w"] == 1).all() and (state["m"]["w"] == 0).all()
    assert (new_p["w"] < 1).all() and int(new_s["step"]) == 1


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_compress_decompress_tree_matches_reference():
    rng = np.random.default_rng(1)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "b": rng.normal(size=(8,)).astype(np.float32)}
    ef = {"w": (rng.normal(size=(64, 64)) * 1e-3).astype(np.float32),
          "b": np.zeros(8, np.float32)}
    jg, jef = jcomp.compress_decompress_tree(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in ef.items()})
    tg, tef = tcomp.compress_decompress_tree(
        {k: _t(v) for k, v in g.items()}, {k: _t(v) for k, v in ef.items()})
    for k in g:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        np.testing.assert_array_equal(tef[k].numpy(), np.asarray(jef[k]))
    # a leaf under the 1024-element block passes uncompressed
    np.testing.assert_array_equal(tg["b"].numpy(), g["b"])
    assert (tef["b"] == 0).all()


def test_compression_takes_a_layer_stack_as_the_reference_stacks_it():
    """A list of layer dicts is one stacked array in the reference: leaves
    under 1024 elements a layer (512 × 2 = 1024) and leaves not a multiple
    of the block (600 × 3) compress as the stacked tensor does."""
    rng = np.random.default_rng(2)
    r = rng.normal(size=(2, 64, 8)).astype(np.float32)
    x = rng.normal(size=(3, 2, 300)).astype(np.float32)
    jg, jef = jcomp.compress_decompress_tree(
        {"layers": {"r": jnp.asarray(r)}, "odd": {"x": jnp.asarray(x)}})
    tg, tef = tcomp.compress_decompress_tree(
        {"layers": [{"r": _t(r[i])} for i in range(2)],
         "odd": [{"x": _t(x[i])} for i in range(3)]})
    for i in range(2):
        np.testing.assert_array_equal(tg["layers"][i]["r"].numpy(),
                                      np.asarray(jg["layers"]["r"][i]))
        np.testing.assert_array_equal(tef["layers"][i]["r"].numpy(),
                                      np.asarray(jef["layers"]["r"][i]))
    for i in range(3):
        np.testing.assert_array_equal(tg["odd"][i]["x"].numpy(),
                                      np.asarray(jg["odd"]["x"][i]))
    assert float(tef["layers"][0]["r"].abs().max()) > 0  # it was compressed


def test_grad_compression_error_feedback():
    """EF accumulates the quantization residual; compressed + EF == signal
    (the reference's contract, in the port)."""
    g = {"w": _t(np.random.default_rng(0).normal(size=(64, 64))
                 .astype(np.float32))}
    ef = tcomp.init_error_feedback(g)
    cg, ef2 = tcomp.compress_decompress_tree(g, ef)
    np.testing.assert_allclose(cg["w"].numpy() + ef2["w"].numpy(),
                               g["w"].numpy(), rtol=1e-5, atol=1e-6)
    assert float(ef2["w"].abs().max()) < float(g["w"].abs().max()) / 100
    # the next step re-adds the residual
    cg2, _ = tcomp.compress_decompress_tree(g, ef2)
    assert not torch.equal(cg2["w"], cg["w"])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (7, 123)])
def test_synthetic_lm_batches_are_the_reference(seed, step):
    want = jdata.SyntheticLM(100, 3, 16, seed=seed).batch_at(step)
    got = tdata.SyntheticLM(100, 3, 16, seed=seed).batch_at(step)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.int32
    np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_packed_corpus_batches_are_the_reference(tmp_path):
    toks = (np.arange(1000, dtype=np.int32) * 7) % 50
    path = str(tmp_path / "corpus.npy")
    np.save(path, toks)
    for step in (0, 4):
        want = jdata.PackedCorpus(path, batch=2, seq_len=16, seed=1).batch_at(
            step)
        got = tdata.PackedCorpus(path, batch=2, seq_len=16, seed=1).batch_at(
            step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
    assert got["tokens"].shape == (2, 16)
    np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_prefetcher_order():
    src = tdata.SyntheticLM(100, 2, 8, seed=1)
    pf = tdata.Prefetcher(src, start_step=3, depth=2)
    got = [pf.next()["tokens"] for _ in range(3)]
    pf.close()
    assert not pf._thread.is_alive()
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, src.batch_at(3 + i)["tokens"])
    assert pf.step == 6


# ---------------------------------------------------------------------------
# checkpointing + restart
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_with_bf16_leaves(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3.0, 0.0],
                                    dtype=torch.bfloat16)},
            "layers": [{"w": torch.randn(3, 2)}, {"w": torch.randn(3, 2)}],
            "step": torch.tensor(9, dtype=torch.int32)}
    d = C.save(str(tmp_path), 7, tree)
    with open(os.path.join(d, C.MANIFEST)) as f:
        man = json.load(f)
    assert man["names"][:2] == ["['a']", "['b']['c']"]
    assert "['layers'][1]['w']" in man["names"]
    assert man["dtypes"][1] == "bfloat16" and man["shapes"][0] == [2, 3]
    restored, step = C.restore(str(tmp_path), tree)
    assert step == 7
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["layers"][1]["w"], tree["layers"][1]["w"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 9
    with pytest.raises(ValueError, match="structure mismatch"):
        C.restore(str(tmp_path), {"a": tree["a"]})


def test_restore_refuses_a_compressed_shard(tmp_path):
    """Restore maps the stored (uncompressed) members of np.savez's file;
    a compressed member is refused, not misread."""
    tree = {"w": torch.randn(3, 4)}
    d = C.save(str(tmp_path), 1, tree)
    np.savez_compressed(os.path.join(d, "shard_0.npz"),
                        a0=tree["w"].numpy())
    with pytest.raises(ValueError, match="compressed"):
        C.restore(str(tmp_path), tree)


def test_checkpoint_atomicity_and_gc(tmp_path):
    rm = C.RestartManager(str(tmp_path), every=1, keep=2, async_write=False)
    tree = {"x": torch.zeros(3)}
    for s in range(1, 5):
        rm.maybe_save(s, {"x": torch.full((3,), float(s))})
    assert C.list_steps(str(tmp_path)) == [3, 4]  # gc keeps last 2
    restored, step = rm.restore_or_none(tree)
    assert step == 4 and float(restored["x"][0]) == 4.0
    # a stale .tmp dir must never be picked up
    os.makedirs(tmp_path / "step_00000099.tmp")
    assert C.latest_step(str(tmp_path)) == 4
    assert rm.maybe_save(5, tree)
    # a directory without a manifest is no checkpoint either
    os.makedirs(tmp_path / "step_00000100")
    assert C.latest_step(str(tmp_path)) == 5


def test_async_save_snapshots_before_returning(tmp_path):
    """The writer thread saves the values at maybe_save, not what a later
    in-place update leaves in the tensors."""
    rm = C.RestartManager(str(tmp_path), every=2, async_write=True)
    x = torch.zeros(4096)
    assert not rm.maybe_save(1, {"x": x})
    assert rm.maybe_save(2, {"x": x})
    x.add_(1.0)  # the caller's next step, in place
    rm.wait()
    restored, step = rm.restore_or_none({"x": torch.empty(4096)})
    assert step == 2 and float(restored["x"].abs().max()) == 0.0


def test_checkpoint_manifest_wall_time_and_monotonic_duration(tmp_path,
                                                              monkeypatch):
    clock = iter([100.0, 102.5])
    monkeypatch.setattr(C.time, "monotonic", lambda: next(clock))
    monkeypatch.setattr(C.time, "time", lambda: 1e18)  # a wild wall clock
    tree = {"w": torch.ones(2, 2)}
    d = C.save(str(tmp_path), 3, tree)
    with open(f"{d}/MANIFEST.json") as f:
        man = json.load(f)
    # wall-clock stays as metadata; the duration field is monotonic-derived
    assert man["time"] == 1e18
    assert man["write_seconds"] == 2.5 and math.isfinite(man["write_seconds"])
    restored, step = C.restore(str(tmp_path), tree)
    assert step == 3 and torch.equal(restored["w"], tree["w"])


# ---------------------------------------------------------------------------
# fault tolerance (heartbeats on the monotonic clock)
# ---------------------------------------------------------------------------

def test_heartbeat_uses_monotonic_not_wall_clock(monkeypatch):
    t = {"mono": 1000.0}
    monkeypatch.setattr(ft.time, "monotonic", lambda: t["mono"])
    monkeypatch.setattr(ft.time, "time", lambda: 1e18)
    mgr = FaultToleranceManager(2, heartbeat_timeout=10.0)
    assert mgr.dead_hosts() == []
    t["mono"] += 5.0
    mgr.heartbeat(0)
    t["mono"] += 7.0   # host 0 heartbeat 7s ago, host 1 12s ago
    assert mgr.dead_hosts() == [1]
    assert mgr.hosts[0].last_heartbeat == 1005.0


def test_heartbeat_failure_detection():
    mgr = FaultToleranceManager(4, heartbeat_timeout=10.0)
    now = 1000.0
    for i in range(4):
        mgr.heartbeat(i, now=now)
    assert mgr.decide(now=now + 5) == Action.CONTINUE
    for i in range(3):
        mgr.heartbeat(i, now=now + 20)
    assert 3 in mgr.dead_hosts(now=now + 20)
    assert mgr.decide(now=now + 20) == Action.ELASTIC_DOWNSIZE


def test_spare_replacement_preferred():
    mgr = FaultToleranceManager(4, n_spares=1, heartbeat_timeout=10.0)
    for i in range(4):
        mgr.heartbeat(i, now=0.0)
    mgr.mark_failed(2)
    assert mgr.decide(now=0.0) == Action.REPLACE_WITH_SPARE
    mgr.mark_failed(1)  # second failure: no spares left
    assert mgr.decide(now=0.0) == Action.ELASTIC_DOWNSIZE


def test_straggler_detection_patience():
    mgr = FaultToleranceManager(4, straggler_factor=1.5, patience=3)
    for _ in range(5):
        for i in range(4):
            mgr.heartbeat(i, step_duration=10.0 if i == 2 else 1.0)
        slow = mgr.stragglers()
    assert slow == [2]
    assert mgr.decide() == Action.RESUME_SAME_MESH  # no spares: reschedule
