"""Port parity, QAT training on the SSM, hybrid, VLM and audio families:
reduced falcon-mamba-7b (Mamba1), zamba2-7b (Mamba2 and the shared
attention block, invoked twice), llama-3.2-vision-11b (gated cross layers
over 16 image tokens) and whisper-tiny (encoder over 24 audio frames and
the decoder's cross attention), one step through
``repro_torch.training.train_loop.make_train_step`` against ``repro``'s
(jitted) on the CPU, f32 activations.

Setup: the reference's float params from ``api.init_params(
jax.random.key(2), cfg)`` (tests/test_archs_smoke.py's
``test_train_grad_step``), the VLM's cross gates drawn nonzero (a zero
gate makes tanh(0) multiply the cross layer out, so its leaves would get
no gradient), loaded through ``convert.from_jax_params``; a batch of 2 × 8
tokens with ``image_embeds`` / ``audio_frames`` drawn as that file's
``_batch`` draws them (normal × 0.1), labels the tokens rolled by one.

Tolerances, those of tests/test_torch_train_step.py: ``loss`` and
``lm_loss`` within 1e-5 relative, ``grad_norm`` within 1e-4 relative, the
params after one **momentum** step (lr 1e-2) within rtol = atol = 1e-5, and
each leaf's gradient (momentum's first m) within 1e-4 of that leaf's
largest |gradient|. The scans' own leaves (``A_log``, ``D``, ``conv_w``,
``conv_b``, ``dt_proj``) take ``SCAN_TOL`` = 1e-3: the port's chunk scans
sum in closed form from cumulative sums, the reference multiplies decays
in an associative scan, so the gradients reaching them through the
recurrence differ in their last bits. Measured: the largest gradient
deviation of a scan leaf 6.9e-5 of its scale (zamba2-7b's ``A_log``;
falcon-mamba-7b's 3.5e-6, at ``dt_proj``), of any other leaf 3.0e-5
(zamba2-7b's float ``in_proj``; the VLM's and whisper's 3.3e-6); losses
within 1.4e-7 relative, grad norms within 9.3e-7, params within 5.5e-6.

Also here: the grad-recording Mamba1 scan (out-of-place, each chunk
recomputed in the backward pass) gives the serving scan's bits and keeps
no chunk's segment weights for the backward pass; microbatches of whisper
(its audio frames split with the tokens) against the full batch; and
``launch/train.py --reduced`` training falcon-mamba-7b and zamba2-7b with
the loss falling, and refusing the VLM and whisper by the missing input.
"""

import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.training import optimizer as jO
from repro.training import train_loop as jT
from repro_torch.configs import registry as treg
from repro_torch.core.tree import tree_leaves, tree_paths
from repro_torch.launch import train
from repro_torch.models import api as tapi
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import from_jax_params
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as T

SSM, HYBRID, VLM, AUDIO = ("falcon-mamba-7b", "zamba2-7b",
                           "llama-3.2-vision-11b", "whisper-tiny")
ARCHS = [SSM, HYBRID, VLM, AUDIO]
SCAN_LEAVES = ("A_log", "D", "conv_w", "conv_b", "dt_proj")
SCAN_TOL = 1e-3
ARGS = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
        "--lr", "3e-3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    return (jreg.get_reduced(arch).replace(activation_dtype=jnp.float32),
            treg.get_reduced(arch).replace(activation_dtype=torch.float32))


def _batch(cfg, b=2, s=8, seed=3):
    """tests/test_archs_smoke.py's ``_batch`` (numpy), with labels."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.family == "vlm":
        batch["image_embeds"] = (rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)) * 0.1).astype(
                np.float32)
    if cfg.family == "audio":
        batch["audio_frames"] = (rng.normal(
            size=(b, cfg.n_audio_frames, cfg.d_model)) * 0.1).astype(
                np.float32)
    return batch


def _ref_params(jc):
    """The reference's float params, the VLM's gates nonzero."""
    params = japi.init_params(jax.random.key(2), jc)
    if jc.family == "vlm":
        rng = np.random.default_rng(7)
        xl = dict(params["xattn_layers"])
        for name in ("gate_attn", "gate_mlp"):
            shape = xl[name].shape
            xl[name] = jnp.asarray(rng.choice([-1.0, 1.0], size=shape)
                                   * rng.uniform(0.3, 1.0, size=shape),
                                   jnp.float32)
        params = dict(params, xattn_layers=xl)
    return params


def _leaf_tol(name):
    """SCAN_TOL for a leaf of a scan's own, 1e-4 for the rest. ``name`` is
    a ``tree_paths`` path, such as "['layers'][1]['ssm']['dt_proj']['w']"."""
    return (SCAN_TOL if any(f"['{k}']" in name for k in SCAN_LEAVES)
            else 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_qat_train_step_matches_reference(arch):
    jc, tc = _cfgs(arch)
    jp = _ref_params(jc)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, "cpu")
    jopt = jO.make_optimizer("momentum", lr=1e-2)
    topt = O.make_optimizer("momentum", lr=1e-2)
    js = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    ts = {"params": tp, "opt": topt.init(tp),
          "step": torch.zeros((), dtype=torch.int32)}
    batch = _batch(tc)
    js2, jm = jax.jit(jT.make_train_step(jc, jopt, qat=True))(
        js, jax.tree.map(jnp.asarray, batch))
    ts2, tm = T.make_train_step(tc, topt, qat=True)(ts, batch)

    assert set(tm) == set(jm) == {"loss", "lm_loss", "grad_norm"}
    for k in tm:
        tol = 1e-4 if k == "grad_norm" else 1e-5
        want, got = float(jm[k]), float(tm[k])
        assert np.isfinite(got) and abs(got - want) <= tol * abs(want), (
            k, got, want)
    assert int(ts2["step"]) == 1
    want_p = from_jax_params(jax.tree.map(np.asarray, js2["params"]), tc,
                             "cpu")
    for (name, got), want in zip(tree_paths(ts2["params"]),
                                 tree_leaves(want_p)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # each leaf's gradient (momentum's first m), against its own scale
    want_m = from_jax_params(jax.tree.map(np.asarray, js2["opt"]["m"]), tc,
                             "cpu")
    for (name, got), want in zip(tree_paths(ts2["opt"]["m"]),
                                 tree_leaves(want_m)):
        got, want = got.numpy(), want.numpy()
        scale = np.abs(want).max()
        assert scale > 0, name
        assert np.abs(got - want).max() <= _leaf_tol(name) * scale, (
            name, np.abs(got - want).max() / scale)


def _scan_inputs(requires_grad):
    """Mamba1 scan inputs at reduced falcon-mamba-7b's d_inner (8192) and
    state (4), B 2, S 10 (two chunks of 4 and a padded one)."""
    cfg = treg.get_reduced(SSM)
    g = torch.Generator()
    g.manual_seed(0)
    b, s, di, ds = 2, 10, cfg.d_inner, cfg.ssm_state
    rnd = lambda *shape: torch.randn(*shape, generator=g)
    ins = [torch.nn.functional.softplus(rnd(b, s, di)), rnd(b, s, di),
           rnd(b, s, ds), rnd(b, s, ds),
           -torch.exp(rnd(di, ds) * 0.5), rnd(b, di, ds) * 0.1]
    return cfg, [t.requires_grad_(requires_grad) for t in ins]


def test_recording_mamba1_scan_gives_the_serving_bits():
    """The training forward's scan (out-of-place ops, each chunk under
    ``checkpoint``) equals the in-place serving scan bit for bit, and the
    tensors autograd keeps for the backward pass hold no chunk's
    [B, c, c, di, ds] segment weights (nor the product with them)."""
    cfg, serve_in = _scan_inputs(False)
    _, train_in = _scan_inputs(True)
    c = cfg.ssm_chunk
    y0, h0 = tssm._mamba1_scan(*serve_in, c)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y1, h1 = tssm._mamba1_scan(*train_in, c)
    assert y1.requires_grad and torch.equal(y0, y1) and torch.equal(h0, h1)
    b, _, di = serve_in[0].shape
    assert saved and max(saved) < b * c * c * di * cfg.ssm_state, max(saved)
    grads = torch.autograd.grad((y1.square().sum() + h1.sum()), train_in)
    assert all(torch.isfinite(gr).all() for gr in grads)


def test_recording_model_forward_gives_the_serving_bits():
    """Whole reduced falcon-mamba-7b and zamba2-7b forwards (QAT) with the
    params recording gradients give the logits of the same params without."""
    for arch in (SSM, HYBRID):
        _, tc = _cfgs(arch)
        tc = tc.with_quant(qat=True)
        g = torch.Generator()
        g.manual_seed(1)
        params = tapi.init_params(g, tc, "cpu", serve_quantized=False)
        batch = {"tokens": torch.as_tensor(_batch(tc, 2, 12)["tokens"],
                                           dtype=torch.int64)}
        want = tapi.forward(params, batch, tc)[0]
        for p in tree_leaves(params):
            p.requires_grad_()
        got = tapi.forward(params, batch, tc)[0]
        assert got.requires_grad and torch.equal(got, want), arch


def test_microbatches_split_the_audio_frames():
    """whisper-tiny, batch 4 in two microbatches: the audio frames split
    with the tokens; params and metrics as the full batch's (the
    reference's tolerance for microbatching, rtol 2e-3 / atol 2e-5)."""
    _, tc = _cfgs(AUDIO)
    opt = O.make_optimizer("momentum", lr=1e-2)
    g = torch.Generator()
    g.manual_seed(1)
    s0 = T.init_train_state(g, tc, opt, "cpu")
    batch = _batch(tc, 4, 8, seed=5)
    s1, m1 = T.make_train_step(tc, opt, microbatches=1)(s0, batch)
    s2, m2 = T.make_train_step(tc, opt, microbatches=2)(s0, batch)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)
    assert set(m1) == set(m2)
    for k in m1:
        np.testing.assert_allclose(float(m1[k]), float(m2[k]), rtol=1e-5)
    # float inputs stay float on the device (an int cast would zero them)
    moved = T._to_device(batch, "cpu")
    assert moved["audio_frames"].dtype == torch.float32
    assert torch.equal(moved["audio_frames"],
                       torch.from_numpy(batch["audio_frames"]))
    assert moved["tokens"].dtype == torch.int64


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_train_main_trains_the_ssm_families(arch, capsys):
    assert train.main(ARGS + ["--arch", arch, "--steps", "20",
                              "--log-every", "10"]) == 0
    out = capsys.readouterr().out
    first, last = map(float, re.search(
        r"loss ([\d.]+) -> ([\d.]+) over 20 steps", out).groups())
    assert np.isfinite([first, last]).all() and last < first, out


@pytest.mark.parametrize("arch,missing", [(VLM, "image_embeds"),
                                          (AUDIO, "audio_frames")])
def test_train_main_refuses_the_frontend_families(arch, missing):
    with pytest.raises(ValueError, match=missing):
        train.main(ARGS + ["--arch", arch, "--steps", "1"])


def test_adamw8bit_on_rows_without_gradient_is_the_reference():
    """The 8-bit AdamW (m and v as linear absmax INT8 codes in blocks of
    2048) on an embedding-like leaf [64, 64] whose first 32 rows get no
    gradient at step 2 (tokens absent from the batch): the port's codes,
    scales and params equal the reference's. Where v's code rounded to 0
    (|g| below ~1/22 of its block's largest) and the gradient is 0, both
    update by lr · m / eps: measured here, the zero rows move by up to
    9.4 in one step at lr 1e-3 (weights of scale 0.02; the rows with a
    gradient by up to 0.023), the divergence of phase 16's 8-bit record on
    the card (PERF.md §6)."""
    from repro.training import optimizer as jopt
    rng = np.random.default_rng(0)
    p0 = (rng.normal(size=(64, 64)) * 0.02).astype(np.float32)
    g1 = (rng.normal(size=(64, 64)) * 1e-3).astype(np.float32)
    g2 = (rng.normal(size=(64, 64)) * 1e-3).astype(np.float32)
    g2[:32] = 0.0
    jo, to = (jopt.make_optimizer("adamw8bit", lr=1e-3),
              O.make_optimizer("adamw8bit", lr=1e-3))
    jp, tp = {"w": jnp.asarray(p0)}, {"w": torch.from_numpy(p0.copy())}
    js, ts = jo.init(jp), to.init(tp)
    for g in (g1, g2):
        before = tp["w"].clone()
        jp, js = jo.update({"w": jnp.asarray(g)}, js, jp)
        tp, ts = to.update({"w": torch.from_numpy(g)}, ts, tp)
        for mv in ("m", "v"):
            np.testing.assert_array_equal(ts[mv]["w"]["q"].numpy(),
                                          np.asarray(js[mv]["w"]["q"]))
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-7)
    jump = (tp["w"] - before)[:32].abs().max().item()
    assert jump > 1.0, jump  # vs ~1e-3 for an AdamW step
