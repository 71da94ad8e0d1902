"""The port's train loop and its entry point, ``repro_torch.launch.train``, on
the CPU at reduced size (f32 activations): the reference's contracts
(tests/test_training.py, tests/test_system.py) inside the port.

  * microbatches = 2 gives the params of microbatches = 1 (the reference's
    tolerance, rtol 2e-3 / atol 2e-5) and the same metrics;
  * the QAT loss falls over 30 AdamW steps for reduced tinyllama-1.1b and
    olmoe-1b-7b;
  * the entry point checkpoints, resumes ("resumed from step 20"), and 10
    straight steps give bit-equal final params and optimizer state to 5
    steps, a restart from the step-5 checkpoint and 5 more;
  * without a card and without ``--device cpu`` it raises; ``--mesh
    single`` (the reference's 16x16) fails on one rank with the rank
    count, ``--mesh multi`` (its pod axis) with that count or the
    refusal naming ROADMAP.md queue 1 item 9 step 5 (``--mesh DxM``
    trains: tests/test_torch_train_mesh.py).
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.training import checkpoint as C
from repro_torch.training import optimizer as O
from repro_torch.training.data import SyntheticLM
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step)
from repro_torch.core.tree import tree_leaves

ARGS = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--lr", "3e-3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one CPU thread here (xdist runs JAX files beside us)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(arch):
    return registry.get_reduced(arch).replace(activation_dtype=torch.float32)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_train_with_microbatches_matches_full_batch():
    cfg = _cfg("tinyllama-1.1b")
    opt = O.make_optimizer("momentum", lr=1e-2)
    batch = SyntheticLM(cfg.vocab_size, 4, 16, seed=0).batch_at(0)
    s0 = init_train_state(_gen(1), cfg, opt, "cpu")
    s1, m1 = make_train_step(cfg, opt, microbatches=1, qat=False)(s0, batch)
    s2, m2 = make_train_step(cfg, opt, microbatches=2, qat=False)(s0, batch)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)
    assert set(m1) == set(m2)
    for k in m1:
        np.testing.assert_allclose(float(m1[k]), float(m2[k]), rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, opt, microbatches=3)(s0, batch)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_train_loss_decreases(arch):
    cfg = _cfg(arch)
    opt = O.make_optimizer("adamw", lr=3e-3)
    step_fn = make_train_step(cfg, opt, qat=True)
    state = init_train_state(_gen(0), cfg, opt, "cpu")
    data = SyntheticLM(cfg.vocab_size, 4, 32, seed=0)
    losses = []
    for s in range(30):
        state, metrics = step_fn(state, data.batch_at(s))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_train_main_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    assert train.main(ARGS + ["--steps", "20", "--ckpt-dir", ckpt,
                              "--ckpt-every", "10"]) == 0
    out = capsys.readouterr().out
    assert "step    20  loss" in out and "ms/step" in out
    assert "loss " in out and "over 20 steps" in out
    assert C.list_steps(ckpt) == [10, 20]
    assert train.main(ARGS + ["--steps", "25", "--ckpt-dir", ckpt,
                              "--ckpt-every", "10"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 20" in out and "over 5 steps" in out
    assert C.latest_step(ckpt) == 25
    assert train.main(ARGS + ["--steps", "25", "--ckpt-dir", ckpt]) == 0
    assert "no steps to run" in capsys.readouterr().out


def test_restart_is_bit_equal_to_a_straight_run(tmp_path):
    """10 straight steps against 5, a restart from the step-5 checkpoint,
    and 5 more: every leaf of the final checkpoints (params, AdamW m and v,
    the step counters) equal bit for bit. The schedule's warmup (20 steps)
    covers both runs, so their lr does not depend on --steps."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert train.main(ARGS + ["--steps", "10", "--ckpt-dir", a]) == 0
    assert train.main(ARGS + ["--steps", "5", "--ckpt-dir", b]) == 0
    assert train.main(ARGS + ["--steps", "10", "--ckpt-dir", b]) == 0
    da, db = (np.load(os.path.join(d, "step_00000010", "shard_0.npz"))
              for d in (a, b))
    assert sorted(da.files) == sorted(db.files) and len(da.files) > 20
    for k in da.files:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_train_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    # the library entry point defaults to the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(_gen(0), _cfg("tinyllama-1.1b"),
                         O.make_optimizer("adamw"))


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_train_main_refuses_a_mesh(mesh, capsys):
    with pytest.raises(SystemExit):
        train.main(ARGS + ["--steps", "1", "--mesh", mesh])
    err = capsys.readouterr().err
    if mesh == "single":
        assert "16x16 needs 256 ranks, have 1" in err
    else:
        assert ("16x16 needs 256 ranks" in err
                or "queue 1 item 9 step 5" in err)
