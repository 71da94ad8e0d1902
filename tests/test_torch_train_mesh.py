"""Training under a (data, model) mesh on the CPU: ranks spawned over gloo
as in tests/test_torch_dp.py (``launch.mesh.spawn``, a ``file://``
rendezvous, one torch thread a rank), each spawn once per module: 2 ranks
(2x1 and 1x2) and 4 (2x2). Reduced tinyllama-1.1b, QAT W2, f32
activations, ``SyntheticLM(seed=0)`` batches of 4 x 32.

  * ``train_shardings``: the logical specs are the reference's
    ``param_spec_tree``, the physical ones its ``resolve_physical_spec``
    over them, and each optimizer leaf, ``ef`` and ``step`` follow the
    reference's ``train_shardings`` rule (mirror the param where the leaf
    is an array of its rank, else replicated) for every optimizer;
  * one FSDP mesh step at 2x1, 1x2 and 2x2 from the reference's params
    (``convert.from_jax_params``) against the reference's single-device
    momentum step, with tests/test_torch_train_step.py's tolerances:
    ``loss`` / ``lm_loss`` within 1e-5 relative, ``grad_norm`` within
    1e-4, the params within rtol = atol = 1e-5;
  * every leaf's gathered gradient at 1x2 and 2x2 within 1e-4 of its own
    largest |gradient| of one device's (a collective that dropped the
    gradient, or a replicated input whose ranks' partials were not summed,
    misses by orders of magnitude);
  * FSDP on equals FSDP off bit for bit over 3 AdamW steps at 2x1 and
    2x2, with and without int8 compression (every param, m, v, ef leaf);
  * Adafactor and the 8-bit AdamW under FSDP at 2x1 against one device:
    losses within 1e-5 relative; Adafactor's params within 1e-5 of each
    leaf's largest |param|; the 8-bit AdamW's within 1e-2 of each leaf's
    largest one-device update |p1 − p0|, at most 1% of them apart by more
    than 1e-6 (its int8 v rounds a small entry to 0 at a tie in one run
    and not the other, and the update is then m / eps: the reference's
    8-bit AdamW moves the reduced embedding by up to 252 in 2 steps);
  * a row-parallel weight fake-quantized with its whole row's scale;
  * a 2x2 checkpoint (rank 0 writing the whole state) restored on one
    device equals the ranks' gathered state;
  * ``launch/train.py --mesh 2x1`` exits 0 with its loss line, resumes
    from its checkpoint; the refusals name ROADMAP.md queue 1 item 9.

The ranks' gloo meshes have lanes (``launch.mesh.GLOO_LANES``) and split
every transfer of 1 KB or more over them here, so these bit-equalities
hold through the split transport too.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.tree import tree_leaves, tree_paths
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as mesh_mod
from repro_torch.training import checkpoint as C
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as T
from repro_torch.training.data import SyntheticLM

B, S = 4, 32
LR = {"momentum": 1e-2, "adamw": 1e-3, "adamw8bit": 1e-3, "adafactor": 1e-2}


def _cfg(arch="tinyllama-1.1b"):
    return registry.get_reduced(arch).replace(activation_dtype=torch.float32)


def _batch(step, cfg=None):
    cfg = cfg or _cfg()
    return SyntheticLM(cfg.vocab_size, B, S, seed=0).batch_at(step)


def _plan(d, m, fsdp=True, coords=(0, 0)):
    return SH.AxisPlan(SH.Mesh(("data", "model"), (d, m), coords, {}),
                       fsdp="data" if fsdp else None)


def _whole_state(cfg, opt, comp=None, np_tree=None):
    """A one-device train state: the reference's params where given, else
    the port's from seed 0."""
    from repro_torch.models.convert import from_jax_params
    if np_tree is None:
        return T.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                  "cpu", grad_compression=comp)
    params = from_jax_params(np_tree, cfg, "cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    if comp:
        from repro_torch.distributed import compression
        state["ef"] = compression.init_error_feedback(params)
    return state


def _rank_train(rank, device, jobs):
    """Each job on this rank: (name, data, fsdp, optimizer, steps,
    compression, reference params or None, want step-0 gradients,
    checkpoint dir or None). Returns per job: the metrics, the gathered
    final state, the gathered step-0 gradients and the gathered state at
    the step-2 checkpoint where asked."""
    import torch.distributed as dist
    from repro_torch.core.tree import tree_map
    from repro_torch.distributed import collectives
    if device.type == "cuda":  # bit-equal runs: no atomics' sum order
        torch.use_deterministic_algorithms(True)
    else:  # the reduced model's transfers take the lanes too
        collectives.LANE_BYTES = 1024
    cfg = _cfg()
    out = {}
    for name, d, fsdp, opt_name, steps, comp, np_tree, grads, ckpt in jobs:
        plan = mesh_mod.make_plan(mesh_mod.make_serving_mesh(
            data=d, model=dist.get_world_size() // d, device=device),
            fsdp=fsdp)
        opt = O.make_optimizer(opt_name, lr=LR[opt_name])
        state = tree_map(lambda t: t.to(device), SH.shard_train_state(
            _whole_state(cfg, opt, comp, np_tree), plan, cfg))
        step = T.make_train_step(cfg, opt, plan=plan, grad_compression=comp)
        specs = T.param_specs(state["params"], plan, cfg)
        res = {}
        if grads:
            g, _ = step.grads(state, _batch(0, cfg))
            res["grads"] = [SH.whole_of(t, s, plan).cpu()
                            for t, s in zip(tree_leaves(g), specs)]
        rm = (C.RestartManager(ckpt, every=2, plan=plan, cfg=cfg)
              if ckpt else None)
        mets = []
        for s in range(steps):
            state, m = step(state, _batch(s, cfg))
            mets.append({k: float(v) for k, v in m.items()})
            if rm is not None:
                rm.maybe_save(s + 1, state)
                if s + 1 == 2:
                    res["at_ckpt"] = _cpu(SH.gather_train_state(state, plan,
                                                                specs))
        if rm is not None:
            rm.wait()
        res["metrics"] = mets
        res["state"] = _cpu(SH.gather_train_state(state, plan, specs))
        out[name] = res
    return out


def _cpu(tree):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t: t.cpu(), tree)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced tinyllama float params (numpy) and its
    jitted single-device QAT momentum step from them on batch 0."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.models import api as japi
    from repro.training import optimizer as jO
    from repro.training import train_loop as jT
    jc = jreg.get_reduced("tinyllama-1.1b").replace(
        activation_dtype=jnp.float32)
    jp = japi.init_params(jax.random.key(0), jc)
    jopt = jO.make_optimizer("momentum", lr=LR["momentum"])
    js = {"params": jp, "opt": jopt.init(jp),
          "step": jnp.zeros((), jnp.int32)}
    js2, jm = jax.jit(jT.make_train_step(jc, jopt, qat=True))(
        js, jax.tree.map(jnp.asarray, _batch(0)))
    return {"np": jax.tree.map(np.asarray, jp),
            "params": jax.tree.map(np.asarray, js2["params"]),
            "metrics": {k: float(v) for k, v in jm.items()}}


def _jobs(world, ref_np, ckpt):
    """The jobs of a spawn of ``world`` ranks."""
    d2 = [("ref", 2, True, "momentum", 1, None, ref_np, True, None)]
    if world == 2:
        d2.append(("ref_1x2", 1, True, "momentum", 1, None, ref_np, True,
                   None))
    for comp in (None, "int8"):
        for fsdp in (False, True):
            d2.append((f"adamw_{comp}_{fsdp}", 2, fsdp, "adamw", 3, comp,
                       None, False,
                       ckpt if world == 4 and fsdp and comp is None
                       else None))
    if world == 2:
        d2 += [(f"{o}_fsdp", 2, True, o, 2, None, None, False, None)
               for o in ("adafactor", "adamw8bit")]
    return d2


@pytest.fixture(scope="module")
def spawned(ref, tmp_path_factory):
    """world -> every rank's results (rank order), each world spawned
    once."""
    cache = {}

    def get(world):
        if world not in cache:
            tmp = tmp_path_factory.mktemp(f"train_mesh{world}")
            ckpt = str(tmp / "ckpt")
            cache[world] = (mesh_mod.spawn(
                _rank_train, world, device="cpu",
                init_method=f"file://{tmp / 'init'}",
                args=(_jobs(world, ref["np"], ckpt),), threads=1), ckpt)
        return cache[world][0]

    get.ckpt = lambda world: cache[world][1]
    return get


def _one_device(opt_name, steps, comp=None, np_tree=None):
    cfg = _cfg()
    opt = O.make_optimizer(opt_name, lr=LR[opt_name])
    state = _whole_state(cfg, opt, comp, np_tree)
    step = T.make_train_step(cfg, opt, grad_compression=comp)
    mets = []
    for s in range(steps):
        state, m = step(state, _batch(s, cfg))
        mets.append({k: float(v) for k, v in m.items()})
    return state, mets


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# ---------------------------------------------------------------------------
# the specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_name", ["adamw", "adamw8bit", "adafactor",
                                      "momentum"])
def test_train_shardings_follow_the_reference(opt_name):
    import jax
    from repro.configs import registry as jreg
    from repro.distributed import sharding as jSH
    from repro.distributed._compat import make_mesh
    from repro.launch.mesh import make_plan as jmake_plan
    from repro.training import optimizer as jO
    from repro.training import train_loop as jT
    cfg = _cfg()
    jc = jreg.get_reduced("tinyllama-1.1b")
    jopt = jO.make_optimizer(opt_name)
    jstate = jT.init_train_state(jax.random.key(0), jc, jopt,
                                 grad_compression="int8")
    topt = O.make_optimizer(opt_name)
    state = T.init_train_state(torch.Generator().manual_seed(0), cfg, topt,
                               "cpu", grad_compression="int8")
    plan = _plan(2, 2)
    sh = T.train_shardings(state, plan, cfg)
    # params: the reference's logical specs (its stacked layers' leading
    # None dropped), resolved as the reference resolves them on a 2x2 mesh
    jlogical = jax.tree_util.tree_flatten_with_path(
        jSH.param_spec_tree(jstate["params"]),
        is_leaf=lambda x: isinstance(x, tuple))[0]
    want = {}
    for path, spec in jlogical:
        key = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        want[tuple(key)] = spec[1:] if key[0] == "layers" else spec
    logical = SH.param_spec_tree(state["params"])
    sizes = {"data": 2, "model": 2}
    for path, leaf in tree_paths(state["params"]):
        keys = [k.strip("'") for k in path.strip("[]").split("][")]
        lkey = tuple(k for k in keys if not k.isdigit())
        node_l, node_p = logical, sh["params"]
        for k in keys:
            node_l = node_l[int(k)] if k.isdigit() else node_l[k]
            node_p = node_p[int(k)] if k.isdigit() else node_p[k]
        assert node_l == want[lkey], path
        phys = jSH.resolve_physical_spec(
            tuple(leaf.shape), [{"model": "model", "fsdp": "data"}.get(a)
                                for a in node_l], sizes)
        assert node_p == phys, path
    # optimizer state, ef and step: the reference's rule, read from its
    # train_shardings on a 1x1 mesh (a mirrored leaf carries its param's
    # spec, a replicated one P(), a dict leaf a dict of P()), compared by
    # leaf kind (the reference stacks a layer leaf's copies)
    jsh = jT.train_shardings(jstate, jmake_plan(make_mesh((1, 1),
                                                          ("data",
                                                           "model"))))
    jdef = jax.tree_util.tree_structure(jsh["params"])
    jnames = [tuple(getattr(k, "key", None) for k in path if hasattr(
        k, "key")) for path, _ in jax.tree_util.tree_flatten_with_path(
            jsh["params"])[0]]
    pspecs = [s for _, s in _spec_leaves(sh["params"])]
    kinds = [tuple(k.strip("'") for k in path.strip("[]").split("][")
                   if not k.isdigit())
             for path, _ in tree_paths(state["params"])]
    for k, sub in jsh["opt"].items():
        if k == "step":
            assert tuple(sub.spec) == () and sh["opt"]["step"] == ()
            continue
        jobj = jdef.flatten_up_to(sub)
        jflag = {name: not isinstance(o, dict) and o.spec == p.spec
                 for name, o, p in zip(jnames, jobj, jdef.flatten_up_to(
                     jsh["params"]))}
        jdict = {name: isinstance(o, dict) for name, o in zip(jnames, jobj)}
        objs = _per_param(state["params"], sh["opt"][k])
        leaves = _per_param(state["params"], state["opt"][k])
        for kind, o, spec, leaf in zip(kinds, objs, pspecs, leaves):
            mirrored = o == spec
            # the port's rule on its own state
            assert mirrored == (torch.is_tensor(leaf)
                                and leaf.dim() == len(spec)), (k, kind)
            if opt_name == "adamw8bit" and isinstance(leaf, dict) != \
                    jdict[kind]:
                continue  # int8 or not: 2048 elements of a layer or a stack
            assert mirrored == jflag[kind], (opt_name, k, kind)
    assert sh["ef"] == sh["params"] and sh["step"] == ()


def _spec_leaves(spec_tree, path=""):
    """(path, spec) of a spec tree (specs are tuples: the leaves)."""
    if isinstance(spec_tree, dict):
        return [x for k, v in spec_tree.items()
                for x in _spec_leaves(v, f"{path}/{k}")]
    if isinstance(spec_tree, list):
        return [x for i, v in enumerate(spec_tree)
                for x in _spec_leaves(v, f"{path}/{i}")]
    return [(path, spec_tree)]


def _per_param(params, sub):
    """The object of ``sub`` at each of ``params``'s leaves, in order."""
    from repro_torch.core.tree import tree_map_with_path
    out = []
    tree_map_with_path(lambda _, __, x: out.append(x), params, sub)
    return out


# ---------------------------------------------------------------------------
# the mesh step against the reference and one device
# ---------------------------------------------------------------------------

REF_LEGS = pytest.mark.parametrize("name,world", [("ref", 2), ("ref_1x2", 2),
                                                  ("ref", 4)],
                                   ids=["2x1", "1x2", "2x2"])


@REF_LEGS
def test_one_fsdp_step_matches_the_reference(spawned, ref, name, world):
    from repro_torch.models.convert import from_jax_params
    res = spawned(world)
    r0 = res[0][name]
    got = r0["metrics"][0]
    assert set(got) == set(ref["metrics"]) == {"loss", "lm_loss",
                                               "grad_norm"}
    for k, want in ref["metrics"].items():
        tol = 1e-4 if k == "grad_norm" else 1e-5
        assert np.isfinite(got[k]) and abs(got[k] - want) <= tol * abs(
            want), k
    want_p = from_jax_params(ref["params"], _cfg(), "cpu")
    for (path, g), w in zip(tree_paths(r0["state"]["params"]),
                            tree_leaves(want_p)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=path)
    assert int(r0["state"]["step"]) == 1
    for r in res:  # every rank: the same metrics, the same whole state
        assert r[name]["metrics"] == r0["metrics"]
        assert _equal(r[name]["state"], r0["state"])


@REF_LEGS
def test_gradients_through_the_collectives(spawned, ref, name, world):
    """Every leaf's gathered gradient against one device's: a collective
    with no backward rule (no gradient upstream of it), or a replicated
    input whose ranks' partial gradients are not summed, misses this by
    orders of magnitude."""
    cfg = _cfg()
    opt = O.make_optimizer("momentum", lr=LR["momentum"])
    want, _ = T.make_train_step(cfg, opt).grads(
        _whole_state(cfg, opt, np_tree=ref["np"]), _batch(0, cfg))
    got = spawned(world)[0][name]["grads"]
    assert len(got) == len(tree_leaves(want)) == 21
    for (path, w), g in zip(tree_paths(want), got):
        scale = w.abs().max().item()
        assert scale > 0, path
        assert (g - w).abs().max().item() <= 1e-4 * scale, path


@pytest.mark.parametrize("comp", [None, "int8"], ids=["plain", "int8"])
@pytest.mark.parametrize("world", [2, 4], ids=["2x1", "2x2"])
def test_fsdp_equals_no_fsdp(spawned, world, comp):
    """FSDP changes where leaves live, not a bit: every rank's gathered
    state (params, AdamW's m and v, ef) and metrics after 3 steps with
    FSDP equal those without; both within 1e-4 of one device's losses."""
    res = spawned(world)
    _, one = _one_device("adamw", 3, comp)
    for r in res:
        on, off = r[f"adamw_{comp}_True"], r[f"adamw_{comp}_False"]
        assert on["metrics"] == off["metrics"]
        assert _equal(on["state"], off["state"])
        names = [p for p, _ in tree_paths(on["state"])]
        assert any(".ef" in n or "['ef']" in n for n in names) == (
            comp == "int8")
        for m, w in zip(on["metrics"], one):
            for k in ("loss", "lm_loss"):
                assert abs(m[k] - w[k]) <= 1e-4 * abs(w[k]), k


@pytest.mark.parametrize("opt_name", ["adafactor", "adamw8bit"])
def test_replicated_optimizer_state_under_fsdp(spawned, opt_name):
    """The reference replicates Adafactor's factored vectors and the 8-bit
    AdamW's {"q", "s"}: each such leaf is updated whole on every rank, so
    the int8 blocks are the whole leaf's; against one device (tolerances:
    module docstring)."""
    steps = 2
    res = spawned(2)
    got = res[0][f"{opt_name}_fsdp"]
    for r in res:
        assert _equal(r[f"{opt_name}_fsdp"]["state"], got["state"])
    one_state, one = _one_device(opt_name, steps)
    for m, w in zip(got["metrics"], one):
        assert abs(m["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
    start = _whole_state(_cfg(), O.make_optimizer(opt_name))["params"]
    far = total = 0
    for (path, g), w, p0 in zip(tree_paths(got["state"]["params"]),
                                tree_leaves(one_state["params"]),
                                tree_leaves(start)):
        d = (g - w).abs()
        if opt_name == "adafactor":
            assert d.max().item() <= 1e-5 * w.abs().max().item(), path
        else:
            moved = (w - p0).abs().max().item()
            assert d.max().item() <= 1e-2 * moved, path
            far += int((d > 1e-6).sum())
            total += d.numel()
    if opt_name == "adamw8bit":
        assert far <= 0.01 * total, (far, total)


@pytest.mark.parametrize("scheme", ["symmetric", "ternary"])
def test_row_parallel_fake_quant_takes_the_whole_row_scale(scheme):
    """A row-parallel weight's K-blocks (the ranks' blocks, contracted in
    turn on one device as the mesh's control does) fake-quantized with
    the whole rows' scale give the whole weight's product; each block's
    own scale gives another function."""
    from repro_torch.core.quantize import fake_quant
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(64, 48, generator=gen)
    w[:32] *= 4.0  # the first K-block's absmax and mean |w| are larger
    x = torch.randn(3, 64, generator=gen)
    quant = {"qat": True, "weight_bits": 2, "scheme": scheme}
    whole = L.lut_dense({"w": w}, x, quant)
    blocks = [{"w": w[:32].clone()}, {"w": w[32:].clone()}]
    split = L.lut_dense({"blocks": ("row", blocks)}, x, quant)
    torch.testing.assert_close(split, whole, rtol=1e-5, atol=1e-5)
    own = sum(x[:, 32 * r:32 * (r + 1)] @ fake_quant(b["w"].T, 2, scheme).T
              for r, b in enumerate(blocks))
    assert (own - whole).abs().max().item() > 1e-2


def test_a_2x2_checkpoint_restores_on_one_device(spawned):
    """The 2x2 FSDP run checkpoints at step 2 (rank 0 writes the whole
    state, the single-device format): a one-device restore holds every
    leaf of the ranks' gathered step-2 state."""
    res = spawned(4)
    at = res[0]["adamw_None_True"]["at_ckpt"]
    for r in res:
        assert _equal(r["adamw_None_True"]["at_ckpt"], at)
    cfg = _cfg()
    opt = O.make_optimizer("adamw", lr=LR["adamw"])
    skeleton = T.init_train_state(torch.Generator().manual_seed(1), cfg,
                                  opt, "cpu")
    restored, step = C.RestartManager(spawned.ckpt(4)).restore_or_none(
        skeleton)
    assert step == 2 and int(restored["step"]) == 2
    assert [p for p, _ in tree_paths(restored)] == \
        [p for p, _ in tree_paths(at)]
    assert _equal(restored, at)


def test_train_main_on_a_mesh(tmp_path, capfd):
    from repro_torch.launch import train
    args = ["--reduced", "--device", "cpu", "--mesh", "2x1", "--batch",
            "4", "--seq", "32", "--lr", "3e-3", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2", "--log-every", "2"]
    assert train.main(args + ["--steps", "4"]) == 0
    out = capfd.readouterr().out
    assert "training mesh 2x1 (data x model), FSDP over data, backend " \
        "gloo" in out
    assert out.count("loss ") == 3 and "over 4 steps" in out  # rank 0
    assert C.list_steps(str(tmp_path)) == [2, 4]
    assert train.main(args + ["--steps", "6"]) == 0
    out = capfd.readouterr().out
    assert "resumed from step 4" in out and "over 2 steps" in out


@pytest.mark.parametrize("arch,step", [
    ("olmoe-1b-7b", "step 3"), ("falcon-mamba-7b", "step 8"),
    ("zamba2-7b", "step 8"), ("llama-3.2-vision-11b", "step 8"),
    ("whisper-tiny", "step 8")])
def test_training_mesh_refusals(arch, step):
    cfg = _cfg(arch)
    opt = O.make_optimizer("adamw")
    for plan in (_plan(2, 1), _plan(1, 2), _plan(2, 2, fsdp=False)):
        with pytest.raises(ValueError, match=f"queue 1 item 9 {step}"):
            T.make_train_step(cfg, opt, plan=plan)
        with pytest.raises(ValueError, match=f"queue 1 item 9 {step}"):
            T.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                               "cpu", plan=plan)
    with pytest.raises(ValueError, match="item 9 step 5"):
        mesh_mod.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="16x16 needs 256 ranks, have 1"):
        mesh_mod.make_production_mesh()


@pytest.mark.parametrize("opt_name", ["adamw", "adamw8bit", "adafactor"])
@pytest.mark.parametrize("shape,coords", [((2, 1), (1, 0)), ((1, 2), (0, 1)),
                                          ((2, 2), (1, 1))],
                         ids=["2x1", "1x2", "2x2"])
def test_a_rank_builds_its_own_state(opt_name, shape, coords):
    """``init_train_state(plan=)`` draws the whole build's sequence and
    keeps this rank's blocks (no process group needed): leaf for leaf
    ``shard_train_state`` of the whole state, the replicated optimizer
    state (int8 pairs, Adafactor's vectors) whole, and ``gather``'s
    inverse on the shapes."""
    cfg = _cfg()
    opt = O.make_optimizer(opt_name)
    plan = _plan(*shape, coords=coords)
    got = T.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                             "cpu", grad_compression="int8", plan=plan)
    want = SH.shard_train_state(
        T.init_train_state(torch.Generator().manual_seed(0), cfg, opt, "cpu",
                           grad_compression="int8"), plan, cfg)
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in tree_paths(want)]
    assert _equal(got, want)
    held = sum(t.numel() for t in tree_leaves(got["params"]))
    whole = sum(t.numel() for t in tree_leaves(_whole_state(
        cfg, opt)["params"]))
    assert held < whole / 2 + 1000  # the norms' vectors stay whole
