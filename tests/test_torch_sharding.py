"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), and ``shard_params``'s
per-rank blocks, on the CPU with no process group.

  * every leaf's logical spec of the port's tree equals the reference's on
    its stacked tree, less the stacked leading ``None``s, for reduced
    tinyllama-1.1b, paper-bitnet-3b (ternary packing), olmoe-1b-7b and
    qwen2-72b, packed and float;
  * ``resolve_physical_spec`` and ``packed_group_bytes`` equal the
    reference's over ``tests/test_collectives.py``'s sweep, and its two
    hypothesis properties hold of the port's function;
  * an unmatched leaf raises with its path;
  * ``kernels.ops.plan_local_shape`` keeps the reference's contract, and
    ``resolve_dispatch`` takes a rank's local shape as it is;
  * ``shard_params``: each rank's block of every projection dequantizes to
    its block of the whole weight, attention splits by whole KV heads (and
    runs whole where they do not divide), the router stays whole, expert
    stacks split along E, a 1x1 plan is the single-device tree.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.core import quantize as JQ
from repro.distributed import sharding as JSH
from repro.models import api as japi
from repro_torch.configs import registry as treg
from repro_torch.core import quantize as Q
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models.convert import from_jax_params
from repro_torch.obs import dispatch as dispatch_obs

ARCHS = ["tinyllama-1.1b", "paper-bitnet-3b", "olmoe-1b-7b", "qwen2-72b"]
AXES = {"data": 2, "model": 4, "pod": 2}


def _plan(model: int, rank: int = 0) -> SH.AxisPlan:
    """A 1 x ``model`` plan as rank ``rank`` sees it (no process group:
    nothing here calls a collective)."""
    mesh = SH.Mesh(("data", "model"), (1, model), (0, rank),
                   {"data": None, "model": None})
    return SH.AxisPlan(mesh=mesh)


def _port_specs(tree, path=""):
    """(path, spec) pairs of the port's spec tree, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_specs(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_specs(v, f"{path}/{i}")
    else:
        yield path, tree


def _unstacked(path: str) -> str:
    """A port path with its list indices dropped: the reference's path."""
    return "/".join(p for p in path.split("/") if not p.isdigit())


@pytest.mark.parametrize("quantized", [True, False], ids=["packed", "float"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_tree_matches_reference(arch, quantized):
    jc = jreg.get_reduced(arch)
    tc = treg.get_reduced(arch)
    shapes = jax.eval_shape(lambda: japi.init_params(
        jax.random.key(0), jc, serve_quantized=quantized))
    ref, _ = JSH._spec_leaves(shapes, JSH.DEFAULT_RULES)
    want = {JSH._path_str(path): spec for path, _, spec in ref}
    port = from_jax_params(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), tc, "cpu")
    got = list(_port_specs(SH.param_spec_tree(port)))
    assert got and len({_unstacked(p) for p, _ in got}) == len(want)
    for path, spec in got:
        ref_spec = want[_unstacked(path)]
        lead = len(ref_spec) - len(spec)
        assert lead >= 0 and ref_spec[:lead] == (None,) * lead, path
        assert tuple(ref_spec[lead:]) == spec, path
    if quantized:
        layer = [s for p, s in got if p == "layers/0/attn/wq/qw/packed"
                 or p == "layers/0/attn/wq/w"]
        assert layer in ([("model", None)], [("fsdp", "model")])


def test_unmatched_leaf_raises_with_its_path():
    params = {"layers": [{"mystery_block": {"theta": torch.zeros(4, 4)}}]}
    with pytest.raises(ValueError, match="layers/0/mystery_block/theta"):
        SH.param_spec_tree(params)


SWEEP = [((6, 10), ("data", "model"), 1), ((8, 12), ("data", "model"), 1),
         ((8,), (("pod", "data"),), 1), ((6,), (("pod", "data"),), 1),
         ((8, 16), (None, "model"), 2), ((8, 4), (None, "model"), 2),
         ((64, 48), ("model", "model"), 3), ((7, 9), (None, None), 1)]


@pytest.mark.parametrize("shape,axes,align", SWEEP)
def test_resolve_physical_spec_matches_reference(shape, axes, align):
    assert SH.resolve_physical_spec(shape, axes, AXES, last_dim_align=align) \
        == JSH.resolve_physical_spec(shape, axes, AXES, last_dim_align=align)


@pytest.mark.parametrize("n,k,bits", [(8, 32, 4), (8, 32, 2), (8, 16, 3),
                                      (16, 64, 1), (8, 64, 3)])
def test_packed_group_bytes_matches_reference(n, k, bits):
    w = np.random.default_rng(0).normal(size=(n, k)).astype(np.float32)
    got = SH.packed_group_bytes(Q.quantize(torch.from_numpy(w), bits,
                                           k_group=4))
    assert got == JSH.packed_group_bytes(JQ.quantize(jnp.asarray(w), bits,
                                                     k_group=4))


try:
    from hypothesis import given, settings, strategies as st
    HAS_HYP = True
except ImportError:
    HAS_HYP = False

if HAS_HYP:
    dims_st = st.lists(st.integers(1, 4096), min_size=1, max_size=4)
    axes_st = st.lists(
        st.sampled_from([None, "data", "model", ("pod", "data")]),
        min_size=1, max_size=4)
    sizes_st = st.fixed_dictionaries({
        "data": st.sampled_from([1, 2, 4, 8]),
        "model": st.sampled_from([1, 2, 4, 8]),
        "pod": st.sampled_from([1, 2])})
    align_st = st.sampled_from([1, 2, 3, 4, 8])

    @settings(max_examples=50, deadline=None)
    @given(dims=dims_st, axes=axes_st, sizes=sizes_st, align=align_st)
    def test_resolved_spec_always_divides(dims, axes, sizes, align):
        """tests/test_collectives.py's property, of the port's resolver,
        which also gives the reference's spec."""
        axes = (axes + [None] * len(dims))[:len(dims)]
        spec = SH.resolve_physical_spec(tuple(dims), tuple(axes), sizes,
                                        last_dim_align=align)
        assert spec == JSH.resolve_physical_spec(
            tuple(dims), tuple(axes), sizes, last_dim_align=align)
        assert len(spec) == len(dims)
        for i, (dim, ax) in enumerate(zip(dims, spec)):
            if ax is None:
                continue
            size = (sizes[ax] if isinstance(ax, str)
                    else int(np.prod([sizes[a] for a in ax])))
            assert dim % size == 0
            if i == len(dims) - 1:
                assert (dim // size) % align == 0

    @settings(max_examples=50, deadline=None)
    @given(n=st.sampled_from([8, 16, 64]),
           k=st.sampled_from([16, 32, 64, 128]),
           bits=st.sampled_from([1, 2, 3, 4]),
           mp=st.sampled_from([2, 4, 8]))
    def test_packed_shard_never_splits_group(n, k, bits, mp):
        """tests/test_collectives.py's property over the port's packed
        weights: a row-parallel byte-dim split lands on group boundaries."""
        qw = Q.quantize(torch.ones(n, k), bits, k_group=4)
        gb = SH.packed_group_bytes(qw)
        spec = SH.resolve_physical_spec(
            tuple(qw.packed.shape), (None, "model"), {"model": mp, "data": 1},
            last_dim_align=gb)
        if spec[1] is not None:
            assert (qw.packed.shape[1] // mp) % gb == 0


def test_plan_local_shape_follows_the_reference_contract():
    assert ops.plan_local_shape(8, 64) == (8, 64)  # no plan
    with SH.plan_scope(_plan(2)):
        assert ops.plan_local_shape(8, 64) == (8, 32)
        assert ops.plan_local_shape(8, 63) == (8, 63)  # does not divide
    with SH.plan_scope(_plan(1)):
        assert ops.plan_local_shape(8, 64) == (8, 64)


def test_resolve_dispatch_takes_the_local_shape_as_it_is():
    """The wrappers hold local tensors: under a plan the dispatch decision
    and its recorded key are those of the shape given, not divided again."""
    want = ops.resolve_dispatch(4, 1024, 512, 4, 2)
    rec = dispatch_obs.enable(dispatch_obs.DispatchRecorder())
    try:
        with SH.plan_scope(_plan(2)):
            got = ops.resolve_dispatch(4, 1024, 512, 4, 2)
        keys = [r["key"] for r in rec.summary()["records"]]
    finally:
        dispatch_obs.disable()
    assert got == want
    assert keys == ["m4.n1024.g512.kg4.w2.f32.tqper_row"], keys


def _cfg(arch, **kw):
    return treg.get_reduced(arch).replace(activation_dtype=torch.float32,
                                          **kw)


def _params(cfg, quantized=True):
    return tapi.init_params(torch.Generator().manual_seed(0), cfg, "cpu",
                            serve_quantized=quantized)


@pytest.mark.parametrize("m", [2, 4])
def test_shard_params_blocks_dequantize_to_the_whole(m):
    cfg = _cfg("tinyllama-1.1b")
    params = _params(cfg)
    whole = params["layers"][0]
    for r in range(m):
        local = SH.shard_params(params, _plan(m, r), cfg)
        mlp = local["layers"][0]["mlp"]
        f = cfg.d_ff // m
        assert mlp["gate"]["tp"] == mlp["up"]["tp"] == "col"
        assert mlp["down"]["tp"] == "row"
        assert torch.equal(Q.dequantize(mlp["up"]["qw"]),
                           Q.dequantize(whole["mlp"]["up"]["qw"])[
                               r * f:(r + 1) * f])
        assert torch.equal(Q.dequantize(mlp["down"]["qw"]),
                           Q.dequantize(whole["mlp"]["down"]["qw"])[
                               :, r * f:(r + 1) * f])
        v = cfg.vocab_size // m
        assert local["embed"]["tp"] == "vocab"
        assert torch.equal(local["embed"]["table"],
                           params["embed"]["table"][r * v:(r + 1) * v])
        assert local["lm_head"]["tp"] == "col"
        assert local["lm_head"]["qw"].n == v
        attn = local["layers"][0]["attn"]
        if m == 2:  # 2 KV heads: one a rank
            assert attn["wk"]["tp"] == "col" and attn["wo"]["tp"] == "row"
            assert attn["wk"]["qw"].n == cfg.head_dim
            assert attn["wo"]["qw"].k_total == cfg.n_heads * cfg.head_dim // 2
        else:  # 2 KV heads over 4 ranks: attention runs whole
            assert all("tp" not in attn[k] for k in ("wq", "wk", "wv", "wo"))
            assert attn["wk"]["qw"] is whole["attn"]["wk"]["qw"]
        # the norms stay whole; sharding twice is sharding once
        assert local["layers"][0]["attn_norm"]["g"] is whole["attn_norm"]["g"]
        again = SH.shard_params(local, _plan(m, r), cfg)
        assert again["layers"][0]["mlp"]["down"] is mlp["down"]


def test_shard_params_float_tree_and_kv_heads():
    cfg = _cfg("tinyllama-1.1b")
    params = _params(cfg, quantized=False)
    local = SH.shard_params(params, _plan(2, 1), cfg)
    wq = params["layers"][0]["attn"]["wq"]["w"]
    assert local["layers"][0]["attn"]["wq"]["tp"] == "col"
    assert torch.equal(local["layers"][0]["attn"]["wq"]["w"],
                       wq[:, wq.shape[1] // 2:])
    assert local["layers"][0]["attn"]["wo"]["w"].shape == (
        cfg.n_heads * cfg.head_dim // 2, cfg.d_model)
    assert SH.local_kv_heads(cfg, _plan(2)) == cfg.n_kv_heads // 2
    assert SH.local_kv_heads(cfg, _plan(4)) == cfg.n_kv_heads
    with SH.plan_scope(_plan(2)):
        cache = tapi.init_cache(cfg, 1, 16, device="cpu")
    assert cache[0].shape[3] == cfg.n_kv_heads // 2


def test_shard_params_experts_router_and_single_rank():
    cfg = _cfg("olmoe-1b-7b")
    params = _params(cfg)
    local = SH.shard_params(params, _plan(2, 1), cfg)
    moe = local["layers"][0]["moe"]
    whole = params["layers"][0]["moe"]
    e = cfg.num_experts // 2
    assert moe["experts"]["tp"] == "expert"
    for name in ("gate_qw", "up_qw", "down_qw"):
        assert torch.equal(moe["experts"][name].packed,
                           whole["experts"][name].packed[e:])
        assert moe["experts"][name].experts == e
    assert moe["router"]["w"] is whole["router"]["w"]
    # a plan of one rank is the single-device tree itself
    assert SH.shard_params(params, _plan(1), cfg) is params


def test_families_under_a_mesh_raise():
    for arch in ("falcon-mamba-7b", "zamba2-7b", "llama-3.2-vision-11b",
                 "whisper-tiny"):
        cfg = _cfg(arch)
        with SH.plan_scope(_plan(2)):
            with pytest.raises(ValueError, match="queue 1 item 9"):
                tapi.init_cache(cfg, 1, 16, device="cpu")
            with pytest.raises(ValueError, match="queue 1 item 9"):
                tapi.forward({}, {"tokens": torch.zeros(1, 2, dtype=torch.long)},
                             cfg)
