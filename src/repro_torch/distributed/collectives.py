"""Collectives over one mesh axis, and the sequence-parallel boundary ops.

The port is explicit SPMD (``sharding`` module docstring): each layer calls
the collective GSPMD inserts in the reference. ``all_reduce`` (sum or max)
and ``all_gather`` (along a dim, blocks in rank order) run over the
process group of one axis of the active plan, ``axis="model"`` or
``axis="data"`` (the plan's batch axis: blocks in data order, on this
rank's data group); on an axis of one rank, or a batch the plan
replicates, they return their input. Both move data with one transport,
an all-gather of every rank's tensor (``_parts``), and reduce locally: a
sum adds the ranks' tensors in rank order, ((x_0 + x_1) + x_2) + ..., on
every rank. So its
bits do not depend on the backend's reduction order: every rank gets the
same bytes, and a mesh's row-parallel output equals one device's
contraction over the same K-ranges summed in the same order
(``reduce_parts``, which ``sharding.one_device_control`` runs on one
device; ``chip_smoke.py`` phase 19 holds the mesh's logits and streams to
that control bit for bit). A max is exact in any order. The transport
costs each rank (m - 1)·n bytes received for an n-byte operand, where a
ring all-reduce moves about 2(m - 1)/m·n.

Gloo took CUDA tensors for every op of this module on the H100 (f32,
bf16 and int64; ``chip_smoke.py`` phase 19 and ``tests/test_torch_cuda.py``
check each), so nothing is staged through host memory. Gloo moves one
group's data on one connection: under gloo an axis line has lanes, more
groups over the same ranks (``launch.mesh.GLOO_LANES``), and a transfer
of ``LANE_BYTES`` or more is split into one chunk a lane, gathered at
once: the same bytes.

Counters (read by ``ServingEngine.stats()["mesh"]``, reset by
``reset_counters``), in all and by axis (``by_axis``: "model", "data"):
``calls``, ``bytes`` (each call's input bytes) and ``seconds`` (host wall
time inside the calls: gloo waits for the stream and the transfer, NCCL
only enqueues).

Gradients. Under autograd each collective has the backward rule that
SPMD semantics give it (``torch.distributed`` records none, so a leaf
upstream of a plain ``dist.all_gather`` would get no gradient):

  * ``all_reduce`` sum: the identity (the output is replicated, and every
    rank computes the same downstream gradient);
  * ``all_gather``: this rank's slice of the gradient;
  * ``replicated_input`` (the identity forward, at the input of a
    column-parallel projection): the ranks' gradients summed in rank
    order;
  * ``scatter`` (this rank's block of a replicated tensor): the ranks'
    gradients gathered;
  * ``fsdp_gather`` (a leaf's data-axis blocks joined, ZeRO-3): the data
    ranks' gradients of the whole leaf summed in rank order, this rank's
    block kept (a reduce-scatter over the one transport).

Every backward reduction is again an all-gather summed in rank order, so
a mesh's gradients have the same bits on every backend. A backward takes
its group from its forward: autograd runs a CUDA backward on a thread of
its own, where the plan (thread-local, ``plan_scope``) is not set.
Without autograd (no input needs a gradient) each runs its forward
alone.
(``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces the gradient, M times the gradient of a replicated output.)

``sp_scatter`` / ``sp_gather``: the reference's sequence-parallel region
boundaries. Without a ``seq`` axis in the plan (no serving plan has one)
they return their input, as the reference's do.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import current_plan

__all__ = ["all_reduce", "all_gather", "reduce_parts", "replicated_input",
           "scatter", "fsdp_gather", "fsdp_gather_tree", "sp_scatter",
           "sp_gather", "counters", "reset_counters"]

AXES = ("model", "data")
_LOGICAL = {"model": "model", "data": "batch"}
_counts = {a: [0, 0, 0.0] for a in AXES}  # calls, bytes, seconds


def counters() -> dict:
    by_axis = {a: {"calls": c, "bytes": n, "seconds": s}
               for a, (c, n, s) in _counts.items()}
    return {"calls": sum(v["calls"] for v in by_axis.values()),
            "bytes": sum(v["bytes"] for v in by_axis.values()),
            "seconds": sum(v["seconds"] for v in by_axis.values()),
            "by_axis": by_axis}


def reset_counters():
    for a in AXES:
        _counts[a] = [0, 0, 0.0]


LANE_BYTES = 1 << 22  # a transfer from 4 MB on is split over the lanes


def _axis(axis: str):
    """(group, size) of the active plan's ``axis``; size 1 without one.
    The group is a tuple where the mesh has lanes for the axis (gloo):
    the axis's group, then its lanes."""
    if axis not in _LOGICAL:
        raise ValueError(f"collectives: axis {axis!r} is not one of {AXES}")
    plan = current_plan()
    if plan is None:
        return None, 1
    group = plan.group(_LOGICAL[axis])
    lanes = plan.mesh.lanes.get(plan.resolve(_LOGICAL[axis]))
    return ((group,) + lanes if lanes else group,
            plan.axis_size(_LOGICAL[axis]))


def _parts(x: torch.Tensor, group, size: int, axis: str):
    """Every rank's ``x`` (same shape and dtype), in rank order: the one
    transport of this module, counted once a call. A tensor of
    ``LANE_BYTES`` or more is split into one contiguous chunk a group
    where ``group`` is a tuple (the axis's group and its lanes), the
    chunks gathered at once and joined: the same bytes."""
    t0 = time.perf_counter()
    src = x.contiguous()
    nbytes = src.numel() * src.element_size()
    if isinstance(group, tuple) and nbytes < LANE_BYTES:
        group = group[0]
    if isinstance(group, tuple):
        chunks = src.reshape(-1).chunk(len(group))
        outs = [[torch.empty_like(c) for _ in range(size)] for c in chunks]
        works = [dist.all_gather(o, c, group=g, async_op=True)
                 for o, c, g in zip(outs, chunks, group)]
        for w in works:
            w.wait()
        parts = [torch.cat([o[r] for o in outs]).reshape(src.shape)
                 for r in range(size)]
    else:
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
    c = _counts[axis]
    c[0] += 1
    c[1] += x.numel() * x.element_size()
    c[2] += time.perf_counter() - t0
    return parts


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _block(t: torch.Tensor, dim: int, size: int, r: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, r * n, n)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        group, size = _axis(axis)
        return reduce_parts(_parts(x, group, size, axis), "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(x: torch.Tensor, op: str = "sum",
               axis: str = "model") -> torch.Tensor:
    """The sum (in rank order) or max of ``x`` over ``axis``'s ranks, on
    every rank (a new tensor where the axis has more than one rank). The
    sum's backward is the identity; a max carries no gradient."""
    group, size = _axis(axis)
    if size == 1:
        return x
    if op == "sum" and _grad(x):
        return _AllReduceSum.apply(x, axis)
    return reduce_parts(_parts(x.detach(), group, size, axis), op)


def reduce_parts(parts, op: str = "sum") -> torch.Tensor:
    """The ranks' tensors reduced as ``all_reduce`` reduces them: their max,
    or their sum in list order, ((x_0 + x_1) + x_2) + ..."""
    if op == "max":
        return torch.stack(parts).amax(dim=0)
    if op != "sum":
        raise ValueError(f"all_reduce: op {op!r} is not sum or max")
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        group, size = _axis(axis)
        ctx.dim, ctx.size = dim, size
        ctx.rank = current_plan().rank_along(_LOGICAL[axis])
        return torch.cat(_parts(x, group, size, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.size, ctx.rank), None, None


def all_gather(x: torch.Tensor, dim: int = -1,
               axis: str = "model") -> torch.Tensor:
    """``axis``'s ranks' blocks of ``x`` concatenated along ``dim`` in rank
    order, on every rank; the backward keeps this rank's slice."""
    group, size = _axis(axis)
    if size == 1:
        return x
    if _grad(x):
        return _AllGather.apply(x, dim, axis)
    return torch.cat(_parts(x, group, size, axis), dim=dim)


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        ctx.group, ctx.size = _axis(axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_parts(_parts(g, ctx.group, ctx.size, ctx.axis),
                            "sum"), None


def replicated_input(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``x`` itself, marking a replicated activation that enters
    rank-local work (a column-parallel projection, a vocab-split head):
    its backward sums the ranks' partial gradients in rank order."""
    group, size = _axis(axis)
    if size == 1 or not _grad(x):
        return x
    return _ReplicatedInput.apply(x, axis)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        ctx.group, ctx.size = _axis(axis)
        return _block(x, dim, ctx.size,
                      current_plan().rank_along(_LOGICAL[axis])).clone()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_parts(g, ctx.group, ctx.size, ctx.axis),
                         dim=ctx.dim), None, None


def scatter(x: torch.Tensor, dim: int = -1,
            axis: str = "model") -> torch.Tensor:
    """This rank's contiguous block of a replicated ``x`` along ``dim``
    (a view without autograd); the backward gathers the ranks' gradient
    blocks."""
    group, size = _axis(axis)
    if size == 1:
        return x
    if _grad(x):
        return _Scatter.apply(x, dim, axis)
    return _block(x, dim, size, current_plan().rank_along(_LOGICAL[axis]))


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        group, size = _axis("data")
        ctx.dim, ctx.group, ctx.size = dim, group, size
        ctx.rank = current_plan().rank_along("batch")
        return torch.cat(_parts(x, group, size, "data"), dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = reduce_parts(_parts(g, ctx.group, ctx.size, "data"), "sum")
        return _block(total, ctx.dim, ctx.size, ctx.rank).contiguous(), None


def fsdp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A leaf's data-axis blocks joined along ``dim`` (ZeRO-3's gather
    before use); its backward sums the data ranks' gradients of the whole
    leaf in rank order and keeps this rank's block."""
    group, size = _axis("data")
    if size == 1:
        return x
    if _grad(x):
        return _FsdpGather.apply(x, dim)
    return torch.cat(_parts(x, group, size, "data"), dim=dim)


def fsdp_gather_tree(node):
    """``node`` (a param subtree) with every leaf that an ``"fsdp"`` mark
    names ({leaf: dim}, ``sharding.shard_params`` under an FSDP plan)
    gathered whole over the data axis, the marks dropped; the node itself
    where the active plan has no FSDP axis."""
    plan = current_plan()
    if plan is None or plan.fsdp is None:
        return node
    if isinstance(node, list):
        return [fsdp_gather_tree(v) for v in node]
    if not isinstance(node, dict):
        return node
    dims = node.get("fsdp", {})
    return {k: (fsdp_gather(v, dims[k]) if k in dims
                else fsdp_gather_tree(v))
            for k, v in node.items() if k != "fsdp"}


def sp_scatter(x: torch.Tensor) -> torch.Tensor:
    """Enter a sequence-parallel region: no-op unless the plan has a
    ``seq`` axis, which no plan of ``make_plan`` has; a plan with one
    raises (ROADMAP.md queue 1 item 9 step 4)."""
    plan = current_plan()
    if plan is None or plan.seq is None:
        return x
    raise NotImplementedError("sequence parallelism is not ported "
                              "(ROADMAP.md queue 1 item 9 step 4)")


def sp_gather(x: torch.Tensor) -> torch.Tensor:
    """Leave a sequence-parallel region: no-op unless the plan has a ``seq``
    axis (see ``sp_scatter``)."""
    plan = current_plan()
    if plan is None or plan.seq is None:
        return x
    raise NotImplementedError("sequence parallelism is not ported "
                              "(ROADMAP.md queue 1 item 9 step 4)")

