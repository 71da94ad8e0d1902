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
check each), so nothing is staged through host memory.

Counters (read by ``ServingEngine.stats()["mesh"]``, reset by
``reset_counters``), in all and by axis (``by_axis``: "model", "data"):
``calls``, ``bytes`` (each call's input bytes) and ``seconds`` (host wall
time inside the calls: gloo waits for the stream and the transfer, NCCL
only enqueues).

``sp_scatter`` / ``sp_gather``: the reference's sequence-parallel region
boundaries. Without a ``seq`` axis in the plan (no serving plan has one)
they return their input, as the reference's do.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import current_plan

__all__ = ["all_reduce", "all_gather", "reduce_parts", "sp_scatter",
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


def _axis(axis: str):
    """(group, size) of the active plan's ``axis``; size 1 without one."""
    if axis not in _LOGICAL:
        raise ValueError(f"collectives: axis {axis!r} is not one of {AXES}")
    plan = current_plan()
    if plan is None:
        return None, 1
    return plan.group(_LOGICAL[axis]), plan.axis_size(_LOGICAL[axis])


def _parts(x: torch.Tensor, group, size: int, axis: str):
    """Every rank's ``x`` (same shape and dtype), in rank order: the one
    transport of this module, counted once a call."""
    t0 = time.perf_counter()
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    c = _counts[axis]
    c[0] += 1
    c[1] += x.numel() * x.element_size()
    c[2] += time.perf_counter() - t0
    return parts


def all_reduce(x: torch.Tensor, op: str = "sum",
               axis: str = "model") -> torch.Tensor:
    """The sum (in rank order) or max of ``x`` over ``axis``'s ranks, on
    every rank (a new tensor where the axis has more than one rank)."""
    group, size = _axis(axis)
    if size == 1:
        return x
    return reduce_parts(_parts(x, group, size, axis), op)


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


def all_gather(x: torch.Tensor, dim: int = -1,
               axis: str = "model") -> torch.Tensor:
    """``axis``'s ranks' blocks of ``x`` concatenated along ``dim`` in rank
    order, on every rank."""
    group, size = _axis(axis)
    if size == 1:
        return x
    return torch.cat(_parts(x, group, size, axis), dim=dim)


def sp_scatter(x: torch.Tensor) -> torch.Tensor:
    """Enter a sequence-parallel region: no-op unless the plan has a
    ``seq`` axis, which no serving plan has (ROADMAP.md queue 1 item 9)."""
    plan = current_plan()
    if plan is None or plan.seq is None:
        return x
    raise NotImplementedError("sequence parallelism waits for the data-axis "
                              "slice (ROADMAP.md queue 1 item 9)")


def sp_gather(x: torch.Tensor) -> torch.Tensor:
    """Leave a sequence-parallel region: no-op unless the plan has a ``seq``
    axis (see ``sp_scatter``)."""
    plan = current_plan()
    if plan is None or plan.seq is None:
        return x
    raise NotImplementedError("sequence parallelism waits for the data-axis "
                              "slice (ROADMAP.md queue 1 item 9)")

