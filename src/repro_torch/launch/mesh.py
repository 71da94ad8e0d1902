"""Meshes, their plans, and the ranks' process groups.

``make_serving_mesh(data=1, model=None)`` builds the (data, model) mesh
over the ranks of the initialized process group, the reference's
``launch/mesh.py`` over its devices; ``make_production_mesh()`` the
reference's (16, 16) one, which needs 256 ranks; ``make_plan`` its
``AxisPlan``, FSDP (ZeRO-3) mapped onto ``"data"`` unless ``fsdp=False``
(the reference's default: training takes it, serving passes False). Rank
r sits at (r // model, r % model): data-major, as the reference's
``make_mesh((data, model), ...)`` orders its devices. Each axis line has
a process group of its own (``data`` model groups of ``model`` ranks,
``model`` data groups of ``data`` ranks; an axis that spans every rank
uses the world group); ``Mesh.groups`` holds this rank's group of each
axis; under gloo each axis line also has ``GLOO_LANES`` - 1 more groups
(``Mesh.lanes``), over which ``collectives`` splits a large transfer.
Not ported: the multi-pod mesh's ``pod`` axis (``POD_AXIS_REFUSAL``),
sequence parallelism (``collectives.sp_scatter`` refuses a ``seq`` axis)
and a pipeline axis.

Ranks. ``init_rank`` joins rank r to the group: its device is
``cuda:(r % device_count)``, or the CPU where the caller asks for it (a
rank with no card and no such request raises, as every entry point of
the port does). The backend is NCCL where every rank has a card of its
own and gloo where ranks share one (NCCL refuses two ranks on one
device) or run on the CPU; every rank's compute stays on its device
either way. ``from_env`` joins a rank that torchrun started (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` set); ``spawn`` starts
the ranks itself, each running a function of an importable module (the
package, never a script's ``__main__``) and returning its result to the
caller. A rank that raises fails ``spawn``, and the other ranks are
stopped.
"""

from __future__ import annotations

import os
import socket
import tempfile
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import AxisPlan, Mesh

__all__ = ["make_serving_mesh", "make_production_mesh", "make_plan",
           "GLOO_LANES", "rank_device", "choose_backend", "init_rank",
           "from_env", "spawn", "free_port", "POD_AXIS_REFUSAL"]

POD_AXIS_REFUSAL = ("the multi-pod (2, 16, 16) mesh's pod axis is not "
                    "ported: ROADMAP.md queue 1 item 9 step 5")
# groups an axis line has under gloo, which moves one group's data on one
# connection: a transfer from ``collectives.LANE_BYTES`` on is split over
# them (NCCL has one group an axis line). chip_smoke.py phase 21 on one
# H100 took 123 s with 8, 136 s with 4 and 165 s with 1 (PERF.md §6)
GLOO_LANES = 8


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[torch.device] = None) -> Mesh:
    """The reference's production mesh: (16, 16) over ("data", "model"),
    256 ranks; raises with the rank count on any other world. The
    multi-pod (2, 16, 16) mesh is refused (``POD_AXIS_REFUSAL``)."""
    if multi_pod:
        raise ValueError(POD_AXIS_REFUSAL)
    return make_serving_mesh(data=16, model=16, device=device)


def make_serving_mesh(*, data: int = 1, model: Optional[int] = None,
                      device: Optional[torch.device] = None) -> Mesh:
    """A (data, model) mesh over the ranks of the process group (one rank,
    a 1x1 mesh, when none is initialized), recording this rank's
    ``device`` (``init_rank``'s). ``model=None`` uses every rank not
    consumed by ``data``. Every rank must call it, in the same order
    with the same sizes: it makes every axis line's group, and under
    gloo its ``GLOO_LANES`` - 1 lanes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model is None:
        model = world // max(1, data)
    if data < 1 or data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"have {world}")
    groups = {"data": None, "model": None}
    backend = dist.get_backend() if dist.is_initialized() else None
    extra = GLOO_LANES - 1 if backend == "gloo" else 0
    lane_groups = {}
    for axis, size, lines in (
            ("model", model, [[d * model + j for j in range(model)]
                              for d in range(data)]),
            ("data", data, [[d * model + j for d in range(data)]
                            for j in range(model)])):
        if size == 1:
            continue
        if size == world:
            groups[axis] = dist.group.WORLD
        else:
            for line in lines:  # every rank makes every group, in one order
                group = dist.new_group(line)
                if rank in line:
                    groups[axis] = group
        mine = []
        for _ in range(extra):
            for line in lines:
                group = dist.new_group(line)
                if rank in line:
                    mine.append(group)
        if mine:
            lane_groups[axis] = tuple(mine)
    return Mesh(("data", "model"), (data, model),
                (rank // model, rank % model), groups, backend, device,
                lane_groups)


def make_plan(mesh: Mesh, *, fsdp: bool = True) -> AxisPlan:
    """The reference's plan: batch over "data", the model and experts over
    "model", FSDP over "data" unless ``fsdp=False``."""
    return AxisPlan(mesh=mesh, batch=("data",), model="model",
                    expert="model", fsdp="data" if fsdp else None, seq=None,
                    stage=None)


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank r's device: ``cuda:(r % device_count)``, or the CPU when
    ``device`` is "cpu"; raises where a card is asked for and none
    exists."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank}: device {str(device)!r} requested but no CUDA "
            "device is available; pass device='cpu' (--device cpu) to run "
            "the kernels' plain versions")
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(world: int, device: torch.device) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_rank(rank: int, world: int, init_method: str,
              device="cuda") -> torch.device:
    """Join the process group as ``rank`` of ``world``; returns the rank's
    device (its current CUDA device where it has a card)."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(choose_backend(world, dev),
                            init_method=init_method, world_size=world,
                            rank=rank)
    return dev


def from_env(device="cuda") -> Optional[torch.device]:
    """Join the group torchrun describes in the environment; None where it
    describes none."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return init_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                     "env://", device)


def free_port() -> int:
    """A free TCP port on localhost, for a ``tcp://localhost:<port>``
    rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, init_method, device, out_dir, threads, args):
    torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // world))
    dev = init_rank(rank, world, init_method, device)
    try:
        result = fn(rank, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, device="cuda",
          init_method: Optional[str] = None, args=(),
          threads: Optional[int] = None) -> List:
    """Run ``fn(rank, device, *args)`` on ``world`` new ranks and return
    their results in rank order. ``fn`` must live in an importable module
    (a spawned rank imports it by name). ``init_method`` defaults to
    ``tcp://localhost:<free port>``; tests give a ``file://`` path of
    their own. ``threads`` caps each rank's torch threads (default: the
    host's cores shared out)."""
    import torch.multiprocessing as mp
    rank_device(0, device)  # raise here, not in every rank
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="ranks") as out_dir:
        mp.start_processes(_entry, args=(fn, world, init_method, device,
                                         out_dir, threads, tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
