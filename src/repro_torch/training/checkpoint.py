"""Atomic, async-capable checkpointing with restart management.

Layout: ``<dir>/step_<n>/`` holding one ``.npz`` (``shard_0.npz``: one host
shard) plus a ``MANIFEST.json`` (the leaves' tree paths, shapes, dtypes,
the step, the wall-clock time as metadata and the monotonic write
duration). Writes go to ``step_<n>.tmp`` then ``os.rename``: a crashed
writer never corrupts the latest checkpoint.

``RestartManager`` implements the recovery policy: resume from the newest
*complete* checkpoint (manifest present), garbage-collect old ones, and
optionally write on a background thread (at most one write in flight; the
host snapshot is taken before ``maybe_save`` returns, so the training step
never waits on disk and a later update cannot race the writer).

Under a mesh (``RestartManager(plan=, cfg=)``) a checkpoint is the whole
train state in the single-device format: every rank joins its blocks
(``sharding.gather_train_state``), rank 0 writes, and the others wait for
that write in ``wait()`` (and before the next save). A checkpoint restores
onto one device, or onto any mesh: each rank reads the whole state on the
host and keeps its blocks (``sharding.shard_train_state``).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import struct
import threading
import time
import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_paths, tree_unflatten

MANIFEST = "MANIFEST.json"


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "") if torch.is_tensor(x) else str(
        np.asarray(x).dtype)


def _to_numpy(x) -> np.ndarray:
    """A leaf as numpy. numpy has no bfloat16 (nor fp8): such leaves are
    stored as f32, a lossless upcast, and cast back on restore."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.is_floating_point() and x.dtype not in (torch.float16, torch.float32,
                                                 torch.float64):
        x = x.to(torch.float32)
    return x.numpy()


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[Dict] = None):
    """Atomic checkpoint write (synchronous). Returns the directory."""
    t_start = time.monotonic()
    named = tree_paths(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {f"a{i}": _to_numpy(x) for i, (_, x) in enumerate(named)}
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    manifest = {
        "step": int(step),
        "names": [n for n, _ in named],
        "shapes": [list(x.shape) for x in arrays.values()],
        "dtypes": [_dtype_name(x) for _, x in named],
        # wall-clock is METADATA ONLY (when was this checkpoint taken);
        # never use it for interval math — durations below are monotonic
        "time": time.time(),
        "write_seconds": None,  # filled in below
        "extra": extra or {},
    }
    manifest["write_seconds"] = time.monotonic() - t_start
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore(ckpt_dir: str, tree_like, step: Optional[int] = None, *,
            device=None):
    """Restore into the structure of ``tree_like``: each leaf takes the
    dtype and device (or ``device``) of ``tree_like``'s, and the stored
    shape. Returns (tree, step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    named = tree_paths(tree_like)
    names = [n for n, _ in named]
    if names != manifest["names"]:
        raise ValueError("checkpoint structure mismatch: "
                         f"{set(names) ^ set(manifest['names'])}")
    data = _stored_arrays(os.path.join(d, "shard_0.npz"))
    restored = [torch.from_numpy(data[f"a{i}"]).to(
        device=c.device if device is None else device, dtype=c.dtype,
        copy=True)
        for i, (_, c) in enumerate(named)]
    return tree_unflatten(tree_like, restored), step


def _stored_arrays(path: str) -> Dict[str, np.ndarray]:
    """The arrays of an ``np.savez`` file (members stored uncompressed) as
    copy-on-write memory maps of the file: the caller's copy reads each one
    once, without ``np.load``'s chunked reads and CRC pass (~0.5 GB/s; the
    manifest and the atomic rename stand for the file's integrity)."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset + 26)  # the local header's lengths
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                           (2, 0): np.lib.format.read_array_header_2_0}
            if version not in read_header:
                raise ValueError(f"{path}: .npy format {version}")
            shape, fortran, dtype = read_header[version](f)
            key = info.filename[:-len(".npy")]
            out[key] = (np.empty(shape, dtype) if math.prod(shape) == 0 else
                        np.memmap(f, dtype=dtype, mode="c", offset=f.tell(),
                                  shape=shape, order="F" if fortran else "C"))
    return out


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, MANIFEST)):
                steps.append(int(name[5:]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _host_copy(x):
    """A leaf's host snapshot: always a copy, also of a CPU tensor."""
    return x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x


class RestartManager:
    """Checkpoint/restart policy: periodic async saves, bounded retention,
    resume-from-latest-complete."""

    def __init__(self, ckpt_dir: str, *, every: int = 100, keep: int = 3,
                 async_write: bool = True, plan=None, cfg=None):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.plan, self.cfg = plan, cfg
        self._specs = None  # the params' specs under ``plan``
        self._mesh = plan is not None and math.prod(plan.mesh.shape) > 1
        self._rank = (torch.distributed.get_rank()
                      if self._mesh and torch.distributed.is_initialized()
                      else 0)
        if self._rank == 0:
            os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, tree, extra=None, force=False):
        """Save ``tree`` (a train state) at ``step`` when due. Under a
        mesh every rank must call it: the ranks' blocks are joined, rank 0
        writes."""
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        if self._mesh:
            from repro_torch.distributed.sharding import gather_train_state
            from repro_torch.training.train_loop import param_specs
            self.wait()
            if self._specs is None:
                self._specs = param_specs(tree["params"], self.plan,
                                          self.cfg)
            tree = gather_train_state(tree, self.plan, self._specs)
            if self._rank != 0:
                return True
        named = tree_paths(tree)
        host_tree = tree_unflatten(tree, [_host_copy(x) for _, x in named])
        if self.async_write:
            self._join()  # at most one write in flight
            self._thread = threading.Thread(
                target=self._save_and_gc_reporting,
                args=(step, host_tree, extra), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host_tree, extra)
        return True

    def _save_and_gc(self, step, tree, extra):
        save(self.dir, step, tree, extra=extra)
        for s in list_steps(self.dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def _save_and_gc_reporting(self, step, tree, extra):
        try:
            self._save_and_gc(step, tree, extra)
        except Exception as e:  # re-raised by wait() on the caller
            self._error = e

    def wait(self):
        """Waits for the write in flight (under a mesh, every rank waits
        for rank 0's: every rank must call it); raises what it raised."""
        try:
            self._join()
        finally:
            if self._mesh:
                torch.distributed.barrier()

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_or_none(self, tree_like):
        """(the newest complete checkpoint's state, its step), or (None,
        0). Under a mesh ``tree_like`` is this rank's state and the result
        its blocks of the whole saved state."""
        step = latest_step(self.dir)
        if step is None:
            return None, 0
        if not self._mesh:
            return restore(self.dir, tree_like, step)
        from repro_torch.core.tree import tree_leaves, tree_map
        from repro_torch.distributed.sharding import shard_train_state
        whole, step = restore(self.dir, tree_like, step, device="cpu")
        device = tree_leaves(tree_like)[0].device
        return tree_map(lambda t: t.to(device), shard_train_state(
            whole, self.plan, self.cfg)), step
