"""Kernel-dispatch profiling: which mpGEMM plan each projection ran.

``kernels.ops.resolve_dispatch`` is the one decision point for every LUT
mpGEMM the port's ``lut_pallas`` path runs, and ``core.lmma.select_fusion``
the shared-memory rule under it. Both call ``record()`` here, which is a
no-op unless a :class:`DispatchRecorder` is active, so a serve can dump
which (shape key, fusion, tile, split-K count) ran and whether the
decision came from the measured tuning cache (``tuned``), the heuristic
(``heuristic``) or the caller (``forced``).

The reference records at trace time, once per compiled program. The port
is eager: the dispatch runs in Python for every projection of every step
(155 a tinyllama decode step). So a record's ``count`` counts dispatches,
not traces, and ``record()`` with no active recorder costs one check of a
module global; callers build a record's key only when ``get_active()``
is not None. ``select_fusion`` sits under the memoized ``auto_fusion``,
so it records once per shape and process, when the shape is first seen.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["DispatchRecord", "DispatchRecorder", "enable", "disable",
           "get_active", "record", "recording"]


@dataclasses.dataclass
class DispatchRecord:
    """One deduplicated dispatch decision and how often it was made."""

    kind: str            # "dispatch" (resolve_dispatch) | "select_fusion"
    key: str             # autotune.shape_key / LMMA descriptor name
    fusion: str          # the fusion that ran
    requested: str       # the caller's policy: auto | tuned | fused | staged
    source: str          # "tuned" (cache hit) | "heuristic" | "forced"
    block_m: int = 0     # the kernel tile's rows (BM), channels (BN) and
    block_n: int = 0     # K-groups per K-step (bg)
    block_g: int = 0
    splits: int = 0      # the split-K count S
    count: int = 1       # dispatches of this exact decision

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class DispatchRecorder:
    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[Tuple, DispatchRecord] = {}

    def record(self, kind: str, key: str, fusion: str, requested: str,
               source: str, blocks: Tuple[int, int, int] = (0, 0, 0),
               splits: int = 0):
        k = (kind, key, fusion, requested, source, tuple(blocks), splits)
        with self._lock:
            rec = self._records.get(k)
            if rec is None:
                self._records[k] = DispatchRecord(
                    kind, key, fusion, requested, source,
                    blocks[0], blocks[1], blocks[2], splits)
            else:
                rec.count += 1

    def records(self, kind: Optional[str] = None) -> List[DispatchRecord]:
        with self._lock:
            recs = list(self._records.values())
        if kind is not None:
            recs = [r for r in recs if r.kind == kind]
        return sorted(recs, key=lambda r: (r.kind, r.key, r.fusion))

    def summary(self) -> dict:
        """Decisions (distinct "dispatch" records) by source, and every
        record."""
        recs = self.records()
        disp = [r for r in recs if r.kind == "dispatch"]
        return {
            "decisions": len(disp),
            "tuned": sum(1 for r in disp if r.source == "tuned"),
            "heuristic": sum(1 for r in disp if r.source == "heuristic"),
            "forced": sum(1 for r in disp if r.source == "forced"),
            "records": [r.as_dict() for r in recs],
        }

    def clear(self):
        with self._lock:
            self._records.clear()

    def __len__(self):
        with self._lock:
            return len(self._records)


_ACTIVE: Optional[DispatchRecorder] = None
_GUARD = threading.Lock()


def enable(recorder: Optional[DispatchRecorder] = None) -> DispatchRecorder:
    """Install and return the active recorder (a new one unless one is
    given or already active)."""
    global _ACTIVE
    with _GUARD:
        if recorder is not None:
            _ACTIVE = recorder
        elif _ACTIVE is None:
            _ACTIVE = DispatchRecorder()
        return _ACTIVE


def disable():
    global _ACTIVE
    with _GUARD:
        _ACTIVE = None


def get_active() -> Optional[DispatchRecorder]:
    return _ACTIVE


def record(kind: str, key: str, fusion: str, requested: str, source: str,
           blocks: Tuple[int, int, int] = (0, 0, 0), splits: int = 0):
    """Record one decision on the active recorder; one check when none."""
    rec = _ACTIVE
    if rec is not None:
        rec.record(kind, key, fusion, requested, source, blocks, splits)


class recording:
    """Context manager: install a fresh recorder, restore the prior one."""

    def __enter__(self) -> DispatchRecorder:
        self._prev = get_active()
        self._rec = DispatchRecorder()
        enable(self._rec)
        return self._rec

    def __exit__(self, *exc):
        global _ACTIVE
        with _GUARD:
            _ACTIVE = self._prev
        return False
