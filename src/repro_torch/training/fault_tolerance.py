"""Fault-tolerance policies: failure detection, straggler mitigation, and the
restart/elastic-downsize decision loop (a copy of the reference's policy
state machine; it reads no device).

Policies implemented:
  * heartbeat-timeout failure detection (per-host deadline),
  * straggler mitigation: per-step duration EWMA; hosts slower than
    ``straggler_factor``× the median for ``patience`` consecutive steps are
    marked for replacement by a hot spare (or trigger elastic downsize),
  * restart decision: RESUME (same mesh) when spares cover failures,
    ELASTIC_DOWNSIZE (shrink the data axis, rescale microbatching) otherwise.
    The port has no elastic re-mesh yet: the decision is the policy's
    output, for a launcher to act on.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import List, Optional


class Action(enum.Enum):
    CONTINUE = "continue"
    REPLACE_WITH_SPARE = "replace_with_spare"
    RESUME_SAME_MESH = "resume_same_mesh"
    ELASTIC_DOWNSIZE = "elastic_downsize"


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float   # monotonic seconds (never wall-clock)
    step_ewma: float = 0.0
    slow_streak: int = 0
    alive: bool = True


class FaultToleranceManager:
    """All heartbeat interval math runs on ``time.monotonic()``: a wall
    clock (``time.time``) can jump backward or forward under NTP slew or
    manual adjustment, and a forward jump larger than ``heartbeat_timeout``
    fires spurious timeouts on every healthy host at once. Callers passing
    explicit ``now`` values (tests, simulated launchers) must use one
    consistent time base across calls — the units are seconds either way."""

    def __init__(self, n_hosts: int, *, n_spares: int = 0,
                 heartbeat_timeout: float = 60.0,
                 straggler_factor: float = 1.5, patience: int = 5):
        now = time.monotonic()
        self.hosts = {i: HostState(i, now) for i in range(n_hosts)}
        self.n_spares = n_spares
        self.timeout = heartbeat_timeout
        self.factor = straggler_factor
        self.patience = patience

    # -- event ingestion ------------------------------------------------------
    def heartbeat(self, host_id: int, step_duration: Optional[float] = None,
                  now: Optional[float] = None):
        h = self.hosts[host_id]
        h.last_heartbeat = now if now is not None else time.monotonic()
        if step_duration is not None:
            h.step_ewma = (0.7 * h.step_ewma + 0.3 * step_duration
                           if h.step_ewma else step_duration)

    def mark_failed(self, host_id: int):
        self.hosts[host_id].alive = False

    # -- policy ---------------------------------------------------------------
    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.monotonic()
        return [h.host_id for h in self.hosts.values()
                if not h.alive or now - h.last_heartbeat > self.timeout]

    def stragglers(self) -> List[int]:
        ew = sorted(h.step_ewma for h in self.hosts.values() if h.step_ewma > 0)
        if not ew:
            return []
        median = ew[len(ew) // 2]
        out = []
        for h in self.hosts.values():
            if h.step_ewma > self.factor * median:
                h.slow_streak += 1
                if h.slow_streak >= self.patience:
                    out.append(h.host_id)
            else:
                h.slow_streak = 0
        return out

    def decide(self, now: Optional[float] = None) -> Action:
        dead = set(self.dead_hosts(now))
        slow = set(self.stragglers())
        impaired = dead | slow
        if not impaired:
            return Action.CONTINUE
        if len(impaired) <= self.n_spares:
            self.n_spares -= len(impaired)
            for i in impaired:
                self.hosts[i].alive = False
            return Action.REPLACE_WITH_SPARE
        if dead:
            return Action.ELASTIC_DOWNSIZE
        return Action.RESUME_SAME_MESH
