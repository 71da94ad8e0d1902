"""Request-lifecycle tracer: Chrome-trace / Perfetto JSON spans.

The port's copy of the reference's ``repro/obs/trace.py``. The span
taxonomy follows one request through the engine: ``admit`` →
``prefill_chunk``(s) → ``decode_chunk``(s) → retire, with the request's
whole lifetime as an async span keyed by its uid, and a ``prefix_hit``
instant where paged admission reuses shared blocks.

Overhead contract:

  * timestamps are host ``perf_counter_ns`` reads taken only where the
    engine already waits for the card or dispatches work: tracing adds no
    device round-trip and leaves ``host_syncs_per_token`` as it is;
  * recording a span is two clock reads and one list append; nothing is
    serialized before ``save()``;
  * a disabled tracer (``enabled=False``) records nothing.

With ``annotate_torch_profiler=True`` (the default) every span the engine
draws also enters ``torch.profiler.record_function`` under the same name
(``annotation``), so the host spans line up with the CUDA activity in a
``torch.profiler`` trace taken around the serve. The tests turn it off.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List

__all__ = ["Tracer", "validate_chrome_trace", "load_trace"]


class Tracer:
    """Append-only span / event recorder emitting Chrome-trace JSON.

    Event kinds (Chrome Trace Event Format): ``X`` complete spans
    (``span()``, or ``complete()`` for an interval the caller timed), ``i``
    instants, ``b`` / ``e`` async spans for request lifetimes that
    interleave across chunk boundaries. Spans nest per thread.
    """

    def __init__(self, *, enabled: bool = True,
                 annotate_torch_profiler: bool = True,
                 process_name: str = "repro-torch-serve"):
        self.enabled = enabled
        self.annotate_torch_profiler = annotate_torch_profiler
        self.process_name = process_name
        self.pid = os.getpid()
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._t0 = time.perf_counter_ns()
        if enabled:
            self._meta("process_name", {"name": process_name})

    def _us(self, t_ns: int) -> float:
        return (t_ns - self._t0) / 1e3

    def _tid(self) -> int:
        tid = getattr(self._tls, "tid", None)
        if tid is None:
            tid = threading.get_ident() & 0x7FFFFFFF
            self._tls.tid = tid
            self._meta("thread_name",
                       {"name": threading.current_thread().name}, tid=tid)
        return tid

    def _meta(self, name: str, args: dict, tid: int = 0):
        with self._lock:
            self._events.append({"name": name, "ph": "M", "pid": self.pid,
                                 "tid": tid, "ts": 0, "args": args})

    def _emit(self, ev: Dict[str, Any]):
        with self._lock:
            self._events.append(ev)

    def annotation(self, name: str):
        """``torch.profiler.record_function(name)`` when the tracer is on and
        annotates, else a no-op context."""
        if self.enabled and self.annotate_torch_profiler:
            from torch.profiler import record_function
            return record_function(name)
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "engine", **attrs):
        """Synchronous complete span (stack discipline per thread)."""
        if not self.enabled:
            yield
            return
        with self.annotation(name):
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                t1 = time.perf_counter_ns()
                self.complete(name, t0, t1, cat, **attrs)

    def complete(self, name: str, t0_ns: int, t1_ns: int,
                 cat: str = "engine", **attrs):
        """Record an interval the caller already timed at its own points."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "X", "cat": cat, "pid": self.pid,
                    "tid": self._tid(), "ts": self._us(t0_ns),
                    "dur": max(0.0, (t1_ns - t0_ns) / 1e3), "args": attrs})

    def _point(self, ph: str, name: str, cat: str, attrs: dict, **extra):
        if not self.enabled:
            return
        self._emit({"name": name, "ph": ph, "cat": cat, **extra,
                    "pid": self.pid, "tid": self._tid(),
                    "ts": self._us(time.perf_counter_ns()), "args": attrs})

    def instant(self, name: str, cat: str = "engine", **attrs):
        self._point("i", name, cat, attrs, s="t")

    def async_begin(self, name: str, id: int, cat: str = "request", **attrs):
        self._point("b", name, cat, attrs, id=int(id))

    def async_end(self, name: str, id: int, cat: str = "request", **attrs):
        self._point("e", name, cat, attrs, id=int(id))

    def __len__(self):
        with self._lock:
            return len(self._events)

    def chrome_trace(self) -> dict:
        """The Chrome-trace JSON object (Perfetto's legacy JSON loader)."""
        with self._lock:
            events = list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"process": self.process_name}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


def load_trace(path: str) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"),
                                                   list):
        raise ValueError(f"{path}: not a Chrome-trace JSON object "
                         "(want {'traceEvents': [...]})")
    return doc["traceEvents"]


def validate_chrome_trace(events: List[dict]) -> dict:
    """Validate events against the Chrome Trace Event Format (the subset
    Perfetto's legacy JSON importer enforces): every event has ``name`` /
    ``ph`` / ``pid`` / ``tid`` / ``ts`` of sane types and a non-negative
    ``ts``; ``X`` events a non-negative ``dur``; async ``b`` / ``e`` events
    an ``id``, balanced per (cat, id), begin <= end; ``X`` events on one
    (pid, tid) track nest (no partial overlap). Returns summary counts;
    raises ``ValueError`` on the first violation."""
    counts: Dict[str, int] = {}
    async_open: Dict[tuple, List[float]] = {}
    by_track: Dict[tuple, List[dict]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for field, types in (("name", str), ("ph", str),
                             ("pid", int), ("tid", int),
                             ("ts", (int, float))):
            if not isinstance(ev.get(field), types):
                raise ValueError(f"event {i} ({ev.get('name')!r}): field "
                                 f"{field!r} missing or mistyped: {ev}")
        ph = ev["ph"]
        counts[ph] = counts.get(ph, 0) + 1
        if ev["ts"] < 0:
            raise ValueError(f"event {i} ({ev['name']!r}): negative ts")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i} ({ev['name']!r}): X event "
                                 f"needs non-negative dur, got "
                                 f"{ev.get('dur')!r}")
            by_track.setdefault((ev["pid"], ev["tid"]), []).append(ev)
        elif ph in ("b", "e"):
            if "id" not in ev:
                raise ValueError(f"event {i} ({ev['name']!r}): async "
                                 f"{ph!r} event needs an id")
            key = (ev.get("cat", ""), ev["id"])
            if ph == "b":
                async_open.setdefault(key, []).append(ev["ts"])
            else:
                opens = async_open.get(key)
                if not opens:
                    raise ValueError(f"event {i} ({ev['name']!r}): async end "
                                     f"without begin for id={ev['id']}")
                t_b = opens.pop()
                if ev["ts"] < t_b:
                    raise ValueError(f"event {i} ({ev['name']!r}): async end "
                                     f"ts {ev['ts']} precedes begin {t_b}")
    dangling = {k: v for k, v in async_open.items() if v}
    if dangling:
        raise ValueError(f"unbalanced async spans (begin without end): "
                         f"{sorted(dangling)[:5]}")
    # same-track X events must nest; the tolerance is 1 ns (1e-3 us):
    # abutting spans share a boundary whose us conversion may round apart
    for (pid, tid), evs in by_track.items():
        evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
        stack: List[tuple] = []  # (end_ts, name)
        for ev in evs:
            t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
            while stack and stack[-1][0] <= t0 + 1e-3:
                stack.pop()
            if stack and t1 > stack[-1][0] + 1e-3:
                raise ValueError(
                    f"span {ev['name']!r} [{t0:.1f}, {t1:.1f}]us on track "
                    f"({pid}, {tid}) partially overlaps enclosing "
                    f"{stack[-1][1]!r} (ends {stack[-1][0]:.1f}us): "
                    "X events on one track must nest")
            stack.append((t1, ev["name"]))
    return {"events": len(events), "by_phase": counts,
            "tracks": len(by_track)}
