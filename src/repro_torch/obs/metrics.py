"""Typed metrics registry: counters, gauges, bounded-reservoir histograms.

The port's own copy of the reference's ``repro/obs/metrics.py`` (pure
Python): the same instruments, names, snapshot and Prometheus text.

  * **Bounded memory.** A histogram keeps an exact ``count`` / ``sum`` /
    ``min`` / ``max`` and a fixed-size reservoir (Vitter's algorithm R) for
    percentiles, so its storage is O(reservoir) however long the engine
    serves.
  * **Thread-safe.** Each instrument takes its own lock; the registry
    locks only get-or-create.
  * **Interpolated percentiles.** ``percentile(p)`` interpolates linearly
    between closest ranks (numpy's "linear"), so p95 of three samples is
    not the largest of them.

The reservoir's RNG is seeded from the instrument's name with CRC-32, so a
snapshot does not depend on the interpreter's string-hash seed.
"""

from __future__ import annotations

import json
import math
import random
import threading
import zlib
from typing import Dict, List, Optional, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "export_stats"]

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid metric name {name!r} (want Prometheus "
                         "[a-zA-Z_:][a-zA-Z0-9_:]*)")
    return name


class _Instrument:
    kind = "?"

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name = _check_name(name)
        self.help = help
        self.unit = unit
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotonically increasing count; a negative increment raises."""

    kind = "counter"

    def __init__(self, name, help="", unit=""):
        super().__init__(name, help, unit)
        self._value = 0

    def inc(self, n: Union[int, float] = 1):
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge(_Instrument):
    """Last-written value (set / add; may go down)."""

    kind = "gauge"

    def __init__(self, name, help="", unit=""):
        super().__init__(name, help, unit)
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = v

    def add(self, v: float):
        with self._lock:
            self._value += v

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        self.set(0.0)

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Histogram(_Instrument):
    """Exact count / sum / min / max and a fixed-size reservoir for
    percentiles: a uniform sample of every observation (algorithm R)."""

    kind = "histogram"

    def __init__(self, name, help="", unit="", reservoir_size: int = 1024):
        super().__init__(name, help, unit)
        if reservoir_size < 1:
            raise ValueError(f"histogram {name}: reservoir_size must be >= 1")
        self.reservoir_size = reservoir_size
        self._rng = random.Random(zlib.crc32(name.encode()))
        self._res: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if len(self._res) < self.reservoir_size:
                self._res.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self.reservoir_size:
                    self._res[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def total(self) -> float:
        """Exact sum of every observation (not reservoir-sampled)."""
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        """Linearly interpolated percentile over the reservoir, ``p`` in
        [0, 1] (numpy's "linear"); 0.0 when nothing was observed."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"percentile wants p in [0,1], got {p}")
        with self._lock:
            xs = sorted(self._res)
        if not xs:
            return 0.0
        rank = p * (len(xs) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def reset(self):
        with self._lock:
            self._res = []
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if self._count else 0.0
            mx = self._max if self._count else 0.0
        return {
            "type": self.kind, "count": count, "sum": total,
            "min": mn, "max": mx,
            "mean": total / count if count else 0.0,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Get-or-create instrument store with JSON and Prometheus exposition.

    ``common_labels`` are attached to every exposed series. Re-registering
    a name as another kind of instrument raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self.common_labels: Dict[str, str] = {}

    def set_common_labels(self, **labels: str):
        self.common_labels.update({k: str(v) for k, v in labels.items()})

    def _get_or_create(self, cls, name, help, unit, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help=help, unit=unit, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}")
            return inst

    def counter(self, name, help="", unit="") -> Counter:
        return self._get_or_create(Counter, name, help, unit)

    def gauge(self, name, help="", unit="") -> Gauge:
        return self._get_or_create(Gauge, name, help, unit)

    def histogram(self, name, help="", unit="",
                  reservoir_size: int = 1024) -> Histogram:
        return self._get_or_create(Histogram, name, help, unit,
                                   reservoir_size=reservoir_size)

    def get(self, name) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def reset(self, prefix: str = ""):
        """Reset every instrument whose name starts with ``prefix`` (all by
        default). They stay registered, so held handles keep working."""
        with self._lock:
            insts = [i for n, i in self._instruments.items()
                     if n.startswith(prefix)]
        for i in insts:
            i.reset()

    def snapshot(self) -> dict:
        """JSON-able ``{"labels": ..., "metrics": {name: {...}}}``."""
        with self._lock:
            insts = dict(self._instruments)
        return {
            "labels": dict(self.common_labels),
            "metrics": {n: i.snapshot() for n, i in sorted(insts.items())},
        }

    def to_json(self, indent: int = 2) -> str:
        """``snapshot()`` as JSON text."""
        return json.dumps(self.snapshot(), indent=indent)

    def prometheus_text(self) -> str:
        """Prometheus text exposition (one HELP / TYPE block a series;
        histograms as summaries: quantiles, ``_sum`` and ``_count``)."""
        labels = ",".join(f'{k}="{v}"'
                          for k, v in sorted(self.common_labels.items()))
        lb = f"{{{labels}}}" if labels else ""

        def qlb(extra):
            items = sorted(self.common_labels.items()) + sorted(extra.items())
            body = ",".join(f'{k}="{v}"' for k, v in items)
            return f"{{{body}}}" if body else ""

        with self._lock:
            insts = sorted(self._instruments.items())
        out = []
        for name, inst in insts:
            if inst.help:
                out.append(f"# HELP {name} {inst.help}")
            if isinstance(inst, Histogram):
                out.append(f"# TYPE {name} summary")
                snap = inst.snapshot()
                for q, key in (("0.5", "p50"), ("0.95", "p95"),
                               ("0.99", "p99")):
                    out.append(f"{name}{qlb({'quantile': q})} {snap[key]}")
                out.append(f"{name}_sum{lb} {snap['sum']}")
                out.append(f"{name}_count{lb} {snap['count']}")
            else:
                out.append(f"# TYPE {name} {inst.kind}")
                out.append(f"{name}{lb} {inst.value}")
        return "\n".join(out) + "\n"


def _sanitize(name: str) -> str:
    return "".join(c if c in _NAME_OK else "_" for c in name)


def export_stats(registry: MetricsRegistry, stats: dict,
                 prefix: str = "engine") -> int:
    """Mirror a nested numeric stats dict into ``<prefix>_<path>`` gauges
    (bools, strings and None skipped); returns the number written."""
    n = 0

    def walk(path, node):
        nonlocal n
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{path}_{k}", v)
        elif isinstance(node, (int, float)) and not isinstance(node, bool):
            registry.gauge(_sanitize(path)).set(float(node))
            n += 1

    walk(prefix, stats)
    return n
