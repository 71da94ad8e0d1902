"""Measured-time autotuner for the LUT mpGEMM kernels, with a persistent
tuning cache: the port's counterpart of the reference's
``repro/core/autotune.py``.

The knobs are the CUDA kernels' launch plan, which the wrappers take at run
time, so tuning needs no other build of ``csrc/``:

  * ``fusion`` — the fused kernel (table built on chip) or the staged pair
    (``table_precompute`` + ``lut_mpgemm``);
  * ``tile`` — an index into ``lut_mpgemm.INT_TILES`` on per_row tables,
    into ``lut_mpgemm.BF16_TILES`` on float tables (the tile's K-step, bg
    groups, follows from it as in the wrappers);
  * ``splits`` — the split-K count S, 1 <= S <= steps // MIN_STEPS.

``candidate_configs`` lists candidates for one shape: candidate 0 is the
heuristic's own plan (``ops.auto_fusion`` with the tile and S that
``int_tile_for`` / ``f32_tile_for``, ``split_for`` and ``wave_splits``
pick), then the other fusion on that tile, then tiles ranked by the LMMA
prior (``lmma._score``), each at its plan's S, twice it and half it.
``tune_mpgemm`` times each on the card: device time with CUDA events
around the whole op, the L2 flushed and ~2 ms of spin on the card ahead
of each start event (the host's queueing stays out), after a first call
whose host wall is ``compile_ms`` — the kernels are built before it. On
the CPU it times the plain versions with the host clock; that serves only
the contract tests.

``TuningCache`` persists winners to JSON keyed by ``shape_key`` (the
reference's key strings), with the backend — the card's name, or "cpu" —
and the torch and CUDA versions at file level. A corrupt, truncated or
unknown-version file degrades to an empty cache with a warning; a file
from another backend or version (a reference file included) is kept, and
every entry is sanitized at lookup; malformed entries are skipped. Saves
are atomic (temp file + ``os.replace``).

``fusion="tuned"`` (``kernels.ops.resolve_dispatch``) reads the active cache
through ``lookup_tuned``, falling back to ``"auto"`` on a miss. The port
dispatches eagerly, once per projection per step, so the sanitized result
is memoized per shape until the active cache changes (``configure``,
``deactivate``, an entry stored): the cache's ``hits`` / ``misses`` /
``sanitized`` count distinct shapes looked up since then.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import tempfile
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import lmma
from repro_torch.core.quantize import QuantizedWeight
from repro_torch.kernels import lut_mpgemm as lut_kernel

__all__ = ["TunedConfig", "TuningCache", "shape_key", "sanitize_config",
           "candidate_configs", "tune_mpgemm", "collect_qw_shapes",
           "pretune_params", "configure", "deactivate", "get_active",
           "lookup_tuned", "lookup_fusion_any", "default_backend",
           "CACHE_FORMAT_VERSION"]

CACHE_FORMAT_VERSION = 1
FUSIONS = ("fused", "staged")


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One launch plan for one mpGEMM shape, and its measurements."""

    fusion: str                 # "fused" | "staged"
    tile: int                   # index into INT_TILES (per_row) / BF16_TILES
    splits: int                 # split-K count S
    steady_ms: float = 0.0      # median device time after the first call
    compile_ms: float = 0.0     # host wall of the first call
    heuristic_ms: float = 0.0   # same-pass steady time of the "auto" plan
    source: str = "heuristic"   # "heuristic" | "measured"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def knobs(self) -> Tuple[str, int, int]:
        return (self.fusion, self.tile, self.splits)


def shape_key(m: int, n: int, g: int, k_group: int, w_bits: int, *,
              dtype: str = "f32",
              table_quant: Optional[str] = "per_row") -> str:
    """Cache key for one mpGEMM problem: shape, dtype and table mode (the
    reference's key strings)."""
    return (f"m{m}.n{n}.g{g}.kg{k_group}.w{w_bits}."
            f"{dtype}.tq{table_quant or 'none'}")


def _tiles(table_quant: Optional[str]):
    return (lut_kernel.INT_TILES if table_quant == "per_row"
            else lut_kernel.BF16_TILES)


def sanitize_config(cfg: TunedConfig, m: int, n: int, g: int, k_group: int,
                    planes: int, table_quant: Optional[str] = "per_row"
                    ) -> Optional[TunedConfig]:
    """Force a (possibly foreign) cache entry into a plan the wrappers
    accept: None when unusable (a field that is no integer — ``inf`` and
    NaN included —, an unknown fusion, a negative tile, S < 1); else the
    tile clamped to the last that exists and S to ``max_splits`` of the
    kernel's K-steps."""
    try:
        tile, splits = int(cfg.tile), int(cfg.splits)
    except (TypeError, ValueError, OverflowError):
        return None
    if cfg.fusion not in FUSIONS or tile < 0 or splits < 1:
        return None
    from repro_torch.kernels import ops
    tile = min(tile, len(_tiles(table_quant)) - 1)
    bg = ops.kernel_plan(m, n, g, k_group, planes, table_quant, cfg.fusion,
                         tile)[3]
    splits = min(splits, lut_kernel.max_splits(-(-g // bg)))
    return dataclasses.replace(cfg, tile=tile, splits=splits)


def default_backend() -> str:
    """The card's name where torch sees one, else "cpu"."""
    return (torch.cuda.get_device_name() if torch.cuda.is_available()
            else "cpu")


# ---------------------------------------------------------------------------
# persistent cache
# ---------------------------------------------------------------------------

class TuningCache:
    """JSON-backed {shape_key -> TunedConfig} map with durable load/save."""

    def __init__(self, path: Optional[str] = None, *,
                 backend: Optional[str] = None):
        self.path = path
        self.backend = default_backend() if backend is None else backend
        self.torch_version = torch.__version__
        self.cuda_version = torch.version.cuda
        self.entries: Dict[str, TunedConfig] = {}
        self.foreign = False      # loaded from another backend / version
        self.hits = 0
        self.misses = 0
        self.sanitized = 0        # lookups whose entry was repaired / dropped
        if path is not None and os.path.exists(path):
            self._load(path)

    def _load(self, path: str):
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            warnings.warn(f"tuning cache {path!r} unreadable ({e}); "
                          "falling back to heuristic dispatch")
            return
        if (not isinstance(raw, dict)
                or raw.get("version") != CACHE_FORMAT_VERSION
                or not isinstance(raw.get("entries"), dict)):
            version = raw.get("version") if isinstance(raw, dict) else "?"
            warnings.warn(f"tuning cache {path!r} has unknown format "
                          f"(version={version!r}, want "
                          f"{CACHE_FORMAT_VERSION}); ignoring it")
            return
        here = (self.backend, self.torch_version, self.cuda_version)
        there = (raw.get("backend"), raw.get("torch_version"),
                 raw.get("cuda_version"))
        if there != here:
            self.foreign = True
            warnings.warn(f"tuning cache {path!r} was tuned on (backend, "
                          f"torch, cuda) = {there} (running {here}); entries "
                          "will be re-validated at lookup")
        fields = {f.name for f in dataclasses.fields(TunedConfig)}
        for key, ent in raw["entries"].items():
            if not isinstance(ent, dict):
                continue
            try:
                cfg = TunedConfig(**{k: v for k, v in ent.items()
                                     if k in fields})
                int(cfg.tile), int(cfg.splits)
            except (TypeError, ValueError, OverflowError):
                continue  # malformed (a reference entry too): skip it
            self.entries[key] = cfg

    def save(self, path: Optional[str] = None):
        """Atomic save: a temp file in the target directory + os.replace."""
        path = path or self.path
        if path is None:
            raise ValueError("TuningCache has no path to save to")
        payload = {
            "version": CACHE_FORMAT_VERSION,
            "backend": self.backend,
            "torch_version": self.torch_version,
            "cuda_version": self.cuda_version,
            "entries": {k: v.as_dict()
                        for k, v in sorted(self.entries.items())},
        }
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tuning_cache.",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)  # atomic: readers never see a torn file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.path = path

    def put(self, key: str, cfg: TunedConfig):
        self.entries[key] = cfg
        _MEMO.clear()

    def lookup(self, key: str) -> Optional[TunedConfig]:
        cfg = self.entries.get(key)
        if cfg is None:
            self.misses += 1
        else:
            self.hits += 1
        return cfg

    def counters(self) -> dict:
        """Lookups and durability state, for ``engine.stats()
        ["tuning_cache"]``; ``sanitized`` nonzero on a same-backend cache
        means the file is stale."""
        return {
            "entries": len(self.entries),
            "hits": self.hits,
            "misses": self.misses,
            "sanitized": self.sanitized,
            "foreign": self.foreign,
            "backend": self.backend,
            "path": self.path,
        }

    def __len__(self):
        return len(self.entries)


# ---------------------------------------------------------------------------
# the active cache, which fusion="tuned" reads
# ---------------------------------------------------------------------------

_ACTIVE: Optional[TuningCache] = None
# per-shape results of lookup_tuned / lookup_fusion_any on the active cache
_MEMO: Dict[tuple, object] = {}


def configure(path: Optional[str], **kw) -> TuningCache:
    """Load (or create) the active tuning cache read by ``fusion="tuned"``."""
    global _ACTIVE
    _ACTIVE = TuningCache(path, **kw)
    _MEMO.clear()
    return _ACTIVE


def deactivate():
    global _ACTIVE
    _ACTIVE = None
    _MEMO.clear()


def get_active() -> Optional[TuningCache]:
    return _ACTIVE


def lookup_tuned(m: int, n: int, g: int, k_group: int, planes: int, *,
                 table_quant: Optional[str] = "per_row"
                 ) -> Optional[TunedConfig]:
    """The sanitized entry for one shape of the active cache, or None (no
    active cache, no entry, or an entry sanitation dropped); memoized."""
    if _ACTIVE is None:
        return None
    mk = ("tuned", m, n, g, k_group, planes, table_quant)
    try:
        return _MEMO[mk]
    except KeyError:
        pass
    key = shape_key(m, n, g, k_group, planes, table_quant=table_quant)
    cfg = _ACTIVE.lookup(key)
    out = None
    if cfg is not None:
        out = sanitize_config(cfg, m, n, g, k_group, planes, table_quant)
        if out != cfg:  # repaired or dropped
            _ACTIVE.sanitized += 1
    _MEMO[mk] = out
    return out


def lookup_fusion_any(m: int, g: int, k_group: int,
                      w_bits: int) -> Optional[str]:
    """Fusion vote for a table shared by several consumers
    (``layers.make_table`` does not know N): the fusion of the largest-N
    entry whose (M, G, k_group, bits) match, or None; memoized."""
    if _ACTIVE is None:
        return None
    mk = ("fusion_any", m, g, k_group, w_bits)
    try:
        return _MEMO[mk]
    except KeyError:
        pass
    prefix, want = f"m{m}.", f".g{g}.kg{k_group}.w{w_bits}."
    best_n, best = -1, None
    for key, cfg in _ACTIVE.entries.items():
        if not key.startswith(prefix) or want not in key:
            continue
        try:
            n = int(key.split(".n")[1].split(".")[0])
        except (IndexError, ValueError):
            continue
        if n > best_n and cfg.fusion in FUSIONS:
            best_n, best = n, cfg.fusion
    _MEMO[mk] = best
    return best


# ---------------------------------------------------------------------------
# candidates: the heuristic's plan, then the LMMA prior over the tiles
# ---------------------------------------------------------------------------

def candidate_configs(m: int, n: int, g: int, k_group: int, planes: int, *,
                      table_quant: Optional[str] = "per_row",
                      max_candidates: int = 6) -> List[TunedConfig]:
    """Candidates for one mpGEMM shape, at most ``max_candidates``.

    Candidate 0 is the heuristic's plan (what ``"auto"`` runs), so a tuned
    plan is never slower than it as measured in the same pass. Then the
    other fusion on the heuristic's tile, so measurement settles fused vs
    staged; then the tiles that hold no more rows than the heuristic's,
    best first by the LMMA prior (``lmma._score``: MACs per byte moved,
    elongated N), each in both fusions at its plan's S, twice it and half
    it (clamped to 1..``max_splits``)."""
    from repro_torch.kernels import ops

    def plan(fusion, tile=None):
        return ops.kernel_plan(m, n, g, k_group, planes, table_quant,
                               fusion, tile)

    hf = ops.auto_fusion(m, n, g, k_group, planes)
    hcfg, _, _, _, hs = plan(hf)
    out = [TunedConfig(hf, hcfg, hs, source="heuristic")]
    seen = {out[0].knobs}

    def add(fusion, tile, splits):
        bg = plan(fusion, tile)[3]
        splits = max(1, min(splits, lut_kernel.max_splits(-(-g // bg))))
        if len(out) < max_candidates and (fusion, tile, splits) not in seen:
            seen.add((fusion, tile, splits))
            out.append(TunedConfig(fusion, tile, splits, source="measured"))

    other = "staged" if hf == "fused" else "fused"
    add(other, hcfg, plan(other, hcfg)[4])
    desc = lmma.LMMADescriptor(m=m, n=n, k=g * k_group, w_bits=planes,
                               k_group=k_group)

    def prior(tile):
        _, bm, bn, bg, _ = plan(hf, tile)
        t, w, a = lmma._tile_bytes(bm, bn, bg, desc)
        return lmma._score(lmma.TileSchedule(bm, bn, bg, t, w, a,
                                             2 * (t + w) + a), desc)

    rows = [t[0] for t in _tiles(table_quant)]
    for tile in sorted((t for t in range(len(rows)) if rows[t] <= rows[hcfg]),
                       key=prior, reverse=True):
        for fusion in (hf, other):
            s = plan(fusion, tile)[4]
            for splits in (s, 2 * s, s // 2):
                add(fusion, tile, splits)
    return out


# ---------------------------------------------------------------------------
# measured tuning
# ---------------------------------------------------------------------------

def _measure(fn, repeats: int, flush) -> Tuple[float, float]:
    """(compile_ms, steady_ms): the host wall of the first call, then the
    median over ``repeats`` calls of the device time (CUDA events, each
    after an L2 flush and ~2 ms of spin on the card, so the events time the
    device work and not the host's queueing) or, on the CPU, of the host
    wall."""
    cuda = flush is not None
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    times = []
    if cuda:
        pairs = []
        for _ in range(max(1, repeats)):
            flush.zero_()
            torch.cuda._sleep(4_000_000)  # clock cycles: ~2 ms at 1.98 GHz
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) for s, e in pairs]
    else:
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return compile_ms, statistics.median(times)


def tune_mpgemm(m: int, qw: QuantizedWeight, *,
                table_quant: Optional[str] = "per_row",
                cache: Optional[TuningCache] = None, repeats: int = 3,
                max_candidates: int = 6, seed: int = 0,
                verbose: bool = False
                ) -> Tuple[TunedConfig, List[TunedConfig]]:
    """Measure the candidates of one (M × qw) mpGEMM on qw's device and
    store the winner (least ``steady_ms``) in ``cache``. Returns (best,
    every measured candidate); best carries the heuristic's time of the
    same pass as ``heuristic_ms``."""
    from repro_torch.kernels import _build, ops

    dev = qw.packed.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((m, qw.k_total), generator=gen, device=dev)
    flush = None
    if dev.type == "cuda":
        _build.build_all()  # one build for every candidate, before timing
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    measured: List[TunedConfig] = []
    for cand in candidate_configs(m, qw.n, qw.g, qw.k_group, qw.num_planes,
                                  table_quant=table_quant,
                                  max_candidates=max_candidates):
        def run(cand=cand):
            return ops.lut_mpgemm(x, qw, table_quant=table_quant,
                                  fusion=cand.fusion, tile=cand.tile,
                                  splits=cand.splits)
        try:
            compile_ms, steady_ms = _measure(run, repeats, flush)
        except (RuntimeError, ValueError) as e:  # refused on this card
            warnings.warn(f"autotune candidate {cand.knobs} failed: {e}")
            continue
        measured.append(dataclasses.replace(cand, compile_ms=compile_ms,
                                            steady_ms=steady_ms))
        if verbose:
            print(f"  cand {cand.fusion:6s} tile {cand.tile} S "
                  f"{cand.splits:<3d} first call {compile_ms:8.2f} ms  "
                  f"steady {steady_ms:8.4f} ms  [{cand.source}]")
    if not measured:
        raise RuntimeError(f"no viable autotune candidate for m={m}, "
                           f"n={qw.n}, k={qw.k_total}")
    best = min(measured, key=lambda c: c.steady_ms)
    heur = next((c for c in measured if c.source == "heuristic"), best)
    best = dataclasses.replace(best, source="measured",
                               heuristic_ms=heur.steady_ms)
    if cache is not None:
        cache.put(shape_key(m, qw.n, qw.g, qw.k_group, qw.num_planes,
                            table_quant=table_quant), best)
    return best, measured


def collect_qw_shapes(params) -> List[QuantizedWeight]:
    """One QuantizedWeight per distinct (N, K, k_group, planes) in a param
    tree (dicts and lists), in the order first met."""
    found, seen = [], set()

    def walk(node):
        if isinstance(node, QuantizedWeight):
            sig = (node.n, node.k_total, node.k_group, node.num_planes)
            if sig not in seen:
                seen.add(sig)
                found.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(params)
    return found


def pretune_params(params, ms: Sequence[int], *,
                   cache: Optional[TuningCache] = None,
                   table_quant: Optional[str] = "per_row",
                   repeats: int = 2, max_candidates: int = 4,
                   skip_cached: bool = True, verbose: bool = False) -> int:
    """Tune every (M, projection shape) pair a serve dispatches (``ms``:
    the engine's decode M, ``max_batch``, and prefill M,
    ``prefill_chunk``) into ``cache`` (the active one by default); entries
    already there are skipped unless ``skip_cached=False``. Returns the
    number of shapes tuned; ``cache.save()`` persists them."""
    cache = cache if cache is not None else get_active()
    tuned = 0
    for qw in collect_qw_shapes(params):
        for m in ms:
            key = shape_key(m, qw.n, qw.g, qw.k_group, qw.num_planes,
                            table_quant=table_quant)
            if skip_cached and cache is not None and key in cache.entries:
                continue
            if verbose:
                print(f"tuning {key} ...")
            tune_mpgemm(m, qw, table_quant=table_quant, cache=cache,
                        repeats=repeats, max_candidates=max_candidates,
                        verbose=verbose)
            tuned += 1
    return tuned
