"""Logical-axis sharding rules, resolved to per-rank blocks of the params.

The port of the reference's ``distributed/sharding.py`` without JAX. The
reference annotates parameters by path regex (``DEFAULT_RULES``), resolves
each logical spec to a legal physical one (``resolve_physical_spec``: a
dim that does not divide, or a packed byte dim whose shard would split a
bit-group, stays replicated) and places the tree; XLA's GSPMD then inserts
every collective. PyTorch has no partitioner for hand-written kernels, so
the port is explicit SPMD: ``shard_params`` keeps each rank's contiguous
block of every leaf and records on each linear how it runs, and the layers
(``models/layers.py``, ``transformer.py``, ``moe.py``) call the collective
GSPMD would have inserted (``distributed/collectives.py``):

  * ``"col"`` — column-parallel: the local block of output channels (N),
    from the whole (replicated) activation, no collective;
  * ``"row"`` — row-parallel: the local block of the contraction (K), a
    partial product summed over the model axis, the bias added once after
    the sum; per_row INT8 tables take the whole row's scale (the max of
    the ranks' row scales) so their codes are the single-device codes;
  * none — replicated: the whole layer on every rank;
  * ``"vocab"`` — the embedding's vocab rows, ``"expert"`` — a stack of
    experts split along E.

Paths are the reference's ``/`` form over the port's trees (a layer stack
is a list, so ``layers/0/attn/wq/qw/packed``; a ``QuantizedWeight``'s
children are ``packed``, ``scale``, ``zero_prime`` and ``cw`` where not
None). A port layer leaf has no leading ``[L]`` dim, so a rule applies to
it without the reference's leading ``None``.

Where the port's layout departs from the reference's resolved spec (layout
only: GSPMD layouts change no result):

  * attention shards by whole KV heads: where ``n_kv_heads`` (or
    ``n_heads``) does not divide by the model axis, a block's ``wq``,
    ``wk``, ``wv`` and ``wo`` run replicated (the reference may split
    ``wk``'s columns in the middle of a head);
  * the MoE router stays replicated (every rank routes all tokens);
  * a packed byte dim is split only where each shard holds whole bit-groups
    of the port's group-major stream, else replicated.

Collectives, the mesh record and process-group setup: ``collectives.py``
and ``launch/mesh.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.quantize import QuantizedWeight

__all__ = ["Mesh", "AxisPlan", "plan_scope", "current_plan", "model_split",
           "data_split", "for_batch", "local_rows", "param_spec_tree",
           "resolve_physical_spec", "packed_group_bytes", "shard_params",
           "one_device_control", "attention_split", "local_kv_heads",
           "tree_to", "strip_marks", "with_marks", "leaf_specs", "specs_for", "mirrors", "map_by_param",
           "train_specs", "block_of", "whole_of", "shard_train_state",
           "gather_train_state", "MARKS", "DEFAULT_RULES"]

_state = threading.local()

_QW_CHILDREN = ("packed", "scale", "zero_prime", "cw")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A small mesh record: axis names and sizes, this rank's coordinate
    along each axis, each axis's process group (None where the axis has
    size 1), the backend the groups run on and this rank's device;
    ``lanes``: per axis, more groups over the same ranks, which a large
    transfer is split over (``collectives``)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[str, Any]
    backend: Optional[str] = None
    device: Optional[torch.device] = None
    lanes: Dict[str, Tuple[Any, ...]] = dataclasses.field(
        default_factory=dict)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]


@dataclasses.dataclass(frozen=True)
class AxisPlan:
    """Logical -> physical axes, as the reference's ``AxisPlan`` (its mesh
    a ``Mesh`` record)."""

    mesh: Mesh
    batch: Tuple[str, ...] = ("data",)
    model: Optional[str] = "model"
    expert: Optional[str] = "model"
    fsdp: Optional[str] = None
    seq: Optional[str] = None
    stage: Optional[str] = None

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == "batch":  # () : the batch replicated
            if not self.batch:
                return None
            return self.batch if len(self.batch) > 1 else self.batch[0]
        return getattr(self, logical)

    def axis_size(self, logical: Optional[str]) -> int:
        """Number of shards the resolved physical axis produces (1 = off)."""
        ax = self.resolve(logical)
        if ax is None:
            return 1
        sizes = self.mesh.sizes
        if isinstance(ax, str):
            return sizes[ax]
        return int(math.prod(sizes[a] for a in ax))

    def rank_along(self, logical: str) -> int:
        """This rank's coordinate along the physical axis of ``logical``."""
        ax = self.resolve(logical)
        return 0 if ax is None else self.mesh.coord(ax)

    def group(self, logical: str):
        """The process group of the physical axis of ``logical``."""
        return self.mesh.groups.get(self.resolve(logical))


@contextlib.contextmanager
def plan_scope(plan: Optional[AxisPlan]):
    prev = getattr(_state, "plan", None)
    _state.plan = plan
    try:
        yield plan
    finally:
        _state.plan = prev


def current_plan() -> Optional[AxisPlan]:
    return getattr(_state, "plan", None)


def model_split() -> Optional[AxisPlan]:
    """The active plan where its model axis has more than one rank, else
    None: a 1x1 plan is the single-device path."""
    plan = current_plan()
    return plan if plan is not None and plan.axis_size("model") > 1 else None


def data_split() -> Optional[AxisPlan]:
    """The active plan where it splits the batch over more than one data
    rank, else None."""
    plan = current_plan()
    return plan if plan is not None and plan.axis_size("batch") > 1 else None


def for_batch(plan: Optional[AxisPlan], b: int) -> Optional[AxisPlan]:
    """``plan`` for a batch of ``b`` rows: its data axis splits the batch
    only where it divides b; otherwise the batch is replicated over it
    (``batch=()``), as ``resolve_physical_spec`` replicates a dim its axis
    does not divide (a batch-1 prefill, a pool of 3 slots on 2 data
    ranks)."""
    if plan is None or b % plan.axis_size("batch") == 0:
        return plan
    return dataclasses.replace(plan, batch=())


def local_rows(plan: Optional[AxisPlan], b: int) -> slice:
    """This rank's contiguous rows of a batch of ``b`` under ``plan``
    (``for_batch``'s): block r of the data axis's D, all rows where the
    batch is replicated."""
    d = 1 if plan is None else plan.axis_size("batch")
    if d == 1 or b % d:
        return slice(0, b)
    n = b // d
    r = plan.rank_along("batch")
    return slice(r * n, (r + 1) * n)


# ---------------------------------------------------------------------------
# Parameter sharding rules: path regex -> logical spec per dim (the
# reference's DEFAULT_RULES, unchanged). Every parameter leaf must match a
# rule: an unmatched leaf raises with its path.
# ---------------------------------------------------------------------------

DEFAULT_RULES = [
    # embeddings / positional tables / lm head: vocab sharded over model axis
    (r"embed/table$", ("model", "fsdp")),
    (r"pos_embed$", (None, None)),
    (r"lm_head/w$", ("fsdp", "model")),
    (r"lm_head/qw/packed$", ("model", None)),
    (r"lm_head/qw/(scale|zero_prime)$", ("model",)),
    (r"lm_head/qw/cw$", (None, "model")),
    # attention projections: column-parallel qkv, row-parallel o
    (r"(attn|xattn|shared_attn)/wq/w$", ("fsdp", "model")),
    (r"(attn|xattn|shared_attn)/wk/w$", ("fsdp", "model")),
    (r"(attn|xattn|shared_attn)/wv/w$", ("fsdp", "model")),
    (r"(attn|xattn|shared_attn)/w[qkv]/b$", ("model",)),
    (r"(attn|xattn|shared_attn)/wo/w$", ("model", "fsdp")),
    (r"(attn|xattn|shared_attn)/wo/b$", (None,)),
    # mlp: column-parallel gate/up, row-parallel down
    (r"(mlp|shared_mlp)/(gate|up)/w$", ("fsdp", "model")),
    (r"(mlp|shared_mlp)/down/w$", ("model", "fsdp")),
    (r"(mlp|shared_mlp)/(gate|up|down)/b$", (None,)),
    # MoE: experts dim over expert axis, then like mlp
    (r"experts/(gate|up)$", ("expert", "fsdp", None)),
    (r"experts/down$", ("expert", None, "fsdp")),
    (r"experts/(gate|up|down)_qw/packed$", ("expert", None, None)),
    (r"experts/(gate|up|down)_qw/(scale|zero_prime)$", ("expert", None)),
    (r"experts/(gate|up|down)_qw/cw$", ("expert", None, None)),
    (r"router/w$", (None, "expert")),
    # mamba: d_inner sharded over model
    (r"ssm/in_proj/w$", ("fsdp", "model")),
    (r"ssm/out_proj/w$", ("model", "fsdp")),
    (r"ssm/(x_proj|dt_proj)/w$", ("model", None)),
    (r"ssm/dt_proj/b$", (None,)),
    (r"ssm/(conv_w)$", (None, "model")),
    (r"ssm/(conv_b|A_log|D|dt_bias|norm_g)$", ("model",)),
    # quantized linears (serving): packed is [N(out), ceil(K·B/8)].
    # column-parallel (the float weight sharded its OUT dim over model):
    (r"(/|^)(wq|wk|wv|gate|up|in_proj)/qw/packed$", ("model", None)),
    (r"(/|^)(wq|wk|wv|gate|up|in_proj)/qw/(scale|zero_prime)$", ("model",)),
    (r"(/|^)(wq|wk|wv|gate|up|in_proj)/qw/cw$", (None, "model")),
    # row-parallel (the float weight sharded its IN dim over model): shard
    # the byte dim, legal only on bit-group boundaries
    (r"(/|^)(wo|down|out_proj|x_proj|dt_proj)/qw/packed$", (None, "model")),
    (r"(/|^)(wo|down|out_proj|x_proj|dt_proj)/qw/(scale|zero_prime)$",
     (None,)),
    (r"(/|^)(wo|down|out_proj|x_proj|dt_proj)/qw/cw$", ("model", None)),
    # norms / gates / small vectors replicated
    (r"norm/(g|b)$", (None,)),
    (r"gate_(attn|mlp)$", (None,)),
    (r"/b$", (None,)),
]


def _spec_for(path: str, shape, rules) -> Optional[Tuple[Optional[str], ...]]:
    """Logical spec for a leaf, or None when no rule matches."""
    for pat, spec in rules:
        if re.search(pat, path):
            spec = tuple(spec)
            if len(spec) < len(shape):  # stacked leading dims
                spec = (None,) * (len(shape) - len(spec)) + spec
            elif len(spec) > len(shape):
                spec = spec[-len(shape):] if len(shape) else ()
            return spec
    return None


def _walk(node, path, fn):
    """``fn(path, leaf)`` over a param tree's array leaves, a
    ``QuantizedWeight`` walked as its non-None children; returns the tree
    of results (a ``QuantizedWeight`` becomes a dict of its children's)."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(node, dict):
        return {k: _walk(v, join(k), fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, join(i), fn) for i, v in enumerate(node))
    if isinstance(node, QuantizedWeight):
        return {c: fn(join(c), getattr(node, c)) for c in _QW_CHILDREN
                if getattr(node, c) is not None}
    if torch.is_tensor(node):
        return fn(path, node)
    return None


def param_spec_tree(params, rules=None):
    """Tree of logical specs (tuples of logical axis names) for params, a
    ``QuantizedWeight`` as a dict of its non-None children's specs. Raises
    listing every unmatched leaf by path."""
    rules = rules or DEFAULT_RULES
    unmatched = []

    def spec(path, leaf):
        s = _spec_for(path, tuple(leaf.shape), rules)
        if s is None:
            unmatched.append(path)
        return s

    out = _walk(params, "", spec)
    if unmatched:
        raise ValueError(
            "no sharding rule matched these parameter leaves (add a rule or "
            "an explicit replicate entry): " + ", ".join(unmatched))
    return out


def packed_group_bytes(qw) -> int:
    """Bytes one k-group occupies in a packed plane row: the granularity
    below which the byte dim of ``packed`` must never be split."""
    g = max(1, qw.k_total // qw.k_group)
    last = qw.packed.shape[-1] if qw.packed is not None else 0
    return max(1, last // g) if last % g == 0 and last else 1


def resolve_physical_spec(shape, phys_axes, axis_sizes,
                          *, last_dim_align: int = 1):
    """Per-dim physical axis names -> a legal spec tuple for ``shape``: a
    dim is replicated (None) when its mesh axis does not divide it, and the
    final dim also when its per-shard extent is not a multiple of
    ``last_dim_align`` (packed planes: never split a bit-group)."""
    out = []
    ndim = len(shape)
    for i, (dim, ax) in enumerate(zip(shape, phys_axes)):
        if ax is None:
            out.append(None)
            continue
        if isinstance(ax, str):
            size = axis_sizes[ax]
        else:
            size = int(math.prod(axis_sizes[a] for a in ax))
        if size <= 0 or dim % size != 0:
            out.append(None)
            continue
        if i == ndim - 1 and last_dim_align > 1 and \
                (dim // size) % last_dim_align != 0:
            out.append(None)
            continue
        out.append(ax)
    return tuple(out)


# ---------------------------------------------------------------------------
# the port's layout decisions and the per-rank blocks
# ---------------------------------------------------------------------------

def attention_split(cfg, plan: Optional[AxisPlan]) -> bool:
    """Whether attention runs on whole local KV heads under ``plan``:
    ``n_kv_heads`` and ``n_heads`` divide by the model axis (each rank
    holds n_heads / m query heads and n_kv_heads / m KV heads of one GQA
    group range). Otherwise every rank runs attention whole."""
    m = 1 if plan is None else plan.axis_size("model")
    return m > 1 and cfg.n_kv_heads % m == 0 and cfg.n_heads % m == 0


def local_kv_heads(cfg, plan: Optional[AxisPlan] = None) -> int:
    """KV heads of this rank's attention cache: n_kv_heads / m where
    attention is split, else all (``attention_split``)."""
    plan = model_split() if plan is None else plan
    if attention_split(cfg, plan):
        return cfg.n_kv_heads // plan.axis_size("model")
    return cfg.n_kv_heads


def _block(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``parts`` along ``dim``, as a tensor of its own
    (the rest of ``t`` is dropped)."""
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size).clone()


def _linear_mode(node, phys, model_ax="model") -> Optional[str]:
    """"col", "row" or None for a linear ``{"w"}`` / ``{"qw"}`` from where
    its main leaf's resolved spec holds the model axis (an expert stack:
    "expert" or None)."""
    on = lambda spec, i: spec[i] == model_ax
    if "w" in node:
        spec = phys["w"]
        if len(spec) == 3:
            return "expert" if on(spec, 0) else None
        return "col" if on(spec, 1) else ("row" if on(spec, 0) else None)
    qw, spec = node["qw"], phys["qw"]
    if qw.is_cw:  # cw [G·E, N]
        s = spec["cw"]
        return "col" if on(s, 1) else ("row" if on(s, 0) else None)
    s = spec["packed"]
    return "col" if on(s, 0) else ("row" if on(s, 1) else None)


def _row_groups_whole(qw: QuantizedWeight, m: int) -> bool:
    """Whether each of m K-blocks of ``qw`` holds whole groups of the
    port's group-major stream (packed: whole group fields in its bytes;
    cw: whole groups of E entries)."""
    if qw.g % m:
        return False
    if qw.is_cw:
        return True
    bits_per_group = qw.k_group * qw.stored_planes
    return (qw.packed.shape[-1] // m) * 8 % bits_per_group == 0


def _shard_qw(qw: QuantizedWeight, mode: str, m: int,
              r: int) -> QuantizedWeight:
    """Rank r's block of a packed weight: its ``packed``, ``scale``,
    ``zero_prime`` and ``cw`` split together, ``n`` / ``k_total`` set to
    the local block."""
    pick = lambda t, dim: None if t is None else _block(t, dim, m, r)
    n, k_total = qw.n, qw.k_total
    if mode == "col":
        packed, scale, zp = pick(qw.packed, 0), pick(qw.scale, 0), \
            pick(qw.zero_prime, 0)
        cw = pick(qw.cw, 1)
        n = qw.n // m
    elif mode == "row":
        packed, scale, zp = pick(qw.packed, 1), qw.scale, qw.zero_prime
        cw = pick(qw.cw, 0)
        k_total = qw.k_total // m
    else:  # expert: every child's leading E
        packed, scale, zp, cw = (pick(t, 0) for t in (
            qw.packed, qw.scale, qw.zero_prime, qw.cw))
    return QuantizedWeight(packed, scale, zp, qw.plane_scales, bits=qw.bits,
                           k_group=qw.k_group, k_total=k_total, n=n,
                           plane_start=qw.plane_start,
                           stored_planes=qw.stored_planes, cw=cw)


_ATTN = re.compile(r"(^|/)(attn|xattn|shared_attn)$")


MARKS = ("tp", "fsdp")


def shard_params(params, plan: AxisPlan, cfg, rules=None):
    """This rank's blocks of a param tree (global tensors in, local out),
    the counterpart of the reference's ``named_sharding_tree`` plus
    ``device_put``. Each leaf keeps its contiguous block per its resolved
    spec (``resolve_physical_spec`` over the rules' logical specs); each
    linear dict gets ``"tp"``: "col", "row" (absent: replicated), the
    embedding "vocab", an expert stack "expert" (module docstring). A
    ``QuantizedWeight``'s children are split together. An unmatched leaf
    raises with its path. A plan whose model axis has one rank and no
    FSDP axis returns ``params`` itself: the single-device path. A node
    sharded already (one that has ``"tp"`` or ``"fsdp"``) is kept as it
    is, so sharding twice is sharding once.

    FSDP (a plan with ``fsdp="data"``, ``launch.mesh.make_plan(fsdp=
    True)``: training's ZeRO-3): a float weight or the embedding table
    whose resolved spec holds the data axis keeps also its block along
    that dim, and its dict gets ``"fsdp"``: {leaf: dim}
    (``collectives.fsdp_gather_tree`` joins the blocks before use). The
    serving plan has no FSDP axis, so the data axis replicates every leaf:
    a rank keeps the blocks of its model coordinate whatever its data
    coordinate."""
    m = plan.axis_size("model")
    dsz = plan.axis_size("fsdp")
    if m == 1 and dsz == 1:
        return params
    r = plan.rank_along("model")
    dr = plan.rank_along("fsdp")
    model_ax, fsdp_ax = plan.resolve("model"), plan.resolve("fsdp")
    sizes = plan.mesh.sizes
    spec_tree = param_spec_tree(params, rules)
    attn_split = attention_split(cfg, plan)

    def phys_of(node, spec):
        """Resolved physical spec of a leaf or QuantizedWeight node."""
        if isinstance(node, QuantizedWeight):
            align = packed_group_bytes(node) if node.packed is not None else 1
            return {c: resolve_physical_spec(
                tuple(getattr(node, c).shape),
                [plan.resolve(a) for a in s], sizes,
                last_dim_align=align if c == "packed" else 1)
                for c, s in spec.items()}
        return resolve_physical_spec(tuple(node.shape),
                                     [plan.resolve(a) for a in spec], sizes)

    def fsdp_dim(phys) -> Optional[int]:
        """The dim a float leaf's resolved spec splits over the data axis
        under an FSDP plan, else None."""
        if dsz == 1 or fsdp_ax not in phys:
            return None
        return phys.index(fsdp_ax)

    def linear(node, spec, path, forced):
        """A linear dict {"w" | "qw", "b"?} -> its local block and mode."""
        key = "w" if "w" in node else "qw"
        phys = phys_of(node[key], spec[key])
        mode = _linear_mode(node, {key: phys}, model_ax) if m > 1 else None
        if m > 1 and forced is not False:
            if forced is None:
                mode = None
            elif mode != forced:
                raise ValueError(
                    f"{path}: resolves to {mode or 'replicated'}, not "
                    f"{forced}, though its attention block is split by "
                    "whole heads")
        if mode == "row" and key == "qw" and not _row_groups_whole(
                node["qw"], m):
            mode = None
        fdim = fsdp_dim(phys) if key == "w" else None
        if mode is None and fdim is None:
            return dict(node)
        out = {}
        if key == "w":
            w = node["w"]
            if mode is not None:
                w = _block(w, {"col": 1, "row": 0}[mode], m, r)
            out["w"] = w if fdim is None else _block(w, fdim, dsz, dr)
        else:
            out["qw"] = _shard_qw(node["qw"], mode, m, r)
        if "b" in node:
            out["b"] = (_block(node["b"], 0, m, r) if mode == "col"
                        else node["b"])
        if mode is not None:
            out["tp"] = mode
        if fdim is not None:
            out["fsdp"] = {"w": fdim}
        return out

    def walk(node, spec, path, forced=False):
        if isinstance(node, dict) and any(k in node for k in MARKS):
            return node  # sharded already
        if isinstance(node, list):
            return [walk(v, s, f"{path}/{i}", forced)
                    for i, (v, s) in enumerate(zip(node, spec))]
        if not isinstance(node, dict):
            return node
        if ("w" in node or "qw" in node) and not path.endswith("router") \
                and (isinstance(node.get("qw"), QuantizedWeight)
                     or torch.is_tensor(node.get("w"))
                     and node["w"].dim() == 2):
            return linear(node, spec, path, forced)
        if path.endswith("router"):  # every rank routes all tokens
            return dict(node)
        if path.endswith("experts"):
            return experts(node, spec, path)
        if path.endswith("embed") and "table" in node:
            phys = phys_of(node["table"], spec["table"])
            table, out = node["table"], {}
            if m > 1 and phys[0] == model_ax:
                table, out["tp"] = _block(table, 0, m, r), "vocab"
            fdim = fsdp_dim(phys)
            if fdim is not None:
                table = _block(table, fdim, dsz, dr)
                out["fsdp"] = {"table": fdim}
            return dict({"table": table}, **out) if out else dict(node)
        sub_forced = forced
        if _ATTN.search(path):
            sub_forced = "attn" if attn_split else None
        out = {}
        for k, v in node.items():
            f = sub_forced
            if sub_forced == "attn":
                f = "row" if k == "wo" else "col"
            out[k] = walk(v, spec[k], f"{path}/{k}" if path else k, f)
        return out

    def experts(node, spec, path):
        """An expert stack (float [E, in, out] or packed ``*_qw``): split
        along E where every one of its leaves resolves so, else whole (no
        FSDP split: MoE training under a mesh is refused)."""
        split = m > 1 and all(
            phys_of(v, spec[k])[0 if torch.is_tensor(v) else
                                "packed" if v.packed is not None
                                else "cw"][0] == model_ax
            for k, v in node.items())
        if not split:
            return dict(node)
        out = {k: (_block(v, 0, m, r) if torch.is_tensor(v)
                   else _shard_qw(v, "expert", m, r)) for k, v in node.items()}
        out["tp"] = "expert"
        return out

    return walk(params, spec_tree, "")


# ---------------------------------------------------------------------------
# the train state under a mesh: specs, blocks, and the whole state again
# ---------------------------------------------------------------------------

def strip_marks(tree):
    """A sharded param tree without its ``"tp"`` / ``"fsdp"`` marks: the
    tensors alone, in the same order (the train state holds this)."""
    if isinstance(tree, list):
        return [strip_marks(v) for v in tree]
    if isinstance(tree, dict):
        return {k: strip_marks(v) for k, v in tree.items() if k not in MARKS}
    return tree


def with_marks(plain, marked):
    """``plain`` (``strip_marks`` of a tree shaped like ``marked``) with
    ``marked``'s marks put back, for the layers to read."""
    if isinstance(marked, list):
        return [with_marks(p, v) for p, v in zip(plain, marked)]
    if isinstance(marked, dict):
        out = {k: with_marks(plain[k], v) for k, v in marked.items()
               if k not in MARKS}
        out.update({k: marked[k] for k in MARKS if k in marked})
        return out
    return plain


def leaf_specs(marked, plan: AxisPlan):
    """The physical spec (a tuple of axis names or None per dim) of each
    leaf of ``strip_marks(marked)``, in tree order, read from the marks:
    "col" splits a weight's dim 1 and its bias over the model axis, "row"
    a weight's dim 0, "vocab" the table's rows, "expert" every leaf's E;
    ``"fsdp"`` {leaf: dim} that dim over the data axis."""
    model_ax, fsdp_ax = plan.resolve("model"), plan.resolve("fsdp")
    out = []

    def walk(node):
        if isinstance(node, list):
            for v in node:
                walk(v)
            return
        mode, dims = node.get("tp"), node.get("fsdp", {})
        for k, v in node.items():
            if k in MARKS:
                continue
            if not torch.is_tensor(v):
                walk(v)
                continue
            spec = [None] * v.dim()
            at = {("col", "w"): 1, ("col", "b"): 0, ("row", "w"): 0,
                  ("vocab", "table"): 0}.get((mode, k))
            if mode == "expert":
                at = 0
            if at is not None:
                spec[at] = model_ax
            if k in dims:
                spec[dims[k]] = fsdp_ax
            out.append(tuple(spec))

    walk(marked)
    return out


def specs_for(params, marked, plan: AxisPlan):
    """``leaf_specs`` of ``marked`` in the leaf order of ``params`` (a tree
    with the same paths, in any key order: a converted tree's)."""
    from repro_torch.core.tree import tree_paths
    by_path = dict(zip((p for p, _ in tree_paths(strip_marks(marked))),
                       leaf_specs(marked, plan)))
    return [by_path[p] for p, _ in tree_paths(params)]


def mirrors(leaf, spec) -> bool:
    """The reference's rule: an optimizer leaf takes its param's spec
    where it is an array of the param's rank, else it is replicated (an
    int8 ``{"q", "s"}`` pair, Adafactor's factored vectors)."""
    return torch.is_tensor(leaf) and leaf.dim() == len(spec)


def map_by_param(fn, params, sub, specs):
    """``fn(spec, state leaf)`` over a tree following ``params``'s leaves
    (an optimizer sub-tree, whose leaf may be a dict), ``specs`` in
    order."""
    from repro_torch.core.tree import tree_map
    it = iter(specs)
    return tree_map(lambda _, s: fn(next(it), s), params, sub)


def train_specs(state, specs):
    """The train state's spec tree, the reference's ``train_shardings``
    rule over per-leaf param ``specs``: params by spec, each optimizer
    leaf its param's spec where it mirrors it (``mirrors``), a dict leaf
    ``{k: ()}`` and anything else ``()`` (replicated), ``ef`` as the
    params, ``step`` ``()``."""
    from repro_torch.core.tree import tree_unflatten
    params = state["params"]
    rep = lambda s: {k: () for k in s} if isinstance(s, dict) else ()
    out = {"params": tree_unflatten(params, list(specs)), "step": ()}
    out["opt"] = {k: (() if k == "step" else map_by_param(
        lambda spec, s: spec if mirrors(s, spec) else rep(s), params, v,
        specs)) for k, v in state["opt"].items()}
    if "ef" in state:
        out["ef"] = out["params"]
    return out


def block_of(t: torch.Tensor, spec, plan: AxisPlan) -> torch.Tensor:
    """This rank's block of a whole tensor ``t`` under ``spec``."""
    sizes = plan.mesh.sizes
    for i, ax in enumerate(spec):
        if ax is not None:
            t = t.narrow(i, plan.mesh.coord(ax) * (t.shape[i] // sizes[ax]),
                         t.shape[i] // sizes[ax])
    return t.clone() if any(a is not None for a in spec) else t


def whole_of(t: torch.Tensor, spec, plan: AxisPlan) -> torch.Tensor:
    """The whole tensor of this rank's block ``t`` under ``spec``, its
    blocks gathered over each axis in rank order (every rank of the
    axes must call it). Runs under ``plan``."""
    from repro_torch.distributed import collectives
    axis = {plan.resolve("model"): "model", plan.resolve("fsdp"): "data"}
    with plan_scope(plan):
        for i, ax in enumerate(spec):
            if ax is not None:
                t = collectives.all_gather(t.detach(), dim=i, axis=axis[ax])
    return t


def shard_train_state(state, plan: AxisPlan, cfg):
    """This rank's blocks of a whole train state: params by
    ``shard_params`` (marks stripped), the optimizer leaves that mirror
    their param and ``ef`` by its spec, replicated leaves and ``step``
    whole."""
    marked = shard_params(state["params"], plan, cfg)
    specs = leaf_specs(marked, plan)
    params = state["params"]
    out = dict(state, params=strip_marks(marked))
    out["opt"] = {k: (v if k == "step" else map_by_param(
        lambda spec, s: block_of(s, spec, plan) if mirrors(s, spec) else s,
        params, v, specs)) for k, v in state["opt"].items()}
    if "ef" in state:
        out["ef"] = map_by_param(lambda spec, s: block_of(s, spec, plan),
                                params, state["ef"], specs)
    return out


def gather_train_state(state, plan: AxisPlan, specs):
    """The whole train state from this rank's blocks (``shard_train_state``
    's inverse), each sharded leaf's blocks joined in rank order, on every
    rank: every rank of the mesh must call it. ``specs``: each param
    leaf's physical spec, in leaf order (``train_loop.param_specs``)."""
    params = state["params"]
    join = lambda spec, s: whole_of(s, spec, plan) if mirrors(s, spec) \
        else s
    out = dict(state, params=map_by_param(join, params, params, specs))
    out["opt"] = {k: (v if k == "step" else map_by_param(join, params, v,
                                                        specs))
                  for k, v in state["opt"].items()}
    if "ef" in state:
        out["ef"] = map_by_param(join, params, state["ef"], specs)
    return out


def one_device_control(params, plan: AxisPlan, cfg):
    """The control of ``plan``'s mesh on one device. Model axis:
    ``params`` whole, each linear that ``shard_params`` splits column- or
    row-parallel given ``"blocks"``: (its mode, the m ranks' blocks of
    it), which ``layers.lut_dense`` contracts as the ranks do, in turn on
    one device: column blocks from the whole x, concatenated; row blocks on
    their K-ranges of x with the whole row's scale, the f32 partials summed
    in rank order (``collectives.reduce_parts``). A split attention block
    gets ``"heads"``: m, and attends over each rank's heads in turn, on
    contiguous copies of their cache blocks (``layers._head_blocks``); the
    caches hold every head. The embedding and the expert stacks stay whole
    (a lookup, and an expert's GEMMs on one rank, change no bit when
    split). Data axis (D > 1): the tree gets ``"rows"``: D, and the dense
    and MoE forwards run a batch that D divides as D row blocks in turn,
    each at a data rank's row count on its rows of the caches, the
    logits concatenated in data order; an MoE layer routes the blocks'
    tokens together (``moe.moe_mlp_blocks``), as the ranks do over the
    data axis. So every kernel runs at the ranks' shapes, and a mesh's
    logits and streams must equal this tree's bit for bit; where they
    differ from one device's, the difference is this arithmetic's."""
    m = plan.axis_size("model")
    ranks = [shard_params(params, AxisPlan(dataclasses.replace(
        plan.mesh, coords=(0, r), groups={})), cfg) for r in range(m)]

    def walk(node, parts):
        if isinstance(node, list):
            return [walk(v, [p[i] for p in parts])
                    for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        mode = parts[0].get("tp")
        if mode in ("col", "row"):
            return dict(node, blocks=(mode, [
                {k: v for k, v in p.items() if k != "tp"} for p in parts]))
        out = {k: walk(v, [p[k] for p in parts]) for k, v in node.items()}
        if isinstance(parts[0].get("wq"), dict) \
                and parts[0]["wq"].get("tp") == "col":  # split attention
            out["heads"] = m
        return out

    ctl = walk(params, ranks)
    d = plan.axis_size("batch")
    return ctl if d == 1 else dict(ctl, rows=d)


def tree_to(params, device):
    """A param tree with its tensors and packed weights on ``device`` (the
    ``"tp"`` marks kept)."""
    if isinstance(params, dict):
        return {k: tree_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(tree_to(v, device) for v in params)
    if torch.is_tensor(params) or isinstance(params, QuantizedWeight):
        return params.to(device)
    return params
