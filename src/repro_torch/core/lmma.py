"""LMMA descriptors + memory-size tile scheduler (§3.3) and the fusion rule.

A copy of the reference's scheduler. ``schedule_tiles`` picks the
elongated (bm, bn, bg) tile that maximizes MACs per byte moved within the
reference's tile-search budget; ``select_fusion`` then asks whether the
fused precompute→lookup working set of that tile fits one thread block's
shared memory on the H100 (232,448 bytes). It does for decode-sized M
(≤ 64 rows at tinyllama's shapes) and does not for a 128-token prefill
chunk, which therefore stages its table through device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["LMMADescriptor", "TileSchedule", "schedule_tiles",
           "fused_tile_bytes", "select_fusion", "SMEM_BYTES"]

# Shared memory one H100 thread block may use (sm_90 opt-in maximum).
SMEM_BYTES = 232_448
# The scheduler's search budget, kept from the reference (64 MiB of TPU
# VMEM) so that the tile it proposes, and hence the fused working set the
# fusion rule judges, is the reference's.
SCHEDULE_BYTES = 64 * 1024 * 1024
LANE = 128


@dataclasses.dataclass(frozen=True)
class LMMADescriptor:
    """lmma.{M}{N}{K}.{A}{W}{Acc}{O} — operand shapes and dtypes."""

    m: int
    n: int
    k: int                      # contraction length (K_total)
    a_dtype: str = "bf16"
    w_bits: int = 2
    acc_dtype: str = "f32"
    o_dtype: str = "bf16"
    k_group: int = 4
    table_bits: int = 8

    def name(self) -> str:
        return (f"lmma.m{self.m}n{self.n}k{self.k}.a{self.a_dtype}."
                f"wint{self.w_bits}.acc{self.acc_dtype}.o{self.o_dtype}")


@dataclasses.dataclass(frozen=True)
class TileSchedule:
    bm: int
    bn: int
    bg: int  # groups per K-block
    table_bytes: int
    weight_bytes: int
    acc_bytes: int
    vmem_bytes: int


_DTYPE_BYTES = {"fp16": 2, "bf16": 2, "f32": 4, "fp8": 1, "int8": 1, "int32": 4}


def _tile_bytes(bm, bn, bg, desc: LMMADescriptor) -> Tuple[int, int, int]:
    e = 1 << (desc.k_group - 1)
    planes = desc.w_bits if desc.w_bits > 0 else 2
    table = bm * bg * e * (desc.table_bits // 8 or 1)          # Eq. 7
    weights = bn * bg * planes * desc.k_group // 8              # Eq. 8 packed
    cw = bn * bg * e                                            # int8 CW
    acc = bm * bn * _DTYPE_BYTES[desc.acc_dtype]
    return table, weights + cw, acc


def _score(ts: TileSchedule, desc: LMMADescriptor) -> float:
    e = 1 << (desc.k_group - 1)
    g_total = desc.k / desc.k_group
    macs = ts.bm * ts.bn * ts.bg * e
    score = macs / (ts.table_bytes + ts.weight_bytes
                    + ts.acc_bytes / max(1, (g_total // ts.bg)))
    return score * (1.0 + 0.1 * (ts.bn / 2048))  # elongated N (§3.2.2)


def schedule_tiles(desc: LMMADescriptor) -> TileSchedule:
    """Pick (bm, bn, bg) by memory size (§3.3.2) with elongated N (§3.2.2)."""
    g_total = desc.k / desc.k_group
    best: Optional[TileSchedule] = None
    bm_cands = [m for m in (8, 16, 32, 64, 128, 256) if m <= max(desc.m, 8)]
    bn_cands = [n for n in (128, 256, 512, 1024, 2048) if n <= max(desc.n, LANE)]
    bg_cands = [g for g in (8, 16, 32, 64, 128, 256, 512) if g <= max(g_total, 8)]
    for bm in bm_cands:
        for bn in bn_cands:
            for bg in bg_cands:
                t, w, a = _tile_bytes(bm, bn, bg, desc)
                tot = 2 * (t + w) + a  # double-buffered inputs
                if tot > SCHEDULE_BYTES:
                    continue
                cand = TileSchedule(bm, bn, bg, t, w, a, tot)
                if best is None or _score(cand, desc) > _score(best, desc):
                    best = cand
    if best is None:
        t, w, a = _tile_bytes(8, LANE, 8, desc)
        best = TileSchedule(8, LANE, 8, t, w, a, 2 * (t + w) + a)
    return best


def fused_tile_bytes(bm: int, bn: int, bg: int, desc: LMMADescriptor) -> int:
    """Working set of the fused kernel for one tile: activation block and
    packed weights (double-buffered), the f32 table block and its int8
    copy, the CW expansion and the accumulator."""
    e = 1 << (desc.k_group - 1)
    planes = desc.w_bits if desc.w_bits > 0 else 2
    a_blk = bm * bg * desc.k_group * _DTYPE_BYTES[desc.a_dtype]
    ent_f32 = bm * bg * e * 4
    tbl_q = bm * bg * e * (desc.table_bits // 8 or 1)
    weights = bn * bg * planes * desc.k_group // 8
    cw = bn * bg * e
    acc = bm * bn * _DTYPE_BYTES[desc.acc_dtype]
    return 2 * (a_blk + weights) + ent_f32 + tbl_q + cw + acc


def select_fusion(desc: LMMADescriptor,
                  ts: Optional[TileSchedule] = None) -> str:
    """§3.1.1 fusion decision: 'fused' iff the fused working set of the
    tile fits one H100 thread block's shared memory, else 'staged'."""
    if ts is None:
        ts = schedule_tiles(desc)
    fits = fused_tile_bytes(ts.bm, ts.bn, ts.bg, desc) <= SMEM_BYTES
    return "fused" if fits else "staged"
