"""Design-space exploration for the LUT datapath (paper §3.2.2, Fig 11/14),
costed for two targets:

  * ``mux_density(K)`` — the paper's hardware model, as in the reference: a
    mux-tree LUT unit performs K MACs per lookup per cycle; area = table
    registers (2^(K-1)·LUT_BIT) + mux tree + the accumulation adder.
    Density K/area peaks at K=4 for INT tables and K≈5 for FP16 tables
    (Fig 11; constants calibrated to those optima).

  * ``tensor_core_cost(K)`` — the port's realization on Hopper: the lookup
    runs as an [M, G·E] × [G·E, N] product on the tensor cores, so it costs
    E/K = 2^(K-1)/K MACs per original weight element, at the H100's int8
    rate (1979 TOP/s) for INT8 tables or, for float tables, F32_PASSES bf16
    passes at the bf16 rate (989 TOP/s) — the kernels split each f32 table
    value into three bf16 terms (``kernels/lut_mpgemm.py``). The
    compute-optimal K is 2 (K=1 is the bit-serial baseline; K=4 keeps the
    paper's table shape, which the kernels use).

Tile-shape DSE (Fig 14): ``tile_traffic`` scores (M, N, K) tiles by bytes
moved per MAC — elongated-N tiles win because each table entry is reused
N times (Eq. 7-8).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# -- mux-hardware constants (arbitrary gate units, calibrated to Fig 11) ----
TABLE_BIT_AREA = 0.21     # per stored table bit
MUX_BIT_AREA = 0.12       # per mux-input bit
INT_ADDER_AREA = 24.0     # INT accumulate adder
FP_ADDER_AREA = 210.0     # FP16 accumulate adder
PRECOMP_ADDER_AREA = 16.0  # per precompute adder (conventional designs only)

# -- H100 SXM dense tensor-core peaks (NVIDIA's data sheet) -----------------
INT8_OPS_S = 1979e12
BF16_OPS_S = 989e12
F32_PASSES = 3            # bf16 terms per f32 table value in the kernels


def mux_density(k: int, *, lut_bits: int = 8, fp_accum: bool = False,
                symmetrized: bool = True, fused_precompute: bool = True) -> float:
    """MACs/cycle per unit area of a mux-LUT dot-product unit."""
    entries = (1 << (k - 1)) if symmetrized else (1 << k)
    table = entries * lut_bits * TABLE_BIT_AREA
    mux = max(entries - 1, 1) * lut_bits * MUX_BIT_AREA
    adder = FP_ADDER_AREA if fp_accum else INT_ADDER_AREA
    area = table + mux + adder
    if not fused_precompute:  # conventional: per-unit precompute adders
        area += entries * PRECOMP_ADDER_AREA
    return k / area


def tensor_core_cost(k: int, *, int8_tables: bool = True,
                     w_bits: int = 2) -> Dict[str, float]:
    """Relative costs of the tensor-core lookup per original weight
    element; ``compute`` in units of one int8 tensor-core MAC."""
    e = 1 << (k - 1)
    macs_per_elem = e / k                       # CW row expansion
    slowdown = 1.0 if int8_tables else F32_PASSES * INT8_OPS_S / BF16_OPS_S
    compute = macs_per_elem * slowdown
    table_bytes_per_elem = e / k * (1 if int8_tables else 4)
    precompute_adds_per_elem = e / k            # table build, CUDA cores
    decode_fields_per_elem = w_bits / k         # unpack work per element
    return {
        "k": k,
        "compute": compute,
        "table_bytes": table_bytes_per_elem,
        "precompute": precompute_adds_per_elem,
        "decode": decode_fields_per_elem,
        # one scalar for argmin: tensor-core time dominates; the CUDA-core
        # work overlaps it and breaks ties at 1% weight
        "score": compute + 0.01 * (precompute_adds_per_elem
                                   + decode_fields_per_elem),
    }


def best_k_mux(lut_bits: int = 8, fp_accum: bool = False,
               ks: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8)) -> int:
    return max(ks, key=lambda k: mux_density(k, lut_bits=lut_bits,
                                             fp_accum=fp_accum))


def best_k_tensor_core(int8_tables: bool = True,
                       ks: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8)) -> int:
    return min(ks, key=lambda k: tensor_core_cost(
        k, int8_tables=int8_tables)["score"])


# -- tile-shape DSE (Fig 14 / Eq. 7-8) --------------------------------------

def tile_traffic(m: int, n: int, k_elems: int, *, k_group: int = 4,
                 w_bits: int = 2, lut_bits: int = 8,
                 a_bits: int = 16) -> Dict[str, float]:
    """Bytes moved per tile and per MAC for an (M, N, K) LUT tile."""
    g = k_elems // k_group
    e = 1 << (k_group - 1)
    table = m * g * e * lut_bits / 8            # Eq. 7 (table side)
    weights = n * g * k_group * w_bits / 8      # Eq. 8 (packed codes)
    acts = m * k_elems * a_bits / 8             # if the table is built here
    out = m * n * 4
    macs = m * n * k_elems
    total = table + weights + out
    return {"table": table, "weights": weights, "acts": acts, "out": out,
            "bytes_per_mac": total / macs, "macs": macs}


def sweep_tiles(area: int = 512, k_group: int = 4, w_bits: int = 2):
    """All (M, N, K) with M·N·K == area (the paper's iso-area sweep)."""
    rows: List[Dict] = []
    for m in (1, 2, 4, 8, 16, 32):
        for n in (4, 8, 16, 32, 64, 128, 256):
            if area % (m * n):
                continue
            k = area // (m * n)
            if k % k_group or k < k_group:
                continue
            r = tile_traffic(m, n, k, k_group=k_group, w_bits=w_bits)
            r.update({"m": m, "n": n, "k": k})
            rows.append(r)
    return sorted(rows, key=lambda r: r["bytes_per_mac"])
