"""Shared quant defaults: the paper's technique as configured per arch.

``LUT_W2`` is the paper's W2 serve config (2-bit symmetric weights on the
odd grid, K=4 groups). ``table_quant="auto"`` resolves per device
(``core.mpgemm.resolve_table_quant``): INT8 per-row tables on CUDA, float
tables on the CPU. ``TERNARY`` is BitNet b1.58's absmean ternary scheme,
stored as two sign planes with plane scales [1, 1]; ``DEQUANT_W2`` is the
paper's dequantization baseline."""

LUT_W2 = {
    "weight_bits": 2,
    "scheme": "symmetric",
    "mpgemm_mode": "lut_xla",
    "table_quant": "auto",
    "k_group": 4,
}

LUT_W4 = dict(LUT_W2, weight_bits=4)
LUT_W1 = dict(LUT_W2, weight_bits=1)
TERNARY = dict(LUT_W2, scheme="ternary")  # BitNet b1.58
DEQUANT_W2 = dict(LUT_W2, mpgemm_mode="dequant")  # paper's baseline
