"""The paper's W2 serve config (2-bit symmetric weights on the odd grid,
K=4 groups). ``table_quant="auto"`` resolves per device
(``core.mpgemm.resolve_table_quant``): INT8 per-row tables on CUDA, float
tables on the CPU."""

LUT_W2 = {
    "weight_bits": 2,
    "scheme": "symmetric",
    "mpgemm_mode": "lut_xla",
    "table_quant": "auto",
    "k_group": 4,
}
