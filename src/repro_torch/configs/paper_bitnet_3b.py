"""paper-bitnet-3b: BitNet b1.58 3B (paper Table 1 / §4.4 eval model) —
ternary weights, INT8-path activations, llama-ish 3B geometry: 26L
d_model=3200 32H (MHA, head_dim 100) d_ff=8640 vocab=32000
[arXiv:2402.17764]."""
from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import TERNARY

CONFIG = ArchConfig(
    arch_id="paper-bitnet-3b", family="dense",
    n_layers=26, d_model=3200, n_heads=32, n_kv_heads=32, d_ff=8640,
    vocab_size=32000,
    quant=TERNARY, source="arXiv:2402.17764 (BitNet b1.58)")


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=0, d_ff=192, vocab_size=512)
