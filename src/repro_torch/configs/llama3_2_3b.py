"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 rope_theta=5e5 — small llama3 [hf:meta-llama/Llama-3.2-3B]."""
from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import LUT_W2

CONFIG = ArchConfig(
    arch_id="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=128256, rope_theta=5e5,
    quant=LUT_W2, source="hf:meta-llama/Llama-3.2-3B")


def reduced():
    return CONFIG.replace(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                          head_dim=0, d_ff=256, vocab_size=512)
