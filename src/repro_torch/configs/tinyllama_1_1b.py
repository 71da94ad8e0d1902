"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small [arXiv:2401.02385; hf]."""
from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import LUT_W2

CONFIG = ArchConfig(
    arch_id="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab_size=32000,
    quant=LUT_W2, source="arXiv:2401.02385")


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                          head_dim=0, d_ff=192, vocab_size=512)
