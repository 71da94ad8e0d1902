"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936 — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import LUT_W2

CONFIG = ArchConfig(
    arch_id="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab_size=151936, qkv_bias=True,
    quant=LUT_W2, source="hf:Qwen/Qwen1.5-0.5B")


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=0, d_ff=160, vocab_size=512)
