"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 rope_theta=1e6, bf16 params — GQA, QKV bias
[arXiv:2407.10671; hf]."""
import torch

from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import LUT_W2

CONFIG = ArchConfig(
    arch_id="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    param_dtype=torch.bfloat16,
    quant=LUT_W2, source="arXiv:2407.10671")


def reduced():
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=0, d_ff=256, vocab_size=512,
                          param_dtype=torch.float32)
