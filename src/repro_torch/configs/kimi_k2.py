"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert)
vocab=163840, MoE 384e top-8, 1 shared expert, first layer dense —
trillion-param MoE [Kimi K2 tech report; unverified]."""
import torch

from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import LUT_W2

CONFIG = ArchConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, num_experts=384, top_k=8, n_shared_experts=1,
    first_dense_layers=1, dense_d_ff=18432, rope_theta=5e4,
    capacity_factor=1.0,
    param_dtype=torch.bfloat16,  # 1T params: bf16
    quant=LUT_W2, source="arXiv:2501 (Kimi K2 tech report)")


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=0, d_ff=64, vocab_size=512, num_experts=8,
                          top_k=2, capacity_factor=8.0, dense_d_ff=128,
                          first_dense_layers=1, param_dtype=torch.float32)
