"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024(expert)
vocab=50304, MoE 64e top-8 [arXiv:2409.02060; hf]."""
from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import LUT_W2

CONFIG = ArchConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab_size=50304, num_experts=64, top_k=8,
    # attention stays float: routing decisions sit downstream of the
    # attention outputs, and quantization jitter there flips top-k picks
    # (the experts hold ~95% of the params, so the packed-weight win stays)
    quant=dict(LUT_W2, skip="attn"), source="arXiv:2409.02060")


def reduced():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=0, d_ff=64, vocab_size=512, num_experts=8,
                          top_k=2, capacity_factor=8.0)
