"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks
[arXiv:2411.15242; unverified]."""
from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import LUT_W2

CONFIG = ArchConfig(
    arch_id="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab_size=32000, ssm_state=64, d_conv=4, expand=2,  # d_inner 7168
    ssm_heads=112, ssm_chunk=64, attn_every=6,
    # mamba2 in/out projections stay float: error injected into the SSM
    # recurrence compounds over sequence and over the reused shared blocks
    quant=dict(LUT_W2, skip="ssm/(in_proj|out_proj)"),
    source="arXiv:2411.15242")


def reduced():
    # d_inner keeps the full config's 7168 (``replace`` carries derived
    # fields over), as the reference's reduced config does
    return CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=0, d_ff=192, vocab_size=512, ssm_state=8,
                          ssm_heads=4, ssm_chunk=4, attn_every=2)
