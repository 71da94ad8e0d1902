"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free, vocab 65024,
ssm_state=16 — mamba1 arch [arXiv:2410.05355; unverified]."""
from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import LUT_W2

CONFIG = ArchConfig(
    arch_id="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, d_ff=0, vocab_size=65024,
    ssm_state=16, d_conv=4, expand=2,  # d_inner 8192, dt_rank 256
    ssm_chunk=16,
    quant=LUT_W2, source="arXiv:2410.05355")


def reduced():
    # d_inner and dt_rank keep the full config's 8192 and 256 (``replace``
    # carries derived fields over), as the reference's reduced config does
    return CONFIG.replace(n_layers=2, d_model=64, vocab_size=256,
                          ssm_state=4, ssm_chunk=4)
