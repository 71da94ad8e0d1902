"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. Vision frontend stubbed:
``batch["image_embeds"]`` carries precomputed patch embeddings."""
from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import LUT_W2

CONFIG = ArchConfig(
    arch_id="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256, rope_theta=5e5,
    xattn_every=5, n_image_tokens=1601,
    quant=LUT_W2, source="hf:meta-llama/Llama-3.2-11B-Vision")


def reduced():
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=0, d_ff=192, vocab_size=512,
                          xattn_every=2, n_image_tokens=16)
