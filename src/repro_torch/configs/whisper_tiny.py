"""whisper-tiny [audio]: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
enc-dec, conv frontend stubbed [arXiv:2212.04356; unverified]:
``batch["audio_frames"]`` carries precomputed frame embeddings."""
from repro_torch.configs.registry import ArchConfig
from repro_torch.configs._defaults import LUT_W2

CONFIG = ArchConfig(
    arch_id="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab_size=51865, enc_layers=4, n_audio_frames=1500,
    max_positions=32768,  # sized for decode_32k (>> whisper's native 448)
    quant=LUT_W2, source="arXiv:2212.04356")


def reduced():
    return CONFIG.replace(n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=4, head_dim=0, d_ff=128, vocab_size=512,
                          n_audio_frames=24, max_positions=128)
