"""Model API for the dense family: param init (float or packed serving
weights), forward and cache init."""

from __future__ import annotations

import torch

from repro_torch.configs.registry import ArchConfig
from repro_torch.models import layers as L, quantized, transformer


def resolve_device(name) -> torch.device:
    """The device to run on: a CUDA device must exist; only an explicit
    "cpu" runs on the CPU (the kernels' plain versions), never a silent
    fall back."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but no CUDA device is "
            "available; pass device='cpu' (--device cpu) to run the "
            "kernels' plain versions")
    return device


def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda", *,
                serve_quantized: bool = True):
    """Random params from ``gen``, made on ``device`` (the card unless the
    caller asks for the CPU). With serve_quantized and a quant config,
    projections are packed per cfg.quant layer by layer, so full-width
    float weights never all exist at once."""
    device = resolve_device(device)
    dtype = cfg.param_dtype
    pack = serve_quantized and cfg.quant

    def finish(tree):
        return quantized.quantize_params(tree, cfg.quant) if pack else tree

    return {
        "embed": transformer.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, device),
        "layers": [finish(transformer.block_init(gen, cfg, dtype, device))
                   for _ in range(cfg.n_layers)],
        "final_norm": L.norm_init(cfg.d_model, dtype, device),
        "lm_head": finish({"lm_head": L.dense_init(
            gen, cfg.d_model, cfg.vocab_size, dtype=dtype,
            device=device)})["lm_head"],
    }


def forward(params, batch, cfg: ArchConfig, **kw):
    return transformer.forward(params, batch, cfg, **kw)


def init_cache(cfg: ArchConfig, batch: int, s_cache: int,
               dtype=torch.bfloat16, device="cuda"):
    return transformer.init_cache(cfg, batch, s_cache, dtype,
                                  resolve_device(device))
