"""Architecture config (the reference's six families) and the port's
registry.

A copy of the reference's ``ArchConfig`` holding only the fields the dense
llama-family transformer, the MoE LM, the Mamba1 LM, the Mamba2 +
shared-attention hybrid, the cross-attention VLM and the encoder-decoder
audio model read, with the reference's parameter counts for these
families. Dtypes are torch dtypes. ``ArchConfig.shapes()`` gives the
reference's four input shapes (``ShapeSpec``) with its per-family skip
rule and the hybrid family's sliding window at ``long_500k``.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any, Dict, List, Optional

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    window: Optional[int] = None   # sliding-window size for long decode
    skip: Optional[str] = None     # reason if this (arch, shape) is skipped


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    norm_eps: float = 1e-5
    # ssm (mamba1/2)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    d_inner: int = 0
    dt_rank: int = 0
    ssm_heads: int = 0
    ssm_chunk: int = 64
    # hybrid
    attn_every: int = 6
    # moe
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    # vlm
    xattn_every: int = 0
    n_image_tokens: int = 0
    # audio (encoder-decoder): n_layers = decoder layers
    enc_layers: int = 0
    n_audio_frames: int = 0
    max_positions: int = 0
    # "bf16" | "int8": anything but "int8" is the f32 cache the serving
    # engine allocates; "int8" stores int8 codes and one f32 absmax scale a
    # (position, head)
    kv_cache_dtype: str = "bf16"
    param_dtype: Any = torch.float32
    activation_dtype: Any = torch.bfloat16
    attn_chunk: int = 1024
    # {"weight_bits", "scheme", "mpgemm_mode", "table_quant", "k_group",
    #  "fusion", "skip"} or None (float weights)
    quant: Optional[dict] = None
    source: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family!r}: the port serves only "
                             f"{FAMILIES}")
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family in ("ssm", "hybrid") and not self.d_inner:
            object.__setattr__(self, "d_inner", self.expand * self.d_model)
        if self.family == "ssm" and not self.dt_rank:
            object.__setattr__(self, "dt_rank", math.ceil(self.d_model / 16))
        if self.family == "hybrid" and not self.ssm_heads:
            object.__setattr__(self, "ssm_heads", max(1, self.d_inner // 64))
        if self.family == "vlm" and not (self.xattn_every > 0
                                         and self.n_image_tokens > 0):
            raise ValueError(f"{self.arch_id}: a vlm config needs "
                             "xattn_every > 0 and n_image_tokens > 0")
        if self.family == "audio" and not (self.enc_layers > 0
                                           and self.n_audio_frames > 0
                                           and self.max_positions > 0):
            raise ValueError(f"{self.arch_id}: an audio config needs "
                             "enc_layers, n_audio_frames and max_positions "
                             "> 0")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def with_quant(self, **kw) -> "ArchConfig":
        q = dict(self.quant or {})
        q.update(kw)
        return self.replace(quant=q)

    def shapes(self) -> List[ShapeSpec]:
        """The four input shapes. ``long_500k`` decodes at 524288
        positions: the hybrid family's shared attention through an
        8192-token rolling window (``kvcache.attn_cache(window=)``), the
        SSM family with O(1) state, every full-attention family skipped."""
        sub_quadratic = self.family in ("ssm", "hybrid")
        long_skip = (None if sub_quadratic else
                     "full-attention arch: 500k decode needs sub-quadratic "
                     "attention (DESIGN.md §5)")
        return [
            ShapeSpec("train_4k", 4096, 256, "train"),
            ShapeSpec("prefill_32k", 32768, 32, "prefill"),
            ShapeSpec("decode_32k", 32768, 128, "decode"),
            ShapeSpec("long_500k", 524288, 1, "decode",
                      window=(8192 if self.family == "hybrid" else None),
                      skip=long_skip),
        ]

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes():
            if s.name == name:
                return s
        raise KeyError(name)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2

    def num_params(self) -> int:
        """Total parameter count, as the reference counts it (embedding
        and head, attention, MLP and SSM weights, whisper's learned
        positions; norms, gates and most biases left out)."""
        d, l = self.d_model, self.n_layers
        n = 2 * self.vocab_size * d
        attn = self._attn_params()
        if self.family in ("dense", "vlm"):
            # vlm: (L - G) self layers and G cross layers, each attention
            # and a gated MLP
            return n + l * (attn + 3 * d * self.d_ff)
        if self.family == "audio":
            return (n + self.enc_layers * (attn + 2 * d * self.d_ff)
                    + l * (2 * attn + 2 * d * self.d_ff)
                    + self.max_positions * d)
        di, ds = self.d_inner, self.ssm_state
        if self.family == "ssm":
            per = (d * 2 * di + di * (self.dt_rank + 2 * ds)
                   + self.dt_rank * di + di * ds + 2 * di + di * d)
            return n + l * per
        if self.family == "hybrid":
            per = d * (2 * di + 2 * ds + self.ssm_heads) + di * d + 2 * di
            return n + l * per + attn + 3 * d * self.d_ff
        nd = self.first_dense_layers
        n += nd * (attn + 3 * d * (self.dense_d_ff or self.d_ff))
        per = attn + self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        per += self.n_shared_experts * 3 * d * self.d_ff
        return n + (l - nd) * per

    def active_params(self) -> int:
        """Parameters a token activates (MoE: its top-k and the shared
        experts only), as the reference counts them."""
        if self.family != "moe":
            return self.num_params()
        d, l, nd = self.d_model, self.n_layers, self.first_dense_layers
        attn = self._attn_params()
        n = 2 * self.vocab_size * d
        n += nd * (attn + 3 * d * (self.dense_d_ff or self.d_ff))
        per = attn + (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff
        return n + (l - nd) * per


_REGISTRY: Dict[str, str] = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "paper-bitnet-3b": "repro_torch.configs.paper_bitnet_3b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama3_2_vision_11b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}


def _module_for(arch_id: str):
    try:
        return importlib.import_module(_REGISTRY[arch_id])
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; the port knows: "
                         f"{', '.join(_REGISTRY)}") from None


def get_config(arch_id: str) -> ArchConfig:
    return _module_for(arch_id).CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _module_for(arch_id).reduced()


def list_archs():
    return list(_REGISTRY)
