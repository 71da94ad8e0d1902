"""Architecture config (dense family) and the port's registry.

A copy of the reference's ``ArchConfig`` holding only the fields the dense
llama-family transformer reads. Dtypes are torch dtypes.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

import torch

FAMILIES = ("dense",)


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

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def with_quant(self, **kw) -> "ArchConfig":
        q = dict(self.quant or {})
        q.update(kw)
        return self.replace(quant=q)


_REGISTRY: Dict[str, str] = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
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
