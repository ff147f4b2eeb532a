"""Encoder-decoder transformer (seamless-m4t-medium backbone): the
config the registry builds.

The encoder, the decoder with its self and cross caches, and the loss
are ROADMAP A9d; given this config, the LM's functions raise
``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.lora import LoRAConfig
from repro_torch.models.attention import GQASpec


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    mlp_kind: str = "gelu"
    rope_base: float = 1e4
    lora: LoRAConfig = LoRAConfig()
    head_mode: str = "lora"
    remat: bool = True
    kv_chunk: int = 1024
    xent_chunk: int = 512

    @property
    def gqa(self) -> GQASpec:
        return GQASpec(self.d_model, self.n_heads, self.n_kv_heads,
                       self.head_dim)
