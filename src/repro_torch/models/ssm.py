"""Mamba-2 (SSD) mixer: the spec the configs build.

The chunked SSD forward, the recurrent decode and their caches are
ROADMAP A9c; a config with ``mamba`` set makes the LM's functions raise
``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_inner: int              # expand * d_model
    head_dim: int = 64        # P
    d_state: int = 128        # N
    n_groups: int = 1         # G
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim
