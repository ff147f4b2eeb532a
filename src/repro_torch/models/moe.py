"""Mixture-of-Experts layer: the spec the configs build.

The JAX package's sort-based static-capacity dispatch (``moe_init``,
``moe_apply``) is ROADMAP A9b; a config with ``moe`` set makes the LM's
functions raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0         # shared experts (fused into one wide MLP)
    capacity_factor: float = 1.25
    mlp_kind: str = "swiglu"
    # dispatch token-chunking: bounds the (E, C, d) dispatch buffer
    max_chunk_tokens: int = 65536
