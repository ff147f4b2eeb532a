"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global sliding window (1024), dual rope bases,
qk-norm, geglu [hf:google/gemma-3-4b-pt]."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8,
        n_kv_heads=4, head_dim=256, d_ff=10240, vocab=262144,
        mlp_kind="geglu", qk_norm=True, embed_scale=True,
        window=1024, window_pattern=6,
        rope_base=1e4, rope_base_global=1e6,
        pad_heads_to=16,              # 8 -> 16 so heads shard 16-way
        lora=LoRAConfig(rank=32, alpha=512.0), head_mode="lora")


def smoke() -> LMConfig:
    return LMConfig(
        name="gemma3-4b-smoke", n_layers=7, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=192, vocab=512,
        mlp_kind="geglu", qk_norm=True, embed_scale=True,
        window=8, window_pattern=3, rope_base=1e4, rope_base_global=1e5,
        lora=LoRAConfig(rank=4, alpha=64.0), head_mode="lora")
