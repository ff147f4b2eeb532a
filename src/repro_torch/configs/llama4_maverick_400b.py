"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048; MoE 128 experts top-1 + 1 shared expert,
interleaved dense/MoE every other layer [hf:meta-llama/Llama-4-Maverick]."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoESpec


def full() -> LMConfig:
    return LMConfig(
        name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048,
        mlp_kind="swiglu", rope_base=5e5,
        moe=MoESpec(d_model=5120, d_ff=8192, n_experts=128, top_k=1,
                    n_shared=1, mlp_kind="swiglu"),
        moe_every=2,
        pad_heads_to=48,              # 40 -> 48 so heads shard 16-way
        lora=LoRAConfig(rank=32, alpha=512.0), head_mode="lora")


def smoke() -> LMConfig:
    return LMConfig(
        name="llama4-maverick-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        mlp_kind="swiglu",
        moe=MoESpec(d_model=64, d_ff=128, n_experts=8, top_k=1,
                    n_shared=1, mlp_kind="swiglu"),
        moe_every=2,
        lora=LoRAConfig(rank=4, alpha=64.0), head_mode="lora")
