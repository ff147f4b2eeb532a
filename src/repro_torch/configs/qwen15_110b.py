"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="qwen1.5-110b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, head_dim=128, d_ff=49152, vocab=152064,
        mlp_kind="swiglu", qkv_bias=True, rope_base=1e6,
        lora=LoRAConfig(rank=32, alpha=512.0), head_mode="lora")


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen1.5-110b-smoke", n_layers=4, d_model=128, n_heads=8,
        n_kv_heads=2, head_dim=16, d_ff=384, vocab=512,
        mlp_kind="swiglu", qkv_bias=True,
        lora=LoRAConfig(rank=4, alpha=64.0), head_mode="lora")
