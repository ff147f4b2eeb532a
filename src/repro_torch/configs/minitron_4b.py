"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron, squared-ReLU MLP [arXiv:2407.14679]."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="minitron-4b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, head_dim=128, d_ff=9216, vocab=256000,
        mlp_kind="sqrelu", rope_base=1e4,
        pad_heads_to=32,              # 24 -> 32 so heads shard 16-way
        lora=LoRAConfig(rank=32, alpha=512.0), head_mode="lora")


def smoke() -> LMConfig:
    return LMConfig(
        name="minitron-4b-smoke", n_layers=4, d_model=96, n_heads=6,
        n_kv_heads=2, head_dim=16, d_ff=288, vocab=512,
        mlp_kind="sqrelu", pad_heads_to=8,
        lora=LoRAConfig(rank=4, alpha=64.0), head_mode="lora")
