"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU [arXiv:2402.16819]. head_dim = 192."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="nemotron-4-340b", n_layers=96, d_model=18432, n_heads=96,
        n_kv_heads=8, head_dim=192, d_ff=73728, vocab=256000,
        mlp_kind="sqrelu", rope_base=1e4,
        lora=LoRAConfig(rank=32, alpha=512.0), head_mode="lora")


def smoke() -> LMConfig:
    return LMConfig(
        name="nemotron-4-340b-smoke", n_layers=4, d_model=96, n_heads=6,
        n_kv_heads=2, head_dim=16, d_ff=384, vocab=512,
        mlp_kind="sqrelu", pad_heads_to=8,
        lora=LoRAConfig(rank=4, alpha=64.0), head_mode="lora")
