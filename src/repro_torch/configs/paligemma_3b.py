"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP frontend STUBBED (precomputed patch embeddings,
256 tokens); prefix-LM mask over the image prefix [arXiv:2407.07726]."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.lm import LMConfig

N_PATCHES = 256


def full() -> LMConfig:
    return LMConfig(
        name="paligemma-3b", n_layers=18, d_model=2048, n_heads=8,
        n_kv_heads=1, head_dim=256, d_ff=16384, vocab=257216,
        mlp_kind="geglu", embed_scale=True,
        prefix_lm=True, prefix_len=N_PATCHES,
        pad_heads_to=16,
        lora=LoRAConfig(rank=32, alpha=512.0), head_mode="lora")


def smoke() -> LMConfig:
    return LMConfig(
        name="paligemma-3b-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=192, vocab=512,
        mlp_kind="geglu", embed_scale=True, prefix_lm=True, prefix_len=8,
        lora=LoRAConfig(rank=4, alpha=64.0), head_mode="lora")
