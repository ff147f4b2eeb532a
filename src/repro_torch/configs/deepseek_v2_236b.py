"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA (kv_lora=512,
q_lora=1536, nope 128 + rope 64, v 128) d_ff=1536/expert vocab=102400;
MoE 160 routed top-6 + 2 shared [arXiv:2405.04434].

Deviation, as in the JAX package: the real model's first layer is dense;
the config stacks 60 uniform MoE layers (only the MoE is specified).
MLA is itself a low-rank factorization — FLoCoRA adapters attach to the
factor matrices (q_a/q_b/kv_a/k_b/v_b), a natural fit."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.attention import MLASpec
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoESpec


def full() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
        n_kv_heads=128, head_dim=128, d_ff=1536, vocab=102400,
        mlp_kind="swiglu", attn_kind="mla",
        mla=MLASpec(d_model=5120, n_heads=128, q_lora_rank=1536,
                    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                    v_head_dim=128),
        moe=MoESpec(d_model=5120, d_ff=1536, n_experts=160, top_k=6,
                    n_shared=2, mlp_kind="swiglu"),
        moe_every=1,
        lora=LoRAConfig(rank=32, alpha=512.0), head_mode="lora")


def smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=64, vocab=512,
        mlp_kind="swiglu", attn_kind="mla",
        mla=MLASpec(d_model=64, n_heads=4, q_lora_rank=32,
                    kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                    v_head_dim=16),
        moe=MoESpec(d_model=64, d_ff=64, n_experts=8, top_k=2,
                    n_shared=2, mlp_kind="swiglu"),
        moe_every=1,
        lora=LoRAConfig(rank=4, alpha=64.0), head_mode="lora")
