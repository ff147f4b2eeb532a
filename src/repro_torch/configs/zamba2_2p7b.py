"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560 (d_inner=5120,
headdim=64, ssm_state=64) + ONE shared GQA attention block (32H kv=32,
head_dim 80) invoked every 6 layers with per-invocation LoRA adapters —
the Zamba2 trick IS the paper's adapter mechanism [arXiv:2411.15242]."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.lm import LMConfig
from repro_torch.models.ssm import MambaSpec


def full() -> LMConfig:
    return LMConfig(
        name="zamba2-2.7b", n_layers=54, d_model=2560, n_heads=32,
        n_kv_heads=32, head_dim=80, d_ff=10240, vocab=32000,
        mlp_kind="gelu",
        mamba=MambaSpec(d_model=2560, d_inner=5120, head_dim=64,
                        d_state=64, n_groups=1, conv_kernel=4, chunk=256),
        shared_attn_every=6,
        lora=LoRAConfig(rank=32, alpha=512.0), head_mode="lora")


def smoke() -> LMConfig:
    return LMConfig(
        name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, mlp_kind="gelu",
        mamba=MambaSpec(d_model=64, d_inner=128, head_dim=16, d_state=16,
                        n_groups=1, conv_kernel=4, chunk=16),
        shared_attn_every=2,
        lora=LoRAConfig(rank=4, alpha=64.0), head_mode="lora")
