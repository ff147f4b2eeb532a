"""mamba2-370m [ssm]: 48L d_model=1024, attn-free, d_inner=2048,
headdim=64 (32 SSM heads), ssm_state=128, vocab=50280 — SSD
[arXiv:2405.21060]."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.lm import LMConfig
from repro_torch.models.ssm import MambaSpec


def full() -> LMConfig:
    return LMConfig(
        name="mamba2-370m", n_layers=48, d_model=1024, n_heads=32,
        n_kv_heads=32, head_dim=32, d_ff=0, vocab=50280,
        attn_kind="none",
        mamba=MambaSpec(d_model=1024, d_inner=2048, head_dim=64,
                        d_state=128, n_groups=1, conv_kernel=4, chunk=256),
        lora=LoRAConfig(rank=32, alpha=512.0), head_mode="lora")


def smoke() -> LMConfig:
    return LMConfig(
        name="mamba2-370m-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=0, vocab=512,
        attn_kind="none",
        mamba=MambaSpec(d_model=64, d_inner=128, head_dim=16, d_state=16,
                        n_groups=1, conv_kernel=4, chunk=16),
        lora=LoRAConfig(rank=4, alpha=64.0), head_mode="lora")
