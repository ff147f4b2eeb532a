"""seamless-m4t-medium [audio]: enc-dec, 12L each, d_model=1024 16H
(kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596]. The speech frontend is
a STUB: the model takes precomputed frame embeddings."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.encdec import EncDecConfig


def full() -> EncDecConfig:
    return EncDecConfig(
        name="seamless-m4t-medium", n_enc_layers=12, n_dec_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096,
        vocab=256206, mlp_kind="gelu",
        lora=LoRAConfig(rank=32, alpha=512.0), head_mode="lora")


def smoke() -> EncDecConfig:
    return EncDecConfig(
        name="seamless-m4t-medium-smoke", n_enc_layers=2, n_dec_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab=512, mlp_kind="gelu",
        lora=LoRAConfig(rank=4, alpha=64.0), head_mode="lora")
