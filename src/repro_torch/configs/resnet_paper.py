"""The paper's own models: ResNet-8 / ResNet-18 (CIFAR) with FLoCoRA,
alpha = 16·r unless given."""
from repro_torch.core.lora import LoRAConfig
from repro_torch.models.resnet import ResNetConfig


def resnet8(rank: int = 32, alpha: float = None, mode: str = "flocora",
            **kw) -> ResNetConfig:
    return ResNetConfig(arch="resnet8", mode=mode,
                        lora=LoRAConfig(rank=rank,
                                        alpha=alpha or 16.0 * rank), **kw)


def resnet18(rank: int = 32, alpha: float = None, mode: str = "flocora",
             **kw) -> ResNetConfig:
    return ResNetConfig(arch="resnet18", mode=mode,
                        lora=LoRAConfig(rank=rank,
                                        alpha=alpha or 16.0 * rank), **kw)
