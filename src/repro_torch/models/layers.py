"""Layers of the ported models (functional, parameter dicts)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def groupnorm_init(c: int, device="cpu") -> dict:
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def groupnorm_nchw(p: dict, x: torch.Tensor, groups: int = 32,
                   eps: float = 1e-5) -> torch.Tensor:
    """x: (N, C, H, W). Contiguous channel groups, biased variance."""
    g = min(groups, int(x.shape[1]))
    y = F.group_norm(x.to(torch.float32), g, p["scale"], p["bias"], eps)
    return y.to(x.dtype)


def groupnorm_apply(p: dict, x: torch.Tensor, groups: int = 32,
                    eps: float = 1e-5) -> torch.Tensor:
    """x: (N, H, W, C). GroupNorm over (H, W, C//G), as the JAX
    package's ``groupnorm_apply``."""
    y = groupnorm_nchw(p, x.permute(0, 3, 1, 2), groups, eps)
    return y.permute(0, 2, 3, 1)
