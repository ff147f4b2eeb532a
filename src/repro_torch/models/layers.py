"""Layers of the ported models (functional, parameter dicts)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils.device import resolve_device


def groupnorm_init(c: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {"scale": torch.ones((c,), dtype=torch.float32, device=dev),
            "bias": torch.zeros((c,), dtype=torch.float32, device=dev)}


def groupnorm_nchw(p: dict, x: torch.Tensor, groups: int = 32,
                   eps: float = 1e-5) -> torch.Tensor:
    """x: (N, C, H, W). Contiguous channel groups, biased variance. The
    input is made contiguous first: a channels-last input (a convolution
    of NHWC images gives one) makes ``group_norm`` clone it in that
    format, which ``torch.func.vmap`` refuses."""
    g = min(groups, int(x.shape[1]))
    y = F.group_norm(x.to(torch.float32).contiguous(), g, p["scale"],
                     p["bias"], eps)
    return y.to(x.dtype)


def groupnorm_apply(p: dict, x: torch.Tensor, groups: int = 32,
                    eps: float = 1e-5) -> torch.Tensor:
    """x: (N, H, W, C). GroupNorm over (H, W, C//G), as the JAX
    package's ``groupnorm_apply``."""
    y = groupnorm_nchw(p, x.permute(0, 3, 1, 2), groups, eps)
    return y.permute(0, 2, 3, 1)
