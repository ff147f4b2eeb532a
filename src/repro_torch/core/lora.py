"""LoRA adapters for convolution and dense layers (FLoCoRA core).

Conv (Huh et al. TMLR'22, the decomposition the paper adopts): frozen
``P`` (HWIO); adapter = conv with ``B`` (kh, kw, c_in, r) (Gaussian)
followed by a 1x1 conv ``A`` (1, 1, r, c_out) (zeros), the stride and
padding on B, stride 1 on A. Kernels are stored HWIO and activations are
NHWC at the public functions, as in the JAX package, so the parameter
trees and the wire match it; the ``*_nchw`` forms permute the kernels
to OIHW and run PyTorch's NCHW convolutions.

Dense (Hu et al. '21): ``a`` (d_in, r) Gaussian, ``b`` (r, d_out) zeros.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 32
    alpha: float = 512.0          # paper: alpha = 16*r for from-scratch
    dtype: torch.dtype = torch.float32

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _normal(gen: torch.Generator, shape: tuple, std: float,
            dtype: torch.dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32) * std
    return x.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Convolutions with XLA's padding rule
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA "SAME": out = ceil(size/stride); the total pad splits with the
    smaller half FIRST, so a 3x3 stride-2 conv on an even input pads
    (0, 1), not PyTorch's symmetric (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nchw(x: torch.Tensor, w_hwio: torch.Tensor, stride: int,
                padding: str = "SAME") -> torch.Tensor:
    """x (N, C, H, W), kernel HWIO -> (N, O, H', W')."""
    kh, kw = int(w_hwio.shape[0]), int(w_hwio.shape[1])
    if padding == "SAME":
        ph = _same_pads(int(x.shape[2]), kh, stride)
        pw = _same_pads(int(x.shape[3]), kw, stride)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID': {padding!r}")
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1).to(x.dtype),
                    stride=stride)


def conv_lora_init(gen: torch.Generator, kh: int, kw: int, c_in: int,
                   c_out: int, cfg: LoRAConfig, device="cpu") -> dict:
    """b: (kh, kw, c_in, r) ~ N(0, 2/fan_in); a: (1, 1, r, c_out) zeros."""
    fan_in = kh * kw * c_in
    b_k = _normal(gen, (kh, kw, c_in, cfg.rank), (2.0 / fan_in) ** 0.5,
                  cfg.dtype, device)
    a_k = torch.zeros((1, 1, cfg.rank, c_out), dtype=cfg.dtype,
                      device=device)
    return {"b": b_k, "a": a_k}


def conv_lora_apply_nchw(x: torch.Tensor, b_k: torch.Tensor,
                         a_k: torch.Tensor, scale: float, stride: int,
                         padding: str = "SAME") -> torch.Tensor:
    """(α/r) · conv1x1(conv(x, B), A) on NCHW activations."""
    h = conv2d_nchw(x, b_k, stride, padding)
    return scale * conv2d_nchw(h, a_k, 1, "VALID")


def conv_lora_apply(x: torch.Tensor, b_k: torch.Tensor, a_k: torch.Tensor,
                    scale: float, stride: tuple[int, int],
                    padding: str = "SAME") -> torch.Tensor:
    """The JAX package's signature: NHWC in and out, ``stride`` a pair
    of equal ints."""
    if stride[0] != stride[1]:
        raise NotImplementedError("unequal strides are not ported")
    y = conv_lora_apply_nchw(x.permute(0, 3, 1, 2), b_k, a_k, scale,
                             stride[0], padding)
    return y.permute(0, 2, 3, 1)


def dense_lora_init(gen: torch.Generator, d_in: int, d_out: int,
                    cfg: LoRAConfig, device="cpu") -> dict:
    """a: (d_in, r) ~ N(0, 1/d_in); b: (r, d_out) = 0."""
    a = _normal(gen, (d_in, cfg.rank), d_in ** -0.5, cfg.dtype, device)
    b = torch.zeros((cfg.rank, d_out), dtype=cfg.dtype, device=device)
    return {"a": a, "b": b}


def dense_lora_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     scale: float,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """(α/r)·(x@a)@b — the low-rank side chain only, computed in
    ``compute_dtype`` as the JAX package does."""
    h = torch.einsum("...i,ir->...r", x.to(compute_dtype),
                     a.to(compute_dtype))
    y = torch.einsum("...r,ro->...o", h, b.to(compute_dtype))
    return (scale * y.to(torch.float32)).to(x.dtype)


def dense_merge(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                scale: float) -> torch.Tensor:
    """W + (α/r)·a@b — serving-time merge (no added latency, paper
    §II-C)."""
    return (w.to(torch.float32)
            + (scale * a.to(torch.float32)) @ b.to(torch.float32)
            ).to(w.dtype)


# ---------------------------------------------------------------------------
# Shape-only adapter detection (message rank for the wire header)
# ---------------------------------------------------------------------------

def adapter_kind(a, b) -> Optional[str]:
    """'conv' | 'dense' | None from the two factors' shapes alone."""
    ash, bsh = tuple(a.shape), tuple(b.shape)
    if (len(ash) == 4 and len(bsh) == 4 and ash[0] == ash[1] == 1
            and ash[2] == bsh[3]):
        return "conv"
    if (len(ash) >= 2 and len(bsh) >= 2 and ash[-1] == bsh[-2]
            and ash[:-2] == bsh[:-2]):
        return "dense"
    return None


def is_adapter_pair(node: Any) -> bool:
    """True for a dict {'a','b'} whose factors form a LoRA pair."""
    if not (isinstance(node, dict) and set(node) >= {"a", "b"}):
        return False
    a, b = node["a"], node["b"]
    if not (hasattr(a, "shape") and hasattr(b, "shape")):
        return False
    return adapter_kind(a, b) is not None


def adapter_rank(node: dict) -> int:
    """Rank of a LoRA pair (the contracted low-rank dimension)."""
    kind = adapter_kind(node["a"], node["b"])
    if kind == "conv":
        return int(node["a"].shape[2])
    if kind == "dense":
        return int(node["a"].shape[-1])
    raise ValueError("not a LoRA adapter pair: "
                     f"a{tuple(node['a'].shape)} b{tuple(node['b'].shape)}")


def _walk_pairs(tree: Any, fn):
    """Rebuild ``tree``, applying ``fn(pair_dict)`` to every adapter
    pair, in dict insertion order. Anything that is not a dict, list or
    tuple is a leaf, wire-form leaves (``PackedLeaf``) included."""
    if isinstance(tree, dict):
        if is_adapter_pair(tree):
            return fn(tree)
        return {k: _walk_pairs(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_walk_pairs(v, fn) for v in tree]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return tree


def tree_ranks(tree: Any) -> tuple[int, ...]:
    """Sorted distinct adapter ranks found in a (fp or flat packed)
    tree. A flat message walks through its shape-only view."""
    if hasattr(tree, "shape_tree"):          # FlatPackedMessage
        tree = tree.shape_tree()
    found: set[int] = set()

    def rec(node):
        if isinstance(node, dict):
            if is_adapter_pair(node):
                found.add(adapter_rank(node))
                return
            for v in node.values():
                rec(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v)

    rec(tree)
    return tuple(sorted(found))


def tree_max_rank(tree: Any) -> Optional[int]:
    """Max adapter rank in the tree, or None if it holds no adapters."""
    rs = tree_ranks(tree)
    return rs[-1] if rs else None
