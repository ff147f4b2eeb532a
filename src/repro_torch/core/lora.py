"""LoRA adapters for convolution and dense layers (FLoCoRA core).

Conv (Huh et al. TMLR'22, the decomposition the paper adopts): frozen
``P`` (HWIO); adapter = conv with ``B`` (kh, kw, c_in, r) (Gaussian)
followed by a 1x1 conv ``A`` (1, 1, r, c_out) (zeros), the stride and
padding on B, stride 1 on A. Kernels are stored HWIO and activations are
NHWC at the public functions, as in the JAX package, so the parameter
trees and the wire match it; the ``*_nchw`` forms permute the kernels
to OIHW and run PyTorch's NCHW convolutions.

Dense (Hu et al. '21): ``a`` (d_in, r) Gaussian, ``b`` (r, d_out) zeros;
``linear_init`` / ``linear_apply`` / ``frozen_weight`` are the
mixed-mode linear ('lora', 'dense' or 'frozen') built on them.

The rank utilities (``pad_adapter``, ``slice_adapter``,
``truncate_adapter``, ``resize_tree_rank``, ``svd_energy_rank``) resize
adapters for heterogeneous-rank fleets, shape-only on the pair dicts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 32
    alpha: float = 512.0          # paper: alpha = 16*r for from-scratch
    dtype: torch.dtype = torch.float32

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


# leaves of more values than this draw slice by slice along their leading
# axes, so the fp32 transient stays near 4 GB (a stacked expert bank of
# deepseek-v2-236b is 5.0e9 values: 20 GB in fp32 for a 10 GB bf16 leaf)
_DRAW_WHOLE = 1 << 30


def _normal(gen: torch.Generator, shape: tuple, std: float,
            dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, std²) drawn in fp32 on the generator's device (a CUDA
    generator draws a full-width model on the card), then moved to
    ``device`` in ``dtype``. A leaf of more than ``_DRAW_WHOLE`` values
    is drawn one slice of its last two axes at a time, in order. On the
    ``meta`` device nothing is drawn: the tensor has the shape and dtype
    only."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if math.prod(shape) <= _DRAW_WHOLE or len(shape) < 3:
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std
        return x.to(device=device, dtype=dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for sl in out.view(-1, *shape[-2:]):
        sl.copy_(torch.randn(shape[-2:], generator=gen, dtype=torch.float32,
                             device=gen.device) * std)
    return out


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


def _pair(stride) -> tuple[int, int]:
    if isinstance(stride, int):
        return stride, stride
    sh, sw = stride
    return int(sh), int(sw)


def conv2d_nchw(x: torch.Tensor, w_hwio: torch.Tensor, stride,
                padding="SAME") -> torch.Tensor:
    """x (N, C, H, W), kernel HWIO -> (N, O, H', W'). ``stride`` is an
    int or an (sh, sw) pair; ``padding`` is ``"SAME"`` (XLA's split, per
    axis), ``"VALID"`` or explicit ``((lo, hi), (lo, hi))`` pairs, as
    ``lax.conv_general_dilated`` takes them."""
    kh, kw = int(w_hwio.shape[0]), int(w_hwio.shape[1])
    sh, sw = _pair(stride)
    if padding == "SAME":
        ph = _same_pads(int(x.shape[-2]), kh, sh)
        pw = _same_pads(int(x.shape[-1]), kw, sw)
    elif padding == "VALID":
        ph = pw = (0, 0)
    elif isinstance(padding, str):
        raise ValueError(f"padding must be 'SAME', 'VALID' or pairs: "
                         f"{padding!r}")
    else:
        ph, pw = (tuple(int(p) for p in pair) for pair in padding)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1).to(x.dtype),
                    stride=(sh, sw))


def conv_lora_init(gen: torch.Generator, kh: int, kw: int, c_in: int,
                   c_out: int, cfg: LoRAConfig, device="cuda") -> dict:
    """b: (kh, kw, c_in, r) ~ N(0, 2/fan_in); a: (1, 1, r, c_out) zeros."""
    device = resolve_device(device)
    fan_in = kh * kw * c_in
    b_k = _normal(gen, (kh, kw, c_in, cfg.rank), (2.0 / fan_in) ** 0.5,
                  cfg.dtype, device)
    a_k = torch.zeros((1, 1, cfg.rank, c_out), dtype=cfg.dtype,
                      device=device)
    return {"b": b_k, "a": a_k}


def conv_lora_apply_nchw(x: torch.Tensor, b_k: torch.Tensor,
                         a_k: torch.Tensor, scale: float, stride,
                         padding="SAME") -> torch.Tensor:
    """(α/r) · conv1x1(conv(x, B), A) on NCHW activations."""
    h = conv2d_nchw(x, b_k, stride, padding)
    return scale * conv2d_nchw(h, a_k, 1, "VALID")


def conv_lora_apply(x: torch.Tensor, b_k: torch.Tensor, a_k: torch.Tensor,
                    scale: float, stride, padding="SAME") -> torch.Tensor:
    """The JAX package's signature: NHWC in and out; ``stride`` and
    ``padding`` as ``conv2d_nchw`` takes them."""
    y = conv_lora_apply_nchw(x.permute(0, 3, 1, 2), b_k, a_k, scale,
                             stride, padding)
    return y.permute(0, 2, 3, 1)


def conv_merge(p: torch.Tensor, b_k: torch.Tensor, a_k: torch.Tensor,
               scale: float) -> torch.Tensor:
    """Fold the adapter back into the base kernel:
    P[h,w,i,o] + (α/r) · Σ_r B[h,w,i,r]·A[0,0,r,o], in fp32."""
    delta = torch.einsum("hwir,ro->hwio", b_k.to(torch.float32),
                         a_k[0, 0].to(torch.float32))
    return (p.to(torch.float32) + scale * delta).to(p.dtype)


def dense_lora_init(gen: torch.Generator, d_in: int, d_out: int,
                    cfg: LoRAConfig, device="cuda",
                    stack: tuple[int, ...] = ()) -> dict:
    """a: (*stack, d_in, r) ~ N(0, 1/d_in); b: (*stack, r, d_out) = 0."""
    device = resolve_device(device)
    a = _normal(gen, (*stack, d_in, cfg.rank), d_in ** -0.5, cfg.dtype,
                device)
    b = torch.zeros((*stack, cfg.rank, d_out), dtype=cfg.dtype,
                    device=device)
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
# Mixed-mode linear (the async engine's and the fleet's model)
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, d_in: int, d_out: int, mode: str,
                cfg: Optional[LoRAConfig] = None,
                stack: tuple[int, ...] = (),
                base_dtype: torch.dtype = torch.bfloat16,
                w_init_scale: Optional[float] = None,
                device="cuda") -> tuple[dict, dict]:
    """(frozen, trainable) param dicts for one (stacked) linear:
    mode='lora' -> frozen {'w'}, trainable {'a', 'b'}; 'dense' ->
    frozen {}, trainable {'w'} (fp32); 'frozen' -> frozen {'w'},
    trainable {}. ``w`` ~ N(0, w_init_scale² or 1/d_in), drawn from
    ``gen`` before the adapter."""
    device = resolve_device(device)
    std = w_init_scale if w_init_scale is not None else d_in ** -0.5
    w = _normal(gen, (*stack, d_in, d_out), std, base_dtype, device)
    if mode == "lora":
        if cfg is None:
            raise ValueError("mode='lora' needs a LoRAConfig")
        return {"w": w}, dense_lora_init(gen, d_in, d_out, cfg, device,
                                         stack)
    if mode == "dense":
        return {}, {"w": w.to(torch.float32)}
    if mode == "frozen":
        return {"w": w}, {}
    raise ValueError(f"unknown linear mode: {mode}")


def linear_logical(d_in_name: Optional[str], d_out_name: Optional[str],
                   mode: str, stack: bool = False) -> tuple[dict, dict]:
    """Logical-axis annotations matching :func:`linear_init`'s (frozen,
    trainable) trees (``utils/sharding.py``); ``stack`` prepends the
    ``layers`` axis of a stacked linear."""
    pre = ("layers",) if stack else ()
    if mode == "lora":
        return ({"w": (*pre, d_in_name, d_out_name)},
                {"a": (*pre, d_in_name, "lora_rank"),
                 "b": (*pre, "lora_rank", d_out_name)})
    if mode == "dense":
        return {}, {"w": (*pre, d_in_name, d_out_name)}
    if mode == "frozen":
        return {"w": (*pre, d_in_name, d_out_name)}, {}
    raise ValueError(f"unknown linear mode: {mode}")


def frozen_weight(frozen: dict,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    """A frozen linear's weight in ``compute_dtype``; an int8 base
    ({'w_q8', 'w_s'}: per-output-channel scales) is dequantized."""
    if "w_q8" in frozen:
        return (frozen["w_q8"].to(compute_dtype)
                * frozen["w_s"].to(compute_dtype)[..., None, :])
    return frozen["w"].to(compute_dtype)


def quantize_frozen_tree(frozen: Any) -> Any:
    """Replace every frozen linear {'w': (..., in, out)} with a symmetric
    per-output-channel int8 pack {'w_q8', 'w_s'}, as the JAX package's
    ``quantize_frozen_tree``: ``s = max(amax over in, 1e-8) / 127``,
    levels ``clip(round(w / s), -127, 127)`` (round half to even) and
    ``w_s`` fp16 of shape (stack..., out). The base is random and never
    updated, so the static int8 pack halves its bytes against bf16.
    Works on ``meta`` tensors (shapes only)."""
    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.ndim >= 2:
                w = w.to(torch.float32)
                s = torch.clamp(w.abs().amax(dim=-2), min=1e-8) / 127.0
                q = torch.clamp(torch.round(w / s[..., None, :]), -127,
                                127).to(torch.int8)
                rest = {k: walk(v) for k, v in node.items() if k != "w"}
                return {"w_q8": q, "w_s": s.to(torch.float16), **rest}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(frozen)


def quantize_frozen_logical(logical) -> dict:
    """The logical-annotation tree of :func:`quantize_frozen_tree`'s
    output: a linear's ``w`` annotation goes to ``w_q8`` as it is, and
    ``w_s`` (stack..., out) keeps its stack and output axes."""
    def walk(node):
        if isinstance(node, dict):
            if "w" in node and isinstance(node["w"], tuple):
                ann = node["w"]
                rest = {k: v for k, v in node.items() if k != "w"}
                return {"w_q8": ann, "w_s": (*ann[:-2], ann[-1]),
                        **{k: walk(v) for k, v in rest.items()}}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(logical)


def linear_apply(frozen: dict, trainable: dict, x: torch.Tensor,
                 scale: float = 1.0,
                 compute_dtype: torch.dtype = torch.bfloat16
                 ) -> torch.Tensor:
    """Apply a mixed-mode linear: x (..., d_in) -> (..., d_out) in
    ``compute_dtype``, plus the LoRA side chain where the trainable
    dict holds one."""
    if "w" in trainable:                       # dense-trained
        w = trainable["w"].to(compute_dtype)
    else:
        w = frozen_weight(frozen, compute_dtype)
    y = torch.einsum("...i,io->...o", x.to(compute_dtype), w)
    if "a" in trainable:                       # LoRA side chain
        y = y + dense_lora_apply(x, trainable["a"], trainable["b"], scale,
                                 compute_dtype).to(y.dtype)
    return y


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


# ---------------------------------------------------------------------------
# Rank resizing (heterogeneous-rank fleets)
# ---------------------------------------------------------------------------

def _dense_factors(pair: dict) -> tuple[torch.Tensor, torch.Tensor, str]:
    """(down, up, kind) in matrix orientation: down (..., m, r), up
    (..., r, n). Conv factors reshape to 2-D: ``b`` (kh, kw, cin, r) is
    the down factor, ``a`` (1, 1, r, cout) the up factor."""
    kind = adapter_kind(pair["a"], pair["b"])
    if kind == "dense":
        return pair["a"], pair["b"], kind
    b, a = pair["b"], pair["a"]
    kh, kw, cin, r = b.shape
    return b.reshape(kh * kw * cin, r), a.reshape(r, a.shape[3]), kind


def _rebuild_pair(down: torch.Tensor, up: torch.Tensor, kind: str,
                  like: dict) -> dict:
    if kind == "dense":
        return {**like, "a": down.to(like["a"].dtype),
                "b": up.to(like["b"].dtype)}
    kh, kw, cin, _ = like["b"].shape
    r = down.shape[-1]
    return {**like,
            "b": down.reshape(kh, kw, cin, r).to(like["b"].dtype),
            "a": up.reshape(1, 1, r, up.shape[-1]).to(like["a"].dtype)}


def pad_adapter(pair: dict, r_target: int) -> dict:
    """Zero-pad both factors' rank dims up to ``r_target``. Exact: the
    padded components add 0 to the product."""
    down, up, kind = _dense_factors(pair)
    r = down.shape[-1]
    if r > r_target:
        raise ValueError(f"pad_adapter: rank {r} > target {r_target}")
    if r == r_target:
        return pair
    return _rebuild_pair(F.pad(down, (0, r_target - r)),
                         F.pad(up, (0, 0, 0, r_target - r)), kind, pair)


def slice_adapter(pair: dict, r_target: int) -> dict:
    """Keep the leading ``r_target`` rank components (HetLoRA-style
    truncation). After an SVD recombination the components are ordered
    by singular value; slicing also inverts ``pad_adapter`` exactly."""
    down, up, kind = _dense_factors(pair)
    if down.shape[-1] < r_target:
        raise ValueError(f"slice_adapter: rank {down.shape[-1]} < target "
                         f"{r_target}")
    return _rebuild_pair(down[..., :r_target], up[..., :r_target, :], kind,
                         pair)


def truncate_adapter(a: torch.Tensor, b: torch.Tensor, r_target: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """SVD re-projection: the best rank-``r_target`` factorization of the
    product ``a @ b`` (dense orientation, leading dims batched), as
    balanced factors a' = U·√S, b' = √S·Vᵀ with rank dims exactly
    ``r_target`` (zero-padded past the product's own rank). Factors may
    differ from the JAX package's in sign and, at equal singular values,
    in order; their product does not."""
    m = a.to(torch.float32) @ b.to(torch.float32)
    u, s, vh = torch.linalg.svd(m, full_matrices=False)
    k = min(r_target, s.shape[-1])
    root = torch.sqrt(s[..., :k])
    a_t = u[..., :, :k] * root[..., None, :]
    b_t = root[..., :, None] * vh[..., :k, :]
    if k < r_target:
        a_t = F.pad(a_t, (0, r_target - k))
        b_t = F.pad(b_t, (0, 0, 0, r_target - k))
    return a_t.to(a.dtype), b_t.to(b.dtype)


def svd_adapter(pair: dict, r_target: int) -> dict:
    """``truncate_adapter`` applied to a pair dict (conv handled)."""
    down, up, kind = _dense_factors(pair)
    d_t, u_t = truncate_adapter(down, up, r_target)
    return _rebuild_pair(d_t, u_t, kind, pair)


def resize_adapter(pair: dict, r_target: int, method: str = "slice") -> dict:
    """Resize one adapter pair to ``r_target``: zero-pad when growing;
    when shrinking, ``"slice"`` (the broadcast path: a fresh adapter
    whose product is still zero keeps its down factor) or ``"svd"`` (the
    energy-optimal truncation of a trained adapter)."""
    r = adapter_rank(pair)
    if r == r_target:
        return pair
    if r < r_target:
        return pad_adapter(pair, r_target)
    if method == "slice":
        return slice_adapter(pair, r_target)
    if method == "svd":
        return svd_adapter(pair, r_target)
    raise ValueError(f"unknown resize method: {method}")


def resize_tree_rank(tree: Any, r_target: int, method: str = "slice") -> Any:
    """Every adapter pair of a trainable tree resized to ``r_target``;
    other leaves (norms, biases, dense heads) pass through."""
    return _walk_pairs(tree, lambda p: resize_adapter(p, r_target, method))


def svd_energy_rank(s: torch.Tensor, energy: float) -> int:
    """Smallest k with cumsum(s²)/sum(s²) >= ``energy`` (FLoRIST
    singular-value thresholding). Batched inputs take the max over the
    batch; an all-zero slice needs rank 1. Returns >= 1."""
    s2 = torch.square(s.to(torch.float32))
    tot = torch.sum(s2, dim=-1, keepdim=True)
    frac = torch.cumsum(s2, dim=-1) / torch.clamp(tot, min=1e-30)
    need = torch.sum(frac < energy, dim=-1) + 1
    need = torch.where(tot[..., 0] > 0, need, torch.ones_like(need))
    k = int(torch.max(need))
    return max(1, min(k, s.shape[-1]))
