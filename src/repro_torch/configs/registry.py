"""Architecture registry: ``--arch <id>`` resolution and the shape
cells, as in the JAX package's ``configs/registry.py``.

40 cells = 10 archs x 4 shapes. ``long_500k`` needs sub-quadratic
attention state: runnable for gemma3 (5:1 local:global), mamba2 (SSM)
and zamba2 (hybrid); skipped for the 7 pure full-attention archs, and
the skips are recorded, not dropped. ``input_specs`` gives a cell's
step inputs as ``meta`` tensors (shapes and dtypes, no allocation),
where the JAX package gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import (deepseek_v2_236b, gemma3_4b,
                                 llama4_maverick_400b, mamba2_370m,
                                 minitron_4b, nemotron_4_340b, paligemma_3b,
                                 qwen15_110b, seamless_m4t_medium,
                                 zamba2_2p7b)
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM

SHAPES: dict[str, dict] = {
    "train_4k": {"seq": 4096, "batch": 256, "step": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "step": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "step": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "step": "decode"},
}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    kind: str                      # 'lm' | 'encdec'
    full: Callable[[], Any]
    smoke: Callable[[], Any]
    long_500k_ok: bool
    skip_reason: str = ""


REGISTRY: dict[str, ArchEntry] = {
    "minitron-4b": ArchEntry(
        "minitron-4b", "lm", minitron_4b.full, minitron_4b.smoke, False,
        "pure full attention — 500k decode cache is quadratic-history"),
    "qwen1.5-110b": ArchEntry(
        "qwen1.5-110b", "lm", qwen15_110b.full, qwen15_110b.smoke, False,
        "pure full attention"),
    "nemotron-4-340b": ArchEntry(
        "nemotron-4-340b", "lm", nemotron_4_340b.full,
        nemotron_4_340b.smoke, False, "pure full attention"),
    "gemma3-4b": ArchEntry(
        "gemma3-4b", "lm", gemma3_4b.full, gemma3_4b.smoke, True),
    "seamless-m4t-medium": ArchEntry(
        "seamless-m4t-medium", "encdec", seamless_m4t_medium.full,
        seamless_m4t_medium.smoke, False, "enc-dec full attention"),
    "paligemma-3b": ArchEntry(
        "paligemma-3b", "lm", paligemma_3b.full, paligemma_3b.smoke, False,
        "pure full attention"),
    "llama4-maverick-400b-a17b": ArchEntry(
        "llama4-maverick-400b-a17b", "lm", llama4_maverick_400b.full,
        llama4_maverick_400b.smoke, False,
        "full attention per assigned config"),
    "deepseek-v2-236b": ArchEntry(
        "deepseek-v2-236b", "lm", deepseek_v2_236b.full,
        deepseek_v2_236b.smoke, False,
        "MLA compresses KV width, not length — full-length per layer"),
    "mamba2-370m": ArchEntry(
        "mamba2-370m", "lm", mamba2_370m.full, mamba2_370m.smoke, True),
    "zamba2-2.7b": ArchEntry(
        "zamba2-2.7b", "lm", zamba2_2p7b.full, zamba2_2p7b.smoke, True),
}


def get(arch_id: str) -> ArchEntry:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def cells() -> list[dict]:
    """All 40 (arch x shape) cells with runnable/skip annotations."""
    out = []
    for aid, e in REGISTRY.items():
        for shape, info in SHAPES.items():
            skip = (shape == "long_500k" and not e.long_500k_ok)
            out.append({"arch": aid, "shape": shape, "step": info["step"],
                        "skip": skip,
                        "skip_reason": e.skip_reason if skip else ""})
    return out


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(entry: ArchEntry, cfg: Any, shape_name: str,
                batch: Optional[int] = None) -> dict:
    """{'batch': ..., and for a decode cell the caches} for the cell's
    step, as ``meta`` tensors: a train batch of ``seq - prefix + 1``
    tokens (a prefix-LM's ``prefix_embed`` beside it), a prefill batch of
    ``seq - prefix`` tokens, a decode step's (B, 1) token with the caches
    of ``seq`` slots; the enc-dec model's ``src_embed`` of ``seq`` frames
    and ``tgt_tokens`` (B, seq + 1), its decode step's ``self_caches``
    and ``cross_caches`` (L, B, seq, Hkv, Dh) bf16. ``batch`` replaces
    the shape's batch size (a cut to fit one card)."""
    info = SHAPES[shape_name]
    b, s = batch or info["batch"], info["seq"]
    step = info["step"]
    bf16, i32 = torch.bfloat16, torch.int32
    if entry.kind == "encdec":
        if step == "train":
            return {"batch": {"src_embed": _meta((b, s, cfg.d_model), bf16),
                              "tgt_tokens": _meta((b, s + 1), i32)}}
        if step == "prefill":
            return {"batch": {"src_embed": _meta((b, s, cfg.d_model), bf16)}}
        cross = (cfg.n_dec_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        return {"batch": {"token": _meta((b, 1), i32)},
                "self_caches": ED.self_cache_init(cfg, b, s, device="meta"),
                "cross_caches": {"k": _meta(cross, bf16),
                                 "v": _meta(cross, bf16)}}

    prefix = cfg.prefix_len if cfg.prefix_lm else 0
    if step in ("train", "prefill"):
        n = s - prefix + (1 if step == "train" else 0)
        out = {"batch": {"tokens": _meta((b, n), i32)}}
        if prefix:
            out["batch"]["prefix_embed"] = _meta((b, prefix, cfg.d_model),
                                                 bf16)
        return out
    return {"batch": {"token": _meta((b, 1), i32)},
            "caches": LM.cache_init(cfg, b, s, device="meta")}
