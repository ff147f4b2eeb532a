"""The yardstick's arithmetic: the card's peaks, the bytes the flat wire's
pack (B1) and reduce (B2) must move, and the model FLOPs of a training
step.

Bytes count what the work needs, from the message layout and K, whatever
kernel does it: B1 reads each valid fp32 value and the row lengths once
and writes every word of the flat buffer and the fp32 scale and zero
point of each row; B2 reads each client's valid words, sidecars and
weight and the row lengths once and writes the fp32 buffer. The layout
is the flat wire's: every leaf of two or more axes gives its last axis's
channels as rows of ``n`` levels, padded to a multiple of 128 words.
FLOPs are ``torch.utils.flop_counter``'s count of the reference model's
forward and backward (gradients of the trained leaves only), on the
``meta`` device.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from flbench.reference import model as ref_model

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str):
    """The peak rates of the card named ``device_name``, or None."""
    for entry in json.loads(PEAKS.read_text())["cards"]:
        if entry["match"] in device_name:
            return entry
    return None


def layout(cfg: dict, mode: str, bits: int) -> dict:
    """Rows, valid levels per row and the padded row width (levels) of
    the trainable tree's flat message."""
    nv = []
    for side, _, shape, _, _ in ref_model.param_specs(cfg, mode):
        if side != "train" or len(shape) < 2:
            continue
        c = shape[-1]
        n = 1
        for d in shape[:-1]:
            n *= d
        nv += [n] * c
    lane = (32 // bits) * 128
    n_max = -(-max(nv) // lane) * lane
    return {"rows": len(nv), "n_valid": nv, "n_max": n_max, "bits": bits}


def b1_bytes(lo: dict) -> int:
    c, bits = lo["rows"], lo["bits"]
    nw = lo["n_max"] * bits // 32
    return 4 * sum(lo["n_valid"]) + 4 * c + 4 * c * nw + 8 * c


def b2_bytes(lo: dict, k: int) -> int:
    c, per = lo["rows"], 32 // lo["bits"]
    words = sum(-(-n // per) for n in lo["n_valid"])
    return 4 * k * words + 8 * k * c + 4 * k + 4 * c + 4 * c * lo["n_max"]


def flops_per_image(cfg: dict, mode: str, batch: int = 4) -> float:
    """Model FLOPs of one training step, per image."""
    specs = ref_model.param_specs(cfg, mode)
    trees = {"frozen": ref_model.skeleton(cfg),
             "train": ref_model.skeleton(cfg)}
    leaves = []
    for side, path, shape, _, _ in specs:
        t = torch.empty(shape, device="meta",
                        requires_grad=(side == "train"))
        ref_model.put(trees[side], path, t)
        leaves.append(t)
    s = cfg["image_size"]
    x = torch.empty((batch, s, s, cfg["in_channels"]), device="meta")
    y = torch.zeros((batch,), dtype=torch.long, device="meta")
    m = ref_model.Model(cfg)
    with FlopCounterMode(display=False) as fc:
        loss = m.loss(trees["frozen"], trees["train"], x, y)
        loss.backward()
    return fc.get_total_flops() / batch
