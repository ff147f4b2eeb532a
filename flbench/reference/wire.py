"""Reading a flat int8 (or 4- or 2-bit) wire message without the program.

The flat wire stacks the channel-first rows of every quantized leaf (the
leaves that have two or more axes, in flatten order: dict keys sorted,
lists in order) into one ``(rows, words)`` buffer of little-endian
uint32 words, row ``c`` of a leaf holding its ``n`` levels from the first
word on; fp32 ``scale`` and ``zp`` hold one value a row, and the vector
leaves travel fp32 beside the buffer, in the same order. ``decode``
turns such a buffer back into the message form of
``reference.fl.encode``.
"""
from __future__ import annotations

import torch

from flbench.reference import model as ref_model


def levels_of(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """(rows, words) int32 or uint32 -> (rows, n) int64 levels."""
    per = 32 // bits
    w = words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(per, dtype=torch.int64) * bits
    lv = (w[..., None] >> shifts) & ((1 << bits) - 1)
    return lv.reshape(w.shape[0], -1)[:, :n]


def decode(payload: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
           fp_leaves: list, like: dict, bits: int) -> dict:
    """The message of ``like``'s structure carried by one flat buffer
    (host tensors)."""
    out, row, fpi = {}, 0, 0
    for path in ref_model.leaf_paths(like):
        shape = tuple(ref_model.get(like, path).shape)
        if len(shape) < 2:
            out[path] = {"fp": fp_leaves[fpi]}
            fpi += 1
            continue
        c = shape[-1]
        n = 1
        for d in shape[:-1]:
            n *= d
        nw = -(-n * bits // 32)
        out[path] = {"levels": levels_of(payload[row: row + c, :nw], bits,
                                         n),
                     "scale": scale[row: row + c],
                     "zp": zp[row: row + c]}
        row += c
    if row != payload.shape[0] or fpi != len(fp_leaves):
        raise ValueError(f"the message holds {payload.shape[0]} rows and "
                         f"{len(fp_leaves)} vectors; the tree has {row} "
                         f"and {fpi}")
    return out
