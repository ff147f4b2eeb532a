"""Layers of the ported models (functional, parameter dicts).

Conventions, as in the JAX package's ``models/layers.py``:
  * activations: (batch, seq, d_model); attention heads (B, S, H, Dh);
  * linear weights: (d_in, d_out), the output channel LAST;
  * every linear is a mixed-mode FLoCoRA linear (``core.lora``);
  * attention never materializes (Sq, Skv) for long sequences: causal
    attention runs an online softmax over KV chunks; sliding-window
    attention is exact blocked local attention (a band of 2W keys per
    query block).

bf16 products in fp32: every attention product of the JAX package is a
bf16 x bf16 einsum with ``preferred_element_type=float32``. A torch bf16
matmul returns bf16, so here the operands are rounded to bf16 and
multiplied in fp32 (:func:`_einsum_f32`): the products are then the
reference's exactly, and only the summation order differs. TF32 must
stay off (PyTorch's default for matmuls) or the fp32 products lose
their low bits on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.lora import LoRAConfig, linear_apply, linear_init, \
    linear_logical
from repro_torch.utils import pcontext
from repro_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, stack: tuple[int, ...] = (),
                 device="cuda") -> dict:
    return {"scale": torch.ones((*stack, d), dtype=torch.float32,
                                device=resolve_device(device))}


def rmsnorm_apply(p: dict, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def rmsnorm_blocks(p: dict, x: torch.Tensor, total: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm_apply` over a last dim of ``total`` channels of
    which ``x`` (and ``p['scale']``) holds this rank's block (a Mamba
    mixer's head block): the mean square is the blocks' sums of squares
    summed (``pcontext.ssm_sum``) over ``total``."""
    xf = x.to(torch.float32)
    var = pcontext.ssm_sum(torch.sum(xf * xf, dim=-1, keepdim=True)) / total
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def embed_lookup(e: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the embedding table ``e`` ({'w'} or an int8 base
    {'w_q8', 'w_s'}) for ``tokens``. Of a sharded step's block of the
    vocab (``pcontext.vocab_block``): the rows the block holds, zeros
    for the others, summed over the blocks; one block gives each token
    its row, so the sum is the whole table's lookup exactly."""
    blk = pcontext.vocab_block("embed")
    if blk is not None:
        local = tokens - blk[0]
        inside = (local >= 0) & (local < blk[1])
        tokens = local.clamp(0, blk[1] - 1)
    if "w_q8" in e:
        x = e["w_q8"][tokens].to(torch.bfloat16) * e["w_s"].to(torch.bfloat16)
    else:
        x = e["w"][tokens]
    if blk is None:
        return x
    return pcontext.vocab_sum(torch.where(inside[..., None], x, 0))


def head_logits(fz: dict, tr: dict, x: torch.Tensor,
                lora_scale: float) -> torch.Tensor:
    """The head's fp32 logits of ``x`` over the whole vocab (of a
    sharded step's vocab block, gathered)."""
    return pcontext.vocab_gather(linear_apply(fz, tr, x, lora_scale).to(
        torch.float32))


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


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_for_positions(positions: torch.Tensor, dim: int,
                       base: float = 10000.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin for integer positions ((S,) or (B, S)), computed directly
    (no max-length table). Returns (..., dim//2) fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    # a Python base: no host-to-device copy (which would stall the host
    # on every layer of a decode step)
    inv = 1.0 / torch.pow(float(base), exps)
    freqs = positions.to(torch.float32)[..., None] * inv
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (S, Dh//2) or (B, S, Dh//2)."""
    if cos.ndim == 2:
        c, si = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, si = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * si, x2 * c + x1 * si], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores (no projections: those live in the block)
# ---------------------------------------------------------------------------

def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` of the bf16-rounded operands in fp32: the
    JAX package's bf16 einsum with ``preferred_element_type=float32``."""
    return torch.einsum(eq, a.to(torch.bfloat16).to(torch.float32),
                        b.to(torch.bfloat16).to(torch.float32))


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _maybe_remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass when autograd is
    recording (the JAX package's ``jax.checkpoint`` with nothing
    saveable); a plain call otherwise."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      prefix_len: Optional[torch.Tensor] = None,
                      kv_chunk: int = 1024,
                      scale: Optional[float] = None,
                      q_offset: int = 0,
                      n_heads: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the memory high-water
    is (B, H, Sq, kv_chunk)).

    q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) with H % Hkv == 0.
    prefix_len: (B,): bidirectional attention within [0, prefix_len)
    (prefix-LM), causal elsewhere. A query that no key of a chunk may
    see (a fully masked row) adds nothing for that chunk. q_offset: the
    absolute position of q[0] (a block of the sequence's queries).
    n_heads: the attention's query heads where q holds a sharded step's
    block of them: k and v repeat to ``n_heads`` and the ``heads``
    constraint keeps the block's.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    k = _repeat_kv(k, (n_heads or h) // hkv)
    v = _repeat_kv(v, (n_heads or h) // hkv)
    q = pcontext.constrain(q, "heads")
    k = pcontext.constrain(k, "heads")
    v = pcontext.constrain(v, "heads")
    sc = scale if scale is not None else d ** -0.5
    qf = (q * sc).to(torch.bfloat16)
    dev = q.device

    n_chunks = -(-skv // kv_chunk)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    # (N, B, C, H, D) views, chunk-major as the reference scans them
    kc = pcontext.constrain(k.reshape(b, n_chunks, kv_chunk, h, d)
                            .transpose(0, 1), "kv_chunks")
    vc = pcontext.constrain(v.reshape(b, n_chunks, kv_chunk, h, dv)
                            .transpose(0, 1), "kv_chunks")
    q_pos = torch.arange(sq, device=dev) + q_offset

    def body(m, l, acc, kch, vch, cidx: int):
        kv_pos = cidx * kv_chunk + torch.arange(kv_chunk, device=dev)
        s_ = _einsum_f32("bqhd,bchd->bhqc", qf, kch)      # (B, H, Sq, C)
        valid = (kv_pos < skv)[None, :]
        if causal:
            ok = q_pos[:, None] >= kv_pos[None, :]
            if prefix_len is not None:
                pl = prefix_len.to(dev)[:, None, None]
                both_prefix = (q_pos[None, :, None] < pl) \
                    & (kv_pos[None, None, :] < pl)
                mask = (ok[None] | both_prefix) & valid
                s_ = torch.where(mask[:, None], s_, -torch.inf)
            else:
                mask = ok & valid
                s_ = torch.where(mask[None, None], s_, -torch.inf)
        else:
            s_ = torch.where(valid[None, None], s_, -torch.inf)
        m_new = torch.maximum(m, torch.amax(s_, dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s_ - m_safe[..., None])
        p = torch.where(torch.isfinite(s_), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l_new = l * corr + torch.sum(p, dim=-1)
        acc_new = acc * corr[..., None] + _einsum_f32(
            "bhqc,bchd->bhqd", p, vch)
        return m_new, l_new, acc_new

    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        m, l, acc = _maybe_remat(body, m, l, acc, kc[ci], vc[ci], ci)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)          # (B, Sq, H, D)


def local_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: int,
                            scale: Optional[float] = None,
                            n_heads: Optional[int] = None) -> torch.Tensor:
    """Exact causal sliding-window attention (window W), O(S·2W).

    Each query block of length W attends to its own and the previous
    block, which covers every key within the causal window
    [pos-W+1, pos]. q: (B, S, H, D); k, v: (B, S, Hkv, D). S % W need
    not hold (padded). n_heads: as :func:`attention_chunked`'s.
    """
    b, s, h, d = q.shape
    hkv = k.shape[2]
    k = _repeat_kv(k, (n_heads or h) // hkv)
    v = _repeat_kv(v, (n_heads or h) // hkv)
    sc = scale if scale is not None else d ** -0.5
    w = window
    nb = -(-s // w)
    pad = nb * w - s
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q = pcontext.constrain(q, "heads")
    k = pcontext.constrain(k, "heads")
    v = pcontext.constrain(v, "heads")
    qb = q.reshape(b, nb, w, h, d)
    kb = k.reshape(b, nb, w, h, d)
    vb = v.reshape(b, nb, w, h, d)
    # band of [previous block, current block]: (B, nb, 2W, H, D)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    kband = torch.cat([kprev, kb], dim=2)
    vband = torch.cat([vprev, vb], dim=2)

    s_ = _einsum_f32("bnqhd,bnkhd->bnhqk", (qb * sc).to(torch.bfloat16),
                     kband)
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None]        # within-block pos
    kpos = torch.arange(2 * w, device=dev)[None, :] - w  # rel. block start
    ok = (kpos <= qpos) & (kpos > qpos - w)   # causal & within window
    first = (torch.arange(nb, device=dev) == 0)[None, :, None, None, None]
    pad_keys = (kpos < 0)[None, None, None]
    ok = ok[None, None, None] & ~(first & pad_keys)
    s_ = torch.where(ok, s_, -torch.inf)
    p = torch.softmax(s_, dim=-1)
    o = _einsum_f32("bnhqk,bnkhd->bnqhd", p, vband)
    o = o.reshape(b, nb * w, h, d)[:, :s]
    return o.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode over a KV cache.

    q: (B, 1, H, D); caches: (B, Smax, Hkv, D); length: an int, a 0-d
    or a (B,) tensor: the number of valid cache entries (the new token
    is already written).
    """
    b, _, h, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    sc = scale if scale is not None else d ** -0.5
    qh = (q[:, 0] * sc).reshape(b, hkv, rep, d)
    s_ = _einsum_f32("bgrd,bsgd->bgrs", qh, k_cache)
    # a sharded step's rank holds a block of the slots (split-KV)
    blk = pcontext.seq_block(k_cache)
    pos = torch.arange(smax, device=q.device)
    if blk is not None:
        pos = pos + blk.offset
    if isinstance(length, torch.Tensor):
        mask = pos[None, :] < length.to(q.device).expand(b)[:, None]
    else:       # an int: compared on the device, no host-to-device copy
        mask = (pos < int(length))[None, :].expand(b, smax)
    s_ = torch.where(mask[:, None, None, :], s_, -torch.inf)
    p = softmax_blocks(s_, blk)
    o = _einsum_f32("bgrs,bsgd->bgrd", p, v_cache)
    if blk is not None:
        o = blk.sum(o)
    return o.reshape(b, 1, h, d).to(q.dtype)


def softmax_blocks(s_: torch.Tensor, blk) -> torch.Tensor:
    """``softmax(s_, -1)``; where the last dim is a rank's block of a
    sequence (``blk``), the max and the sum run over every block, so
    each block holds its share of the whole softmax."""
    if blk is None:
        return torch.softmax(s_, dim=-1)
    m = blk.max(torch.amax(s_, dim=-1, keepdim=True))
    e = torch.exp(s_ - m)
    return e / blk.sum(torch.sum(e, dim=-1, keepdim=True))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLPSpec:
    kind: str          # 'swiglu' | 'geglu' | 'sqrelu' | 'gelu'
    d_model: int
    d_ff: int


def mlp_init(gen: torch.Generator, spec: MLPSpec, mode: str,
             lora: LoRAConfig, stack: tuple[int, ...] = (),
             device="cuda") -> tuple[dict, dict]:
    dims = {"wi": (spec.d_model, spec.d_ff), "wg": (spec.d_model, spec.d_ff),
            "wo": (spec.d_ff, spec.d_model)}
    names = ["wi", "wg", "wo"] if spec.kind in ("swiglu", "geglu") \
        else ["wi", "wo"]
    fz, tr = {}, {}
    for nm in names:
        f, t = linear_init(gen, *dims[nm], mode, lora, stack,
                           device=device)
        if f:
            fz[nm] = f
        if t:
            tr[nm] = t
    return fz, tr


def mlp_logical(spec: MLPSpec, mode: str, stack: bool) -> tuple[dict, dict]:
    """Logical annotations parallel to :func:`mlp_init`'s trees."""
    fz, tr = {}, {}
    names = ["wi", "wg", "wo"] if spec.kind in ("swiglu", "geglu") \
        else ["wi", "wo"]
    dims = {"wi": ("fsdp", "mlp"), "wg": ("fsdp", "mlp"),
            "wo": ("mlp", "fsdp")}
    for nm in names:
        f, t = linear_logical(*dims[nm], mode, stack)
        if f:
            fz[nm] = f
        if t:
            tr[nm] = t
    return fz, tr


def _out_width(fz: dict, tr: dict, nm: str) -> int:
    src = tr.get(nm, {}) if "w" in tr.get(nm, {}) else fz.get(nm, {})
    w = src.get("w", src.get("w_q8"))
    return int(w.shape[-1])


def mlp_apply(fz: dict, tr: dict, spec: MLPSpec, x: torch.Tensor,
              lora_scale: float) -> torch.Tensor:
    def g(nm, xx):
        return linear_apply(fz.get(nm, {}), tr.get(nm, {}), xx, lora_scale)

    # a sharded step's tensor-parallel MLP: its weights are this rank's
    # blocks of the hidden units, its output a part of the sum
    tp = _out_width(fz, tr, "wi") != spec.d_ff
    if tp:
        x = pcontext.tp_enter(x)

    if spec.kind == "swiglu":
        h = F.silu(g("wg", x).to(torch.float32)).to(x.dtype) * g("wi", x)
    elif spec.kind == "geglu":
        # jax.nn.gelu(approximate=True) is the tanh form
        h = F.gelu(g("wg", x).to(torch.float32),
                   approximate="tanh").to(x.dtype) * g("wi", x)
    elif spec.kind == "sqrelu":
        h = F.relu(g("wi", x))
        h = h * h
    elif spec.kind == "gelu":
        # jax.nn.gelu's default is approximate=True: the tanh form too
        h = F.gelu(g("wi", x).to(torch.float32),
                   approximate="tanh").to(x.dtype)
    else:
        raise ValueError(spec.kind)
    y = g("wo", h)
    return pcontext.tp_exit(y) if tp else y


# ---------------------------------------------------------------------------
# Chunked softmax cross-entropy (never materializes (B, S, V))
# ---------------------------------------------------------------------------

def chunked_xent(x: torch.Tensor, head_fz: dict, head_tr: dict,
                 labels: torch.Tensor, lora_scale: float, chunk: int = 512,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy. x: (B, S, d); labels: (B, S).

    Walks sequence chunks; per chunk computes logits (B, c, V),
    logsumexp and the label logit, then drops the logits (recomputed in
    the backward pass), so live memory stays at (B, chunk, V). Of a
    sharded step's block of the vocab (``pcontext.vocab_block``) the
    logits are (B, c, V/m): the max, the sum of the exponentials and the
    label's logit (from the block that holds it) are taken over the
    blocks, the same collectives in the recomputation."""
    blk = pcontext.vocab_block("head")
    if blk is not None:
        x = pcontext.vocab_enter(x)
    b, s, d = x.shape
    n = -(-s // chunk)
    pad = n * chunk - s
    labels = labels.to(torch.long)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=x.device)
    mask = mask.to(torch.float32)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))

    def body(xch, lch, mch):
        logits = linear_apply(head_fz, head_tr, xch, lora_scale,
                              compute_dtype=torch.bfloat16
                              ).to(torch.float32)
        if blk is None:
            lse = torch.logsumexp(logits, dim=-1)
            lab = torch.gather(logits, -1, lch[..., None])[..., 0]
        else:
            lse, lab = _lse_label_blocks(logits, lch, blk)
        nll = (lse - lab) * mch
        return torch.sum(nll), torch.sum(mch)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, c = _maybe_remat(body, x[:, sl], labels[:, sl], mask[:, sl])
        tot, cnt = tot + t, cnt + c
    # a sharded step's batch block: the sums over every rank's tokens
    tot, cnt = pcontext.batch_sum(tot), pcontext.batch_sum(cnt)
    return tot / torch.clamp(cnt, min=1.0)


def _lse_label_blocks(logits: torch.Tensor, labels: torch.Tensor,
                      blk: tuple[int, int]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, the label's logit) over the whole vocab from this
    rank's block of the logits (..., V/m) holding vocab rows
    ``[blk[0], blk[0] + blk[1])``."""
    local = labels - blk[0]
    inside = (local >= 0) & (local < blk[1])
    lab = torch.gather(logits, -1, local.clamp(0, blk[1] - 1)[..., None])
    return _BlockLogSumExp.apply(logits), \
        pcontext.vocab_sum(torch.where(inside, lab[..., 0], 0.0))


class _BlockLogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of the vocab blocks of every
    rank from this rank's block, its max and its sum of exponentials
    taken over the blocks; the backward is logsumexp's own, ``g *
    exp(x - lse)``, on the block (one block: ``torch.logsumexp`` to the
    bit)."""

    @staticmethod
    def forward(ctx, x):
        mx = pcontext.vocab_max(torch.amax(x, dim=-1))
        lse = torch.log(pcontext.vocab_sum(
            torch.sum(torch.exp(x - mx[..., None]), dim=-1))) + mx
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None])
