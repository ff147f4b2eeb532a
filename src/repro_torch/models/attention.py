"""Attention blocks: GQA with its sliding-window variant, and
DeepSeek-V2's multi-head latent attention (MLA). Projections are FLoCoRA
mixed-mode linears.

Head padding: where a config sets ``pad_heads_to`` (gemma3-4b's 8 query
heads padded to 16, minitron-4b's 24 to 32), the extra query heads are
zeroed by a head mask on q and on the attention output, so the function
is exactly the unpadded one; the weights are not edited. KV heads are
never padded (the GQA repeat covers them).

Caches:
  GQA full:  {'k','v': (B, Smax, Hkv, Dh)}                      (global)
  GQA ring:  same shapes with Smax == window (ring buffer)      (local)
  MLA:       {'ckv': (B, Smax, kv_lora), 'kr': (B, Smax, rope)} (latent)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.lora import LoRAConfig, frozen_weight, \
    linear_apply, linear_init
from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GQASpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    pad_heads_to: Optional[int] = None   # padded query-head count

    @property
    def hq(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def rep(self) -> int:
        assert self.hq % self.n_kv_heads == 0
        return self.hq // self.n_kv_heads


def gqa_init(gen: torch.Generator, spec: GQASpec, mode: str,
             lora: LoRAConfig, stack: tuple[int, ...] = (),
             device="cuda") -> tuple[dict, dict]:
    dev = resolve_device(device)
    d, hq, hkv, dh = spec.d_model, spec.hq, spec.n_kv_heads, spec.head_dim
    fz, tr = {}, {}
    for nm, d_in, d_out in (("wq", d, hq * dh), ("wk", d, hkv * dh),
                            ("wv", d, hkv * dh), ("wo", hq * dh, d)):
        f, t = linear_init(gen, d_in, d_out, mode, lora, stack, device=dev)
        if f:
            fz[nm] = f
        if t:
            tr[nm] = t
    if spec.qkv_bias:
        for nm, n in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            tr[nm] = torch.zeros((*stack, n), dtype=torch.float32,
                                 device=dev)
    if spec.qk_norm:
        tr["q_norm"] = L.rmsnorm_init(dh, stack, dev)
        tr["k_norm"] = L.rmsnorm_init(dh, stack, dev)
    return fz, tr


def _head_mask(spec: GQASpec, dtype, device) -> Optional[torch.Tensor]:
    if not spec.pad_heads_to or spec.pad_heads_to == spec.n_heads:
        return None
    m = torch.zeros((spec.hq,), dtype=dtype, device=device)
    m[: spec.n_heads] = 1.0
    return m[None, None, :, None]


def _qkv(fz, tr, spec: GQASpec, x: torch.Tensor, lora_scale: float, rope):
    b, s, _ = x.shape
    dh = spec.head_dim
    q = linear_apply(fz.get("wq", {}), tr.get("wq", {}), x, lora_scale)
    k = linear_apply(fz.get("wk", {}), tr.get("wk", {}), x, lora_scale)
    v = linear_apply(fz.get("wv", {}), tr.get("wv", {}), x, lora_scale)
    if spec.qkv_bias:
        q = q + tr["bq"].to(q.dtype)
        k = k + tr["bk"].to(k.dtype)
        v = v + tr["bv"].to(v.dtype)
    q = q.reshape(b, s, spec.hq, dh)
    k = k.reshape(b, s, spec.n_kv_heads, dh)
    v = v.reshape(b, s, spec.n_kv_heads, dh)
    if spec.qk_norm:
        q = L.rmsnorm_apply(tr["q_norm"], q)
        k = L.rmsnorm_apply(tr["k_norm"], k)
    if rope is not None:
        cos, sin = rope
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    hm = _head_mask(spec, q.dtype, q.device)
    if hm is not None:
        q = q * hm
    return q, k, v


def _out(fz, tr, spec: GQASpec, o: torch.Tensor,
         lora_scale: float) -> torch.Tensor:
    """Head mask, merge the heads, output projection."""
    b, s = o.shape[:2]
    hm = _head_mask(spec, o.dtype, o.device)
    if hm is not None:
        o = o * hm
    o = o.reshape(b, s, spec.hq * spec.head_dim)
    return linear_apply(fz.get("wo", {}), tr.get("wo", {}), o, lora_scale)


def gqa_apply(fz: dict, tr: dict, spec: GQASpec, x: torch.Tensor,
              lora_scale: float, rope, *,
              window: Optional[int] = None,
              causal: bool = True,
              prefix_len: Optional[torch.Tensor] = None,
              kv_chunk: int = 1024) -> torch.Tensor:
    """Training / prefill forward. Returns (B, S, d)."""
    s = x.shape[1]
    q, k, v = _qkv(fz, tr, spec, x, lora_scale, rope)
    if window is not None and window < s:
        o = L.local_attention_blocked(q, k, v, window=window)
    else:
        o = L.attention_chunked(q, k, v, causal=causal,
                                prefix_len=prefix_len, kv_chunk=kv_chunk)
    return _out(fz, tr, spec, o, lora_scale)


def gqa_cache_init(spec: GQASpec, batch: int, max_seq: int,
                   window: Optional[int] = None,
                   dtype: torch.dtype = torch.bfloat16,
                   device="cuda") -> dict:
    smax = min(window, max_seq) if window else max_seq
    shp = (batch, smax, spec.n_kv_heads, spec.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shp, dtype=dtype, device=dev),
            "v": torch.zeros(shp, dtype=dtype, device=dev)}


def gqa_decode(fz: dict, tr: dict, spec: GQASpec, x: torch.Tensor,
               cache: dict, pos: int, lora_scale: float, rope, *,
               window: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d); pos: the current absolute position (an int). The
    new k/v land in slot ``pos % Smax`` of a ring (window) cache and
    slot ``pos`` of a full one, written IN PLACE into ``cache`` (the JAX
    package returns new arrays; here the cache tensors are reused).
    Returns (y, cache)."""
    q, k, v = _qkv(fz, tr, spec, x, lora_scale, rope)
    smax = cache["k"].shape[1]
    slot = (pos % smax) if window else pos
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    o = L.decode_attention(q, cache["k"], cache["v"], min(pos + 1, smax))
    return _out(fz, tr, spec, o, lora_scale), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLASpec:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def mla_init(gen: torch.Generator, spec: MLASpec, mode: str,
             lora: LoRAConfig, stack: tuple[int, ...] = (),
             device="cuda") -> tuple[dict, dict]:
    """The six linears (drawn in the JAX package's order) and the two
    latent norms."""
    dev = resolve_device(device)
    h = spec.n_heads
    parts = {
        "q_a": (spec.d_model, spec.q_lora_rank),
        "q_b": (spec.q_lora_rank, h * spec.qk_dim),
        "kv_a": (spec.d_model, spec.kv_lora_rank + spec.qk_rope_dim),
        "k_b": (spec.kv_lora_rank, h * spec.qk_nope_dim),
        "v_b": (spec.kv_lora_rank, h * spec.v_head_dim),
        "wo": (h * spec.v_head_dim, spec.d_model),
    }
    fz, tr = {}, {}
    for nm, dims in parts.items():
        f, t = linear_init(gen, *dims, mode, lora, stack, device=dev)
        if f:
            fz[nm] = f
        if t:
            tr[nm] = t
    tr["q_a_norm"] = L.rmsnorm_init(spec.q_lora_rank, stack, dev)
    tr["kv_a_norm"] = L.rmsnorm_init(spec.kv_lora_rank, stack, dev)
    return fz, tr


def _mla_q(fz, tr, spec: MLASpec, x: torch.Tensor, lora_scale: float,
           rope) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    qa = linear_apply(fz.get("q_a", {}), tr.get("q_a", {}), x, lora_scale)
    qa = L.rmsnorm_apply(tr["q_a_norm"], qa)
    q = linear_apply(fz.get("q_b", {}), tr.get("q_b", {}), qa, lora_scale)
    q = q.reshape(b, s, spec.n_heads, spec.qk_dim)
    q_nope = q[..., : spec.qk_nope_dim]
    q_rope = L.apply_rope(q[..., spec.qk_nope_dim:], *rope)
    return q_nope, q_rope


def _mla_latent(fz, tr, spec: MLASpec, x: torch.Tensor, lora_scale: float,
                rope) -> tuple[torch.Tensor, torch.Tensor]:
    """(ckv (B, S, kv_lora), kr (B, S, rope)): the normed latent and the
    one rope key head every query head shares."""
    kv = linear_apply(fz.get("kv_a", {}), tr.get("kv_a", {}), x, lora_scale)
    ckv = L.rmsnorm_apply(tr["kv_a_norm"], kv[..., : spec.kv_lora_rank])
    kr = L.apply_rope(kv[..., spec.kv_lora_rank:][:, :, None, :], *rope)
    return ckv, kr[:, :, 0]


def mla_apply(fz: dict, tr: dict, spec: MLASpec, x: torch.Tensor,
              lora_scale: float, rope, *,
              kv_chunk: int = 1024) -> torch.Tensor:
    """Training / prefill: per-head K and V materialized from the latent
    (q/k width ``qk_dim``, v width ``v_head_dim``). Returns (B, S, d)."""
    b, s, _ = x.shape
    h = spec.n_heads
    q_nope, q_rope = _mla_q(fz, tr, spec, x, lora_scale, rope)
    ckv, kr = _mla_latent(fz, tr, spec, x, lora_scale, rope)
    k_nope = linear_apply(fz.get("k_b", {}), tr.get("k_b", {}), ckv,
                          lora_scale).reshape(b, s, h, spec.qk_nope_dim)
    v = linear_apply(fz.get("v_b", {}), tr.get("v_b", {}), ckv,
                     lora_scale).reshape(b, s, h, spec.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None].expand(b, s, h, spec.qk_rope_dim)],
                  dim=-1)
    o = L.attention_chunked(q, k, v, causal=True, kv_chunk=kv_chunk,
                            scale=spec.qk_dim ** -0.5)
    o = o.reshape(b, s, h * spec.v_head_dim)
    return linear_apply(fz.get("wo", {}), tr.get("wo", {}), o, lora_scale)


def mla_cache_init(spec: MLASpec, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device="cuda") -> dict:
    dev = resolve_device(device)
    return {"ckv": torch.zeros((batch, max_seq, spec.kv_lora_rank),
                               dtype=dtype, device=dev),
            "kr": torch.zeros((batch, max_seq, spec.qk_rope_dim),
                              dtype=dtype, device=dev)}


def _eff_weight(fz: dict, tr: dict, lora_scale: float) -> torch.Tensor:
    """The merged weight of a mixed-mode linear, ``w + s·a@b`` in fp32
    where it has an adapter: absorption needs the matrix, not its
    action."""
    w = tr["w"] if "w" in tr else frozen_weight(fz)
    if "a" in tr:
        w = w.to(torch.float32) + lora_scale * (
            tr["a"].to(torch.float32) @ tr["b"].to(torch.float32))
    return w


def mla_decode(fz: dict, tr: dict, spec: MLASpec, x: torch.Tensor,
               cache: dict, pos: int, lora_scale: float,
               rope) -> tuple[torch.Tensor, dict]:
    """Latent-cache decode with weight absorption (O(S·kv_lora) a head).
    x: (B, 1, d); pos: the absolute position (an int). The new latent
    lands in slot ``pos`` of ``cache``, IN PLACE. Returns (y, cache)."""
    b = x.shape[0]
    h = spec.n_heads
    q_nope, q_rope = _mla_q(fz, tr, spec, x, lora_scale, rope)
    ckv_new, kr_new = _mla_latent(fz, tr, spec, x, lora_scale, rope)
    cache["ckv"][:, pos] = ckv_new[:, 0].to(cache["ckv"].dtype)
    cache["kr"][:, pos] = kr_new[:, 0].to(cache["kr"].dtype)
    ckv, kr = cache["ckv"], cache["kr"]
    # absorb k_b into q: q_abs[b,h,c] = sum_d q_nope[b,h,d] * k_b[c,(h d)]
    k_b = _eff_weight(fz.get("k_b", {}), tr.get("k_b", {}), lora_scale)
    v_b = _eff_weight(fz.get("v_b", {}), tr.get("v_b", {}), lora_scale)
    k_b = k_b.reshape(spec.kv_lora_rank, h, spec.qk_nope_dim)
    v_b = v_b.reshape(spec.kv_lora_rank, h, spec.v_head_dim)
    q_abs = torch.einsum("bhd,chd->bhc", q_nope[:, 0].to(torch.float32),
                         k_b.to(torch.float32))
    s_lat = L._einsum_f32("bhc,bsc->bhs", q_abs, ckv)
    s_rope = L._einsum_f32("bhr,bsr->bhs", q_rope[:, 0], kr)
    scores = (s_lat + s_rope) * spec.qk_dim ** -0.5
    smax = ckv.shape[1]
    mask = torch.arange(smax, device=x.device) <= pos
    scores = torch.where(mask[None, None, :], scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    ctx = L._einsum_f32("bhs,bsc->bhc", p, ckv)
    o = torch.einsum("bhc,chd->bhd", ctx, v_b.to(torch.float32))
    o = o.reshape(b, 1, h * spec.v_head_dim).to(x.dtype)
    y = linear_apply(fz.get("wo", {}), tr.get("wo", {}), o, lora_scale)
    return y, cache
