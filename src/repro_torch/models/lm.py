"""Decoder LM: the JAX package's ``models/lm.py`` for the dense family
(gemma3-4b, minitron-4b, qwen1.5-110b, nemotron-4-340b) and the MLA and
MoE layers (deepseek-v2-236b, llama4-maverick-400b-a17b).

Layer stacking mirrors the reference: the per-arch layer sequence
resolves into groups, ``(pattern, repeats)`` pairs whose parameters are
stacked over ``repeats`` (a leading axis on every leaf), so a tree
initialized by the JAX package carries across leaf by leaf
(``convert.params_from_jax``). Where JAX scans a group, the port loops
over the index in Python; with ``cfg.remat`` each layer is recomputed
in the backward pass (``torch.utils.checkpoint``).

Parameters: the embedding, the head's base and the layers' linears are
frozen bf16; the adapters and the norms train in fp32. Serving is
``prefill`` (the prompt, building the KV caches) then ``decode_step``
(one token); sliding-window layers keep a ring cache of ``window``
slots, aligned at prefill so that token t sits in slot ``t % window``;
MLA layers keep the latent cache and decode by weight absorption. A MoE
layer adds its Switch aux loss to ``forward``'s second output.

Not ported yet: Mamba-2 and the shared attention of zamba2 (ROADMAP
A9c), the prefix-LM and the encoder-decoder (A9d). A config that needs
one makes every function here raise ``NotImplementedError`` naming the
item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import lora
from repro_torch.core.lora import LoRAConfig, linear_apply, linear_init
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.encdec import EncDecConfig
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                   # 'gqa' | 'mla' | 'mamba' | 'shared_gqa'
    ffn: str                     # 'dense' | 'moe' | 'none'
    window: Optional[int] = None
    global_rope: bool = False    # use rope_base_global


@dataclasses.dataclass(frozen=True)
class Group:
    pattern: tuple[LayerSpec, ...]
    repeats: int


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    mlp_kind: str = "swiglu"
    qkv_bias: bool = False
    qk_norm: bool = False
    pad_heads_to: Optional[int] = None
    rope_base: float = 1e4
    rope_base_global: Optional[float] = None
    window: Optional[int] = None
    window_pattern: Optional[int] = None   # every Nth layer is global
    attn_kind: str = "gqa"                 # 'gqa' | 'mla' | 'none'
    mla: Optional[A.MLASpec] = None
    moe: Optional[MOE.MoESpec] = None
    moe_every: int = 1
    mamba: Optional[SSM.MambaSpec] = None
    shared_attn_every: Optional[int] = None   # zamba2
    prefix_lm: bool = False
    prefix_len: int = 0
    embed_scale: bool = False
    # FLoCoRA
    lora: LoRAConfig = LoRAConfig()
    head_mode: str = "lora"                 # 'dense'|'lora'|'frozen'
    # memory policy
    remat: bool = True
    kv_chunk: int = 1024
    xent_chunk: int = 512

    @property
    def gqa(self) -> A.GQASpec:
        return A.GQASpec(self.d_model, self.n_heads, self.n_kv_heads,
                         self.head_dim, self.qkv_bias, self.qk_norm,
                         self.pad_heads_to)


def _check(cfg: Any) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item where
    ``cfg`` needs a part of the LM zoo the port lacks."""
    if isinstance(cfg, EncDecConfig):
        what = "the encoder-decoder model (ROADMAP A9d)"
    elif cfg.mamba is not None or cfg.shared_attn_every \
            or cfg.attn_kind == "none":
        what = "Mamba-2 layers and shared attention (ROADMAP A9c)"
    elif cfg.prefix_lm:
        what = "the prefix-LM (ROADMAP A9d)"
    else:
        return
    raise NotImplementedError(f"{cfg.name}: {what} is not ported yet")


def resolve_groups(cfg: LMConfig) -> list[Group]:
    if cfg.shared_attn_every:                      # zamba2
        ev = cfg.shared_attn_every
        assert cfg.n_layers % ev == 0
        pat = (LayerSpec("shared_gqa", "dense"),) + \
            (LayerSpec("mamba", "none"),) * ev
        return [Group(pat, cfg.n_layers // ev)]
    if cfg.mamba is not None and cfg.attn_kind == "none":  # mamba2
        return [Group((LayerSpec("mamba", "none"),), cfg.n_layers)]
    mixer = "mla" if cfg.attn_kind == "mla" else "gqa"
    if cfg.window_pattern:                          # gemma3: N-1 local, 1 global
        n = cfg.window_pattern
        pat = tuple(LayerSpec(mixer, "dense", window=cfg.window)
                    for _ in range(n - 1)) + \
            (LayerSpec(mixer, "dense", window=None, global_rope=True),)
        full = cfg.n_layers // n
        groups = [Group(pat, full)]
        rem = cfg.n_layers - full * n
        if rem:
            groups.append(Group(
                (LayerSpec(mixer, "dense", window=cfg.window),), rem))
        return groups
    if cfg.moe is not None:
        if cfg.moe_every == 1:
            return [Group((LayerSpec(mixer, "moe"),), cfg.n_layers)]
        assert cfg.n_layers % cfg.moe_every == 0
        pat = (LayerSpec(mixer, "dense"),) * (cfg.moe_every - 1) + \
            (LayerSpec(mixer, "moe"),)
        return [Group(pat, cfg.n_layers // cfg.moe_every)]
    return [Group((LayerSpec(mixer, "dense", window=cfg.window),),
                  cfg.n_layers)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _mlp_spec(cfg: LMConfig) -> L.MLPSpec:
    return L.MLPSpec(cfg.mlp_kind, cfg.d_model, cfg.d_ff)


def _layer_init(gen: torch.Generator, cfg: LMConfig, spec: LayerSpec,
                stack: tuple[int, ...], dev: torch.device
                ) -> tuple[dict, dict]:
    """One pattern position, stacked over ``stack``."""
    fz: dict = {}
    tr: dict = {"norm1": L.rmsnorm_init(cfg.d_model, stack, dev)}
    if spec.mixer == "gqa":
        fz["attn"], tr["attn"] = A.gqa_init(gen, cfg.gqa, "lora", cfg.lora,
                                            stack, dev)
    elif spec.mixer == "mla":
        fz["attn"], tr["attn"] = A.mla_init(gen, cfg.mla, "lora", cfg.lora,
                                            stack, dev)
    else:
        raise ValueError(spec.mixer)
    tr["norm2"] = L.rmsnorm_init(cfg.d_model, stack, dev)
    if spec.ffn == "dense":
        f, t = L.mlp_init(gen, _mlp_spec(cfg), "lora", cfg.lora, stack, dev)
        key = "mlp"
    else:
        f, t = MOE.moe_init(gen, cfg.moe, "lora", cfg.lora, stack, dev)
        key = "moe"
    if f:
        fz[key] = f
    if t:
        tr[key] = t
    return fz, tr


def init(gen, cfg: LMConfig, device="cuda") -> dict:
    """{'frozen', 'train'} on ``device`` (default: the card; raises
    without one). ``gen`` is a ``torch.Generator`` or an int seed; a
    seed draws from a generator on the card when ``device`` is one
    (a full-width model is drawn there), else on the CPU. On the
    ``meta`` device the trees hold shapes only (no allocation)."""
    _check(cfg)
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(
            device=dev if dev.type == "cuda" else "cpu").manual_seed(
                int(gen))
    frozen: dict = {}
    train: dict = {}
    # embeddings: frozen, random, shared once
    frozen["embed"] = {"w": lora._normal(gen, (cfg.vocab, cfg.d_model), 1.0,
                                         torch.bfloat16, dev)}
    hf, ht = linear_init(gen, cfg.d_model, cfg.vocab, cfg.head_mode,
                         cfg.lora, w_init_scale=cfg.d_model ** -0.5,
                         device=dev)
    if hf:
        frozen["head"] = hf
    if ht:
        train["head"] = ht
    train["final_norm"] = L.rmsnorm_init(cfg.d_model, device=dev)
    frozen["groups"] = []
    train["groups"] = []
    for g in resolve_groups(cfg):
        pairs = [_layer_init(gen, cfg, spec, (g.repeats,), dev)
                 for spec in g.pattern]
        frozen["groups"].append([f for f, _ in pairs])
        train["groups"].append([t for _, t in pairs])
    return {"frozen": frozen, "train": train}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _rope_for(cfg: LMConfig, spec: LayerSpec, positions: torch.Tensor):
    base = cfg.rope_base_global if (spec.global_rope and
                                    cfg.rope_base_global) else cfg.rope_base
    dim = cfg.mla.qk_rope_dim if spec.mixer == "mla" else cfg.head_dim
    return L.rope_for_positions(positions, dim, base)


def _at(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked group tree (views)."""
    return tree_map(lambda t: t[i], tree)


def _layers(frozen: dict, train: dict, cfg: LMConfig):
    """(group index, layer index, pattern index, spec, frozen, train) of
    every layer in order."""
    for gi, g in enumerate(resolve_groups(cfg)):
        for i in range(g.repeats):
            for pi, spec in enumerate(g.pattern):
                yield (gi, i, pi, spec, _at(frozen["groups"][gi][pi], i),
                       _at(train["groups"][gi][pi], i))


def _ffn_block(cfg: LMConfig, spec: LayerSpec, fz: dict, tr: dict,
               x: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The norm, the dense MLP or the MoE, the residual: (x, the MoE's
    aux loss, None for a dense layer)."""
    h = L.rmsnorm_apply(tr["norm2"], x)
    if spec.ffn == "dense":
        h = L.mlp_apply(fz.get("mlp", {}), tr.get("mlp", {}),
                        _mlp_spec(cfg), h, cfg.lora.scale)
        aux = None
    else:
        h, aux = MOE.moe_apply(fz.get("moe", {}), tr.get("moe", {}),
                               cfg.moe, h, cfg.lora.scale)
    return x + h, aux


def _apply_layer(cfg: LMConfig, spec: LayerSpec, fz: dict, tr: dict,
                 x: torch.Tensor, positions: torch.Tensor
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = L.rmsnorm_apply(tr["norm1"], x)
    rope = _rope_for(cfg, spec, positions)
    if spec.mixer == "mla":
        h = A.mla_apply(fz["attn"], tr["attn"], cfg.mla, h, cfg.lora.scale,
                        rope, kv_chunk=cfg.kv_chunk)
    else:
        h = A.gqa_apply(fz["attn"], tr["attn"], cfg.gqa, h, cfg.lora.scale,
                        rope, window=spec.window, causal=True,
                        kv_chunk=cfg.kv_chunk)
    return _ffn_block(cfg, spec, fz, tr, x + h)


def _embed_lookup(frozen: dict, tokens: torch.Tensor) -> torch.Tensor:
    e = frozen["embed"]
    if "w_q8" in e:
        return (e["w_q8"][tokens].to(torch.bfloat16)
                * e["w_s"].to(torch.bfloat16))
    return e["w"][tokens]


def param_device(frozen: dict) -> torch.device:
    """The device an LM's parameters lie on (its embedding's)."""
    return next(iter(frozen["embed"].values())).device


def _embed(frozen: dict, cfg: LMConfig, tokens) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, device=param_device(frozen)).to(
        torch.long)
    x = _embed_lookup(frozen, tokens)
    if cfg.embed_scale:
        x = (x.to(torch.float32) * (cfg.d_model ** 0.5)).to(x.dtype)
    return x


def _no_prefix(cfg: LMConfig, prefix_embed) -> None:
    _check(cfg)
    if prefix_embed is not None:
        raise NotImplementedError(
            f"{cfg.name}: prefix embeddings (the prefix-LM) are not ported "
            "yet (ROADMAP A9d)")


def forward(frozen: dict, train: dict, cfg: LMConfig, tokens,
            prefix_embed=None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S). Returns (hidden (B, S, d), aux loss)."""
    _no_prefix(cfg, prefix_embed)
    x = _embed(frozen, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, _, _, spec, fz, tr in _layers(frozen, train, cfg):
        if remat:
            x, a = checkpoint(_apply_layer, cfg, spec, fz, tr, x, positions,
                              use_reentrant=False)
        else:
            x, a = _apply_layer(cfg, spec, fz, tr, x, positions)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm_apply(train["final_norm"], x)
    return x, aux


def loss_fn(frozen: dict, train: dict, cfg: LMConfig,
            batch: dict) -> tuple[torch.Tensor, dict]:
    """batch: {'tokens': (B, S+1) int, optional 'loss_mask' (B, S)}."""
    _no_prefix(cfg, batch.get("prefix_embed"))
    dev = param_device(frozen)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    h, aux = forward(frozen, train, cfg, tokens[:, :-1])
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
    xent = L.chunked_xent(h, frozen.get("head", {}), train.get("head", {}),
                          tokens[:, 1:], cfg.lora.scale,
                          chunk=cfg.xent_chunk, mask=mask)
    loss = xent + 0.01 * aux
    return loss, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_init(cfg: LMConfig, batch: int, max_seq: int,
               device="cuda") -> list:
    """Stacked cache tree parallel to the groups: leaves (repeats, B,
    Smax, Hkv, Dh) bf16 for GQA, (repeats, B, Smax, kv_lora / rope) for
    MLA's latent."""
    _check(cfg)
    dev = resolve_device(device)
    out = []
    for g in resolve_groups(cfg):
        pos_caches = []
        for spec in g.pattern:
            if spec.mixer == "mla":
                c = A.mla_cache_init(cfg.mla, batch, max_seq, device="meta")
            else:
                c = A.gqa_cache_init(cfg.gqa, batch, max_seq, spec.window,
                                     device="meta")
            pos_caches.append({k: torch.zeros((g.repeats, *v.shape),
                                              dtype=v.dtype, device=dev)
                               for k, v in c.items()})
        out.append(pos_caches)
    return out


def _check_prefill_windows(cfg: LMConfig, s: int, total_seq: int) -> None:
    """A sliding-window layer given a prompt no longer than its window
    fills a cache of ``total_seq`` slots, but its ring holds
    ``min(window, total_seq)``. The JAX package fails there too (a
    dynamic_update_slice of mismatched shapes); the port says why."""
    for g in resolve_groups(cfg):
        for spec in g.pattern:
            w = spec.window
            if w is not None and s <= w < total_seq:
                raise ValueError(
                    f"prefill: a {s}-token prompt at a sliding-window "
                    f"layer (window {w}) with max_seq {total_seq}: the "
                    f"ring cache holds {w} slots but a prompt no longer "
                    "than the window fills max_seq of them. Use a prompt "
                    "longer than the window or max_seq <= window (the "
                    "JAX package cannot build this cache either)")


def _prefill_layer(cfg: LMConfig, spec: LayerSpec, fz: dict, tr: dict,
                   x: torch.Tensor, positions: torch.Tensor, max_seq: int
                   ) -> tuple[torch.Tensor, dict]:
    """Like ``_apply_layer``, and also this layer's cache."""
    sc = cfg.lora.scale
    s = x.shape[1]
    h = L.rmsnorm_apply(tr["norm1"], x)
    rope = _rope_for(cfg, spec, positions)
    if spec.mixer == "mla":
        ckv, kr = A._mla_latent(fz["attn"], tr["attn"], cfg.mla, h, sc, rope)
        hw = max(0, max_seq - s)
        cache = {"ckv": F.pad(ckv, (0, 0, 0, hw)).to(torch.bfloat16),
                 "kr": F.pad(kr, (0, 0, 0, hw)).to(torch.bfloat16)}
        x = x + A.mla_apply(fz["attn"], tr["attn"], cfg.mla, h, sc, rope,
                            kv_chunk=cfg.kv_chunk)
        return _ffn_block(cfg, spec, fz, tr, x)[0], cache
    q, k, v = A._qkv(fz["attn"], tr["attn"], cfg.gqa, h, sc, rope)
    w = spec.window
    if w is not None and w < s:
        o = L.local_attention_blocked(q, k, v, window=w)
        # the ring holds the last w tokens, token t in slot t % w
        kc = torch.roll(k[:, -w:], s % w, dims=1)
        vc = torch.roll(v[:, -w:], s % w, dims=1)
    else:
        o = L.attention_chunked(q, k, v, causal=True, kv_chunk=cfg.kv_chunk)
        hw = max(0, max_seq - s)
        kc = F.pad(k, (0, 0, 0, 0, 0, hw))
        vc = F.pad(v, (0, 0, 0, 0, 0, hw))
    cache = {"k": kc.to(torch.bfloat16), "v": vc.to(torch.bfloat16)}
    x = x + A._out(fz["attn"], tr["attn"], cfg.gqa, o, sc)
    return _ffn_block(cfg, spec, fz, tr, x)[0], cache


def _head_logits(frozen: dict, train: dict, cfg: LMConfig,
                 x: torch.Tensor) -> torch.Tensor:
    return linear_apply(frozen.get("head", {}), train.get("head", {}), x,
                        cfg.lora.scale).to(torch.float32)


def prefill(frozen: dict, train: dict, cfg: LMConfig, tokens,
            prefix_embed=None, max_seq: Optional[int] = None
            ) -> tuple[torch.Tensor, list, int]:
    """Forward over the prompt, building caches sized ``max_seq``
    (default: the prompt length; generation passes prompt + headroom).
    Returns (last logits (B, V) fp32, caches, next position)."""
    _no_prefix(cfg, prefix_embed)
    x = _embed(frozen, cfg, tokens)
    b, s, _ = x.shape
    total_seq = s if max_seq is None else max(max_seq, s)
    _check_prefill_windows(cfg, s, total_seq)
    positions = torch.arange(s, device=x.device)[None, :]
    caches = cache_init(cfg, b, total_seq, x.device)
    for gi, i, pi, spec, fz, tr in _layers(frozen, train, cfg):
        x, c = _prefill_layer(cfg, spec, fz, tr, x, positions, total_seq)
        for key, val in c.items():
            caches[gi][pi][key][i] = val
    x = L.rmsnorm_apply(train["final_norm"], x)
    return _head_logits(frozen, train, cfg, x[:, -1]), caches, s


def decode_step(frozen: dict, train: dict, cfg: LMConfig, token,
                caches: list, pos: int) -> tuple[torch.Tensor, list]:
    """token: (B, 1); pos: the absolute position of ``token`` (an int).
    Writes the new k/v (an MLA layer: the new latent) into ``caches``
    in place and returns (logits
    (B, 1, V) fp32, caches)."""
    _check(cfg)
    pos = int(pos)
    x = _embed(frozen, cfg, token)
    sc = cfg.lora.scale
    pos_b = torch.full((x.shape[0], 1), pos, device=x.device)
    for gi, i, pi, spec, fz, tr in _layers(frozen, train, cfg):
        cache = {k: v[i] for k, v in caches[gi][pi].items()}   # views
        h = L.rmsnorm_apply(tr["norm1"], x)
        rope = _rope_for(cfg, spec, pos_b)
        if spec.mixer == "mla":
            h, _ = A.mla_decode(fz["attn"], tr["attn"], cfg.mla, h, cache,
                                pos, sc, rope)
        else:
            h, _ = A.gqa_decode(fz["attn"], tr["attn"], cfg.gqa, h, cache,
                                pos, sc, rope, window=spec.window)
        x = _ffn_block(cfg, spec, fz, tr, x + h)[0]
    x = L.rmsnorm_apply(train["final_norm"], x)
    return _head_logits(frozen, train, cfg, x), caches
