"""Encoder-decoder transformer (seamless-m4t-medium backbone): the JAX
package's ``models/encdec.py``.

The audio frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, S_src, d). The encoder is a
bidirectional transformer stack; a decoder layer is causal
self-attention, cross-attention to the encoder's output and an FFN. All
projections are FLoCoRA linears (frozen bf16 base, fp32 adapters); the
norms train in fp32. Layers are stacked over a leading axis on every
leaf (``enc`` and ``dec``), so a tree initialized by the JAX package
carries across leaf by leaf (``convert.params_from_jax``). Where JAX
scans the layers, the port loops over them in Python; with
``cfg.remat`` each layer is recomputed in the backward pass
(``torch.utils.checkpoint``).

Serving: the encoder runs once; the cross-attention K/V of every decoder
layer are computed once from its output (``cross_cache``, static while
decoding) beside the self-attention cache that ``decode_step`` fills in
place, one slot a token.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import lora
from repro_torch.core.lora import LoRAConfig, linear_apply, linear_init, \
    linear_logical
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.utils import pcontext
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    mlp_kind: str = "gelu"
    rope_base: float = 1e4
    lora: LoRAConfig = LoRAConfig()
    head_mode: str = "lora"
    remat: bool = True
    kv_chunk: int = 1024
    xent_chunk: int = 512

    @property
    def gqa(self) -> A.GQASpec:
        return A.GQASpec(self.d_model, self.n_heads, self.n_kv_heads,
                         self.head_dim)

    @property
    def mlp(self) -> L.MLPSpec:
        return L.MLPSpec(self.mlp_kind, self.d_model, self.d_ff)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _enc_layer_init(gen: torch.Generator, cfg: EncDecConfig,
                    stack: tuple[int, ...], dev: torch.device
                    ) -> tuple[dict, dict]:
    fz: dict = {}
    tr: dict = {"norm1": L.rmsnorm_init(cfg.d_model, stack, dev),
                "norm2": L.rmsnorm_init(cfg.d_model, stack, dev)}
    fz["attn"], tr["attn"] = A.gqa_init(gen, cfg.gqa, "lora", cfg.lora,
                                        stack, dev)
    fz["mlp"], tr["mlp"] = L.mlp_init(gen, cfg.mlp, "lora", cfg.lora, stack,
                                      dev)
    return fz, tr


def _dec_layer_init(gen: torch.Generator, cfg: EncDecConfig,
                    stack: tuple[int, ...], dev: torch.device
                    ) -> tuple[dict, dict]:
    """An encoder layer's parameters, plus the cross-attention's norm
    (``norm_x``) and projections (``cross``)."""
    fz, tr = _enc_layer_init(gen, cfg, stack, dev)
    tr["norm_x"] = L.rmsnorm_init(cfg.d_model, stack, dev)
    fz["cross"], tr["cross"] = A.gqa_init(gen, cfg.gqa, "lora", cfg.lora,
                                          stack, dev)
    return fz, tr


def init(gen, cfg: EncDecConfig, device="cuda") -> dict:
    """{'frozen', 'train'} on ``device`` (default: the card; raises
    without one), the reference's tree: frozen ``embed``, ``head``'s
    base and the stacked ``enc``/``dec`` linears in bf16; trained
    ``final_norm``, ``enc_norm``, ``head``'s adapter and the stacked
    layers' adapters and norms in fp32. ``gen`` is a
    ``torch.Generator`` or an int seed (drawn on the card when
    ``device`` is one); on the ``meta`` device the trees hold shapes
    only."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(
            device=dev if dev.type == "cuda" else "cpu").manual_seed(
                int(gen))
    frozen: dict = {"embed": {"w": lora._normal(
        gen, (cfg.vocab, cfg.d_model), 1.0, torch.bfloat16, dev)}}
    train: dict = {"final_norm": L.rmsnorm_init(cfg.d_model, device=dev),
                   "enc_norm": L.rmsnorm_init(cfg.d_model, device=dev)}
    hf, ht = linear_init(gen, cfg.d_model, cfg.vocab, cfg.head_mode,
                         cfg.lora, w_init_scale=cfg.d_model ** -0.5,
                         device=dev)
    if hf:
        frozen["head"] = hf
    if ht:
        train["head"] = ht
    frozen["enc"], train["enc"] = _enc_layer_init(
        gen, cfg, (cfg.n_enc_layers,), dev)
    frozen["dec"], train["dec"] = _dec_layer_init(
        gen, cfg, (cfg.n_dec_layers,), dev)
    return {"frozen": frozen, "train": train}


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

def _enc_layer_logical(cfg: EncDecConfig, stack: bool) -> tuple[dict, dict]:
    """Logical annotations parallel to :func:`_enc_layer_init`'s
    trees."""
    pre = ("layers",) if stack else ()
    fz: dict = {}
    tr: dict = {"norm1": {"scale": (*pre, None)},
                "norm2": {"scale": (*pre, None)}}
    fz["attn"], tr["attn"] = A.gqa_logical(cfg.gqa, "lora", stack)
    fz["mlp"], tr["mlp"] = L.mlp_logical(cfg.mlp, "lora", stack)
    return fz, tr


def _dec_layer_logical(cfg: EncDecConfig, stack: bool) -> tuple[dict, dict]:
    """Logical annotations parallel to :func:`_dec_layer_init`'s
    trees."""
    fz, tr = _enc_layer_logical(cfg, stack)
    tr["norm_x"] = {"scale": (("layers",) if stack else ()) + (None,)}
    fz["cross"], tr["cross"] = A.gqa_logical(cfg.gqa, "lora", stack)
    return fz, tr


def logical(cfg: EncDecConfig) -> dict:
    """Logical-axis annotation trees parallel to :func:`init`'s frozen
    and train trees (``utils/sharding.py``)."""
    lf: dict = {"embed": {"w": ("vocab", "fsdp")}}
    lt: dict = {"final_norm": {"scale": (None,)},
                "enc_norm": {"scale": (None,)}}
    hlf, hlt = linear_logical("fsdp", "vocab", cfg.head_mode)
    if hlf:
        lf["head"] = hlf
    if hlt:
        lt["head"] = hlt
    lf["enc"], lt["enc"] = _enc_layer_logical(cfg, stack=True)
    lf["dec"], lt["dec"] = _dec_layer_logical(cfg, stack=True)
    return {"frozen": lf, "train": lt}


def _at(tree, i: int):
    """Layer ``i`` of a stacked tree (views)."""
    return tree_map(lambda t: t[i], tree)


def param_device(frozen: dict) -> torch.device:
    return frozen["embed"]["w"].device


def _rope(cfg: EncDecConfig, positions: torch.Tensor):
    return L.rope_for_positions(positions, cfg.head_dim, cfg.rope_base)


def _cross_apply(fz: dict, tr: dict, spec: A.GQASpec, x: torch.Tensor,
                 memory: torch.Tensor, sc: float,
                 kv_chunk: int) -> torch.Tensor:
    """Cross-attention: queries from ``x``, keys and values from
    ``memory``; no rope, no mask."""
    b, s, _ = x.shape
    dh = spec.head_dim
    # a sharded step's head block: wq its columns, wo its rows
    blk = pcontext.head_block(spec.hq)
    hq = spec.hq if blk is None else blk[1]
    if blk is not None:
        x, memory = pcontext.heads_enter(x), pcontext.heads_enter(memory)
    q = linear_apply(fz.get("wq", {}), tr.get("wq", {}), x, sc)
    k = linear_apply(fz.get("wk", {}), tr.get("wk", {}), memory, sc)
    v = linear_apply(fz.get("wv", {}), tr.get("wv", {}), memory, sc)
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, memory.shape[1], spec.n_kv_heads, dh)
    v = v.reshape(b, memory.shape[1], spec.n_kv_heads, dh)
    o = L.attention_chunked(q, k, v, causal=False, kv_chunk=kv_chunk,
                            n_heads=spec.hq)
    o = o.reshape(b, s, hq * dh)
    y = linear_apply(fz.get("wo", {}), tr.get("wo", {}), o, sc)
    return y if blk is None else pcontext.heads_exit(y)


def _same(x):
    return x


def _enc_layer(cfg: EncDecConfig, fz: dict, tr: dict, x: torch.Tensor,
               rope, constrain=_same) -> torch.Tensor:
    fz = pcontext.params(fz, cfg.gqa.hq)
    tr = pcontext.params(tr, cfg.gqa.hq)
    sc = cfg.lora.scale
    h = L.rmsnorm_apply(tr["norm1"], x)
    x = constrain(x + A.gqa_apply(fz["attn"], tr["attn"], cfg.gqa, h, sc,
                                  rope, causal=False, kv_chunk=cfg.kv_chunk))
    h = L.rmsnorm_apply(tr["norm2"], x)
    return constrain(x + L.mlp_apply(fz["mlp"], tr["mlp"], cfg.mlp, h, sc))


def _dec_layer(cfg: EncDecConfig, fz: dict, tr: dict, x: torch.Tensor,
               memory: torch.Tensor, rope, constrain=_same) -> torch.Tensor:
    fz = pcontext.params(fz, cfg.gqa.hq)
    tr = pcontext.params(tr, cfg.gqa.hq)
    sc = cfg.lora.scale
    h = L.rmsnorm_apply(tr["norm1"], x)
    x = constrain(x + A.gqa_apply(fz["attn"], tr["attn"], cfg.gqa, h, sc,
                                  rope, causal=True, kv_chunk=cfg.kv_chunk))
    h = L.rmsnorm_apply(tr["norm_x"], x)
    x = constrain(x + _cross_apply(fz["cross"], tr["cross"], cfg.gqa, h,
                                   memory, sc, cfg.kv_chunk))
    h = L.rmsnorm_apply(tr["norm2"], x)
    return constrain(x + L.mlp_apply(fz["mlp"], tr["mlp"], cfg.mlp, h, sc))


def _run(layer, cfg: EncDecConfig, n: int, fz: dict, tr: dict,
         x: torch.Tensor, *args) -> torch.Tensor:
    """``layer`` over the ``n`` stacked layers of (fz, tr), each
    recomputed in the backward pass where ``cfg.remat`` is set and
    autograd is recording."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(n):
        if remat:
            x = checkpoint(layer, cfg, _at(fz, i), _at(tr, i), x, *args,
                           use_reentrant=False)
        else:
            x = layer(cfg, _at(fz, i), _at(tr, i), x, *args)
    return x


def encode(frozen: dict, train: dict, cfg: EncDecConfig,
           src_embed, constrain=None) -> torch.Tensor:
    """src_embed: (B, S_src, d) frame embeddings. Bidirectional
    self-attention with rope over the source positions; returns the
    ``enc_norm``-ed memory (B, S_src, d) bf16. ``constrain`` is the
    residual stream's sharding constraint (the identity by default)."""
    constrain = constrain or _same
    dev = param_device(frozen)
    x = constrain(torch.as_tensor(src_embed, device=dev).to(torch.bfloat16))
    rope = _rope(cfg, torch.arange(x.shape[1], device=dev))
    x = _run(_enc_layer, cfg, cfg.n_enc_layers, frozen["enc"], train["enc"],
             x, rope, constrain)
    return L.rmsnorm_apply(train["enc_norm"], x)


def decode_train(frozen: dict, train: dict, cfg: EncDecConfig, tgt,
                 memory: torch.Tensor, constrain=None) -> torch.Tensor:
    """Teacher-forced decoder over target tokens (B, S_tgt) against the
    encoder's ``memory``; returns the ``final_norm``-ed hidden states
    (B, S_tgt, d)."""
    constrain = constrain or _same
    dev = param_device(frozen)
    tgt = torch.as_tensor(tgt, device=dev).to(torch.long)
    x = constrain(L.embed_lookup(frozen["embed"], tgt))
    rope = _rope(cfg, torch.arange(x.shape[1], device=dev))
    x = _run(_dec_layer, cfg, cfg.n_dec_layers, frozen["dec"], train["dec"],
             x, memory, rope, constrain)
    return L.rmsnorm_apply(train["final_norm"], x)


def loss_fn(frozen: dict, train: dict, cfg: EncDecConfig,
            batch: dict, constrain=None) -> tuple[torch.Tensor, dict]:
    """batch: {'src_embed': (B, S_src, d), 'tgt_tokens': (B, S_tgt + 1)}.
    Returns (mean next-token cross entropy, {'xent': the same}): no aux
    loss."""
    memory = encode(frozen, train, cfg, batch["src_embed"], constrain)
    tgt = torch.as_tensor(batch["tgt_tokens"], device=memory.device)
    h = decode_train(frozen, train, cfg, tgt[:, :-1], memory, constrain)
    xent = L.chunked_xent(h, frozen.get("head", {}), train.get("head", {}),
                          tgt[:, 1:], cfg.lora.scale, chunk=cfg.xent_chunk)
    return xent, {"xent": xent}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def cross_cache(frozen: dict, train: dict, cfg: EncDecConfig,
                memory: torch.Tensor) -> dict:
    """Every decoder layer's cross-attention K/V of ``memory``, stacked:
    {'k', 'v': (L, B, S_src, Hkv, Dh)} bf16, static while decoding."""
    sc = cfg.lora.scale
    b, s, _ = memory.shape
    shp = (b, s, cfg.gqa.n_kv_heads, cfg.head_dim)
    out: dict = {"k": [], "v": []}
    for i in range(cfg.n_dec_layers):
        fz = pcontext.params(_at(frozen["dec"]["cross"], i))
        tr = pcontext.params(_at(train["dec"]["cross"], i))
        for nm in ("k", "v"):
            out[nm].append(linear_apply(fz.get(f"w{nm}", {}),
                                        tr.get(f"w{nm}", {}), memory,
                                        sc).reshape(shp))
    return {nm: torch.stack(v) for nm, v in out.items()}


def self_cache_init(cfg: EncDecConfig, batch: int, max_seq: int,
                    device="cuda") -> dict:
    """The decoder's self-attention caches, zeros: {'k', 'v': (L, B,
    max_seq, Hkv, Dh)} bf16, written in place by ``decode_step``."""
    c = A.gqa_cache_init(cfg.gqa, batch, max_seq, device="meta")
    dev = resolve_device(device)
    return {k: torch.zeros((cfg.n_dec_layers, *v.shape), dtype=v.dtype,
                           device=dev) for k, v in c.items()}


def decode_step(frozen: dict, train: dict, cfg: EncDecConfig, token,
                self_caches: dict, cross_caches: dict,
                pos: int) -> tuple[torch.Tensor, dict]:
    """token: (B, 1); pos: its absolute position (an int). Writes the new
    self-attention k/v into ``self_caches`` in place; cross-attention
    reads the whole of ``cross_caches``. Returns (logits (B, 1, V) fp32,
    self_caches)."""
    pos = int(pos)
    dev = param_device(frozen)
    token = torch.as_tensor(token, device=dev).to(torch.long)
    x = L.embed_lookup(frozen["embed"], token)
    sc = cfg.lora.scale
    spec = cfg.gqa
    b = x.shape[0]
    rope = _rope(cfg, torch.full((b, 1), pos, device=dev))
    for i in range(cfg.n_dec_layers):
        fz = pcontext.params(_at(frozen["dec"], i))
        tr = pcontext.params(_at(train["dec"], i))
        cache, put_back = pcontext.layer_cache(self_caches, i)   # views
        h = L.rmsnorm_apply(tr["norm1"], x)
        h, _ = A.gqa_decode(fz["attn"], tr["attn"], spec, h, cache, pos, sc,
                            rope)
        put_back()
        x = x + h
        h = L.rmsnorm_apply(tr["norm_x"], x)
        q = linear_apply(fz["cross"].get("wq", {}), tr["cross"].get("wq", {}),
                         h, sc).reshape(b, 1, spec.hq, cfg.head_dim)
        cross, _ = pcontext.layer_cache(cross_caches, i)   # read only
        xk, xv = cross["k"], cross["v"]
        blk = pcontext.seq_block(xk)
        o = L.decode_attention(q, xk, xv,
                               xk.shape[1] if blk is None else blk.total)
        o = o.reshape(b, 1, spec.hq * cfg.head_dim)
        x = x + linear_apply(fz["cross"].get("wo", {}),
                             tr["cross"].get("wo", {}), o, sc)
        h = L.rmsnorm_apply(tr["norm2"], x)
        x = x + L.mlp_apply(fz["mlp"], tr["mlp"], cfg.mlp, h, sc)
    x = L.rmsnorm_apply(train["final_norm"], x)
    logits = L.head_logits(frozen.get("head", {}), train.get("head", {}), x,
                           sc)
    return logits, self_caches
