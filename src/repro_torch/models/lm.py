"""Decoder LM: the JAX package's ``models/lm.py`` for the dense family
(gemma3-4b, minitron-4b, qwen1.5-110b, nemotron-4-340b), the MLA and
MoE layers (deepseek-v2-236b, llama4-maverick-400b-a17b), the Mamba-2
layers with zamba2's shared attention (mamba2-370m, zamba2-2.7b) and the
prefix-LM (paligemma-3b). The encoder-decoder (seamless-m4t-medium) is
``models/encdec.py``.

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
layer adds its Switch aux loss to ``forward``'s second output. A Mamba
layer (no FFN, no norm2) keeps an fp32 SSM state and the last K - 1
conv inputs. zamba2's shared attention block has ONE frozen GQA set
(``frozen['shared_attn']``) used at every invocation, with the
invocation's own stacked adapters, gelu MLP and KV cache.

The prefix-LM takes ``prefix_embed`` (B, P, d), precomputed patch
embeddings (the image frontend is a stub, as in the reference), and puts
them before the text: positions and rope run over all P + S tokens, and
attention is bidirectional within the first P. ``embed_scale`` applies
to the text embeddings only. As in the reference, ``forward`` (and so
``loss_fn``) without ``prefix_embed`` makes the first ``cfg.prefix_len``
TEXT tokens bidirectional, while ``prefill`` without it is causal
throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import lora
from repro_torch.core.lora import LoRAConfig, linear_init, linear_logical
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.encdec import EncDecConfig
from repro_torch.utils import pcontext
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
    """Refuse an encoder-decoder config: its functions are
    ``models/encdec.py``'s."""
    if isinstance(cfg, EncDecConfig):
        raise TypeError(f"{cfg.name} is an encoder-decoder model: use "
                        "repro_torch.models.encdec")


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
    """One pattern position, stacked over ``stack``. A ``shared_gqa``
    position keeps only its adapters: its frozen base is the model's one
    ``frozen['shared_attn']`` (the reference draws one here and drops
    it, as this does)."""
    fz: dict = {}
    tr: dict = {"norm1": L.rmsnorm_init(cfg.d_model, stack, dev)}
    if spec.mixer in ("gqa", "shared_gqa"):
        f, tr["attn"] = A.gqa_init(gen, cfg.gqa, "lora", cfg.lora, stack,
                                   dev)
        if spec.mixer == "gqa":
            fz["attn"] = f
    elif spec.mixer == "mla":
        fz["attn"], tr["attn"] = A.mla_init(gen, cfg.mla, "lora", cfg.lora,
                                            stack, dev)
    elif spec.mixer == "mamba":
        fz["mix"], tr["mix"] = SSM.mamba_init(gen, cfg.mamba, "lora",
                                              cfg.lora, stack, dev)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn == "none":
        return fz, tr
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


def _layer_logical(cfg: LMConfig, spec: LayerSpec, stack: bool
                   ) -> tuple[dict, dict]:
    """Logical annotations parallel to :func:`_layer_init`'s trees."""
    pre = ("layers",) if stack else ()
    fz: dict = {}
    tr: dict = {"norm1": {"scale": (*pre, None)}}
    if spec.mixer in ("gqa", "shared_gqa"):
        f, t = A.gqa_logical(cfg.gqa, "lora", stack)
        tr["attn"] = t
        if spec.mixer == "gqa":
            fz["attn"] = f
    elif spec.mixer == "mla":
        fz["attn"], tr["attn"] = A.mla_logical(cfg.mla, "lora", stack)
    elif spec.mixer == "mamba":
        fz["mix"], tr["mix"] = SSM.mamba_logical(cfg.mamba, "lora", stack)
    if spec.ffn == "dense":
        tr["norm2"] = {"scale": (*pre, None)}
        f, t = L.mlp_logical(_mlp_spec(cfg), "lora", stack)
        if f:
            fz["mlp"] = f
        if t:
            tr["mlp"] = t
    elif spec.ffn == "moe":
        tr["norm2"] = {"scale": (*pre, None)}
        f, t = MOE.moe_logical(cfg.moe, "lora", stack)
        if f:
            fz["moe"] = f
        if t:
            tr["moe"] = t
    return fz, tr


def logical(cfg: LMConfig) -> dict:
    """Logical-axis annotation trees parallel to :func:`init`'s frozen
    and train trees: pure Python (no tensors), for
    ``utils/sharding.py``."""
    groups = resolve_groups(cfg)
    lf: dict = {"embed": {"w": ("vocab", "fsdp")}}
    lt: dict = {"final_norm": {"scale": (None,)}}
    hlf, hlt = linear_logical("fsdp", "vocab", cfg.head_mode)
    if hlf:
        lf["head"] = hlf
    if hlt:
        lt["head"] = hlt
    if any(s.mixer == "shared_gqa" for g in groups for s in g.pattern):
        lf["shared_attn"], _ = A.gqa_logical(cfg.gqa, "lora", stack=False)
    lf["groups"] = []
    lt["groups"] = []
    for g in groups:
        pairs = [_layer_logical(cfg, spec, stack=True) for spec in g.pattern]
        lf["groups"].append([f for f, _ in pairs])
        lt["groups"].append([t for _, t in pairs])
    return {"frozen": lf, "train": lt}


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
    groups = resolve_groups(cfg)
    if any(s.mixer == "shared_gqa" for g in groups for s in g.pattern):
        frozen["shared_attn"], _ = A.gqa_init(gen, cfg.gqa, "lora",
                                              cfg.lora, device=dev)
    frozen["groups"] = []
    train["groups"] = []
    for g in groups:
        pairs = [_layer_init(gen, cfg, spec, (g.repeats,), dev)
                 for spec in g.pattern]
        frozen["groups"].append([f for f, _ in pairs])
        train["groups"].append([t for _, t in pairs])
    return {"frozen": frozen, "train": train}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _rope_for(cfg: LMConfig, spec: LayerSpec, positions: torch.Tensor):
    if spec.mixer == "mamba":
        return None
    base = cfg.rope_base_global if (spec.global_rope and
                                    cfg.rope_base_global) else cfg.rope_base
    dim = cfg.mla.qk_rope_dim if spec.mixer == "mla" else cfg.head_dim
    return L.rope_for_positions(positions, dim, base)


def _at(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked group tree (views)."""
    return tree_map(lambda t: t[i], tree)


def _layers(frozen: dict, train: dict, cfg: LMConfig):
    """(group index, layer index, pattern index, spec, frozen, train) of
    every layer in order. A ``shared_gqa`` layer's frozen dict holds the
    shared block as its ``attn``, beside its own MLP."""
    for gi, g in enumerate(resolve_groups(cfg)):
        for i in range(g.repeats):
            for pi, spec in enumerate(g.pattern):
                fz = _at(frozen["groups"][gi][pi], i)
                if spec.mixer == "shared_gqa":
                    fz = dict(fz, attn=frozen["shared_attn"])
                yield (gi, i, pi, spec, fz, _at(train["groups"][gi][pi], i))


def _same(x):
    return x


def _ffn_block(cfg: LMConfig, spec: LayerSpec, fz: dict, tr: dict,
               x: torch.Tensor, constrain=_same
               ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The residual constraint on ``x`` (the mixer's residual sum), then
    the norm, the dense MLP or the MoE and the residual: (x, the MoE's
    aux loss, None for a dense layer). A layer without an FFN returns
    ``x`` as it is."""
    x = constrain(x)
    if spec.ffn == "none":
        return x, None
    h = L.rmsnorm_apply(tr["norm2"], x)
    if spec.ffn == "dense":
        h = L.mlp_apply(fz.get("mlp", {}), tr.get("mlp", {}),
                        _mlp_spec(cfg), h, cfg.lora.scale)
        aux = None
    else:
        h, aux = MOE.moe_apply(fz.get("moe", {}), tr.get("moe", {}),
                               cfg.moe, h, cfg.lora.scale)
    return constrain(x + h), aux


def _whole_seq_layer(spec: LayerSpec) -> bool:
    """A layer without a sequence-parallel form: sliding-window
    attention, Mamba (a scan over the sequence)."""
    return spec.mixer == "mamba" or spec.window is not None


def _n_heads(cfg: LMConfig, spec: LayerSpec) -> int:
    """The (padded) query heads of a layer's attention, or the heads of
    its Mamba mixer."""
    if spec.mixer == "mamba":
        return cfg.mamba.n_heads
    return cfg.mla.n_heads if spec.mixer == "mla" else cfg.gqa.hq


def _split_heads(cfg: LMConfig, spec: LayerSpec) -> bool:
    """Whether a sequence-parallel step runs this whole-sequence layer's
    mixer (sliding-window attention, Mamba) on its head block of the
    whole sequence (then its output is reduce-scattered onto the
    sequence block and its FFN runs on the block), rather than the whole
    layer on the whole sequence."""
    with pcontext.whole_seq():
        if spec.mixer == "mamba":
            return pcontext.ssm_block(_n_heads(cfg, spec)) is not None
        return pcontext.head_block(_n_heads(cfg, spec)) is not None


def _apply_layer(cfg: LMConfig, spec: LayerSpec, fz: dict, tr: dict,
                 x: torch.Tensor, positions: torch.Tensor,
                 prefix_len: Optional[torch.Tensor] = None,
                 constrain=_same
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    heads = _n_heads(cfg, spec)
    if pcontext.seq_split() and _whole_seq_layer(spec):
        # sequence parallelism: the whole sequence, then this block
        xf = pcontext.seq_gather(x)
        split = _split_heads(cfg, spec)
        with pcontext.whole_seq():
            fz, tr = pcontext.params(fz, heads), pcontext.params(tr, heads)
            pf = torch.arange(xf.shape[1], device=xf.device)[None, :]
            if split:
                h = _mixer(cfg, spec, fz, tr, xf, pf, prefix_len)
            else:
                y, aux = _layer_body(cfg, spec, fz, tr, xf, pf, prefix_len,
                                     constrain)
        if split:
            return _ffn_block(cfg, spec, fz, tr, x + h, constrain)
        return pcontext.seq_slice(y), aux
    fz, tr = pcontext.params(fz, heads), pcontext.params(tr, heads)
    return _layer_body(cfg, spec, fz, tr, x, positions, prefix_len,
                       constrain)


def _mixer(cfg: LMConfig, spec: LayerSpec, fz: dict, tr: dict,
           x: torch.Tensor, positions: torch.Tensor,
           prefix_len: Optional[torch.Tensor]) -> torch.Tensor:
    """The norm and the mixer: the residual branch before the FFN."""
    h = L.rmsnorm_apply(tr["norm1"], x)
    rope = _rope_for(cfg, spec, positions)
    if spec.mixer == "mamba":
        return SSM.mamba_apply(fz["mix"], tr["mix"], cfg.mamba, h,
                               cfg.lora.scale)
    if spec.mixer == "mla":
        return A.mla_apply(fz["attn"], tr["attn"], cfg.mla, h,
                           cfg.lora.scale, rope, kv_chunk=cfg.kv_chunk)
    return A.gqa_apply(fz["attn"], tr["attn"], cfg.gqa, h, cfg.lora.scale,
                       rope, window=spec.window, causal=True,
                       prefix_len=prefix_len, kv_chunk=cfg.kv_chunk)


def _layer_body(cfg: LMConfig, spec: LayerSpec, fz: dict, tr: dict,
                x: torch.Tensor, positions: torch.Tensor,
                prefix_len: Optional[torch.Tensor], constrain
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = _mixer(cfg, spec, fz, tr, x, positions, prefix_len)
    return _ffn_block(cfg, spec, fz, tr, x + h, constrain)


def param_device(frozen: dict) -> torch.device:
    """The device an LM's parameters lie on (its embedding's)."""
    return next(iter(frozen["embed"].values())).device


def _embed(frozen: dict, cfg: LMConfig, tokens) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, device=param_device(frozen)).to(
        torch.long)
    x = L.embed_lookup(frozen["embed"], tokens)
    if cfg.embed_scale:
        x = (x.to(torch.float32) * (cfg.d_model ** 0.5)).to(x.dtype)
    return x


def _with_prefix(x: torch.Tensor, prefix_embed
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The text embeddings ``x`` with ``prefix_embed`` (B, P, d), cast
    to their dtype, put before them, and the (B,) prefix length P; ``x``
    and None without a prefix."""
    if prefix_embed is None:
        return x, None
    pe = torch.as_tensor(prefix_embed, device=x.device)
    x = torch.cat([pe.to(x.dtype), x], dim=1)
    return x, torch.full((x.shape[0],), pe.shape[1], dtype=torch.int32,
                         device=x.device)


def forward(frozen: dict, train: dict, cfg: LMConfig, tokens,
            prefix_embed=None, constrain=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S); prefix_embed: optional (B, P, d), put before the
    text; ``constrain``: the residual stream's sharding constraint (the
    identity by default). Returns (hidden (B, P + S, d), aux loss)."""
    _check(cfg)
    constrain = constrain or _same
    x, prefix_len = _with_prefix(_embed(frozen, cfg, tokens), prefix_embed)
    x = constrain(x)
    if prefix_len is None and cfg.prefix_lm and cfg.prefix_len:
        # the reference's fallback: the first cfg.prefix_len TEXT tokens
        # attend both ways. prefill has none (module docstring).
        prefix_len = torch.full((x.shape[0],), cfg.prefix_len,
                                dtype=torch.int32, device=x.device)
    # sequence parallelism: this rank's block of the residual stream
    x = pcontext.seq_slice(x)
    positions = (torch.arange(x.shape[1], device=x.device)
                 + pcontext.seq_offset())[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, _, _, spec, fz, tr in _layers(frozen, train, cfg):
        if remat:
            x, a = checkpoint(_apply_layer, cfg, spec, fz, tr, x, positions,
                              prefix_len, constrain, use_reentrant=False)
        else:
            x, a = _apply_layer(cfg, spec, fz, tr, x, positions, prefix_len,
                                constrain)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm_apply(train["final_norm"], x)
    return x, aux


def loss_fn(frozen: dict, train: dict, cfg: LMConfig,
            batch: dict, constrain=None) -> tuple[torch.Tensor, dict]:
    """batch: {'tokens': (B, S+1) int, optional 'prefix_embed' (B, P, d),
    optional 'loss_mask' (B, S) over the text labels}."""
    dev = param_device(frozen)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    prefix_embed = batch.get("prefix_embed")
    h, aux = forward(frozen, train, cfg, tokens[:, :-1], prefix_embed,
                     constrain)
    if prefix_embed is not None:
        h = h[:, prefix_embed.shape[1]:]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = pcontext.seq_slice(torch.as_tensor(mask, device=dev))
    xent = L.chunked_xent(h, frozen.get("head", {}), train.get("head", {}),
                          pcontext.seq_slice(tokens[:, 1:]), cfg.lora.scale,
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
    MLA's latent, a Mamba layer's fp32 {'ssm': (repeats, B, H, P, N),
    'conv': (repeats, B, K-1, C)}."""
    _check(cfg)
    dev = resolve_device(device)
    out = []
    for g in resolve_groups(cfg):
        pos_caches = []
        for spec in g.pattern:
            if spec.mixer == "mla":
                c = A.mla_cache_init(cfg.mla, batch, max_seq, device="meta")
            elif spec.mixer == "mamba":
                c = SSM.mamba_cache_init(cfg.mamba, batch, device="meta")
            else:
                c = A.gqa_cache_init(cfg.gqa, batch, max_seq, spec.window,
                                     device="meta")
            # a sharded prefill's rank allocates its own block only
            pos_caches.append({k: torch.zeros(pcontext.constrain(
                torch.empty((g.repeats, *v.shape), device="meta"),
                "cache_stack").shape, dtype=v.dtype, device=dev)
                for k, v in c.items()})
        out.append(pos_caches)
    return out


def _layer_cache_logical(cfg: LMConfig, spec: LayerSpec) -> dict:
    """A layer's cache annotations with the leading layer-stack axis."""
    if spec.mixer in ("gqa", "shared_gqa"):
        base = A.gqa_cache_logical()
    elif spec.mixer == "mla":
        base = A.mla_cache_logical()
    else:
        base = SSM.mamba_cache_logical()
    return {k: ("layers",) + t for k, t in base.items()}


def cache_logical(cfg: LMConfig) -> list:
    """Logical annotations parallel to :func:`cache_init`'s tree."""
    return [[_layer_cache_logical(cfg, spec) for spec in g.pattern]
            for g in resolve_groups(cfg)]


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


def _check_prefill_mamba(cfg: LMConfig, s: int) -> None:
    """The Mamba layers' two prompt-length rules
    (``ssm.check_final_state``)."""
    if any(spec.mixer == "mamba" for g in resolve_groups(cfg)
           for spec in g.pattern):
        SSM.check_final_state(cfg.mamba, s)


def _prefill_layer(cfg: LMConfig, spec: LayerSpec, fz: dict, tr: dict,
                   x: torch.Tensor, positions: torch.Tensor, max_seq: int,
                   prefix_len: Optional[torch.Tensor] = None,
                   constrain=_same) -> tuple[torch.Tensor, dict]:
    """Like ``_apply_layer``, and also this layer's cache. A
    sliding-window layer ignores ``prefix_len``, as in the reference."""
    heads = _n_heads(cfg, spec)
    if pcontext.seq_split() and _whole_seq_layer(spec):
        # sequence parallelism: the whole sequence, then this block
        xf = pcontext.seq_gather(x)
        split = _split_heads(cfg, spec)
        with pcontext.whole_seq():
            fz, tr = pcontext.params(fz, heads), pcontext.params(tr, heads)
            pf = torch.arange(xf.shape[1], device=xf.device)[None, :]
            if split:
                h, cache = _prefill_mixer(cfg, spec, fz, tr, xf, pf,
                                          max_seq, prefix_len)
            else:
                y, cache = _prefill_body(cfg, spec, fz, tr, xf, pf, max_seq,
                                         prefix_len, constrain)
        if split:
            return _ffn_block(cfg, spec, fz, tr, x + h, constrain)[0], cache
        return pcontext.seq_slice(y), cache
    fz, tr = pcontext.params(fz, heads), pcontext.params(tr, heads)
    return _prefill_body(cfg, spec, fz, tr, x, positions, max_seq,
                         prefix_len, constrain)


def _prefill_body(cfg: LMConfig, spec: LayerSpec, fz: dict, tr: dict,
                  x: torch.Tensor, positions: torch.Tensor, max_seq: int,
                  prefix_len: Optional[torch.Tensor], constrain
                  ) -> tuple[torch.Tensor, dict]:
    h, cache = _prefill_mixer(cfg, spec, fz, tr, x, positions, max_seq,
                              prefix_len)
    return _ffn_block(cfg, spec, fz, tr, x + h, constrain)[0], cache


def _prefill_mixer(cfg: LMConfig, spec: LayerSpec, fz: dict, tr: dict,
                   x: torch.Tensor, positions: torch.Tensor, max_seq: int,
                   prefix_len: Optional[torch.Tensor]
                   ) -> tuple[torch.Tensor, dict]:
    """A layer's norm and mixer over the prompt, and its cache: (the
    residual branch, cache)."""
    sc = cfg.lora.scale
    h = L.rmsnorm_apply(tr["norm1"], x)
    if spec.mixer == "mamba":
        # the SSD over the prompt; its recurrence's last state and the
        # last K - 1 pre-conv inputs are the decode cache
        return SSM.mamba_forward(fz["mix"], tr["mix"], cfg.mamba, h, sc,
                                 final_state=True)
    rope = _rope_for(cfg, spec, positions)
    if spec.mixer == "mla":
        ckv, kr = A._mla_latent(fz["attn"], tr["attn"], cfg.mla, h, sc, rope)
        # sequence parallelism: the cache holds every position
        ckv, kr = pcontext.seq_gather(ckv), pcontext.seq_gather(kr)
        hw = max(0, max_seq - ckv.shape[1])
        cache = {"ckv": pcontext.constrain(
            F.pad(ckv, (0, 0, 0, hw)).to(torch.bfloat16), "cache3"),
            "kr": pcontext.constrain(
            F.pad(kr, (0, 0, 0, hw)).to(torch.bfloat16), "cache3")}
        return A.mla_apply(fz["attn"], tr["attn"], cfg.mla, h, sc, rope,
                           kv_chunk=cfg.kv_chunk), cache
    q, k, v = A._qkv(fz["attn"], tr["attn"], cfg.gqa, h, sc, rope)
    s = x.shape[1]
    w = spec.window
    if w is not None and w < s:
        o = L.local_attention_blocked(q, k, v, window=w, n_heads=cfg.gqa.hq)
        # the ring holds the last w tokens, token t in slot t % w
        kc = torch.roll(k[:, -w:], s % w, dims=1)
        vc = torch.roll(v[:, -w:], s % w, dims=1)
    else:
        # sequence parallelism: this block's queries, every key; the
        # cache holds every position
        k, v = pcontext.seq_gather(k), pcontext.seq_gather(v)
        o = L.attention_chunked(q, k, v, causal=True, prefix_len=prefix_len,
                                kv_chunk=cfg.kv_chunk,
                                q_offset=pcontext.seq_offset(),
                                n_heads=cfg.gqa.hq)
        hw = max(0, max_seq - k.shape[1])
        kc = F.pad(k, (0, 0, 0, 0, 0, hw))
        vc = F.pad(v, (0, 0, 0, 0, 0, hw))
    cache = {"k": pcontext.constrain(kc.to(torch.bfloat16), "cache4"),
             "v": pcontext.constrain(vc.to(torch.bfloat16), "cache4")}
    return A._out(fz["attn"], tr["attn"], cfg.gqa, o, sc), cache


def _head_logits(frozen: dict, train: dict, cfg: LMConfig,
                 x: torch.Tensor) -> torch.Tensor:
    return L.head_logits(frozen.get("head", {}), train.get("head", {}), x,
                         cfg.lora.scale)


def prefill(frozen: dict, train: dict, cfg: LMConfig, tokens,
            prefix_embed=None, max_seq: Optional[int] = None,
            constrain=None) -> tuple[torch.Tensor, list, int]:
    """Forward over the prompt, after ``prefix_embed`` (B, P, d) where
    given, building caches sized ``max_seq`` (default: P + the prompt
    length; generation passes prompt + headroom). Without
    ``prefix_embed`` attention is causal throughout, even for a
    prefix-LM (the reference's prefill has no ``cfg.prefix_len``
    fallback). Returns (last logits (B, V) fp32, caches, next position
    P + S). ``constrain`` is the residual stream's sharding constraint
    (the identity by default)."""
    _check(cfg)
    constrain = constrain or _same
    x, prefix_len = _with_prefix(_embed(frozen, cfg, tokens), prefix_embed)
    x = constrain(x)
    b, s, _ = x.shape
    total_seq = s if max_seq is None else max(max_seq, s)
    _check_prefill_windows(cfg, s, total_seq)
    _check_prefill_mamba(cfg, s)
    # sequence parallelism: this rank's block of the residual stream
    x = pcontext.seq_slice(x)
    positions = (torch.arange(x.shape[1], device=x.device)
                 + pcontext.seq_offset())[None, :]
    caches = cache_init(cfg, b, total_seq, x.device)
    for gi, i, pi, spec, fz, tr in _layers(frozen, train, cfg):
        x, c = _prefill_layer(cfg, spec, fz, tr, x, positions, total_seq,
                              prefix_len, constrain)
        for key, val in c.items():
            # the layer's cache takes the stack's layout (a Mamba state
            # of a head block has it already)
            dst = caches[gi][pi][key]
            if val.shape != dst.shape[1:]:
                val = pcontext.constrain(val[None], "cache_stack")[0]
            dst[i] = val
    x = L.rmsnorm_apply(train["final_norm"], x)
    # the last position (under sequence parallelism, the last block's)
    last = pcontext.seq_gather(x[:, -1:])[:, -1]
    return _head_logits(frozen, train, cfg, last), caches, s


def decode_step(frozen: dict, train: dict, cfg: LMConfig, token,
                caches: list, pos: int) -> tuple[torch.Tensor, list]:
    """token: (B, 1); pos: the absolute position of ``token`` (an int).
    Writes the new k/v (an MLA layer: the new latent; a Mamba layer: its
    new states) into ``caches`` in place and returns (logits (B, 1, V)
    fp32, caches)."""
    _check(cfg)
    pos = int(pos)
    x = _embed(frozen, cfg, token)
    sc = cfg.lora.scale
    pos_b = torch.full((x.shape[0], 1), pos, device=x.device)
    for gi, i, pi, spec, fz, tr in _layers(frozen, train, cfg):
        heads = _n_heads(cfg, spec)     # a Mamba mixer's may split
        fz, tr = pcontext.params(fz, heads), pcontext.params(tr, heads)
        cache, put_back = pcontext.layer_cache(caches[gi][pi], i)  # views
        h = L.rmsnorm_apply(tr["norm1"], x)
        rope = _rope_for(cfg, spec, pos_b)
        if spec.mixer == "mamba":
            h, new = SSM.mamba_decode(fz["mix"], tr["mix"], cfg.mamba, h,
                                      cache, sc)
            for k, v in new.items():        # the bf16 conv state widens
                cache[k].copy_(v)
        elif spec.mixer == "mla":
            h, _ = A.mla_decode(fz["attn"], tr["attn"], cfg.mla, h, cache,
                                pos, sc, rope)
        else:
            h, _ = A.gqa_decode(fz["attn"], tr["attn"], cfg.gqa, h, cache,
                                pos, sc, rope, window=spec.window)
        put_back()
        x = _ffn_block(cfg, spec, fz, tr, x + h)[0]
    x = L.rmsnorm_apply(train["final_norm"], x)
    return _head_logits(frozen, train, cfg, x), caches
