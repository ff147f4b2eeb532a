"""Mixture-of-Experts layer with sort-based static-capacity dispatch, as in
the JAX package's ``models/moe.py``.

Tokens are sorted by expert id (a STABLE sort: which tokens fall past an
expert's capacity depends on that order) into a static (E, C, d) buffer,
giving one batched product a weight over the expert axis. Capacity
C = ceil(T·k/E · capacity_factor) rounded up to 8.

The reference scatters every token into the buffer, its dropped ones
into a drop row C that is sliced away, and sums each token's k
contributions with one scatter-add. On the card a scatter over
colliding rows lands in a run-dependent order, so the port GATHERS
instead: buffer row (e, c) reads the token at sorted position
``offset[e] + c``, and the combine folds a token's k contributions one
slot at a time in ascending expert order, the order in which the
reference's sorted updates reach each token. No index collides, and the
result is bit-identical from run to run.

Experts are FLoCoRA targets: frozen (E, d, f) banks with stacked
per-expert adapters (E, d, r) / (E, r, f). The router trains dense in
fp32; shared experts are one wide MLP.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import lora
from repro_torch.core.lora import LoRAConfig, frozen_weight, linear_init
from repro_torch.models.layers import MLPSpec, _maybe_remat, mlp_apply, \
    mlp_init
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0         # shared experts (fused into one wide MLP)
    capacity_factor: float = 1.25
    mlp_kind: str = "swiglu"
    # dispatch token-chunking: bounds the (E, C, d) dispatch buffer
    max_chunk_tokens: int = 65536


def _cap(spec: MoESpec, tokens: int) -> int:
    c = int(tokens * spec.top_k * spec.capacity_factor / spec.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def _bank_names(spec: MoESpec) -> list[str]:
    return ["wi", "wg", "wo"] if spec.mlp_kind in ("swiglu", "geglu") \
        else ["wi", "wo"]


def _shared_spec(spec: MoESpec) -> MLPSpec:
    return MLPSpec(spec.mlp_kind, spec.d_model, spec.d_ff * spec.n_shared)


def moe_init(gen: torch.Generator, spec: MoESpec, mode: str,
             lora_cfg: LoRAConfig, stack: tuple[int, ...] = (),
             device="cuda") -> tuple[dict, dict]:
    """The router (fp32, trained dense), the banks ``(*stack, E, d, f)``
    with their per-expert adapters, and the shared experts; drawn in the
    JAX package's order."""
    dev = resolve_device(device)
    e = spec.n_experts
    fz, tr = {}, {}
    tr["router"] = {"w": lora._normal(gen, (*stack, spec.d_model, e),
                                      spec.d_model ** -0.5, torch.float32,
                                      dev)}
    dims = {"wi": (spec.d_model, spec.d_ff), "wg": (spec.d_model, spec.d_ff),
            "wo": (spec.d_ff, spec.d_model)}
    for nm in _bank_names(spec):
        f, t = linear_init(gen, *dims[nm], mode, lora_cfg, stack=(*stack, e),
                           device=dev)
        if f:
            fz[nm] = f
        if t:
            tr[nm] = t
    if spec.n_shared:
        sfz, str_ = mlp_init(gen, _shared_spec(spec), mode, lora_cfg, stack,
                             device=dev)
        if sfz:
            fz["shared"] = sfz
        if str_:
            tr["shared"] = str_
    return fz, tr


def _expert_ffn(fz: dict, tr: dict, spec: MoESpec, buf: torch.Tensor,
                lora_scale: float) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d), batched over experts in bf16."""
    bf = torch.bfloat16

    def bank(nm, x):
        if nm in fz and ("w" in fz[nm] or "w_q8" in fz[nm]):
            w = frozen_weight(fz[nm])
        else:
            w = tr[nm]["w"].to(bf)
        y = torch.bmm(x.to(bf), w)
        t = tr.get(nm, {})
        if "a" in t:
            h = torch.bmm(x.to(bf), t["a"].to(bf))
            y = y + lora_scale * torch.bmm(h, t["b"].to(bf))
        return y

    if spec.mlp_kind == "swiglu":
        h = F.silu(bank("wg", buf).to(torch.float32)).to(buf.dtype) \
            * bank("wi", buf)
    elif spec.mlp_kind == "geglu":
        h = F.gelu(bank("wg", buf).to(torch.float32),
                   approximate="tanh").to(buf.dtype) * bank("wi", buf)
    elif spec.mlp_kind == "sqrelu":
        h = F.relu(bank("wi", buf))
        h = h * h
    elif spec.mlp_kind == "gelu":
        # jax.nn.gelu's default is approximate=True: the tanh form
        h = F.gelu(bank("wi", buf).to(torch.float32),
                   approximate="tanh").to(buf.dtype)
    else:
        raise ValueError(spec.mlp_kind)
    return bank("wo", h)


def expert_counts(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Pairs routed to each expert (int64; integer adds, so exact in any
    order, and no host sync as ``torch.bincount`` has on the card)."""
    return torch.zeros(n_experts, dtype=torch.long,
                       device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))


def dispatch_plan(spec: MoESpec, idx: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Where each of a chunk's (token, slot) pairs goes. idx: (t, k)
    expert ids. Returns (pos (t, k): the pair's row in its expert's
    buffer, ``>= cap`` where it is dropped; src (E, cap): the token
    filling buffer row (e, c), ``-1`` where the row is empty; cap)."""
    t, k = idx.shape
    e = spec.n_experts
    dev = idx.device
    flat_e = idx.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    counts = expert_counts(flat_e, e)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(t * k, device=dev) - offsets[flat_e[order]]
    cap = _cap(spec, t)
    slot = offsets[:, None] + torch.arange(cap, device=dev)[None, :]
    full = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    src = torch.where(full, order[slot.clamp(max=t * k - 1)] // k, -1)
    return pos.reshape(t, k), src, cap


def _dispatch_chunk(fz: dict, tr: dict, spec: MoESpec, xt: torch.Tensor,
                    gates: torch.Tensor, idx: torch.Tensor,
                    lora_scale: float) -> torch.Tensor:
    """Sort-dispatch one token chunk through the expert banks.
    xt: (t, d); gates, idx: (t, k). Returns (t, d) in xt's dtype."""
    t, d = xt.shape
    pos, src, cap = dispatch_plan(spec, idx)
    full = (src >= 0)[..., None]
    buf = torch.where(full, xt[src.clamp(min=0)], 0)
    out = _expert_ffn(fz, tr, spec, buf, lora_scale)
    out = F.pad(out, (0, 0, 0, 1))                  # row cap: dropped
    keep = pos < cap
    w = (gates * keep).to(out.dtype)                # (t, k)
    rows = out[idx, pos.clamp(max=cap)]             # (t, k, d)
    # fold the k slots one at a time, each token's in ascending expert
    # order (the reference's sorted scatter-add order): no collisions
    slot_order = torch.argsort(idx, dim=1, stable=True)
    ar = torch.arange(t, device=xt.device)
    y = torch.zeros((t, d), dtype=out.dtype, device=xt.device)
    for j in range(spec.top_k):
        sj = slot_order[:, j]
        y = y + rows[ar, sj] * w[ar, sj][:, None]
    return y


def route(tr: dict, spec: MoESpec, xt: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fp32 router over tokens xt (T, d): (gates (T, k) renormalized,
    idx (T, k), probs (T, E)). Top-k ties go to the lower expert index,
    as ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    logits = xt.to(torch.float32) @ tr["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, : spec.top_k], order[:, : spec.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def n_chunks_for(spec: MoESpec, t: int) -> int:
    n = max(1, -(-t // spec.max_chunk_tokens))
    while t % n:
        n += 1
    return n


def moe_apply(fz: dict, tr: dict, spec: MoESpec, x: torch.Tensor,
              lora_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (y (B, S, d), the Switch aux loss
    E·Σ_e f_e·P_e). Tokens dispatch in ``max_chunk_tokens`` chunks, each
    recomputed in the backward pass."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gates, idx, probs = route(tr, spec, xt)
    pe = probs.mean(0)
    fe = expert_counts(idx.reshape(-1), spec.n_experts).to(torch.float32) / t
    aux = spec.n_experts * torch.sum(pe * fe)

    n_chunks = n_chunks_for(spec, t)
    if n_chunks == 1:
        y = _dispatch_chunk(fz, tr, spec, xt, gates, idx, lora_scale)
    else:
        tc = t // n_chunks
        y = torch.cat([_maybe_remat(
            _dispatch_chunk, fz, tr, spec, xt[i * tc:(i + 1) * tc],
            gates[i * tc:(i + 1) * tc], idx[i * tc:(i + 1) * tc],
            lora_scale) for i in range(n_chunks)])
    if spec.n_shared:
        y = y + mlp_apply(fz.get("shared", {}), tr.get("shared", {}),
                          _shared_spec(spec), xt, lora_scale)
    return y.reshape(b, s, d).to(x.dtype), aux
