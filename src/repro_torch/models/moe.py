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
from repro_torch.core.lora import LoRAConfig, frozen_weight, linear_init, \
    linear_logical
from repro_torch.models.layers import MLPSpec, _maybe_remat, mlp_apply, \
    mlp_init, mlp_logical
from repro_torch.utils import pcontext
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


def moe_logical(spec: MoESpec, mode: str, stack: bool) -> tuple[dict, dict]:
    """Logical annotations parallel to :func:`moe_init`'s trees: the
    banks carry the ``expert`` axis after the optional layer stack."""
    pre = ("layers",) if stack else ()
    fz, tr = {}, {}
    tr["router"] = {"w": (*pre, "fsdp", None)}
    dims = {"wi": ("fsdp", "mlp_nosplit"), "wg": ("fsdp", "mlp_nosplit"),
            "wo": ("mlp_nosplit", "fsdp")}

    def ins(tup):
        return tup[: len(pre)] + ("expert",) + tup[len(pre):]

    for nm in _bank_names(spec):
        f, t = linear_logical(*dims[nm], mode, stack)
        if f:
            fz[nm] = {k: ins(v) for k, v in f.items()}
        if t:
            tr[nm] = {k: ins(v) for k, v in t.items()}
    if spec.n_shared:
        sfz, str_ = mlp_logical(_shared_spec(spec), mode, stack)
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


def _cumcount(keys: torch.Tensor, n: int) -> tuple:
    """(each entry's place among the entries of its key, in order; the
    entries' stable order by key; each key's count; each key's first
    place in that order) of ``keys`` in [0, n)."""
    counts = expert_counts(keys, n)
    first = torch.cumsum(counts, 0) - counts
    order = torch.argsort(keys, stable=True)
    rank = torch.empty_like(keys)
    rank[order] = torch.arange(keys.numel(), device=keys.device) \
        - first[keys[order]]
    return rank, order, counts, first


def dispatch_plan(spec: MoESpec, idx: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Where each of a chunk's (token, slot) pairs goes. idx: (t, k)
    expert ids. Returns (pos (t, k): the pair's row in its expert's
    buffer, ``>= cap`` where it is dropped; src (E, cap): the token
    filling buffer row (e, c), ``-1`` where the row is empty; cap)."""
    t, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(t * k)
    pos, order, counts, offsets = _cumcount(flat_e, spec.n_experts)
    cap = _cap(spec, t)
    slot = offsets[:, None] + torch.arange(cap, device=dev)[None, :]
    full = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    src = torch.where(full, order[slot.clamp(max=t * k - 1)] // k, -1)
    return pos.reshape(t, k), src, cap


def _dispatch_chunk(fz: dict, tr: dict, spec: MoESpec, xt: torch.Tensor,
                    gates: torch.Tensor, idx: torch.Tensor,
                    lora_scale: float) -> torch.Tensor:
    """Sort-dispatch one token chunk through the expert banks (the
    one-card step's dispatch). xt: (t, d); gates, idx: (t, k). Returns
    (t, d) in xt's dtype."""
    pos, src, cap = dispatch_plan(spec, idx)
    full = (src >= 0)[..., None]
    buf = pcontext.constrain(torch.where(full, xt[src.clamp(min=0)], 0),
                             "expert")
    out = pcontext.constrain(_expert_ffn(fz, tr, spec, buf, lora_scale),
                             "expert")
    out = F.pad(out, (0, 0, 0, 1))                  # row cap: dropped
    keep = pos < cap
    rows = out[idx, pos.clamp(max=cap)]             # (t, k, d)
    return pcontext.constrain(_combine(spec, rows, gates, idx, keep),
                              "tokens")


def _combine(spec: MoESpec, rows: torch.Tensor, gates: torch.Tensor,
             idx: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each token's k expert rows (t, k, d), weighted by its gates where
    kept, folded one slot at a time in ascending expert order (the
    reference's sorted scatter-add order): no collisions."""
    t, d = rows.shape[0], rows.shape[-1]
    w = (gates * keep).to(rows.dtype)               # (t, k)
    slot_order = torch.argsort(idx, dim=1, stable=True)
    ar = torch.arange(t, device=rows.device)
    y = torch.zeros((t, d), dtype=rows.dtype, device=rows.device)
    for j in range(spec.top_k):
        sj = slot_order[:, j]
        y = y + rows[ar, sj] * w[ar, sj][:, None]
    return y


def _dispatch_split(fz: dict, tr: dict, spec: MoESpec, xt: torch.Tensor,
                    gates: torch.Tensor, idx: torch.Tensor,
                    lora_scale: float, sp) -> torch.Tensor:
    """The dispatch of a sharded step whose ``model`` axis splits the
    experts (``launch/spmd.py`` ``ExpertSplit`` ``sp``): xt (t, d), gates
    and idx (t, k) of this rank's local tokens; the banks in ``fz`` /
    ``tr`` this rank's block of experts. Returns (t, d)."""
    w = next(iter(fz.get("wi", tr.get("wi", {})).values()))
    if w.shape[0] != sp.eb:
        raise ValueError(f"expert banks of {w.shape[0]} experts where "
                         f"the split gives this rank {sp.eb}")
    x_m, g_m, i_m = sp.mine(xt), sp.mine(gates), sp.mine(idx)
    every = sp.gather(i_m)              # (members, tokens, k) expert ids
    ys = []
    for ch in sp.chunks:
        args = (fz, tr, spec, sp, ch, x_m, g_m, i_m, every, lora_scale)
        ys.append(_maybe_remat(_split_chunk, *args) if len(sp.chunks) > 1
                  else _split_chunk(*args))
    return sp.whole(torch.cat(ys))


def _split_chunk(fz: dict, tr: dict, spec: MoESpec, sp, ch,
                 x_m: torch.Tensor, g_m: torch.Tensor, i_m: torch.Tensor,
                 every: torch.Tensor, lora_scale: float) -> torch.Tensor:
    """One chunk of :func:`_dispatch_split`: the chunk's dispatch order
    from every token's expert ids, this rank's (E/m, C) block of its
    buffer filled from the ranks that hold the tokens, the banks, and
    the rows back to their tokens. Returns this rank's tokens' outputs
    in the chunk (hi - lo, d)."""
    dev, d, k = x_m.device, x_m.shape[1], spec.top_k
    own_p, own_l, at = sp.tensors(ch, dev)
    pos, src, cap = dispatch_plan(spec, every[own_p, own_l])
    eb, j, m, n = sp.eb, sp.j, sp.m_group, sp.n_members
    # the member holding the token of each buffer row, and its place
    p_row = torch.where(src >= 0, own_p[src.clamp(min=0)], -1)
    l_row = own_l[src.clamp(min=0)]
    p_b, l_b = p_row[j * eb:(j + 1) * eb], l_row[j * eb:(j + 1) * eb]
    # this rank's block's rows whose tokens its batch block holds
    fill = (p_b >= 0) & (p_b // m == sp.me // m)
    idx_m = i_m[ch.lo:ch.hi]
    pos_m = pos[at]
    keep = pos_m < cap
    if sp.mode == "a2a":
        # a kept pair's slot: its place among the rows of one expert
        # block that one member's tokens fill, in buffer order
        e_all = spec.n_experts
        key = torch.where(src >= 0, torch.arange(e_all, device=dev)[:, None]
                          // eb * n + p_row, e_all // eb * n)
        slot = _cumcount(key.reshape(-1), e_all // eb * n + 1
                         )[0].reshape(e_all, cap)
        width = min(ch.most * k, eb * cap)
        dest = idx_m // eb
        at_s = torch.where(keep, slot[idx_m, pos_m.clamp(max=cap - 1)],
                           width)
        rows_in = x_m[ch.lo:ch.hi, None].expand(-1, k, -1).reshape(-1, d)
        send = x_m.new_zeros(m, width + 1, d).index_put(
            (dest.reshape(-1), at_s.reshape(-1)), rows_in)
        got = sp.a2a(send[:, :width])               # (m, width, d)
        src_m = (p_b % m).clamp(min=0)
        s_b = slot[j * eb:(j + 1) * eb].clamp(max=width - 1)
        buf = torch.where(fill[..., None], got[src_m, s_b], 0)
    else:
        buf = torch.where(fill[..., None], sp.rep_enter(x_m)[l_b], 0)
    buf = pcontext.constrain(sp.reduce(buf, cap), "expert")
    out = sp.unreduce(_expert_ffn(fz, tr, spec, buf, lora_scale), cap)
    if sp.mode == "a2a":
        back = out.new_zeros(m, width + 1, d).index_put(
            (torch.where(fill, src_m, 0).reshape(-1),
             torch.where(fill, s_b, width).reshape(-1)),
            out.reshape(-1, d))
        got = sp.a2a(back[:, :width])
        rows = torch.where(keep[..., None],
                           got[dest, at_s.clamp(max=width - 1)], 0)
    else:
        ours = keep & (idx_m // eb == j)
        rows = sp.rep_exit(torch.where(
            ours[..., None], out[(idx_m - j * eb).clamp(0, eb - 1),
                                 pos_m.clamp(max=cap - 1)], 0))
    return _combine(spec, rows, g_m[ch.lo:ch.hi], idx_m, keep)


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
    xt = pcontext.constrain(x.reshape(t, d), "tokens")
    gates, idx, probs = route(tr, spec, xt)
    counts = expert_counts(idx.reshape(-1), spec.n_experts)
    # a sharded step's rank holds t of the tg tokens: the aux loss is
    # over all tg
    tg = pcontext.token_total(t)
    if tg == t:
        pe = probs.mean(0)
        fe = counts.to(torch.float32) / t
    else:
        pe = pcontext.token_sum(probs.sum(0)) / tg
        fe = pcontext.token_sum(counts.to(torch.float32)) / tg
    aux = spec.n_experts * torch.sum(pe * fe)

    # a sharded step splits the experts over its model axis
    sp = pcontext.expert_split(spec, b, s)
    n_chunks = n_chunks_for(spec, t)
    if sp is not None:
        y = _dispatch_split(fz, tr, spec, xt, gates, idx, lora_scale, sp)
    elif n_chunks == 1:
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
