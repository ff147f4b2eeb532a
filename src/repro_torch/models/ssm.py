"""Mamba-2 (SSD, state-space duality) mixer: the JAX package's
``models/ssm.py``.

The chunked SSD of Dao & Gu (arXiv:2405.21060): within a chunk, a
quadratic attention-like product under a 1-semiseparable decay mask;
across chunks, a state recurrence (a Python loop over the chunks where
the reference scans). Decode is the O(1) recurrent step with an SSM
state cache and a rolling cache of the last ``conv_kernel - 1`` inputs
of the depthwise conv.

The projections are split per component (z/x/B/C/dt) as in the
reference. z/x/out are FLoCoRA LoRA linears; the B/C/dt projections, the
depthwise conv, ``A_log``/``D``/``dt_bias`` and the gated norm train
densely in fp32. ``n_groups`` is 1 in every config: the chunk scores sum
over the groups and decode reads group 0, as the reference does.

Numerics follow the reference op for op: the projections and the conv
in bf16 (the conv sums its K bf16 products in Python order, then adds
the bias and applies silu in fp32), the decay mask, chunk states and the
recurrence in fp32, and the intra-chunk product as a bf16 x bf16 product
whose output is rounded to bf16 and widened to fp32. One departure: the
decay mask is applied before its ``exp``, not after (same forward
values; a finite backward where the reference's overflows).

A sharded step may run a mixer on its block of heads
(``pcontext.ssm_block``, the reference's ``ssm_heads`` / ``ssm_inner``
rules): head ``h`` owns channels ``[h P, (h + 1) P)`` of ``d_inner``, so
``wz`` / ``wx`` / the norm hold the block's channels and ``wo`` its rows;
B, C and ``dt`` are computed whole and the per-head leaves, ``dt`` and
the conv (whole: its channels at rest are not laid out by heads) taken
at the block; the gated norm's mean square is summed over the blocks and
``wo``'s partial outputs add over them. The SSM state is the block's
heads; the conv cache is gathered whole.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lora import LoRAConfig, _normal, linear_apply, \
    linear_init, linear_logical
from repro_torch.models import layers as L
from repro_torch.utils import pcontext
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_inner: int              # expand * d_model
    head_dim: int = 64        # P
    d_state: int = 128        # N
    n_groups: int = 1         # G
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim


def mamba_init(gen: torch.Generator, spec: MambaSpec, mode: str,
               lora: LoRAConfig, stack: tuple[int, ...] = (),
               device="cuda") -> tuple[dict, dict]:
    """(frozen, trainable) of one Mamba-2 mixer stacked over ``stack``;
    the leaves, shapes, dtypes and the init values of ``A_log``, ``D``,
    ``dt_bias``, the conv bias and the norm are the reference's."""
    dev = resolve_device(device)
    gn = spec.n_groups * spec.d_state
    h = spec.n_heads
    fz, tr = {}, {}
    for nm, d_in, d_out, m in (
            ("wz", spec.d_model, spec.d_inner, mode),
            ("wx", spec.d_model, spec.d_inner, mode),
            ("wb", spec.d_model, gn, "dense"),
            ("wc", spec.d_model, gn, "dense"),
            ("wdt", spec.d_model, h, "dense"),
            ("wo", spec.d_inner, spec.d_model, mode)):
        f, t = linear_init(gen, d_in, d_out, m, lora, stack, device=dev)
        if f:
            fz[nm] = f
        if t:
            tr[nm] = t
    convdim = spec.d_inner + 2 * gn
    tr["conv"] = {"w": _normal(gen, (*stack, spec.conv_kernel, convdim),
                               0.1, torch.float32, dev),
                  "b": torch.zeros((*stack, convdim), dtype=torch.float32,
                                   device=dev)}

    def per_head(v: torch.Tensor) -> torch.Tensor:
        return v.to(dev).expand(*stack, h).clone()

    tr["A_log"] = per_head(torch.log(torch.linspace(
        1.0, 16.0, h, dtype=torch.float32)))
    tr["D"] = per_head(torch.ones((h,), dtype=torch.float32))
    tr["dt_bias"] = per_head(torch.log(torch.expm1(
        torch.full((h,), 0.01, dtype=torch.float32))))
    tr["norm"] = L.rmsnorm_init(spec.d_inner, stack, dev)
    return fz, tr


def mamba_logical(spec: MambaSpec, mode: str, stack: bool
                  ) -> tuple[dict, dict]:
    """Logical annotations parallel to :func:`mamba_init`'s trees."""
    pre = ("layers",) if stack else ()
    fz, tr = {}, {}
    for nm, dims, m in (("wz", ("fsdp", "ssm_inner"), mode),
                        ("wx", ("fsdp", "ssm_inner"), mode),
                        ("wb", ("fsdp", None), "dense"),
                        ("wc", ("fsdp", None), "dense"),
                        ("wdt", ("fsdp", None), "dense"),
                        ("wo", ("ssm_inner", "fsdp"), mode)):
        f, t = linear_logical(*dims, m, stack)
        if f:
            fz[nm] = f
        if t:
            tr[nm] = t
    tr["conv"] = {"w": (*pre, None, "ssm_inner"), "b": (*pre, "ssm_inner")}
    tr["A_log"] = (*pre, None)
    tr["D"] = (*pre, None)
    tr["dt_bias"] = (*pre, None)
    tr["norm"] = {"scale": (*pre, "ssm_inner")}
    return fz, tr


def _proj(fz: dict, tr: dict, nm: str, x: torch.Tensor,
          scale: float) -> torch.Tensor:
    return linear_apply(fz.get(nm, {}), tr.get(nm, {}), x, scale)


def _bc_dt(fz: dict, tr: dict, x: torch.Tensor, scale: float,
           blk: Optional[tuple]) -> tuple:
    """(B, C, dt in fp32 of the block's heads): the projections that a
    head block computes whole."""
    bmat, cmat, dt = (linear_apply(fz.get(nm, {}), tr.get(nm, {}), x, scale)
                      for nm in ("wb", "wc", "wdt"))
    return bmat, cmat, _heads_of(dt.to(torch.float32), blk)


def _causal_depthwise_conv(xbc: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor,
                           state: Optional[torch.Tensor] = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """xbc: (B, S, C); w: (K, C); state: the K - 1 inputs before
    ``xbc`` (zeros when None). Returns (y, new state (B, K-1, C)): the
    last K - 1 rows of the padded input."""
    k, s = w.shape[0], xbc.shape[1]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    y = xp[:, 0:s] * w[0].to(xbc.dtype)
    for i in range(1, k):              # the reference's Python-order sum
        y = y + xp[:, i:i + s] * w[i].to(xbc.dtype)
    y = F.silu((y + b.to(y.dtype)).to(torch.float32)).to(xbc.dtype)
    return y, xp[:, s:]


def _gate(tr: dict, y: torch.Tensor, z: torch.Tensor,
          total: Optional[int] = None) -> torch.Tensor:
    """The silu(z) gate and the rmsnorm (before the out projection); of
    a head block, the norm over the whole ``total`` channels."""
    g = y * F.silu(z.to(torch.float32)).to(y.dtype)
    if total is None:
        return L.rmsnorm_apply(tr["norm"], g)
    return L.rmsnorm_blocks(tr["norm"], g, total)


def _heads_of(v: torch.Tensor, blk: Optional[tuple]) -> torch.Tensor:
    """The block's heads of a last dim over every head."""
    return v if blk is None else v[..., blk[0]:blk[0] + blk[1]]


def _inner_cols(t: torch.Tensor, spec: MambaSpec,
                blk: Optional[tuple]) -> torch.Tensor:
    """The block's channels of a last dim over the conv's ``d_inner + 2
    G N`` channels: its heads' x channels, then every B and C one."""
    if blk is None:
        return t
    p = spec.head_dim
    return torch.cat([t[..., blk[0] * p:(blk[0] + blk[1]) * p],
                      t[..., spec.d_inner:]], dim=-1)


def _whole_conv(state: torch.Tensor, di: int) -> torch.Tensor:
    """A conv cache of a head block's channels (x block, B, C) with
    every block's x channels gathered in."""
    return torch.cat([pcontext.ssm_gather(state[..., :di]),
                      state[..., di:]], dim=-1)


def _check_block(z: torch.Tensor, di: int) -> None:
    if z.shape[-1] != di:
        raise ValueError(f"a Mamba mixer split over model into blocks of "
                         f"{di} channels got wz's {z.shape[-1]}: its "
                         "d_inner is not split over model at rest")


def check_final_state(spec: MambaSpec, s: int) -> None:
    """Raise ``ValueError`` where a prompt of ``s`` tokens cannot give
    the decode cache. The JAX package fails or goes wrong in both cases:
    past the chunk and not a multiple of it, its final-state pass
    reshapes without the tail padding (a TypeError); shorter than
    ``conv_kernel - 1``, it stores the prompt's inputs at the FRONT of
    the conv cache, so the next decode step convolves them with the
    wrong taps and parts from the forward."""
    k1 = spec.conv_kernel - 1
    if s > spec.chunk and s % spec.chunk:
        raise ValueError(
            f"prefill: a {s}-token prompt at a Mamba layer (chunk "
            f"{spec.chunk}): the decode cache needs the state after whole "
            f"chunks, so the prompt must be at most {spec.chunk} tokens "
            "or a multiple of the chunk (the JAX package fails here too)")
    if s < k1:
        raise ValueError(
            f"prefill: a {s}-token prompt at a Mamba layer (conv kernel "
            f"{spec.conv_kernel}): the conv cache holds the last {k1} "
            f"inputs, so the prompt needs at least {k1} tokens (the JAX "
            "package stores a shorter prompt misaligned)")


def mamba_forward(fz: dict, tr: dict, spec: MambaSpec, x: torch.Tensor,
                  lora_scale: float, final_state: bool = False
                  ) -> tuple[torch.Tensor, Optional[dict]]:
    """Training / prefill forward (B, S, d) -> (B, S, d), chunked SSD.
    A sequence longer than the chunk and not a multiple of it is padded
    at its tail to whole chunks (causal: the padding never reaches the
    first S outputs). With ``final_state`` also returns the decode
    cache after the last token: {'ssm': the recurrence's state after
    the last chunk (B, H, P, N) fp32, 'conv': the last K - 1 pre-conv
    inputs (B, K-1, C) bf16}; that needs S no longer than the chunk or
    a multiple of it, and at least K - 1 (``check_final_state``)."""
    bsz, s0, _ = x.shape
    h, p, n, g = spec.n_heads, spec.head_dim, spec.d_state, spec.n_groups
    blk = pcontext.ssm_block(h)         # a sharded step's head block
    if blk is not None:
        x = pcontext.ssm_enter(x)
        h = blk[1]
    di = h * p                          # the block's d_inner channels
    lc = min(spec.chunk, s0)
    pad = (-s0) % lc
    if final_state:
        check_final_state(spec, s0)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    s = s0 + pad
    nc = s // lc
    f32 = torch.float32

    z = _proj(fz, tr, "wz", x, lora_scale)
    _check_block(z, di)
    xs = _proj(fz, tr, "wx", x, lora_scale)
    bmat, cmat, dt = _bc_dt(fz, tr, x, lora_scale, blk)

    xbc_in = torch.cat([xs, bmat, cmat], dim=-1)
    xbc, _ = _causal_depthwise_conv(
        xbc_in, _inner_cols(tr["conv"]["w"], spec, blk),
        _inner_cols(tr["conv"]["b"], spec, blk))
    xs = xbc[..., :di]
    bmat = xbc[..., di:di + g * n]
    cmat = xbc[..., di + g * n:]

    dt = F.softplus(dt + _heads_of(tr["dt_bias"], blk))     # (B,S,H)
    a = -torch.exp(_heads_of(tr["A_log"], blk).to(f32))     # (H,)

    xh = xs.reshape(bsz, nc, lc, h, p)
    bh = bmat.reshape(bsz, nc, lc, g, n).to(f32)
    ch = cmat.reshape(bsz, nc, lc, g, n).to(f32)
    dth = dt.reshape(bsz, nc, lc, h)
    cum = torch.cumsum(dth * a, dim=2)                      # (B,nc,Lc,H)

    # intra-chunk: decay L[i, j] = exp(cum_i - cum_j) below the diagonal,
    # laid out (B, nc, H, Lc, Ls) so the product batches over the heads.
    # The reference takes exp of the whole square and zeroes the upper
    # triangle after; there exp overflows where a chunk decays by more
    # than fp32's exp range (88.7), and the backward's 0 * inf is NaN.
    # Masking before the exp gives the same forward values.
    cum_t = cum.transpose(2, 3)
    seg = cum_t[..., :, None] - cum_t[..., None, :]
    tril = torch.ones((lc, lc), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tril, seg, float("-inf")))
    del seg
    cb = torch.einsum("bclgn,bcsgn->bcls", ch, bh)          # g == 1
    scores = cb[:, :, None] * decay * dth.transpose(2, 3)[..., None, :]
    del decay
    y_intra = torch.matmul(scores.to(torch.bfloat16),
                           xh.to(torch.bfloat16).permute(0, 1, 3, 2, 4))
    del scores
    y_intra = y_intra.permute(0, 1, 3, 2, 4).to(f32)        # (B,nc,Lc,H,P)

    # chunk states and the inter-chunk recurrence
    last = cum[:, :, -1:, :]                                # (B,nc,1,H)
    wdecay = torch.exp(last - cum) * dth                    # (B,nc,Lc,H)
    states = torch.einsum("bclgn,bclhp->bchpn", bh,
                          wdecay[..., None] * xh.to(f32))   # (B,nc,H,P,N)
    chunk_decay = torch.exp(last[:, :, 0])                  # (B,nc,H)
    hc = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hc)
        hc = hc * chunk_decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                     # (B,nc,H,P,N)
    y_inter = torch.einsum("bclgn,bchpn->bclhp", ch, hprevs) \
        * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + _heads_of(tr["D"], blk).to(f32)[None, None, :, None] \
        * xs.reshape(bsz, s, h, p).to(f32)
    y = _gate(tr, y.reshape(bsz, s, di).to(x.dtype), z,
              None if blk is None else spec.d_inner)
    out = _proj(fz, tr, "wo", y[:, :s0] if pad else y, lora_scale)
    if blk is not None:
        out = pcontext.ssm_exit(out)
    if not final_state:
        return out, None
    k1 = spec.conv_kernel - 1
    conv = xbc_in[:, s0 - k1:]
    return out, {"ssm": hc, "conv": (conv if blk is None else
                                     _whole_conv(conv, di)
                                     ).to(torch.bfloat16)}


def mamba_apply(fz: dict, tr: dict, spec: MambaSpec, x: torch.Tensor,
                lora_scale: float) -> torch.Tensor:
    """Training / prefill forward: (B, S, d) -> (B, S, d), chunked SSD."""
    return mamba_forward(fz, tr, spec, x, lora_scale)[0]


def mamba_cache_init(spec: MambaSpec, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device="cuda") -> dict:
    """{'ssm': (B, H, P, N) fp32, 'conv': (B, K-1, C) ``dtype``}, zero."""
    dev = resolve_device(device)
    gn = spec.n_groups * spec.d_state
    return {"ssm": torch.zeros((batch, spec.n_heads, spec.head_dim,
                                spec.d_state), dtype=torch.float32,
                               device=dev),
            "conv": torch.zeros((batch, spec.conv_kernel - 1,
                                 spec.d_inner + 2 * gn), dtype=dtype,
                                device=dev)}


def mamba_cache_logical() -> dict:
    return {"ssm": ("batch", "ssm_heads", None, None),
            "conv": ("batch", None, "ssm_inner")}


def mamba_decode(fz: dict, tr: dict, spec: MambaSpec, x: torch.Tensor,
                 cache: dict, lora_scale: float
                 ) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d). The O(1) recurrent step; returns (y, the new cache
    {'ssm' fp32, 'conv' in x's compute dtype bf16}) as new tensors. Of a
    head block, ``cache['ssm']`` is the block's heads and
    ``cache['conv']`` whole."""
    bsz = x.shape[0]
    h, p, n, g = spec.n_heads, spec.head_dim, spec.d_state, spec.n_groups
    blk = pcontext.ssm_block(h)         # a sharded step's head block
    if blk is not None:
        x = pcontext.ssm_enter(x)
        h = blk[1]
    di = h * p
    f32 = torch.float32
    z = _proj(fz, tr, "wz", x, lora_scale)
    _check_block(z, di)
    xs = _proj(fz, tr, "wx", x, lora_scale)
    bmat, cmat, dt = _bc_dt(fz, tr, x, lora_scale, blk)

    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    xbc, conv_state = _causal_depthwise_conv(
        xbc, _inner_cols(tr["conv"]["w"], spec, blk),
        _inner_cols(tr["conv"]["b"], spec, blk),
        _inner_cols(cache["conv"], spec, blk))
    xs = xbc[:, 0, :di]                                     # (B, d_inner)
    bvec = xbc[:, 0, di:di + g * n]
    cvec = xbc[:, 0, di + g * n:]

    dt = F.softplus(dt[:, 0] + _heads_of(tr["dt_bias"], blk))  # (B,H)
    a = -torch.exp(_heads_of(tr["A_log"], blk).to(f32))
    da = torch.exp(dt * a)
    xh = xs.reshape(bsz, h, p).to(f32)
    bn = bvec.reshape(bsz, g, n).to(f32)[:, 0]              # (B,N)
    cn = cvec.reshape(bsz, g, n).to(f32)[:, 0]

    ssm = cache["ssm"] * da[..., None, None] \
        + (dt[..., None] * xh)[..., None] * bn[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", ssm, cn) \
        + _heads_of(tr["D"], blk).to(f32)[None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(x.dtype)
    out = _proj(fz, tr, "wo", _gate(tr, y, z, None if blk is None
                                    else spec.d_inner), lora_scale)
    if blk is None:
        return out, {"ssm": ssm, "conv": conv_state}
    return pcontext.ssm_exit(out), {"ssm": ssm,
                                    "conv": _whole_conv(conv_state, di)}
