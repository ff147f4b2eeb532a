"""The port's LM layers (``repro_torch.models.layers`` and the GQA block
of ``models/attention.py``) against the JAX package's on the same numpy
inputs, on the CPU.

Tolerances: the attention cores round their operands to bf16 and
multiply in fp32 exactly as the reference's ``preferred_element_type``
einsums do, so they agree to fp32 summation order: max abs error
<= 1e-2 * max|out| on bf16 outputs (one bf16 ulp is 2^-8 ~ 4e-3
relative). Element-wise fp32 functions (rope,
the MLP activations, the norms) agree to a few fp32 ulps before the
bf16 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lora import LoRAConfig as JLoRA
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.core.lora import LoRAConfig as TLoRA
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.utils.tree import tree_map

torch.set_num_threads(2)

BF16_TOL = 1e-2      # of max|out|, bf16 outputs


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel: float = BF16_TOL) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


def _pair(x: np.ndarray, dtype: str = "bfloat16"):
    """The same values as a JAX array and a torch tensor."""
    j = jnp.asarray(x, getattr(jnp, dtype))
    return j, convert.params_from_jax(np.asarray(j), "cpu")


def _qkv(rng, b, s, h, hkv, d):
    return [_pair(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 5, 64)) * 3)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    _close(TL.rmsnorm_apply({"scale": torch.from_numpy(scale)}, xt),
           JL.rmsnorm_apply({"scale": jnp.asarray(scale)}, xj), rel=0.0)
    init = TL.rmsnorm_init(16, (3,), device="cpu")["scale"]
    np.testing.assert_array_equal(init.numpy(),
                                  np.asarray(JL.rmsnorm_init(16, (3,))
                                             ["scale"]))


@pytest.mark.parametrize("pos_shape", [(24,), (2, 24), (2, 1)])
def test_rope_matches_jax(pos_shape):
    """cos/sin within 3e-4 absolute at positions up to 1,600 and base 1e6
    (an fp32 ulp of an angle near 1,600 rad is 1.2e-4); the rotation of
    bf16 q by the same cos/sin is bit-equal."""
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 1600, pos_shape)
    cj, sj = JL.rope_for_positions(jnp.asarray(pos), 16, 1e6)
    ct, st = TL.rope_for_positions(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=3e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=3e-4)
    s = pos_shape[-1]
    xj, xt = _pair(rng.standard_normal((2, s, 4, 16)))
    # same cos/sin into both: the rotation itself
    _close(TL.apply_rope(xt, torch.from_numpy(np.asarray(cj)),
                         torch.from_numpy(np.asarray(sj))),
           JL.apply_rope(xj, cj, sj), rel=0.0)


def test_repeat_kv_matches_jax():
    rng = np.random.default_rng(2)
    kj, kt = _pair(rng.standard_normal((2, 5, 3, 4)))
    np.testing.assert_array_equal(_np(TL._repeat_kv(kt, 4)),
                                  _np(JL._repeat_kv(kj, 4)))


@pytest.mark.parametrize("sq,skv,chunk,causal", [
    (20, 20, 7, True),       # padded last chunk (20 = 2*7 + 6)
    (20, 20, 32, True),      # one chunk larger than the sequence
    (5, 17, 4, True),        # fewer queries than keys
    (9, 13, 5, False),       # bidirectional, padded
])
def test_attention_chunked_matches_jax(sq, skv, chunk, causal):
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng.standard_normal((2, sq, 4, 16)))
    kj, kt = _pair(rng.standard_normal((2, skv, 2, 16)))
    vj, vt = _pair(rng.standard_normal((2, skv, 2, 16)))
    kw = dict(causal=causal, kv_chunk=chunk)
    _close(TL.attention_chunked(qt, kt, vt, **kw),
           JL.attention_chunked(qj, kj, vj, **kw))


def test_attention_chunked_prefix_and_masked_rows():
    """Prefix-LM masking; and rows fully masked within a chunk (queries
    0..4 see no key of the chunks from 5 on): guarded in both packages,
    so a query's output is its own chunk's alone, exactly."""
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 12, 4, 4, 8)
    pl = np.array([5, 9], np.int32)
    _close(TL.attention_chunked(qt, kt, vt, prefix_len=torch.from_numpy(pl),
                                kv_chunk=5),
           JL.attention_chunked(qj, kj, vj, prefix_len=jnp.asarray(pl),
                                kv_chunk=5))
    got = TL.attention_chunked(qt, kt, vt, kv_chunk=5)
    _close(got, JL.attention_chunked(qj, kj, vj, kv_chunk=5))
    alone = TL.attention_chunked(qt[:, :5], kt[:, :5], vt[:, :5], kv_chunk=5)
    assert torch.equal(got[:, :5], alone)


@pytest.mark.parametrize("s,w", [(24, 8), (21, 8), (7, 8), (17, 4)])
def test_local_attention_blocked_matches_jax(s, w):
    """S % W != 0 in three of the cases (the padded last block); S < W
    in one (one block, its pad keys masked)."""
    rng = np.random.default_rng(5)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, s, 4, 2, 16)
    _close(TL.local_attention_blocked(qt, kt, vt, window=w),
           JL.local_attention_blocked(qj, kj, vj, window=w))


def test_local_attention_equals_masked_full():
    """The port's blocked form against a dense masked softmax in fp32
    (the JAX package's own check, test_consistency.py)."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((2, 24, 4, 16), (2, 24, 2, 16),
                                   (2, 24, 2, 16)))
    o = TL.local_attention_blocked(q, k, v, window=8)
    kr, vr = TL._repeat_kv(k, 2), TL._repeat_kv(v, 2)
    s_ = torch.einsum("bqhd,bkhd->bhqk", q * 16 ** -0.5, kr)
    qp, kp = torch.arange(24)[:, None], torch.arange(24)[None, :]
    s_ = torch.where(((kp <= qp) & (kp > qp - 8))[None, None], s_,
                     -torch.inf)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, -1), vr)
    assert float((o - ref).abs().max()) < 2e-2


@pytest.mark.parametrize("length", [1, 11, 16])
def test_decode_attention_matches_jax(length):
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng.standard_normal((2, 1, 8, 16)))
    kj, kt = _pair(rng.standard_normal((2, 16, 2, 16)))
    vj, vt = _pair(rng.standard_normal((2, 16, 2, 16)))
    _close(TL.decode_attention(qt, kt, vt, length),
           JL.decode_attention(qj, kj, vj, length))
    lens = np.array([length, 16], np.int32)
    _close(TL.decode_attention(qt, kt, vt, torch.from_numpy(lens)),
           JL.decode_attention(qj, kj, vj, jnp.asarray(lens)))


def _tree_pair(tree):
    """A JAX tree and its torch copy (bf16 leaves carried exactly)."""
    host = jax.device_get(tree)
    return tree, convert.params_from_jax(host, "cpu")


def _moved(tree, seed: int):
    """Adapters moved off their init (``b`` is zero there), in both
    packages' trees."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.02 * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype)
        if str(p[-1]) == "['b']" else x, tree)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "sqrelu", "gelu"])
def test_mlp_matches_jax(kind):
    spec_j = JL.MLPSpec(kind, 32, 96)
    spec_t = TL.MLPSpec(kind, 32, 96)
    fz, tr = JL.mlp_init(jax.random.PRNGKey(0), spec_j, "lora",
                         JLoRA(rank=4, alpha=64.0))
    (_, fzt), (trj, trt) = _tree_pair(fz), _tree_pair(_moved(tr, 8))
    rng = np.random.default_rng(9)
    xj, xt = _pair(rng.standard_normal((2, 6, 32)))
    _close(TL.mlp_apply(fzt, trt, spec_t, xt, 16.0),
           JL.mlp_apply(fz, trj, spec_j, xj, 16.0), rel=2e-2)
    names = {"swiglu": 3, "geglu": 3}.get(kind, 2)
    fz_t, tr_t = TL.mlp_init(torch.Generator().manual_seed(0), spec_t,
                             "lora", TLoRA(rank=4, alpha=64.0),
                             device="cpu")
    assert len(fz_t) == len(tr_t) == names
    assert {k: tuple(v["w"].shape) for k, v in fz_t.items()} == \
        {k: v["w"].shape for k, v in fz.items()}


def test_gelu_is_jax_default_tanh_form():
    """jax.nn.gelu's default (the plain ``gelu`` MLP) and geglu's
    ``approximate=True`` are both F.gelu(approximate='tanh'), not the
    erf form."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    np.testing.assert_allclose(tanh.numpy(), want, atol=2e-6)
    assert float(np.abs(erf.numpy() - want).max()) > 1e-4


def _head(d, v, mode="lora"):
    from repro.core.lora import linear_init
    fz, tr = linear_init(jax.random.PRNGKey(3), d, v, mode,
                         JLoRA(rank=4, alpha=64.0), w_init_scale=d ** -0.5)
    return _tree_pair(fz), _tree_pair(_moved(tr, 10))


@pytest.mark.parametrize("s,chunk,masked", [(20, 8, False), (20, 8, True),
                                            (16, 16, False),
                                            (5, 512, True)])
def test_chunked_xent_matches_jax(s, chunk, masked):
    """Padded chunks (20 = 2*8 + 4; 5 in one 512-chunk) and a loss
    mask: the mean NLL within 1e-3 relative, and its gradient into the
    hidden state and the head's adapters within 2e-2 of their max. The
    logits are bf16 in both packages, but inside its scanned chunk XLA
    may keep the head's base + adapter sum in fp32 (excess precision),
    so they differ by bf16 ulps (5e-5 relative in the loss here)."""
    (fzj, fzt), (trj, trt) = _head(32, 64)
    rng = np.random.default_rng(11)
    xj, xt = _pair(rng.standard_normal((2, s, 32)))
    lab = rng.integers(0, 64, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) < 0.7) if masked else None

    def jloss(x, tr):
        return JL.chunked_xent(x, fzj, tr, jnp.asarray(lab), 16.0, chunk,
                               None if mask is None else jnp.asarray(mask))

    lj, (gxj, gtj) = jax.value_and_grad(jloss, argnums=(0, 1))(xj, trj)
    xt = xt.clone().requires_grad_(True)
    trt = tree_map(lambda t: t.clone().requires_grad_(True), trt)
    lt = TL.chunked_xent(xt, fzt, trt, torch.from_numpy(lab), 16.0, chunk,
                         None if mask is None else torch.from_numpy(mask))
    gxt, ga, gb = torch.autograd.grad(lt, [xt, trt["a"], trt["b"]])
    assert abs(float(lt) - float(lj)) <= 1e-3 * abs(float(lj))
    _close(gxt, gxj, rel=2e-2)
    _close(ga, gtj["a"], rel=2e-2)
    _close(gb, gtj["b"], rel=2e-2)


GQA = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)


@pytest.mark.parametrize("opts", [{}, {"qkv_bias": True},
                                  {"qk_norm": True},
                                  {"n_heads": 3, "n_kv_heads": 1,
                                   "pad_heads_to": 4}])
@pytest.mark.parametrize("window", [None, 4])
def test_gqa_apply_and_decode_match_jax(opts, window):
    """The GQA block (bias, qk-norm, padded heads; full and sliding
    window) forward, and a decode step into a ring cache whose slot
    wraps (pos 13 % 4), against the JAX package's."""
    spec_j = JA.GQASpec(**{**GQA, **opts})
    spec_t = TA.GQASpec(**{**GQA, **opts})
    fz, tr = JA.gqa_init(jax.random.PRNGKey(1), spec_j, "lora",
                         JLoRA(rank=4, alpha=64.0))
    (_, fzt), (trj, trt) = _tree_pair(fz), _tree_pair(_moved(tr, 12))
    rng = np.random.default_rng(13)
    xj, xt = _pair(rng.standard_normal((2, 10, 64)))
    pos = np.arange(10)[None]
    rope_j = JL.rope_for_positions(jnp.asarray(pos), 16)
    rope_t = TL.rope_for_positions(torch.from_numpy(pos), 16)
    _close(TA.gqa_apply(fzt, trt, spec_t, xt, 16.0, rope_t, window=window,
                        kv_chunk=4),
           JA.gqa_apply(fz, trj, spec_j, xj, 16.0, rope_j, window=window,
                        kv_chunk=4), rel=2e-2)
    cache_j = JA.gqa_cache_init(spec_j, 2, 16, window)
    cache_j = jax.tree.map(lambda c: c + jnp.asarray(
        rng.standard_normal(c.shape), c.dtype), cache_j)
    cache_t = convert.params_from_jax(jax.device_get(cache_j), "cpu")
    assert {k: tuple(v.shape) for k, v in cache_t.items()} == \
        {k: tuple(v.shape) for k, v in TA.gqa_cache_init(
            spec_t, 2, 16, window, device="cpu").items()}
    x1j, x1t = _pair(rng.standard_normal((2, 1, 64)))
    p1 = np.full((2, 1), 13)
    yj, cj = JA.gqa_decode(fz, trj, spec_j, x1j, cache_j, jnp.asarray(13),
                           16.0, JL.rope_for_positions(jnp.asarray(p1), 16),
                           window=window)
    yt, ct = TA.gqa_decode(fzt, trt, spec_t, x1t, cache_t, 13, 16.0,
                           TL.rope_for_positions(torch.from_numpy(p1), 16),
                           window=window)
    _close(yt, yj, rel=2e-2)
    for key in ("k", "v"):
        _close(ct[key], cj[key], rel=2e-2)


def test_padded_heads_are_exact():
    """Padding 3 heads to 4 changes nothing: the padded block equals the
    unpadded one on the same real-head weights."""
    g = torch.Generator().manual_seed(0)
    pad = TA.GQASpec(48, 3, 1, 16, pad_heads_to=4)
    plain = TA.GQASpec(48, 3, 1, 16)
    fz, tr = TA.gqa_init(g, pad, "lora", TLoRA(rank=4, alpha=64.0),
                         device="cpu")
    tr = tree_map(lambda t: t + 0.02 * torch.randn(t.shape, generator=g),
                  tr)
    keep = 3 * 16
    fz_p = {"wq": {"w": fz["wq"]["w"][:, :keep]}, "wk": fz["wk"],
            "wv": fz["wv"], "wo": {"w": fz["wo"]["w"][:keep]}}
    tr_p = {"wq": {"a": tr["wq"]["a"], "b": tr["wq"]["b"][:, :keep]},
            "wk": tr["wk"], "wv": tr["wv"],
            "wo": {"a": tr["wo"]["a"][:keep], "b": tr["wo"]["b"]}}
    x = torch.randn((2, 6, 48), generator=g).to(torch.bfloat16)
    rope = TL.rope_for_positions(torch.arange(6)[None], 16)
    a = TA.gqa_apply(fz, tr, pad, x, 16.0, rope)
    b = TA.gqa_apply(fz_p, tr_p, plain, x, 16.0, rope)
    _close(a, b, rel=1e-2)
