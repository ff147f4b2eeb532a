"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``, function by function, on trees from the
reference's ``mamba_init`` carried across by ``convert`` (the adapters'
``b`` factors and the conv bias moved off their zero init), at
mamba2-370m's smoke layer width (d 64, d_inner 128, 8 heads of 16,
state 16, chunk 16, conv kernel 4).

The reference runs eagerly here (op by op: no fused bf16 chains kept in
fp32), so the two round to bf16 at the same places. Tolerances, each
stated beside the error measured on the CPU (torch 2.13, jax 0.9):
- ``_causal_depthwise_conv``: equal bits (measured: equal);
- ``mamba_apply`` output: ``APPLY_REL`` = 1e-2 of max|y| (measured:
  equal bits at every length and dtype here; 0.21% at other draws,
  a bf16 ulp of the output where a cumsum or an fp32 einsum sums in
  another order and a rounding flips);
- ``mamba_decode`` outputs and both caches over 6 steps: ``APPLY_REL``
  (measured: outputs and conv state equal, SSM state 1.1e-7);
- gradients of ``mamba_apply``: ``GRAD_L2`` = 3e-2 relative L2 a leaf
  (measured 1.08%, the conv bias's: its bf16 cotangent summed over
  batch and sequence in another order; the LoRA factors equal, ``wb``
  and ``wc`` within 0.44%);
- the port's own SSD against its own recurrence: tests/test_
  consistency.py's 1e-2 absolute (measured: equal bits), and the
  prefill's final SSM state within ``APPLY_REL`` (measured 1.1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lora import LoRAConfig as JLoRA
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.core.lora import LoRAConfig as TLoRA
from repro_torch.models import ssm as TS
from repro_torch.utils.tree import flatten_with_names, tree_leaves, tree_map

torch.set_num_threads(2)

SPEC = dict(d_model=64, d_inner=128, head_dim=16, d_state=16, chunk=16)
SCALE = 16.0
APPLY_REL = 1e-2
GRAD_L2 = 3e-2


def _tree(seed=0, **kw):
    spec = dict(SPEC, **kw)
    js, ts = JS.MambaSpec(**spec), TS.MambaSpec(**spec)
    jf, jt = JS.mamba_init(jax.random.PRNGKey(seed), js, "lora",
                           JLoRA(rank=4, alpha=64.0))
    rng = np.random.default_rng(seed + 1)
    jt = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.01 * jnp.asarray(
            rng.standard_normal(x.shape), x.dtype)
        if str(path[-1]) == "['b']" else x, jt)
    return (js, ts, jf, jt, convert.params_from_jax(jax.device_get(jf), "cpu"),
            convert.params_from_jax(jax.device_get(jt), "cpu"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _x(shape, seed, bf16):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32),
            torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_depthwise_conv_matches_jax(with_state):
    js, ts, jf, jt, tf, tt = _tree()
    c = js.d_inner + 2 * js.d_state
    xj, xt = _x((2, 10, c), 3, True)
    sj, st = _x((2, js.conv_kernel - 1, c), 4, False) if with_state \
        else (None, None)
    yj, nj = JS._causal_depthwise_conv(xj, jt["conv"]["w"], jt["conv"]["b"],
                                       sj)
    yt, nt = TS._causal_depthwise_conv(xt, tt["conv"]["w"], tt["conv"]["b"],
                                       st)
    assert yt.dtype == nt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(yt), _np(yj))
    np.testing.assert_array_equal(_np(nt), _np(nj))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", [32, 8, 20, 48],
                         ids=["chunks", "short", "padded", "padded3"])
def test_mamba_apply_matches_jax(s, bf16):
    """Two whole chunks, one short chunk (s < chunk), and tail padding
    (20 and 48 tokens: the last chunk part padding)."""
    js, ts, jf, jt, tf, tt = _tree()
    xj, xt = _x((2, s, js.d_model), s, bf16)
    yj = JS.mamba_apply(jf, jt, js, xj, SCALE)
    yt = TS.mamba_apply(tf, tt, ts, xt, SCALE)
    assert yt.dtype == torch.bfloat16 and str(yj.dtype) == "bfloat16"
    assert _rel(yt, yj) <= APPLY_REL


def test_mamba_decode_matches_jax_over_steps():
    """Six steps from a nonzero cache: each step's output and both new
    caches (the port's conv state comes back bf16, as the reference's)."""
    js, ts, jf, jt, tf, tt = _tree()
    cj = JS.mamba_cache_init(js, 2)
    rng = np.random.default_rng(5)
    cj = {"ssm": jnp.asarray(rng.standard_normal(cj["ssm"].shape) * 0.1,
                             jnp.float32),
          "conv": jnp.asarray(rng.standard_normal(cj["conv"].shape),
                              jnp.float32).astype(jnp.bfloat16)
          .astype(jnp.float32)}
    ct = convert.params_from_jax(jax.device_get(cj), "cpu")
    xj, xt = _x((2, 6, js.d_model), 6, True)
    for t in range(6):
        yj, cj = JS.mamba_decode(jf, jt, js, xj[:, t:t + 1], cj, SCALE)
        yt, ct = TS.mamba_decode(tf, tt, ts, xt[:, t:t + 1], ct, SCALE)
        assert yt.shape == (2, 1, js.d_model) and yt.dtype == torch.bfloat16
        assert _rel(yt, yj) <= APPLY_REL
        assert ct["ssm"].dtype == torch.float32
        assert ct["conv"].dtype == torch.bfloat16
        assert _rel(ct["ssm"], cj["ssm"]) <= APPLY_REL
        assert _rel(ct["conv"], cj["conv"]) <= APPLY_REL


def test_mamba_cache_init_matches_jax():
    js, ts = JS.MambaSpec(**SPEC), TS.MambaSpec(**SPEC)
    cj = JS.mamba_cache_init(js, 3)
    ct = TS.mamba_cache_init(ts, 3, device="cpu")
    assert sorted(ct) == sorted(cj) == ["conv", "ssm"]
    for k in ct:
        assert tuple(ct[k].shape) == cj[k].shape
        assert str(ct[k].dtype) == f"torch.{cj[k].dtype.name}" \
            == "torch.float32"
        assert not bool(ct[k].any())
    assert TS.mamba_cache_init(ts, 1, torch.bfloat16,
                               "cpu")["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("s", [32, 20], ids=["chunks", "padded"])
def test_mamba_apply_gradients_match_jax(s):
    """Every trained leaf's gradient of <mamba_apply(x), w> (bf16 input)
    against ``jax.grad``."""
    js, ts, jf, jt, tf, tt = _tree()
    xj, xt = _x((2, s, js.d_model), 7, True)
    w = np.random.default_rng(8).standard_normal(
        (2, s, js.d_model)).astype(np.float32)

    def loss_j(t):
        return jnp.sum(JS.mamba_apply(jf, t, js, xj, SCALE)
                       .astype(jnp.float32) * w)

    gj = jax.grad(loss_j)(jt)
    tt = tree_map(lambda t: t.clone().requires_grad_(True), tt)
    loss = (TS.mamba_apply(tf, tt, ts, xt, SCALE).float()
            * torch.from_numpy(w)).sum()
    names = [n for n, _ in flatten_with_names(tt)]
    gt = torch.autograd.grad(loss, tree_leaves(tt))
    gjl = jax.tree.leaves(gj)
    assert len(names) == len(gjl) == len(gt) == 15
    for nm, a, b in zip(names, gjl, gt):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, nm
        assert np.abs(b).max() > 0, nm
        rel = np.linalg.norm(a - b) / np.linalg.norm(a)
        assert rel <= GRAD_L2, (nm, rel)


def test_ssd_equals_own_sequential_recurrence():
    """tests/test_consistency.py's test_ssd_equals_sequential_recurrence
    on the port: the chunked SSD over 32 tokens (4 chunks of 8) against
    32 ``mamba_decode`` steps from an empty cache, within its 1e-2; the
    prefill's final state against the recurrence's."""
    spec = TS.MambaSpec(d_model=32, d_inner=64, head_dim=16, d_state=8,
                        chunk=8)
    fz, tr = TS.mamba_init(torch.Generator().manual_seed(0), spec, "lora",
                           TLoRA(rank=4, alpha=64.0), device="cpu")
    x = torch.randn((2, 32, 32),
                    generator=torch.Generator().manual_seed(1)) * 0.5
    with torch.no_grad():
        y_ssd, final = TS.mamba_forward(fz, tr, spec, x, 16.0,
                                        final_state=True)
        c = TS.mamba_cache_init(spec, 2, device="cpu")
        ys = []
        for t in range(32):
            y, c = TS.mamba_decode(fz, tr, spec, x[:, t:t + 1], c, 16.0)
            ys.append(y)
    y_seq = torch.cat(ys, dim=1)
    assert float((y_ssd.float() - y_seq.float()).abs().max()) < 1e-2
    assert _rel(final["ssm"], c["ssm"]) <= APPLY_REL
    assert torch.equal(final["conv"], c["conv"])


def test_mamba_init_tree_matches_jax():
    """The port's own init: the reference's leaves, shapes and dtypes,
    stacked and not, and its init values of A_log, D, dt_bias, the conv
    bias and the norm; the adapters' b at zero."""
    for stack in ((), (3,)):
        js, ts = JS.MambaSpec(**SPEC), TS.MambaSpec(**SPEC)
        jf, jt = JS.mamba_init(jax.random.PRNGKey(0), js, "lora",
                               JLoRA(rank=4, alpha=64.0), stack)
        tf, tt = TS.mamba_init(torch.Generator().manual_seed(0), ts, "lora",
                               TLoRA(rank=4, alpha=64.0), stack,
                               device="cpu")
        for got, ref in ((tf, jf), (tt, jt)):
            got = dict(flatten_with_names(got))
            want = dict(flatten_with_names(convert.params_from_jax(
                jax.device_get(ref), "cpu")))
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].shape == want[k].shape, k
                assert got[k].dtype == want[k].dtype, k
                if k.split("/")[0] in ("A_log", "D", "dt_bias", "norm") \
                        or k in ("conv/b", "wz/b", "wx/b", "wo/b"):
                    torch.testing.assert_close(got[k], want[k], rtol=1e-6,
                                               atol=0), k


def test_decay_overflow_backward_is_finite():
    """A reference behaviour the port does not copy: where a chunk
    decays by more than fp32's exp range (88.7), the reference's decay
    mask (``exp`` of the whole square, its upper triangle zeroed after)
    overflows, and its backward is NaN (0 * inf) in every gradient
    upstream of the decay (``A_log``, ``dt_bias``, ``wdt``). The port
    masks before the ``exp``: the same forward, every gradient finite,
    and the others the reference's. Here dt_bias = 8 makes dt ~ 8 a
    token, so a chunk of 16 decays by 128 to 2,048."""
    js, ts, jf, jt, tf, tt = _tree()
    jt = dict(jt, dt_bias=jnp.full_like(jt["dt_bias"], 8.0))
    tt = dict(tt, dt_bias=torch.full_like(tt["dt_bias"], 8.0))
    xj, xt = _x((2, 32, js.d_model), 9, True)
    w = np.random.default_rng(10).standard_normal(
        (2, 32, js.d_model)).astype(np.float32)

    def loss_j(t):
        return jnp.sum(JS.mamba_apply(jf, t, js, xj, SCALE)
                       .astype(jnp.float32) * w)

    gj = jax.grad(loss_j)(jt)
    tt = tree_map(lambda t: t.clone().requires_grad_(True), tt)
    yt = TS.mamba_apply(tf, tt, ts, xt, SCALE)
    assert _rel(yt, JS.mamba_apply(jf, jt, js, xj, SCALE)) <= APPLY_REL
    names = [n for n, _ in flatten_with_names(tt)]
    gt = torch.autograd.grad((yt.float() * torch.from_numpy(w)).sum(),
                             tree_leaves(tt))
    upstream = {"A_log", "dt_bias", "wdt/w"}
    for nm, a, b in zip(names, jax.tree.leaves(gj), gt):
        a, b = _np(a), _np(b)
        assert np.isfinite(b).all(), nm
        if nm in upstream:
            assert not np.isfinite(a).all(), nm
        else:
            assert np.isfinite(a).all(), nm
            rel = np.linalg.norm(a - b) / np.linalg.norm(a)
            assert rel <= GRAD_L2, (nm, rel)
