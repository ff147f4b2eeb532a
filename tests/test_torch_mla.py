"""The port's multi-head latent attention (``repro_torch.models.attention``
MLA) against the JAX package's on identical inputs and JAX-initialized
parameters: ``mla_apply`` (per-head K and V from the latent, q/k width
192-style ``qk_dim`` beside a narrower v), ``mla_decode`` (the latent
cache, weight absorption) over several positions, ``_eff_weight``, the
init and cache trees, and the LM's ``_rope_for`` at an MLA layer (the
rope width is ``qk_rope_dim``, not ``head_dim``).

Tolerances. Both packages run the linears in bf16 and the attention
products in fp32 over bf16-rounded operands; the JAX functions run op by
op here. Outputs are held within 2e-2 of max|y| (a bf16 ulp is 2^-8;
measured 0.0625 of 14.2, 0.44%, on mla_apply), the caches within 2e-2
of max|c|, and the fp32 merge of ``_eff_weight`` within rtol 1e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lora import LoRAConfig as JLoRA
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import convert
from repro_torch.core.lora import LoRAConfig as TLoRA
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.utils.tree import flatten_with_names

torch.set_num_threads(2)

REL = 2e-2
F32_RTOL = 1e-5
SCALE = 16.0
FIELDS = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
              qk_nope_dim=16, qk_rope_dim=8, v_head_dim=12)


def _t(x):
    return convert.params_from_jax(jax.device_get(x), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel=REL) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)
    return err


@functools.lru_cache(maxsize=None)
def _params():
    js, ts = JA.MLASpec(**FIELDS), TA.MLASpec(**FIELDS)
    fz, tr = JA.mla_init(jax.random.PRNGKey(0), js, "lora",
                         JLoRA(rank=4, alpha=64.0))
    rng = np.random.default_rng(1)
    tr = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 * jnp.asarray(rng.standard_normal(x.shape),
                                            x.dtype)
        if str(p[-1]) == "['b']" else x, tr)
    return js, ts, fz, tr, _t(fz), _t(tr)


def _x(shape, seed):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16)


def _ropes(positions, dim):
    return (JL.rope_for_positions(jnp.asarray(positions), dim, 1e4),
            TL.rope_for_positions(torch.as_tensor(positions), dim, 1e4))


@pytest.mark.parametrize("kv_chunk", [1024, 5], ids=["one_chunk", "chunks"])
def test_mla_apply_matches_jax(kv_chunk):
    js, ts, fz, tr, tfz, ttr = _params()
    xj, xt = _x((2, 12, js.d_model), seed=2)
    jr, tr_ = _ropes(np.arange(12)[None], js.qk_rope_dim)
    yj = JA.mla_apply(fz, tr, js, xj, SCALE, jr, kv_chunk=kv_chunk)
    yt = TA.mla_apply(tfz, ttr, ts, xt, SCALE, tr_, kv_chunk=kv_chunk)
    assert yt.dtype == torch.bfloat16
    _close(yt, yj)
    # the latent the cache keeps
    cj, kj = JA._mla_latent(fz, tr, js, xj, SCALE, jr)
    ct, kt = TA._mla_latent(tfz, ttr, ts, xt, SCALE, tr_)
    assert ct.shape == (2, 12, js.kv_lora_rank) \
        and kt.shape == (2, 12, js.qk_rope_dim)
    _close(ct, cj)
    _close(kt, kj)


def test_mla_decode_matches_jax():
    """Four decode steps at positions 9..12 of a 16-slot latent cache
    whose first 9 slots hold a random prefix: every output and the
    cache after each step. The port writes the cache in place."""
    js, ts, fz, tr, tfz, ttr = _params()
    smax, start = 16, 9
    rng = np.random.default_rng(3)
    cache_j = JA.mla_cache_init(js, 2, smax)
    pre = {k: jnp.asarray(np.where(
        np.arange(smax)[None, :, None] < start,
        rng.standard_normal(v.shape), 0.0), jnp.bfloat16)
        for k, v in cache_j.items()}
    cache_t = TA.mla_cache_init(ts, 2, smax, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in cache_t.items()} == \
        {"ckv": ((2, smax, js.kv_lora_rank), torch.bfloat16),
         "kr": ((2, smax, js.qk_rope_dim), torch.bfloat16)}
    for k, v in _t(pre).items():
        cache_t[k].copy_(v)
    cache_j = pre
    for step, pos in enumerate(range(start, start + 4)):
        xj, xt = _x((2, 1, js.d_model), seed=10 + step)
        jr, tr_ = _ropes(np.full((2, 1), pos), js.qk_rope_dim)
        yj, cache_j = JA.mla_decode(fz, tr, js, xj, cache_j,
                                    jnp.asarray(pos), SCALE, jr)
        yt, same = TA.mla_decode(tfz, ttr, ts, xt, cache_t, pos, SCALE, tr_)
        assert same is cache_t
        _close(yt, yj)
        for k in ("ckv", "kr"):
            _close(cache_t[k], cache_j[k])


@pytest.mark.parametrize("mode", ["lora", "dense", "frozen"])
def test_eff_weight_matches_jax(mode):
    from repro.core.lora import linear_init as jlinear_init
    fz, tr = jlinear_init(jax.random.PRNGKey(4), 16, 24, mode,
                          JLoRA(rank=4, alpha=64.0))
    if "b" in tr:
        tr = dict(tr, b=tr["b"] + 0.1)
    want = JA._eff_weight(fz, tr, SCALE)
    got = TA._eff_weight(_t(fz), _t(tr), SCALE)
    assert got.dtype == convert.params_from_jax(
        np.asarray(jax.device_get(want)), "cpu").dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_RTOL,
                               atol=F32_RTOL)


def test_mla_init_tree_matches_jax():
    js, ts = JA.MLASpec(**FIELDS), TA.MLASpec(**FIELDS)
    for stack in ((), (3,)):
        jf, jt = JA.mla_init(jax.random.PRNGKey(0), js, "lora",
                             JLoRA(rank=4, alpha=64.0), stack)
        tf, tt = TA.mla_init(torch.Generator().manual_seed(0), ts, "lora",
                             TLoRA(rank=4, alpha=64.0), stack, device="cpu")
        for got, want in ((tf, _t(jf)), (tt, _t(jt))):
            got, want = dict(flatten_with_names(got)), \
                dict(flatten_with_names(want))
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].shape == want[k].shape, k
                assert got[k].dtype == want[k].dtype, k
                if k.endswith("/b") or k.endswith("scale"):
                    assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "gemma3-4b"])
def test_rope_for_takes_the_mla_rope_width(arch):
    """At an MLA layer the rope spans ``qk_rope_dim`` (deepseek-v2: 64
    of the 128-wide head); at a GQA layer ``head_dim``, as in the JAX
    package's ``_rope_for``."""
    from repro.configs import registry as JR
    from repro_torch.configs import registry as TR
    jc, tc = JR.get(arch).full(), TR.get(arch).full()
    pos = np.arange(7)[None]
    for jg, tg in zip(JLM.resolve_groups(jc), TLM.resolve_groups(tc)):
        for jspec, tspec in zip(jg.pattern, tg.pattern):
            cj, sj = JLM._rope_for(jc, jspec, jnp.asarray(pos))
            ct, st = TLM._rope_for(tc, tspec, torch.as_tensor(pos))
            width = (tc.mla.qk_rope_dim if tspec.mixer == "mla"
                     else tc.head_dim)
            assert ct.shape[-1] * 2 == width
            np.testing.assert_allclose(_np(ct), _np(cj), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(_np(st), _np(sj), rtol=1e-6,
                                       atol=1e-6)
