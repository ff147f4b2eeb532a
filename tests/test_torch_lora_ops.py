"""The port's conv-LoRA helpers against the JAX package's on the CPU:
``conv_lora_apply`` at unequal strides with SAME, VALID and explicit
padding (rtol 1e-5, atol 1e-6: fp32 convolutions), ``conv_merge`` (the
merged kernel's conv equals the base conv plus the adapter, rtol 1e-5,
atol 1e-5), and the ``FLoCoRAConfig.head_mode`` field."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import flocora as jflocora
from repro.core import lora as jlora
from repro_torch import core as tcore
from repro_torch.core import lora as tlora
from repro_torch.core.flocora import FLoCoRAConfig

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _operands(h, w, cin, cout, kh, kw, r, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, h, w, cin)).astype(np.float32),
            rng.normal(size=(kh, kw, cin, cout)).astype(np.float32) * 0.2,
            rng.normal(size=(kh, kw, cin, r)).astype(np.float32) * 0.2,
            rng.normal(size=(1, 1, r, cout)).astype(np.float32) * 0.2)


PADDINGS = ["SAME", "VALID", ((1, 0), (0, 2)), ((0, 1), (2, 1))]


@pytest.mark.parametrize("stride", [(1, 2), (2, 1), (2, 2), 3],
                         ids=["1x2", "2x1", "2x2", "3"])
@pytest.mark.parametrize("padding", PADDINGS,
                         ids=["same", "valid", "pads_a", "pads_b"])
def test_conv_lora_apply_matches_jax(stride, padding):
    x, _, b, a = _operands(9, 8, 5, 6, 3, 3, 4)
    js = (stride, stride) if isinstance(stride, int) else stride
    want = np.asarray(jlora.conv_lora_apply(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(a), 1.5, js, padding))
    got = tlora.conv_lora_apply(torch.from_numpy(x), torch.from_numpy(b),
                                torch.from_numpy(a), 1.5, stride, padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv2d_rejects_unknown_padding():
    x, w, _, _ = _operands(8, 8, 3, 4, 3, 3, 2)
    with pytest.raises(ValueError):
        tlora.conv2d_nchw(torch.from_numpy(x).permute(0, 3, 1, 2),
                          torch.from_numpy(w), 1, "FULL")


@pytest.mark.parametrize("kh,stride", [(3, (1, 1)), (3, (2, 1)),
                                       (1, (2, 2))])
def test_conv_merge_matches_jax(kh, stride):
    x, p, b, a = _operands(8, 8, 5, 6, kh, kh, 4)
    want = np.asarray(jlora.conv_merge(jnp.asarray(p), jnp.asarray(b),
                                       jnp.asarray(a), 2.0))
    got = tlora.conv_merge(torch.from_numpy(p), torch.from_numpy(b),
                           torch.from_numpy(a), 2.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # conv with the merged kernel == base conv + the adapter's chain
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    merged = tlora.conv2d_nchw(xt, got, stride)
    split = tlora.conv2d_nchw(xt, torch.from_numpy(p), stride) \
        + tlora.conv_lora_apply_nchw(xt, torch.from_numpy(b),
                                     torch.from_numpy(a), 2.0, stride)
    np.testing.assert_allclose(merged.numpy(), split.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_conv_merge_keeps_dtype():
    _, p, b, a = _operands(4, 4, 3, 4, 3, 3, 2)
    got = tlora.conv_merge(torch.from_numpy(p).to(torch.bfloat16),
                           torch.from_numpy(b), torch.from_numpy(a), 1.0)
    assert got.dtype == torch.bfloat16


def test_core_exports_match_reference():
    for name in ("conv_merge", "dense_lora_apply", "dense_merge"):
        assert callable(getattr(tcore, name))
        assert callable(getattr(jcore, name))


@pytest.mark.parametrize("mode", ["dense", "lora", "frozen"])
def test_head_mode_is_carried(mode):
    got = FLoCoRAConfig(quant_bits=8, head_mode=mode)
    want = jflocora.FLoCoRAConfig(quant_bits=8, head_mode=mode)
    assert got.head_mode == want.head_mode == mode
    assert FLoCoRAConfig().head_mode == jflocora.FLoCoRAConfig().head_mode
