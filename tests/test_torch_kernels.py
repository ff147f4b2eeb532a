"""Port kernels' plain versions vs the JAX package (jnp twins and Pallas
kernels in interpret mode). The CUDA kernels against their plain
versions are in tests/test_torch_cuda.py.

quant_pack: packed words, scale and zp are BIT-exact (scale and zp
compared as uint32 bit patterns). dequant_agg_rows: rtol=atol=1e-5, the
reference's own cross-program contract (repro/kernels/dequant_agg.py),
with row tails exactly zero."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jflat
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.kernels import ops as jops
from repro.kernels.dequant_agg import dequant_agg_rows_pallas
from repro.kernels.quant_pack import quant_pack_pallas
from repro.models import resnet as jresnet
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from test_torch_cuda import _assert_pack_equal, _bits, _cohort, \
    _ragged_rows, _words

torch.set_num_threads(1)

BITS = [2, 4, 8]
# the jnp twin as the JAX package runs it: inside one jitted program
_qpr_jnp = jax.jit(jops._quant_pack_rows_jnp, static_argnums=2)


@pytest.fixture(scope="module")
def resnet8_r8_shapes():
    cfg = jresnet.ResNetConfig(arch="resnet8",
                               lora=JLoRAConfig(rank=8, alpha=128.0))
    return jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0),
                                               cfg))["train"]


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(8, 2048), (16, 512), (5, 100), (1, 64)])
def test_quant_pack_bit_exact_vs_jax(bits, shape):
    rng = np.random.default_rng(bits * 100 + shape[1])
    x = (rng.normal(size=shape) * 2.0).astype(np.float32)
    lane = kops.lane_levels(bits)
    xp = np.pad(x, ((0, 0), (0, (-shape[1]) % lane)))
    nv = np.full((shape[0],), shape[1], np.int32)
    got = kops.quant_pack(torch.from_numpy(x), bits)
    _assert_pack_equal(got, jops.quant_pack(jnp.asarray(x), bits))
    _assert_pack_equal(got, _qpr_jnp(
        jnp.asarray(xp), jnp.asarray(nv), bits))


@pytest.mark.parametrize("bits", BITS)
def test_quant_pack_rows_ragged_resnet_layout(bits, resnet8_r8_shapes):
    """The flat layout's own ragged n_valid (ResNet-8 r=8), with an
    all-zero row, a non-negative row, a negative row and n_valid=0 rows."""
    lo = jflat.layout_for(resnet8_r8_shapes, bits)
    nv = lo.n_valid_vec().copy()
    nv[3] = 0
    x = _ragged_rows(nv, lo.n_max, seed=bits)
    got = kops.quant_pack_rows(torch.from_numpy(x), torch.from_numpy(nv),
                               bits)
    _assert_pack_equal(got, _qpr_jnp(
        jnp.asarray(x), jnp.asarray(nv), bits))
    # the Pallas kernel (interpret mode) on a row subset spanning every
    # leaf length, the degenerate rows included
    rows = np.unique(np.concatenate([
        np.arange(8), np.searchsorted(np.cumsum(nv > -1), np.linspace(
            9, lo.c_total - 1, 16).astype(int))]))[:24]
    want = quant_pack_pallas(jnp.asarray(x[rows]), bits,
                             n_valid=jnp.asarray(nv[rows]),
                             interpret=True)
    _assert_pack_equal([t[rows] for t in got], want)
    # degenerate rows: scale 1, zp +0.0 (bit pattern 0), all-zero words
    zp_bits = _bits(got[2])
    assert zp_bits[0] == 0 and zp_bits[1] == 0 and zp_bits[3] == 0
    assert float(got[1][0]) == 1.0 and float(got[1][3]) == 1.0
    assert not _words(got[0][3]).any()


def test_quant_pack_zero_point_sign():
    """round(-0.0 / scale) is -0.0 and clamp keeps the sign; the
    reference emits +0.0 and the wire carries those bits."""
    x = np.zeros((2, 512), np.float32)
    x[1, :10] = np.arange(10, dtype=np.float32)
    nv = np.array([512, 512], np.int32)
    _, _, zp = kops.quant_pack_rows(torch.from_numpy(x),
                                    torch.from_numpy(nv), 8)
    _, _, zpj = _qpr_jnp(jnp.asarray(x), jnp.asarray(nv), 8)
    assert _bits(zp).tolist() == [0, 0] == _bits(zpj).tolist()


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k", [1, 3, 7])
def test_dequant_agg_rows_vs_jax(bits, k):
    p, s, z, w, nv = _cohort(k, bits, seed=10 * k + bits)
    got = kops.dequant_agg_rows(torch.from_numpy(p), torch.from_numpy(s),
                                torch.from_numpy(z), torch.from_numpy(w),
                                torch.from_numpy(nv), bits).numpy()
    want = np.asarray(jops.dequant_agg_rows(
        jnp.asarray(p), jnp.asarray(s), jnp.asarray(z), jnp.asarray(w),
        jnp.asarray(nv), bits))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    zpz = jnp.where(jnp.asarray(s) > 0, jnp.asarray(z), 0.0)
    pallas = np.asarray(dequant_agg_rows_pallas(
        jnp.asarray(p), jnp.asarray(s), zpz, jnp.asarray(w),
        jnp.asarray(nv), bits, block_k=2, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    tail = np.arange(got.shape[1])[None, :] >= nv[:, None]
    assert (got[tail] == 0.0).all() and (_bits(got[tail]) == 0).all()
    assert (got[-2:] == 0.0).all()


def test_dequant_agg_rows_block_k_bit_identical():
    """Every block_k / whole_k gives the same bits (one sequential fold)."""
    p, s, z, w, nv = _cohort(5, 8, seed=3)
    args = [torch.from_numpy(a) for a in (p, s, z, w, nv)]
    outs = [kops.dequant_agg_rows(*args, 8, block_k=bk).numpy()
            for bk in (1, 2, 4, 5, None)]
    outs.append(kops.dequant_agg_rows(*args, 8, whole_k=True).numpy())
    for o in outs[1:]:
        np.testing.assert_array_equal(_bits(o), _bits(outs[0]))


def test_pack_unpack_words_roundtrip():
    rng = np.random.default_rng(0)
    for bits in BITS:
        lv = rng.integers(0, 1 << bits, size=(3, 64 * (32 // bits)))
        words = kref.pack_words(torch.from_numpy(lv), bits)
        np.testing.assert_array_equal(
            _words(words), np.asarray(jax.device_get(
                jops.ref.pack_words(jnp.asarray(lv, jnp.uint32), bits))))
        np.testing.assert_array_equal(
            kref.unpack_words(words, bits).numpy(), lv)


def test_channel_first_views_match_jax():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    for per_stack in (False, True):
        got = kops.to_channel_first_2d(torch.from_numpy(x), per_stack)
        want = np.asarray(jops.to_channel_first_2d(jnp.asarray(x),
                                                   per_stack))
        np.testing.assert_array_equal(got.numpy(), want)
        back = kops.from_channel_first_2d(got, x.shape, per_stack)
        np.testing.assert_array_equal(back.numpy(), x)


def test_cpu_wrappers_never_launch():
    kops.reset_launch_counts()
    x = torch.zeros((2, 512))
    kops.quant_pack_rows(x, torch.tensor([512, 3]), 8)
    assert kops.launch_counts() == {"quant_pack_rows": 0,
                                    "dequant_agg_rows": 0,
                                    "multi_lora_matmul": 0,
                                    "multi_lora_matmul_packed": 0}


@pytest.mark.parametrize("bits", BITS)
def test_full_width_refs_match_jax(bits):
    """quant_pack_ref / dequant_agg_ref (every column valid) against the
    JAX package's kernels/ref.py."""
    rng = np.random.default_rng(bits)
    xs = (rng.normal(size=(3, 8, 64 * (32 // bits))) * 3).astype(np.float32)
    packs = [kref.quant_pack_ref(torch.from_numpy(x), bits) for x in xs]
    for x, got in zip(xs, packs):
        _assert_pack_equal(got, jops.ref.quant_pack_ref(jnp.asarray(x), bits))
    p, s, z = (torch.stack([t[i] for t in packs]) for i in range(3))
    w = torch.tensor([0.5, 0.3, 0.2])
    got = kref.dequant_agg_ref(p, s, z, w, bits).numpy()
    want = np.asarray(jops.ref.dequant_agg_ref(
        jnp.asarray(p.numpy()), jnp.asarray(s.numpy()),
        jnp.asarray(z.numpy()), jnp.asarray(w.numpy()), bits))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
