"""The per-leaf aggregate (B3, ``dequant_agg``) and the single-adapter
LoRA matmul (B6, ``lora_matmul``): the port's plain versions against the
JAX package.

B3: BIT-identical to the Pallas kernel ``dequant_agg_pallas`` run in
interpret mode and to the JAX wrapper ``ops.dequant_agg``, with scale = 0
rows, ragged C and scalar, vector and absent ``n_valid``. B6: within
8e-3 * max|y| of the JAX wrapper ``ops.lora_matmul`` (Pallas, interpret
mode), whose single K tile rounds h exactly as the plain version does,
and within the reference's own 2e-2 * max|y| of the JAX package's
``kernels/ref.py`` ``lora_matmul_ref``, which never rounds h. The CUDA
kernels against these plain versions are in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dequant_agg import dequant_agg_pallas
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

torch.set_num_threads(1)

BITS = [2, 4, 8]
# tests/test_kernels.py's four shapes (m, k, n, r)
LORA_SHAPES = [(128, 256, 192, 8), (64, 128, 128, 32), (256, 512, 256, 128),
               (8, 128, 128, 4)]


def _leaf_cohort(k: int, bits: int, c: int, nw: int, seed: int):
    """K clients' packed words of one leaf (random bits: word tails are
    nonzero), sidecars with two scale = 0 rows whose zp is nonzero, and
    weights with a -0.0 (its contributions are -0.0 or +0.0: the fold's
    init decides the sign of a zero sum)."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 1 << 32, size=(k, c, nw), dtype=np.uint32)
    s = rng.uniform(1e-3, 1e-1, size=(k, c)).astype(np.float32)
    s[:, 1:3] = 0.0
    z = rng.integers(0, 1 << bits, size=(k, c)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=k).astype(np.float32)
    w[0] = -0.0
    nv = rng.integers(0, nw * (32 // bits) + 1, size=c).astype(np.int32)
    return p, s, z, w, nv


def _u32(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("nv_kind", ["none", "scalar", "vector"])
def test_dequant_agg_bit_identical_to_pallas(bits, k, nv_kind):
    c, nw = 13, 24                      # C is not a multiple of block_c
    p, s, z, w, nv = _leaf_cohort(k, bits, c, nw, seed=bits * 10 + k)
    n = nw * (32 // bits)
    arg = {"none": None, "scalar": n - 7, "vector": nv}[nv_kind]
    got = kops.dequant_agg(*(torch.from_numpy(a) for a in (p, s, z, w)),
                           bits, arg)
    assert tuple(got.shape) == (c, n)
    zpz = np.where(s > 0, z, 0.0).astype(np.float32)
    jnv = None if arg is None else (arg if nv_kind == "scalar"
                                    else jnp.asarray(arg))
    pallas = dequant_agg_pallas(jnp.asarray(p), jnp.asarray(s),
                                jnp.asarray(zpz), jnp.asarray(w), bits,
                                n_valid=jnv, interpret=True)
    np.testing.assert_array_equal(_u32(got), _u32(pallas))
    vec = None if arg is None else jnp.asarray(
        np.broadcast_to(np.asarray(arg, np.int32), (c,)))
    wrapped = jops.dequant_agg(jnp.asarray(p), jnp.asarray(s), jnp.asarray(z),
                               jnp.asarray(w), bits, n_valid=vec)
    np.testing.assert_array_equal(_u32(got), _u32(wrapped))
    if arg is not None:                 # tails are exact +0.0
        nvv = np.broadcast_to(np.asarray(arg), (c,))
        tail = np.arange(n)[None, :] >= nvv[:, None]
        assert (_u32(got)[tail] == 0).all()


def test_dequant_agg_differs_from_flat_fold_only_in_association():
    """B3 and B2 fold the same clients in different orders: on the same
    inputs they agree within a few ulp, and B3's init keeps a -0.0 that
    B2's 0.0 start turns positive."""
    bits, k = 8, 5
    p, s, z, w, nv = _leaf_cohort(k, bits, 10, 64, seed=3)
    w[0] = 0.5
    args = [torch.from_numpy(a) for a in (p, s, z, w)]
    b3 = kops.dequant_agg(*args, bits, torch.from_numpy(nv))
    b2 = kops.dequant_agg_rows(*args, torch.from_numpy(nv), bits)
    torch.testing.assert_close(b3, b2, rtol=1e-6, atol=1e-6)
    one = [torch.from_numpy(a) for a in (p[:1], s[:1], z[:1])]
    neg = torch.tensor([-1.0])
    assert (kops.dequant_agg(*one, neg, bits) == 0).any()
    zero_b3 = _u32(kops.dequant_agg(*one, neg * 0.0, bits))
    assert (zero_b3 == 0x80000000).any()
    zero_b2 = _u32(kops.dequant_agg_rows(*one, neg * 0.0, torch.full(
        (10,), 256, dtype=torch.int32), bits))
    assert not (zero_b2 == 0x80000000).any()


def test_dequant_agg_checks_inputs():
    p, s, z, w, nv = _leaf_cohort(2, 8, 4, 8, seed=0)
    args = [torch.from_numpy(a) for a in (p, s, z, w)]
    with pytest.raises(ValueError):
        kops.dequant_agg(*args, 3)
    with pytest.raises(ValueError):
        kops.dequant_agg(*args, 8, np.arange(5))


def _bf16(rng, shape, scale):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16)


def _lora_inputs(m, k, n, r, seed):
    rng = np.random.default_rng(seed)
    return (_bf16(rng, (m, k), 0.5), _bf16(rng, (k, n), 0.1),
            _bf16(rng, (k, r), 0.1), _bf16(rng, (r, n), 0.1))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("shape", LORA_SHAPES)
def test_lora_matmul_matches_jax(shape):
    m, k, n, r = shape
    xs = _lora_inputs(m, k, n, r, seed=m + r)
    got = kops.lora_matmul(*(_t(a) for a in xs), 2.0)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    got = got.to(torch.float32).numpy()
    pallas = np.asarray(jops.lora_matmul(*(jnp.asarray(a) for a in xs), 2.0),
                        np.float32)
    ymax = float(np.abs(pallas).max())
    assert float(np.abs(got - pallas).max()) <= 8e-3 * ymax
    want = np.asarray(jref.lora_matmul_ref(*(jnp.asarray(a) for a in xs),
                                           2.0), np.float32)
    assert float(np.abs(got - want).max()) <= 2e-2 * (
        float(np.abs(want).max()) + 1e-6)


def test_lora_matmul_zero_adapter_is_base():
    x, w, a, _ = _lora_inputs(64, 128, 128, 8, seed=0)
    b = np.zeros((8, 128), ml_dtypes.bfloat16)
    got = kops.lora_matmul(_t(x), _t(w), _t(a), _t(b), 16.0)
    base = (_t(x).to(torch.float32) @ _t(w).to(torch.float32)).to(
        torch.bfloat16)
    assert torch.equal(got, base)


def test_lora_matmul_ragged_within_reference_bound():
    """A ragged (100, 300, 200, r=6): the plain version against the JAX
    package's reference (h never rounded) within its 2e-2 bound."""
    xs = _lora_inputs(100, 300, 200, 6, seed=5)
    got = kops.lora_matmul(*(_t(a) for a in xs), 2.0).to(torch.float32)
    want = np.asarray(jref.lora_matmul_ref(*(jnp.asarray(a) for a in xs),
                                           2.0), np.float32)
    assert float(np.abs(got.numpy() - want).max()) <= 2e-2 * float(
        np.abs(want).max())


@pytest.mark.parametrize("r", [160, 256])
def test_lora_matmul_ranks_past_128_match_jax(r):
    """Ranks above 128, which the JAX wrapper pads to a multiple of 128
    and computes: within 8e-3 * max|y| of it (Pallas, interpret mode, one
    K tile) and within 2e-2 * max|y| of the JAX package's reference."""
    xs = _lora_inputs(16, 256, 128, r, seed=r)
    got = kops.lora_matmul(*(_t(a) for a in xs), 2.0)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (16, 128)
    got = got.to(torch.float32).numpy()
    pallas = np.asarray(jops.lora_matmul(*(jnp.asarray(a) for a in xs), 2.0),
                        np.float32)
    assert float(np.abs(got - pallas).max()) <= 8e-3 * float(
        np.abs(pallas).max())
    want = np.asarray(jref.lora_matmul_ref(*(jnp.asarray(a) for a in xs),
                                           2.0), np.float32)
    assert float(np.abs(got - want).max()) <= 2e-2 * float(
        np.abs(want).max())
    assert kops.lora_plan(16, 256, 128, r).path == "masked"


def test_lora_matmul_refuses_rank_zero():
    x, w, a, b = (torch.zeros(s, dtype=torch.bfloat16)
                  for s in ((4, 8), (8, 8), (8, 0), (0, 8)))
    with pytest.raises(ValueError, match="rank"):
        kops.lora_matmul(x, w, a, b, 1.0)


def test_cpu_leaf_wrappers_never_launch():
    kops.reset_launch_counts()
    p, s, z, w, _ = _leaf_cohort(2, 4, 4, 8, seed=1)
    kops.dequant_agg(*(torch.from_numpy(a) for a in (p, s, z, w)), 4)
    kops.lora_matmul(*(_t(a) for a in _lora_inputs(8, 16, 16, 4, 0)), 1.0)
    assert kops.launch_counts()["dequant_agg"] == 0
    assert kops.launch_counts()["lora_matmul"] == 0
