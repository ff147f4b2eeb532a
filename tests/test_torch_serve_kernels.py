"""The serving kernels' plain versions vs the JAX package: the jnp twins
(``_multi_lora_matmul_q_jnp``, ``_multi_lora_matmul_jnp``) and the Pallas
kernels in interpret mode. The CUDA kernels against their plain versions
are in tests/test_torch_cuda.py.

Tolerance atol=2e-5, rtol=1e-5: the reference's own fused-vs-fp contract
(tests/test_serve.py), since the two frameworks sum the contractions in
different orders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.lora_matmul import (multi_lora_matmul_pallas,
                                       multi_lora_matmul_q_pallas)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from test_torch_cuda import _packed_slabs, _serve_inputs

torch.set_num_threads(1)

BITS = [2, 4, 8]
TOL = dict(atol=2e-5, rtol=1e-5)
# (m, k, n, r, e, r_valid): tests/test_serve.py's shapes, a ragged K (60
# levels: a partial last word at every width), the rank-4 bucket (RW=1
# holding 8 int4 slots, 4 valid) and rank-6 adapters padded into the
# rank-8 bucket (scale-0 A rows)
CASES = [(8, 64, 128, 8, 5, 8), (16, 64, 128, 8, 5, 8), (8, 60, 128, 8, 5, 8),
         (8, 64, 128, 4, 3, 4), (8, 60, 64, 8, 4, 6)]


def _case(bits, case):
    m, k, n, r, e, rv = case
    _, _, packed = _packed_slabs(e, k, n, r, bits, seed=bits * 10 + k,
                                 r_valid=rv)
    x, w, ids = _serve_inputs(m, k, n, e, seed=m * 7 + n)
    return x, w, packed, ids


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("case", CASES)
def test_packed_ref_matches_jnp_twin(bits, case):
    x, w, packed, ids = _case(bits, case)
    got = kref.multi_lora_matmul_q_ref(
        torch.from_numpy(x), torch.from_numpy(w),
        *[torch.from_numpy(a) for a in packed], torch.from_numpy(ids), 0.5,
        bits)
    want = jops._multi_lora_matmul_q_jnp(
        jnp.asarray(x), jnp.asarray(w), *[jnp.asarray(a) for a in packed],
        jnp.asarray(ids), 0.5, bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("case", CASES)
def test_packed_ref_matches_pallas_interpret(bits, case):
    x, w, packed, ids = _case(bits, case)
    got = kops.multi_lora_matmul_packed(
        torch.from_numpy(x), torch.from_numpy(w),
        *[torch.from_numpy(a) for a in packed], ids.tolist(), 0.5, bits)
    want = multi_lora_matmul_q_pallas(
        jnp.asarray(x), jnp.asarray(w), *[jnp.asarray(a) for a in packed],
        jnp.asarray(ids), 0.5, bits, block_m=4, block_n=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES[:3])
def test_fp_ref_matches_jnp_twin_and_pallas(case):
    m, k, n, r, e, _ = case
    a, b, _ = _packed_slabs(e, k, n, r, 8, seed=k + r)
    x, w, ids = _serve_inputs(m, k, n, e, seed=m + n)
    got = kops.multi_lora_matmul(*[torch.from_numpy(v) for v in
                                   (x, w, a, b)], ids.tolist(), 0.5)
    jargs = [jnp.asarray(v) for v in (x, w, a, b, ids)]
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops._multi_lora_matmul_jnp(*jargs, 0.5)),
        **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(multi_lora_matmul_pallas(
            *jargs[:4], jargs[4], 0.5, block_m=4, block_n=64,
            interpret=True)), **TOL)


@pytest.mark.parametrize("bits", [4, 8])
def test_packed_equals_fp_on_its_dequant(bits):
    """The fused dequant IS the codec's dequant: the packed slabs through
    the packed wrapper equal their dequantized stacks through the fp
    wrapper."""
    m, k, n, r, e = 8, 60, 64, 8, 4
    _, _, packed = _packed_slabs(e, k, n, r, bits, seed=3, r_valid=6)
    x, w, ids = _serve_inputs(m, k, n, e, seed=4)
    pt = [torch.from_numpy(a) for a in packed]
    aq, a_s, a_z, bq, b_s, b_z = pt
    adeq = (kref.unpack_words(aq, bits)[..., :k].float() - a_z[..., None]) \
        * a_s[..., None]
    bdeq = (kref.unpack_words(bq, bits)[..., :r].float() - b_z[..., None]) \
        * b_s[..., None]
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = kops.multi_lora_matmul_packed(xt, wt, *pt, ids.tolist(), 0.5, bits)
    want = kops.multi_lora_matmul(xt, wt, adeq.transpose(1, 2).contiguous(),
                                  bdeq.transpose(1, 2).contiguous(),
                                  ids.tolist(), 0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # the scale-0 rank padding gives exact-zero A lanes
    assert torch.all(adeq[:, 6:] == 0.0)


def test_cpu_wrappers_launch_nothing_and_check_ids():
    x, w, packed, ids = _case(4, CASES[0])
    pt = [torch.from_numpy(a) for a in packed]
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    kops.reset_launch_counts()
    kops.multi_lora_matmul_packed(xt, wt, *pt, ids.tolist(), 0.5, 4)
    assert kops.launch_counts()["multi_lora_matmul_packed"] == 0
    e = packed[0].shape[0]
    with pytest.raises(ValueError, match="ids"):
        kops.multi_lora_matmul_packed(xt, wt, *pt, [e] * x.shape[0], 0.5, 4)
    with pytest.raises(ValueError, match="ids"):
        kops.multi_lora_matmul_packed(xt, wt, *pt, [0], 0.5, 4)
    with pytest.raises(ValueError, match="bits"):
        kops.multi_lora_matmul_packed(xt, wt, *pt, ids.tolist(), 0.5, 3)
    with pytest.raises(ValueError, match="too short"):
        kops.multi_lora_matmul_packed(xt, wt, pt[0][..., :1], *pt[1:],
                                      ids.tolist(), 0.5, 4)


# adapter ranks past 128, which the JAX wrappers compute (the fp one pads R
# to a multiple of 128 on the TPU; the packed one takes any R): m, k, n,
# R, E, with R = 150 valid ranks padded into the R = 160 bucket for the
# packed slabs
HIGH_RANK = (8, 64, 128, 160, 3)
HIGH_RANK_TOL = dict(atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("bits", BITS)
def test_packed_rank_160_matches_jax(bits):
    m, k, n, r, e = HIGH_RANK
    _, _, packed = _packed_slabs(e, k, n, r, bits, seed=bits + 40,
                                 r_valid=150)
    x, w, ids = _serve_inputs(m, k, n, e, seed=41)
    got = kops.multi_lora_matmul_packed(
        torch.from_numpy(x), torch.from_numpy(w),
        *[torch.from_numpy(a) for a in packed], ids.tolist(), 0.5, bits)
    jargs = [jnp.asarray(v) for v in (x, w, *packed)]
    for want in (jops.multi_lora_matmul_packed(*jargs, jnp.asarray(ids), 0.5,
                                               bits),
                 jops._multi_lora_matmul_q_jnp(*jargs, jnp.asarray(ids), 0.5,
                                               bits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **HIGH_RANK_TOL)


def test_fp_rank_160_matches_jax():
    m, k, n, r, e = HIGH_RANK
    a, b, _ = _packed_slabs(e, k, n, r, 8, seed=42)
    x, w, ids = _serve_inputs(m, k, n, e, seed=43)
    got = kops.multi_lora_matmul(*[torch.from_numpy(v) for v in
                                   (x, w, a, b)], ids.tolist(), 0.5)
    jargs = [jnp.asarray(v) for v in (x, w, a, b, ids)]
    for want in (jops.multi_lora_matmul(*jargs, 0.5),
                 jops._multi_lora_matmul_jnp(*jargs, 0.5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **HIGH_RANK_TOL)
