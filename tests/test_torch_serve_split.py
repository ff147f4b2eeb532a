"""The serving kernels' split-bf16 base product, emulated on the CPU.

``csrc/multi_lora_matmul.cu`` computes x@W on the tensor cores as
``xhi@Whi + xlo@Whi + xhi@Wlo`` with fp32 accumulators, where
``hi = bf16(v)`` and ``lo = bf16(v - hi)``. No CUDA kernel runs here, so
this file emulates that product with casts and holds the whole serving
function built on it to the plain versions (``kref.multi_lora_matmul_q_ref``,
``kref.multi_lora_matmul_ref``) and to the JAX package's twin within the
card's contract, rtol = atol = 1e-4, at the serving width (d = 2560) with
inputs scaled as ``make_store``'s (x 0.5 randn, W 0.05 randn, adapters
0.1 randn, int4). A single bf16 or TF32 pass misses that contract; the
last tests show it, so a product cut back to one pass fails here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

torch.set_num_threads(4)

TOL = dict(rtol=1e-4, atol=1e-4)
S = 0.5
E = 6
# (m, k, n, r): the simulator's batch, a rank bucket of the m = 64 step,
# the whole step, and the card check's ragged widths and rank
CASES = [(8, 2560, 2560, 8), (32, 2560, 2560, 8), (64, 2560, 2560, 8),
         (64, 2559, 2555, 6)]


def split_bf16(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as fp32 values that bf16 holds exactly: hi = bf16(v),
    lo = bf16(v - hi); v - hi is exact in fp32."""
    hi = v.to(torch.bfloat16).to(torch.float32)
    return hi, (v - hi).to(torch.bfloat16).to(torch.float32)


def split_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's x@W: three bf16 passes into fp32, lo@lo dropped."""
    xh, xl = split_bf16(x)
    wh, wl = split_bf16(w)
    return xh @ wl + xl @ wh + xh @ wh


def one_pass_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return split_bf16(x)[0] @ split_bf16(w)[0]


def tf32(v: torch.Tensor) -> torch.Tensor:
    """v rounded to TF32 (10 explicit mantissa bits, to nearest even)."""
    b = v.contiguous().view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.to(torch.int32).view(torch.float32)


def one_pass_tf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return tf32(x) @ tf32(w)


def _inputs(m, k, n, r, seed):
    """x, W, fp stacks A (E, K, R), B (E, R, N), their int4 wire rows
    (aq, a_scale, a_zp, bq, b_scale, b_zp) and ids, numpy-seeded."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((E, k, r)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((E, r, n)) * 0.1).astype(np.float32)
    ids = rng.integers(0, E, m).astype(np.int32)
    bits, per = 4, 8
    kw, rw = -(-k // per), -(-r // per)

    def pack(rows, width):
        xp = np.pad(rows, ((0, 0), (0, width * per - rows.shape[1])))
        p, sc, zp = kref.quant_pack_ref(torch.from_numpy(xp), bits)
        return p, sc, zp

    aq, a_s, a_z, bq, b_s, b_z = ([] for _ in range(6))
    for i in range(E):
        p, sc, zp = pack(a[i].T, kw)
        aq.append(p), a_s.append(sc), a_z.append(zp)
        p, sc, zp = pack(b[i].T, rw)
        bq.append(p), b_s.append(sc), b_z.append(zp)
    packed = [torch.stack(t) for t in (aq, a_s, a_z, bq, b_s, b_z)]
    return (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(a),
            torch.from_numpy(b), packed, torch.from_numpy(ids))


def _dequant(packed, k, r):
    aq, a_s, a_z, bq, b_s, b_z = packed
    la = kref.unpack_words(aq, 4)[..., :k].to(torch.float32)
    lb = kref.unpack_words(bq, 4)[..., :r].to(torch.float32)
    adeq = (la - a_z[..., None]) * a_s[..., None]          # (E, R, K)
    bdeq = (lb - b_z[..., None]) * b_s[..., None]          # (E, N, R)
    # (E, K, R), (E, R, N)
    return adeq.transpose(1, 2), bdeq.transpose(1, 2)


def emulated(x, w, a_stack, b_stack, ids, product=split_product):
    """The serving function with the kernel's base product: acc + s*y,
    h and y in fp32 as the kernel's CUDA-core parts compute them."""
    ids = ids.to(torch.int64)
    h = torch.einsum("mk,mkr->mr", x, a_stack[ids])
    y = torch.einsum("mr,mrn->mn", h, b_stack[ids])
    return product(x, w) + S * y


@pytest.mark.parametrize("case", CASES)
def test_split_packed_within_contract(case):
    m, k, n, r = case
    x, w, _, _, packed, ids = _inputs(m, k, n, r, seed=m + k)
    a_deq, b_deq = _dequant(packed, k, r)
    got = emulated(x, w, a_deq, b_deq, ids)
    want = kref.multi_lora_matmul_q_ref(x, w, *packed, ids, S, 4)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_split_fp_within_contract(case):
    m, k, n, r = case
    x, w, a, b, _, ids = _inputs(m, k, n, r, seed=m + n + 1)
    got = emulated(x, w, a, b, ids)
    want = kref.multi_lora_matmul_ref(x, w, a, b, ids, S)
    torch.testing.assert_close(got, want, **TOL)


def test_split_matches_jax_twin():
    """The JAX package's fused serving matmul (its jnp twin) at the
    m = 64 step's shape, against the emulated kernel arithmetic."""
    m, k, n, r = CASES[2]
    x, w, _, _, packed, ids = _inputs(m, k, n, r, seed=3)
    a_deq, b_deq = _dequant(packed, k, r)
    got = emulated(x, w, a_deq, b_deq, ids)
    want = jops._multi_lora_matmul_q_jnp(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        *[jnp.asarray(t.numpy()) for t in packed], jnp.asarray(ids.numpy()),
        S, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_split_parts_are_exact():
    """hi + lo carries 16 significant bits of v, and v - hi loses none."""
    v = torch.from_numpy((np.random.default_rng(0).standard_normal(4096)
                          * 0.05).astype(np.float32))
    hi, lo = split_bf16(v)
    assert torch.equal((v - hi) + hi, v)
    rel = ((hi + lo - v).abs() / v.abs()).max()
    assert float(rel) <= 2.0 ** -16


@pytest.mark.parametrize("product", [one_pass_bf16, one_pass_tf32],
                         ids=["bf16", "tf32"])
def test_one_pass_misses_contract(product):
    """One bf16 or TF32 pass breaks rtol = atol = 1e-4 at d = 2560; the
    three-pass split on the same inputs keeps it."""
    m, k, n, r = CASES[2]
    x, w, a, b, _, ids = _inputs(m, k, n, r, seed=11)
    want = kref.multi_lora_matmul_ref(x, w, a, b, ids, S)
    one = emulated(x, w, a, b, ids, product=product)
    err = (one - want).abs()
    assert bool((err > TOL["atol"] + TOL["rtol"] * want.abs()).any())
    torch.testing.assert_close(emulated(x, w, a, b, ids), want, **TOL)


@pytest.mark.parametrize("m,k", [(1, 60), (8, 2560), (32, 2560), (64, 2560),
                                 (64, 2559), (5, 2559), (512, 256)])
def test_h_splits_cover_k(m, k):
    """The h kernel's k chunks: whole 32-level pieces (packed words never
    straddle two chunks), covering K with no empty chunk, at most
    ``SERVE_H_SPLITS_MAX`` of them, and at least ``SERVE_H_BLOCKS`` / 2
    blocks where K and that cap allow."""
    splits, chunk = kops.serving_h_splits(m, k)
    assert chunk % kops.SERVE_H_CHUNK == 0
    assert (splits - 1) * chunk < k <= splits * chunk
    assert splits <= kops.SERVE_H_SPLITS_MAX
    assert m * splits >= min(kops.SERVE_H_BLOCKS // 2,
                             m * kops.SERVE_H_SPLITS_MAX // 2,
                             m * -(-k // kops.SERVE_H_CHUNK))
