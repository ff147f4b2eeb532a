"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports nothing of JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Without a CUDA device every test here skips. The helpers at the top also
build the inputs of tests/test_torch_kernels.py (the JAX parity tests).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import flat as tflat
from repro_torch.core.lora import LoRAConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import resnet

BITS = [2, 4, 8]


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _words(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).astype(np.uint32)


def _assert_pack_equal(got, want):
    np.testing.assert_array_equal(_words(got[0]), _words(want[0]))
    np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]))
    np.testing.assert_array_equal(_bits(got[2]), _bits(want[2]))


def _ragged_rows(n_valid: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Rows of varied scale and sign; the tail past each row's length is
    nonzero garbage, which the quantizer must never see."""
    rng = np.random.default_rng(seed)
    c = n_valid.shape[0]
    x = rng.normal(size=(c, n)) * rng.uniform(0.01, 5.0, size=(c, 1))
    x = x.astype(np.float32)
    x[1, :] = np.abs(x[1, :])                       # xmin = 0: zp = +0.0
    x[2, :] = -np.abs(x[2, :])                      # all negative
    tail = np.arange(n)[None, :] >= n_valid[:, None]
    x[tail] = 7.0
    x[0, :] = 0.0                                   # all-zero row
    return x


def _cohort(k: int, bits: int, seed: int):
    """K clients' packed rows with ragged lengths, plus two phantom rows
    (scale 0, nonzero zp and words) that must aggregate to exact 0."""
    rng = np.random.default_rng(seed)
    c, nw = 24, 64
    per = 32 // bits
    n = nw * per
    nv = rng.integers(1, n + 1, size=c).astype(np.int32)
    nv[:3] = [n, 1, per + 1]
    packs, scales, zps = [], [], []
    for _ in range(k):
        x = _ragged_rows(nv, n, int(rng.integers(1 << 30)))
        p, s, z = kref.quant_pack_rows_ref(torch.from_numpy(x),
                                           torch.from_numpy(nv), bits)
        p, s, z = p.numpy().copy(), s.numpy().copy(), z.numpy().copy()
        p[-2:] = rng.integers(0, 1 << 31, size=(2, nw), dtype=np.uint32)
        s[-2:] = 0.0
        z[-2:] = 3.0
        packs.append(p)
        scales.append(s)
        zps.append(z)
    w = (rng.uniform(size=k) + 0.1).astype(np.float32)
    return np.stack(packs), np.stack(scales), np.stack(zps), w, nv


def _packed_slabs(e: int, k: int, n: int, r: int, bits: int, seed: int,
                  r_valid=None):
    """A rank bucket's serving slabs, numpy-seeded: fp adapters A (E, K,
    R), B (E, R, N) and their packed wire rows (aq, a_scale, a_zp, bq,
    b_scale, b_zp), compact words as the serving cache stages them.
    Each channel row is zero-padded to whole words before packing, so
    the word tails hold zp levels, which the kernels must not read.
    With ``r_valid < r`` every slot is a rank-``r_valid`` adapter padded
    into the rank-``r`` bucket: A rows past it carry scale = zp = 0 and
    zero words, B words past it are zero."""
    rng = np.random.default_rng(seed)
    per = 32 // bits
    rv = r if r_valid is None else r_valid
    kw, rw, rwv = -(-k // per), -(-r // per), -(-rv // per)
    a = (rng.standard_normal((e, k, r)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((e, r, n)) * 0.2).astype(np.float32)
    aq = np.zeros((e, r, kw), np.uint32)
    a_s = np.zeros((e, r), np.float32)
    a_z = np.zeros((e, r), np.float32)
    bq = np.zeros((e, n, rw), np.uint32)
    b_s = np.zeros((e, n), np.float32)
    b_z = np.zeros((e, n), np.float32)

    def pack(rows, width):
        xp = np.pad(rows, ((0, 0), (0, width * per - rows.shape[1])))
        words, scale, zp = kref.quant_pack_ref(torch.from_numpy(xp), bits)
        return words.numpy(), scale.numpy(), zp.numpy()

    for i in range(e):
        aq[i, :rv], a_s[i, :rv], a_z[i, :rv] = pack(a[i].T[:rv], kw)
        bq[i, :, :rwv], b_s[i], b_z[i] = pack(b[i].T[:, :rv], rwv)
    return a, b, (aq, a_s, a_z, bq, b_s, b_z)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
def test_cuda_quant_pack_rows_bit_exact(bits, cuda):
    """The ResNet-8 r=8 flat layout's ragged rows, the degenerate rows
    included."""
    cfg = resnet.ResNetConfig(lora=LoRAConfig(rank=8, alpha=128.0))
    lo = tflat.layout_for(resnet.init(0, cfg, device="cpu")["train"], bits)
    nv_np = lo.n_valid_vec().copy()
    nv_np[3] = 0
    nv = torch.from_numpy(nv_np).to(cuda)
    x = torch.from_numpy(_ragged_rows(nv_np, lo.n_max, seed=bits)).to(cuda)
    before = kops.quant_pack_rows.launches
    got = kops.quant_pack_rows(x, nv, bits)
    assert kops.quant_pack_rows.launches == before + 1
    _assert_pack_equal(got, kref.quant_pack_rows_ref(x, nv, bits))
    assert _bits(got[2])[[0, 1, 3]].tolist() == [0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k", [1, 3, 7])
def test_cuda_dequant_agg_rows(bits, k, cuda):
    p, s, z, w, nv = _cohort(k, bits, seed=k + bits)
    args = [torch.from_numpy(a).to(cuda) for a in (p, s, z, w, nv)]
    before = kops.dequant_agg_rows.launches
    got = kops.dequant_agg_rows(*args, bits)
    assert kops.dequant_agg_rows.launches == before + 1
    want = kref.dequant_agg_rows_ref(*args, bits)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for bk in (1, 2, None):
        again = kops.dequant_agg_rows(*args, bits, block_k=bk)
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))


@pytest.mark.gpu
def test_cuda_wrappers_check_inputs(cuda):
    x = torch.zeros((4, 512), device=cuda)
    nv = torch.full((4,), 512, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kops.quant_pack_rows(x.t().contiguous().t()[:, :500], nv, 8)
    with pytest.raises(ValueError):
        kops.quant_pack_rows(x.to(torch.float64), nv, 8)
    p = torch.zeros((2, 4, 128), dtype=torch.int32, device=cuda)
    s = torch.ones((2, 4), device=cuda)
    with pytest.raises(ValueError):
        kops.dequant_agg_rows(p, s, s, torch.ones(2), nv, 8)


# (m, k, n, r, e): the serving shapes at a small width, a ragged K and
# N, one row, the rank-8 bucket at d=256, then the serving width
# (d=2560, E=512): a rank-8 bucket of the m=64 step, the whole step at
# rank 4, and a ragged K, N and R with few rows
SERVE_SHAPES = [(8, 64, 128, 8, 5), (13, 60, 200, 4, 7), (1, 256, 256, 8, 3),
                (64, 256, 256, 8, 32), (32, 2560, 2560, 8, 512),
                (64, 2560, 2560, 4, 512), (5, 2559, 2555, 6, 9)]


def _serve_inputs(m, k, n, e, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    ids = rng.integers(0, e, m).astype(np.int32)
    return x, w, ids


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_cuda_multi_lora_matmul_packed(bits, shape, cuda):
    m, k, n, r, e = shape
    _, _, packed = _packed_slabs(e, k, n, r, bits, seed=bits + m,
                                 r_valid=r - 1)
    x, w, ids = _serve_inputs(m, k, n, e, seed=m + k)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    pt = [torch.from_numpy(a).to(cuda) for a in packed]
    before = kops.multi_lora_matmul_packed.launches
    got = kops.multi_lora_matmul_packed(xt, wt, *pt, ids.tolist(), 0.5,
                                        bits)
    assert kops.multi_lora_matmul_packed.launches == before + 1
    want = kref.multi_lora_matmul_q_ref(xt, wt, *pt,
                                        torch.from_numpy(ids).to(cuda),
                                        0.5, bits)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_cuda_multi_lora_matmul(shape, cuda):
    m, k, n, r, e = shape
    a, b, _ = _packed_slabs(e, k, n, r, 8, seed=m)
    x, w, ids = _serve_inputs(m, k, n, e, seed=m + n)
    args = [torch.from_numpy(v).to(cuda) for v in (x, w, a, b)]
    before = kops.multi_lora_matmul.launches
    got = kops.multi_lora_matmul(*args, ids.tolist(), 0.5)
    assert kops.multi_lora_matmul.launches == before + 1
    want = kref.multi_lora_matmul_ref(*args, torch.from_numpy(ids).to(cuda),
                                      0.5)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, None], ids=["packed", "fp"])
def test_cuda_serving_repeat_bit_identical(bits, cuda):
    """Two calls on the same inputs give the same bits: the split-K
    partials are summed in a fixed order, with no atomics."""
    m, k, n, r, e = 64, 2560, 2560, 8, 16
    a, b, packed = _packed_slabs(e, k, n, r, 4, seed=21)
    x, w, ids = _serve_inputs(m, k, n, e, seed=22)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    if bits is None:
        ab = [torch.from_numpy(v).to(cuda) for v in (a, b)]
        outs = [kops.multi_lora_matmul(xt, wt, *ab, ids.tolist(), 0.5)
                for _ in range(2)]
    else:
        pt = [torch.from_numpy(v).to(cuda) for v in packed]
        outs = [kops.multi_lora_matmul_packed(xt, wt, *pt, ids.tolist(), 0.5,
                                              bits) for _ in range(2)]
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))


@pytest.mark.gpu
def test_cuda_serving_rank_limit(cuda):
    """The kernels take R <= SERVE_RANK_MAX; a larger rank raises before
    any launch."""
    r = kops.SERVE_RANK_MAX + 1
    x = torch.zeros((2, 32), device=cuda)
    w = torch.zeros((32, 64), device=cuda)
    before = kops.multi_lora_matmul.launches
    with pytest.raises(ValueError, match="rank"):
        kops.multi_lora_matmul(x, w, torch.zeros((3, 32, r), device=cuda),
                               torch.zeros((3, r, 64), device=cuda), [0, 1],
                               0.5)
    assert kops.multi_lora_matmul.launches == before


@pytest.mark.gpu
def test_cuda_serving_wrappers_check_inputs(cuda):
    _, _, packed = _packed_slabs(3, 32, 64, 4, 4, seed=0)
    pt = [torch.from_numpy(a).to(cuda) for a in packed]
    x = torch.zeros((2, 32), device=cuda)
    w = torch.zeros((32, 64), device=cuda)
    with pytest.raises(ValueError, match="ids"):
        kops.multi_lora_matmul_packed(x, w, *pt, [0, 3], 0.5, 4)
    with pytest.raises(ValueError):
        kops.multi_lora_matmul_packed(x.double(), w, *pt, [0, 1], 0.5, 4)
    with pytest.raises(ValueError):
        kops.multi_lora_matmul(x, w, torch.zeros((3, 32, 4), device=cuda),
                               torch.zeros((3, 64, 4), device=cuda)
                               .transpose(1, 2), [0, 1], 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("nv_kind", ["none", "scalar", "vector"])
def test_cuda_dequant_agg_bit_identical(bits, k, nv_kind, cuda):
    """B3: one launch per call, the same bits as its plain version, with
    scale = 0 rows and a -0.0 weight, C = 13 (not a multiple of 8)."""
    rng = np.random.default_rng(bits * 10 + k)
    c, nw = 13, 24
    n = nw * (32 // bits)
    p = rng.integers(0, 1 << 32, size=(k, c, nw), dtype=np.uint32)
    s = rng.uniform(1e-3, 1e-1, size=(k, c)).astype(np.float32)
    s[:, 1:3] = 0.0
    z = rng.integers(0, 1 << bits, size=(k, c)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=k).astype(np.float32)
    w[0] = -0.0
    nv = {"none": None, "scalar": n - 7,
          "vector": torch.from_numpy(rng.integers(0, n + 1, c).astype(
              np.int32)).to(cuda)}[nv_kind]
    args = [torch.from_numpy(a).to(cuda) for a in (p, s, z, w)]
    before = kops.dequant_agg.launches
    got = kops.dequant_agg(*args, bits, nv)
    assert kops.dequant_agg.launches == before + 1
    want = kref.dequant_agg_ref(*args, bits, nv)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_cuda_dequant_agg_checks_inputs(cuda):
    p = torch.zeros((2, 4, 128), dtype=torch.int32, device=cuda)
    s = torch.ones((2, 4), device=cuda)
    w = torch.ones(2, device=cuda)
    with pytest.raises(ValueError):           # int32 words, not uint32
        kops.dequant_agg(p, s, s, w, 8)
    with pytest.raises(ValueError):           # n_valid of the wrong length
        kops.dequant_agg(p.view(torch.uint32), s, s, w, 8,
                         torch.ones(5, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):           # fp64 sidecars
        kops.dequant_agg(p.view(torch.uint32), s.double(), s, w, 8)


# (m, k, n, r): tests/test_kernels.py's four shapes, kernel_bench's, a
# ragged one
LORA_SHAPES = [(128, 256, 192, 8), (64, 128, 128, 32), (256, 512, 256, 128),
               (8, 128, 128, 4), (256, 512, 512, 32), (100, 300, 200, 6)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LORA_SHAPES)
def test_cuda_lora_matmul(shape, cuda):
    """B6: one launch per call, within 8e-3 * max|y| of its plain
    version (bf16 output; h rounded to bf16 once on both sides)."""
    m, k, n, r = shape
    rng = np.random.default_rng(m + r)

    def bf(shape_, scale):
        return torch.from_numpy((rng.normal(size=shape_) * scale).astype(
            np.float32)).to(torch.bfloat16).to(cuda)

    x, w, a, b = bf((m, k), 0.5), bf((k, n), 0.1), bf((k, r), 0.1), \
        bf((r, n), 0.1)
    before = kops.lora_matmul.launches
    got = kops.lora_matmul(x, w, a, b, 2.0)
    assert kops.lora_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    want = kref.lora_matmul_ref(x, w, a, b, 2.0).to(torch.float32)
    err = float((got.to(torch.float32) - want).abs().max())
    assert err <= 8e-3 * float(want.abs().max())


@pytest.mark.gpu
def test_cuda_lora_matmul_checks_inputs(cuda):
    x = torch.zeros((4, 16), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((16, 8), dtype=torch.bfloat16, device=cuda)
    a = torch.zeros((16, 4), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros((4, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):           # fp32 x
        kops.lora_matmul(x.float(), w, a, b, 1.0)
    with pytest.raises(ValueError):           # b of the wrong rank
        kops.lora_matmul(x, w, a, b[:3], 1.0)
    with pytest.raises(ValueError):           # a CPU operand
        kops.lora_matmul(x, w.cpu(), a, b, 1.0)
