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
# N, one row, and the rank-8 bucket at d=256
SERVE_SHAPES = [(8, 64, 128, 8, 5), (13, 60, 200, 4, 7), (1, 256, 256, 8, 3),
                (64, 256, 256, 8, 32)]


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
