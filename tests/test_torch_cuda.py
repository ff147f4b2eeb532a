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


# the main path's row lengths (ResNet-8 r=32 flat layout), and 1, 31, 33,
# 2560 levels
QUANT_ROW_LEVELS = [32, 576, 1152, 27, 64, 2304, 128, 256, 1, 31, 33, 2560]


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
def test_cuda_quant_pack_rows_bit_exact_row_lengths(bits, cuda):
    """Three rows of every length in QUANT_ROW_LEVELS, in a buffer as wide
    as the flat layout makes one for 2560 levels."""
    lane = kops.lane_levels(bits)
    n = -(-max(QUANT_ROW_LEVELS) // lane) * lane
    nv_np = np.repeat(np.array(QUANT_ROW_LEVELS, np.int32), 3)
    nv = torch.from_numpy(nv_np).to(cuda)
    x = torch.from_numpy(_ragged_rows(nv_np, n, seed=10 + bits)).to(cuda)
    _assert_pack_equal(kops.quant_pack_rows(x, nv, bits),
                       kref.quant_pack_rows_ref(x, nv, bits))


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
@pytest.mark.parametrize("r", [136, 160, 256])
@pytest.mark.parametrize("bits", [4, None], ids=["packed", "fp"])
def test_cuda_serving_ranks_past_128(bits, r, cuda):
    """R past 128 (h walked in rank chunks in the product's epilogue, the
    prep kernel's fp h in chunks of its threads; R = 136 ends in a partial
    chunk of 8 after four whole ones) within 1e-4 of the plain versions
    at d = 2560, m = 64; a repeated call gives the same bits."""
    m, k, n, e = 64, 2560, 2560, 6
    a, b, packed = _packed_slabs(e, k, n, r, 4, seed=r, r_valid=r - 10)
    x, w, ids = _serve_inputs(m, k, n, e, seed=r + 1)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    idt = torch.from_numpy(ids).to(cuda)
    if bits is None:
        ab = [torch.from_numpy(v).to(cuda) for v in (a, b)]
        outs = [kops.multi_lora_matmul(xt, wt, *ab, ids.tolist(), 0.5)
                for _ in range(2)]
        want = kref.multi_lora_matmul_ref(xt, wt, *ab, idt, 0.5)
    else:
        pt = [torch.from_numpy(v).to(cuda) for v in packed]
        outs = [kops.multi_lora_matmul_packed(xt, wt, *pt, ids.tolist(), 0.5,
                                              bits) for _ in range(2)]
        want = kref.multi_lora_matmul_q_ref(xt, wt, *pt, idt, 0.5, bits)
    torch.testing.assert_close(outs[0], want, rtol=1e-4, atol=1e-4)
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))


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
# ragged one, the full width (gemma3-4b's d = 2560, r = 32), an M that is
# not a multiple of the 128-row tile, r = 128 at full width, an aligned K
# that is not a multiple of the 64-deep stage, and ranks past 128 (the
# masked path) at full width and at a small width
LORA_SHAPES = [(128, 256, 192, 8), (64, 128, 128, 32), (256, 512, 256, 128),
               (8, 128, 128, 4), (256, 512, 512, 32), (100, 300, 200, 6),
               (512, 2560, 2560, 32), (130, 2560, 2560, 32),
               (512, 2560, 2560, 128), (256, 2600, 512, 32),
               (512, 2560, 2560, 160), (256, 512, 256, 256)]


def _lora_operands(shape, device):
    m, k, n, r = shape
    rng = np.random.default_rng(m + r)

    def bf(shape_, scale):
        return torch.from_numpy((rng.normal(size=shape_) * scale).astype(
            np.float32)).to(torch.bfloat16).to(device)

    return bf((m, k), 0.5), bf((k, n), 0.1), bf((k, r), 0.1), bf((r, n), 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LORA_SHAPES)
def test_cuda_lora_matmul(shape, cuda):
    """B6: one launch per call on the path ``ops.lora_plan`` names,
    within 8e-3 * max|y| of its plain version (bf16 output; h rounded to
    bf16 once on both sides)."""
    m, k, n, r = shape
    x, w, a, b = _lora_operands(shape, cuda)
    before = kops.lora_matmul.launches
    paths = dict(kops.lora_matmul.paths)
    got = kops.lora_matmul(x, w, a, b, 2.0)
    assert kops.lora_matmul.launches == before + 1
    path = kops.lora_plan(m, k, n, r).path
    assert kops.lora_matmul.paths[path] == paths[path] + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    want = kref.lora_matmul_ref(x, w, a, b, 2.0).to(torch.float32)
    err = float((got.to(torch.float32) - want).abs().max())
    assert err <= 8e-3 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 2560, 2560, 32), (100, 300, 200, 6),
                                   (512, 2560, 2560, 160)],
                         ids=["wgmma", "masked", "masked-r160"])
def test_cuda_lora_matmul_repeat_bit_identical(shape, cuda):
    """No atomics on either path: a second call gives the same bits."""
    ops_ = _lora_operands(shape, cuda)
    first = kops.lora_matmul(*ops_, 3.0)
    again = kops.lora_matmul(*ops_, 3.0)
    assert torch.equal(first.view(torch.int16), again.view(torch.int16))


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


def _resnet8_leaf_cohort(bits: int, k: int, seed: int, device):
    """K clients' flat messages of ResNet-8 r=32's adapters (18 packed
    leaves, 10 to 256 rows), seen per leaf through ``as_tree``: strided
    row slices of each flat buffer. The last client's every fifth row has
    scale = 0 and a nonzero zp; the weights hold a -0.0."""
    from repro_torch.utils.tree import tree_flatten, tree_map
    rng = np.random.default_rng(seed)
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    base = resnet.init(0, cfg, device="cpu")["train"]
    msgs = [tflat.pack_flat(tree_map(lambda p: (p + torch.from_numpy(
        (rng.standard_normal(tuple(p.shape)) * 0.02).astype(np.float32)))
        .to(device), base), bits) for _ in range(k)]
    msgs[-1].scale[::5] = 0.0
    msgs[-1].zp[::5] = 3.0
    w = torch.from_numpy(rng.uniform(0.1, 1.0, k).astype(np.float32))
    w[0] = -0.0
    trees = [tree_flatten(m.as_tree())[0] for m in msgs]
    cols = [list(c) for c in zip(*trees) if hasattr(c[0], "payload")]
    return msgs, cols, w.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k", [1, 5, 20])
def test_cuda_dequant_agg_leaves_resnet8(bits, k, cuda):
    """The grouped B3 over ResNet-8 r=32's 18 leaf shapes in ONE launch,
    reading strided ``as_tree`` payloads where they lie: every leaf
    bit-identical to the plain version (the table: 235 and 523 int64
    words at K = 1 and 5 ride in the kernel's parameters, K = 20's 1,603
    are uploaded)."""
    _, cols, w = _resnet8_leaf_cohort(bits, k, seed=bits + k, device=cuda)
    assert len(cols) == 18
    leaves = [([(m.payload, m.scale, m.zp) for m in col],
               col[0].n_per_channel) for col in cols]
    before = kops.dequant_agg.launches
    got = kops.dequant_agg_leaves(leaves, w, bits)
    assert kops.dequant_agg.launches == before + 1
    want = kref.dequant_agg_leaves_ref(leaves, w, bits)
    for g, v in zip(got, want):
        assert torch.equal(g.view(torch.int32), v.view(torch.int32))


@pytest.mark.gpu
def test_cuda_per_leaf_fedavg_packed_one_launch(cuda):
    """A per-leaf round's aggregate is ONE dequant_agg launch and no
    dequant_agg_rows, within 1e-6 * max|x| of the flat fold (B2) of the
    same messages."""
    from repro_torch.core import aggregation
    from repro_torch.utils.tree import flatten_with_names
    msgs, _, _ = _resnet8_leaf_cohort(8, 5, seed=3, device=cuda)
    w = torch.tensor([3.0, 1.0, 4.0, 1.0, 5.0])
    flat = aggregation.fedavg_packed(msgs, w)
    kops.reset_launch_counts()
    leaf = aggregation.fedavg_packed([m.as_tree() for m in msgs], w)
    counts = kops.launch_counts()
    assert counts["dequant_agg"] == 1 and counts["dequant_agg_rows"] == 0
    for (_, a), (_, b) in zip(flatten_with_names(flat),
                              flatten_with_names(leaf)):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())


@pytest.mark.gpu
def test_cuda_vmapped_cohort_matches_local_trainer(cuda):
    """The vmapped cohort engine (ResNet-8 r=8, K=3, n_steps 3/2/0 over
    a 3-step schedule, 16x16 images) against ``make_local_trainer`` run
    client by client on the card: losses within rtol 1e-4, each tree
    leaf within 1e-4 of its magnitude, the masked client bit-identical
    to its start. Under cuDNN's deterministic algorithms: with its
    default ones the first block's convolution gradients vary from run
    to run in both engines, and about one run in eight puts a leaf 1.23x
    past the limit (blocks/0/conv2/a); deterministic, the gap is 1e-3 of
    the limit in every run."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _cohort_matches_local_trainer(cuda)
    finally:
        torch.backends.cudnn.deterministic = det


def _cohort_matches_local_trainer(cuda):
    from repro_torch.fl import ClientConfig, make_cohort_trainer, \
        make_local_trainer
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=8, alpha=128.0))
    model = resnet.init(0, cfg, device=cuda)
    gen = torch.Generator().manual_seed(1)
    train0 = tree_map(lambda p: p + 0.05 * torch.randn(
        p.shape, generator=gen).to(cuda), model["train"])
    rng = np.random.default_rng(2)
    batches = {"x": torch.from_numpy(rng.normal(size=(3, 3, 8, 16, 16, 3))
                                     .astype(np.float32)).to(cuda),
               "y": torch.from_numpy(rng.integers(0, 10, (3, 3, 8))
                                     .astype(np.int32)).to(cuda)}
    n_steps = [3, 2, 0]
    loss = lambda f, t, b: resnet.loss_fn(f, t, cfg, b)
    ccfg = ClientConfig(local_epochs=1, batch_size=8, lr=0.01)
    trained, losses = make_cohort_trainer(loss, ccfg)(
        model["frozen"], train0, batches,
        torch.tensor(n_steps, dtype=torch.int32, device=cuda))
    local = make_local_trainer(loss, ccfg)
    for k, n in enumerate(n_steps):
        got = [x[k] for x in tree_leaves(trained)]
        if n == 0:
            assert float(losses[k]) == 0.0
            for g, s in zip(got, tree_leaves(train0)):
                assert torch.equal(g, s)
            continue
        want, want_loss = local(model["frozen"], train0,
                                {key: v[k, :n] for key, v in
                                 batches.items()})
        torch.testing.assert_close(losses[k], want_loss, rtol=1e-4,
                                   atol=0.0)
        for g, w in zip(got, tree_leaves(want)):
            assert float((g - w).abs().max()) <= 1e-4 * float(
                w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_flat_kernels_resnet18_layout(bits, cuda):
    """B1 and B2 at the paper's Table IV layout (ResNet-18 r=64: 6,026
    rows of up to 4,608 levels at int8, 5,120 at int4): B1 bit-exact on
    an update's flat buffer, B2 over K=4 of its messages within
    rtol=atol=1e-5 of the plain version and bit-identical across
    block_k."""
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = resnet.ResNetConfig(arch="resnet18",
                              lora=LoRAConfig(rank=64, alpha=1024.0))
    base = resnet.init(0, cfg, device="cpu")["train"]
    gen = torch.Generator().manual_seed(bits)
    updates = [tree_map(lambda p: (p + 0.02 * torch.randn(
        p.shape, generator=gen)).to(cuda), base) for _ in range(4)]
    lo = tflat.layout_for(updates[0], bits)
    assert (lo.c_total, lo.n_max) == (6026, 4608 if bits == 8 else 5120)
    nv = torch.from_numpy(lo.n_valid_vec()).to(cuda)
    packs = []
    for u in updates:
        flat = tflat.flat_rows(tree_leaves(u), lo)
        got = kops.quant_pack_rows(flat, nv, bits)
        _assert_pack_equal(got, kref.quant_pack_rows_ref(flat, nv, bits))
        packs.append(got)
    p, s, z = (torch.stack(x) for x in zip(*packs))
    w = torch.tensor([0.1, 0.2, 0.3, 0.4], device=cuda)
    got = kops.dequant_agg_rows(p, s, z, w, nv, bits)
    want = kref.dequant_agg_rows_ref(p, s, z, w, nv, bits)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for bk in (1, 2, None):
        again = kops.dequant_agg_rows(p, s, z, w, nv, bits, block_k=bk)
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))


def _sparse_updates(k: int, seed: int):
    """K ResNet-8 r=32 client updates on the CPU (numpy-seeded), each
    adapter ``a`` left exactly zero in a third of its columns (ties at
    the k-th magnitude)."""
    from repro_torch.utils.tree import tree_map
    rng = np.random.default_rng(seed)
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=32, alpha=512.0))
    base = resnet.init(0, cfg, device="cpu")["train"]

    def move(p):
        d = (rng.standard_normal(tuple(p.shape)) * 0.02).astype(np.float32)
        if p.ndim == 4:
            d[..., ::3] = 0.0
        return p + torch.from_numpy(d)

    return [tree_map(move, base) for _ in range(k)]


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8, None])
def test_cuda_sparse_pack_matches_plain(bits, cuda):
    """A ResNet-8 r=32 message's sparse pack (density 0.1) on the card:
    ONE quant_pack_rows launch (none without bits), and every leaf's
    indices, words, scale and zp bit-identical to the plain version on
    the CPU."""
    from repro_torch.core import messages
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.sparse import is_sparse_leaf
    from repro_torch.utils.tree import tree_leaves, tree_map
    tree = _sparse_updates(1, seed=bits or 0)[0]
    kops.reset_launch_counts()
    got = messages.pack_message(tree_map(lambda x: x.to(cuda), tree),
                                QuantConfig(bits=bits), density=0.1)
    assert kops.launch_counts()["quant_pack_rows"] == (bits is not None)
    want = messages.pack_message(tree, QuantConfig(bits=bits), density=0.1)
    pairs = [(g, w) for g, w in zip(tree_leaves(got), tree_leaves(want))
             if is_sparse_leaf(w)]
    assert len(pairs) == 18
    for g, w in pairs:
        assert torch.equal(g.idx.cpu(), w.idx)
        if bits is None:
            assert torch.equal(g.payload.cpu(), w.payload)
            continue
        np.testing.assert_array_equal(_words(g.payload.contiguous()),
                                      _words(w.payload.contiguous()))
        np.testing.assert_array_equal(_bits(g.scale), _bits(w.scale))
        np.testing.assert_array_equal(_bits(g.zp), _bits(w.zp))


@pytest.mark.gpu
def test_cuda_sparse_aggregate_bit_identical(cuda):
    """The scatter-add aggregate of 5 sparse int4 messages: two calls on
    the card bit-identical (one collision-free index_add_ a client), and
    within 1e-6 * max|x| of the CPU's."""
    from repro_torch.core import aggregation, messages
    from repro_torch.core.quant import QuantConfig
    from repro_torch.utils.tree import flatten_with_names, tree_map
    trees = _sparse_updates(5, seed=7)
    q = QuantConfig(bits=4)
    msgs = [messages.pack_message(tree_map(lambda x: x.to(cuda), t), q,
                                  density=0.1) for t in trees]
    w = torch.tensor([3.0, 1.0, 4.0, 1.0, 5.0])
    a = aggregation.fedavg_packed(msgs, w)
    b = aggregation.fedavg_packed(msgs, w)
    cpu = aggregation.fedavg_packed(
        [messages.pack_message(t, q, density=0.1) for t in trees], w)
    for (name, x), (_, y), (_, z) in zip(flatten_with_names(a),
                                         flatten_with_names(b),
                                         flatten_with_names(cpu)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name
        assert float((x.cpu() - z).abs().max()) <= 1e-6 * float(
            z.abs().max()), name


@pytest.mark.gpu
def test_cuda_mixed_rank_round_b2_per_bucket(cuda):
    """One round of a three-tier fleet (r in {4, 8, 16}, ResNet-8 at
    16x16, all 6 clients) on the card: one dequant_agg_rows launch a rank
    bucket; one quant_pack_rows launch a broadcast (one a bucket), an
    uplink, and in round 1 a downlink measured once a rank."""
    from repro_torch.core.flocora import FLoCoRAConfig, RankSchedule
    from repro_torch.fl import ClientConfig, FLServer, ServerConfig
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=16, alpha=256.0))
    rng = np.random.default_rng(0)
    data = [{"x": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
             "y": rng.integers(0, 10, 8).astype(np.int32)}
            for _ in range(6)]
    srv = FLServer(resnet.init(0, cfg, device=cuda),
                   lambda f, t, b: resnet.loss_fn(f, t, cfg, b), data,
                   ServerConfig(n_clients=6, clients_per_round=6),
                   ClientConfig(local_epochs=1, batch_size=8, lr=0.01),
                   FLoCoRAConfig(rank=16, alpha=256.0, quant_bits=8,
                                 rank_schedule=RankSchedule.tiered(
                                     (4, 8, 16), 6)), device=cuda)
    kops.reset_launch_counts()
    rec = srv.run_round()
    counts = kops.launch_counts()
    assert rec["cohort_ranks"] == {4: 2, 8: 2, 16: 2}
    assert counts["dequant_agg_rows"] == 3
    assert counts["quant_pack_rows"] == 3 + 6 + 3
    assert rec["up_bytes_by_rank"] == {4: 57_400, 8: 88_888, 16: 151_864}


@pytest.mark.gpu
def test_cuda_streaming_fold_bit_identical(cuda):
    """The streaming fold (one K = 1 dequant_agg_rows launch an arrival)
    over 10 int8 ResNet-8 r=16 uplinks: two runs on the card
    bit-identical, within 1e-6 * max|x| of the plain version's; one B2
    launch an arrival."""
    from repro_torch.core import aggregation, messages
    from repro_torch.core.quant import QuantConfig
    from repro_torch.utils.tree import flatten_with_names, tree_map
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=16, alpha=256.0))
    base = resnet.init(0, cfg, device="cpu")["train"]
    gen = torch.Generator().manual_seed(3)
    trees = [tree_map(lambda p: p + 0.02 * torch.randn(p.shape,
                                                       generator=gen), base)
             for _ in range(10)]
    weights = [float(w) for w in np.linspace(8.0, 64.0, 10)]
    q = QuantConfig(bits=8)

    def run(dev):
        agg = aggregation.FedBuffAggregator(streaming=True, half_life=4.0)
        for i, (t, w) in enumerate(zip(trees, weights)):
            msg = messages.pack_message(
                tree_map(lambda x: x.to(dev), t), q, flat=True)
            agg.add(msg, w, i % 3)
        return agg.flush()

    kops.reset_launch_counts()
    a = run(cuda)
    assert kops.launch_counts()["dequant_agg_rows"] == 10
    b = run(cuda)
    plain = run(torch.device("cpu"))
    for (name, x), (_, y), (_, z) in zip(flatten_with_names(a),
                                         flatten_with_names(b),
                                         flatten_with_names(plain)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name
        assert float((x.cpu() - z).abs().max()) <= 1e-6 * float(
            z.abs().max()), name


@pytest.mark.gpu
def test_cuda_async_events_match_cpu(cuda):
    """A short async run (two rank tiers, streaming FedBuff, ResNet-8 r=8
    at 16x16) on the card: every flush's event fields and bytes equal
    the CPU engine's, losses within rtol 1e-3."""
    from repro_torch.core.flocora import FLoCoRAConfig, RankSchedule
    from repro_torch.fl import AsyncConfig, AsyncFLServer, ClientConfig, \
        FleetTrace
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=8, alpha=128.0))
    rng = np.random.default_rng(0)
    data = [{"x": rng.normal(size=(16, 16, 16, 3)).astype(np.float32),
             "y": rng.integers(0, 10, 16).astype(np.int32)}
            for _ in range(6)]

    def run(dev):
        srv = AsyncFLServer(
            resnet.init(0, cfg, device="cpu"),
            lambda f, t, b: resnet.loss_fn(f, t, cfg, b), data,
            AsyncConfig(total_arrivals=8, concurrency=4, buffer_size=4,
                        streaming_agg=True, microbatch_window=30.0),
            ClientConfig(local_epochs=1, batch_size=8, lr=0.01),
            FLoCoRAConfig(rank=8, alpha=128.0, quant_bits=8,
                          rank_schedule=RankSchedule.tiered((4, 8), 6)),
            trace=FleetTrace(seed=0), device=dev)
        return srv.run()

    gpu, cpu = run(cuda), run(torch.device("cpu"))
    assert len(gpu) == len(cpu) == 2
    for a, b in zip(gpu, cpu):
        assert {k: v for k, v in a.items() if k != "client_loss"} == \
            {k: v for k, v in b.items() if k != "client_loss"}
        assert abs(a["client_loss"] - b["client_loss"]) <= \
            1e-3 * abs(b["client_loss"])


@pytest.mark.gpu
def test_cuda_gemma3_width_depth6_matches_cpu(cuda):
    """gemma3-4b's width (d 2560, vocab 262,144, heads 8 padded to 16,
    window 1,024) at depth 6, one tree on the card and on the CPU:
    prefill and decode logits within 2e-2 of max|logit| (bf16 in both,
    cuBLAS and the CPU's GEMMs summing in other orders), greedy tokens
    equal."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve import generate
    from repro_torch.utils.tree import tree_to
    cfg = dataclasses.replace(registry.get("gemma3-4b").full(), n_layers=6)
    p = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg,
                device=cuda)
    cpu = {k: tree_to(v, "cpu") for k, v in p.items()}
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    toks, _ = generate(p["frozen"], p["train"], cfg, prompt, 4, device=cuda)
    toks_cpu, _ = generate(cpu["frozen"], cpu["train"], cfg, prompt, 4,
                           device="cpu")
    assert torch.equal(toks.cpu(), toks_cpu)
    with torch.no_grad():
        lg, caches, pos = lm.prefill(p["frozen"], p["train"], cfg,
                                     torch.from_numpy(prompt).to(cuda),
                                     max_seq=20)
        lc, caches_c, _ = lm.prefill(cpu["frozen"], cpu["train"], cfg,
                                     prompt, max_seq=20)
        scale = float(lc.abs().max())
        assert float((lg.cpu() - lc).abs().max()) <= 2e-2 * scale
        dg, _ = lm.decode_step(p["frozen"], p["train"], cfg, toks[:, :1],
                               caches, pos)
        dc, _ = lm.decode_step(cpu["frozen"], cpu["train"], cfg,
                               toks_cpu[:, :1], caches_c, pos)
        assert float((dg.cpu() - dc).abs().max()) <= 2e-2 * float(
            dc.abs().max())


@pytest.mark.gpu
def test_cuda_telemetry_steady_state(cuda):
    """On the card: the run fingerprint names the card; a strict serving
    engine's and a strict streaming fold's steady-state calls build no
    program (the first call of a shape may load the kernels)."""
    from repro_torch import obs, serve
    from repro_torch.core import messages
    from repro_torch.core.aggregation import StreamingFlatAccumulator
    from repro_torch.core.quant import QuantConfig
    meta = obs.run_meta()
    assert meta["backend"] == "cuda"
    assert meta["device_kind"] == torch.cuda.get_device_name(0)
    weights, store = serve.make_store(16, d_model=256, device=cuda)
    cache = serve.AdapterCache(1 << 24, store.qcfg, device=cuda)
    eng = serve.AdapterServingEngine(weights, 0.5, store.qcfg, cache,
                                     fetch=lambda c: store.msgs[c],
                                     strict_compiles=True, device=cuda)
    eng.admit(list(range(8)))
    x = torch.randn((8, 256), device=cuda)
    y0 = eng.step(x, list(range(8)))
    with obs.count_compiles() as c:
        y = eng.step(x, list(range(8)))
    assert c.count == 0 and torch.equal(y, y0)
    gen = torch.Generator().manual_seed(0)
    msgs = [messages.pack_message(
        {"w": torch.randn((64, 40), generator=gen).to(cuda)},
        QuantConfig(bits=8), flat=True) for _ in range(3)]
    st = StreamingFlatAccumulator.for_layout(msgs[0].layout,
                                             strict_compiles=True,
                                             device=cuda)
    st.fold(msgs[0], 1.0)
    with obs.count_compiles() as c:
        st.fold(msgs[1], 1.0)
        st.fold(msgs[2], 2.0)
    assert c.count == 0 and st.count == 3


def _moe_layer(spec, cuda, seed):
    """A MoE layer drawn on the card (adapters moved off init) and its
    copy on the CPU."""
    from repro_torch.core.lora import LoRAConfig as TLoRA
    from repro_torch.models import moe
    from repro_torch.utils.tree import tree_map, tree_to
    fz, tr = moe.moe_init(torch.Generator(device=cuda).manual_seed(seed),
                          spec, "lora", TLoRA(rank=32, alpha=512.0),
                          device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    tr = {k: tree_map(lambda t: t + 0.01 * torch.randn(
        t.shape, generator=gen, device=cuda), v) if k != "router" else v
        for k, v in tr.items()}
    return fz, tr, tree_to(fz, "cpu"), tree_to(tr, "cpu")


@pytest.mark.gpu
def test_cuda_moe_layer_full_width_matches_cpu(cuda):
    """One deepseek-v2-236b MoE layer at its published width (160
    experts of 5,120 x 1,536, top-6, 2 shared): the card's routes equal
    the CPU's on the same bf16 input, its output within 2e-2 of max|y|
    (bf16 banks, cuBLAS and the CPU summing in other orders) and its aux
    loss within 1e-5."""
    from repro_torch.configs import registry
    from repro_torch.models import moe
    spec = registry.get("deepseek-v2-236b").full().moe
    fz, tr, fz_c, tr_c = _moe_layer(spec, cuda, 0)
    x = torch.randn((1, 64, spec.d_model),
                    generator=torch.Generator().manual_seed(2)).to(
                        torch.bfloat16)
    with torch.no_grad():
        _, i_c, _ = moe.route(tr_c, spec, x[0])
        _, i_g, _ = moe.route(tr, spec, x[0].to(cuda))
        y_c, a_c = moe.moe_apply(fz_c, tr_c, spec, x, 16.0)
        y_g, a_g = moe.moe_apply(fz, tr, spec, x.to(cuda), 16.0)
    assert torch.equal(i_g.cpu(), i_c)
    err = float((y_g.cpu().float() - y_c.float()).abs().max())
    assert err <= 2e-2 * float(y_c.float().abs().max()), err
    assert abs(float(a_g) - float(a_c)) <= 1e-5 * float(a_c)


@pytest.mark.gpu
def test_cuda_moe_combine_bit_identical(cuda):
    """4,096 tokens top-6 over 160 experts at d_model 5,120, every
    expert past its capacity at factor 0.5: two dispatches give the same
    bits, and so do two whole layers (the k-slot fold has no colliding
    index; the dispatch only gathers)."""
    from repro_torch.models import moe
    spec = moe.MoESpec(d_model=5120, d_ff=256, n_experts=160, top_k=6,
                       n_shared=1, capacity_factor=0.5)
    fz, tr, _, _ = _moe_layer(spec, cuda, 3)
    x = torch.randn((2, 2048, spec.d_model), device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        gates, idx, _ = moe.route(tr, spec, x.reshape(-1, spec.d_model))
        pos, _, cap = moe.dispatch_plan(spec, idx)
        assert bool((pos >= cap).any())
        args = (fz, tr, spec, x.reshape(-1, spec.d_model), gates, idx, 16.0)
        assert torch.equal(moe._dispatch_chunk(*args),
                           moe._dispatch_chunk(*args))
        y0, a0 = moe.moe_apply(fz, tr, spec, x, 16.0)
        y1, a1 = moe.moe_apply(fz, tr, spec, x, 16.0)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
