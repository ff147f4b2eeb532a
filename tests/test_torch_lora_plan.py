"""B6 (``lora_matmul``) on the card: its path and tiling, chosen in Python
by ``ops.lora_plan`` from the shapes and operand alignment alone, and the
wgmma path's arithmetic emulated on the CPU.

The wgmma path recomputes h = x@a inside every 128 x 80 tile, summing x's
64-deep K stages in fp32, rounds h to bf16 once after the last stage and
adds ``s * (bf16(h) @ b)`` from a separate accumulator: the association
of the plain version ``ref.lora_matmul_ref``. The emulation below follows
that stage order and is held to the plain version at gemma3-4b's width
(d = 2560) and to the JAX package's Pallas kernel (interpret mode) at a
small shape, both at s = 3.0, a scale that is not a power of two. The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

torch.set_num_threads(1)

FULL = (512, 2560, 2560, 32)      # (M, K, N, r) at gemma3-4b's width
TOL = 8e-3


def _bf16(rng, shape, scale):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(torch.bfloat16)


def _inputs(m, k, n, r, seed):
    rng = np.random.default_rng(seed)
    return (_bf16(rng, (m, k), 0.5), _bf16(rng, (k, n), 0.1),
            _bf16(rng, (k, r), 0.1), _bf16(rng, (r, n), 0.1))


def _emulate_wgmma_path(x, w, a, b, s, stage=64):
    """The TMA path's arithmetic on the CPU: acc and h summed over K in
    64-deep stages in fp32, h rounded to bf16 once, y = acc + s * low."""
    xf, wf, af, bf = (t.to(torch.float32) for t in (x, w, a, b))
    acc = torch.zeros(x.shape[0], w.shape[1])
    hacc = torch.zeros(x.shape[0], a.shape[1])
    for k0 in range(0, x.shape[1], stage):
        acc += xf[:, k0:k0 + stage] @ wf[k0:k0 + stage]
        hacc += xf[:, k0:k0 + stage] @ af[k0:k0 + stage]
    low = hacc.to(torch.bfloat16).to(torch.float32) @ bf
    return (acc + s * low).to(torch.bfloat16)


def test_full_width_takes_the_wgmma_path_in_one_wave():
    plan = kops.lora_plan(*FULL)
    assert plan.path == "wgmma"
    assert plan.tile == kops.LORA_WG_TILE == (128, 80)
    assert plan.blocks == 4 * 32 <= kops.LORA_SMS
    assert plan.waves == 1


def test_ragged_shape_takes_the_masked_path():
    plan = kops.lora_plan(100, 300, 200, 6)
    assert plan.path == "masked"
    assert plan.tile == (kops.LORA_TILE, kops.LORA_TILE)
    assert plan.blocks == 2 * 4


@pytest.mark.parametrize("shape,path", [
    ((512, 2560, 2560, 32), "wgmma"),
    ((130, 2560, 2560, 32), "wgmma"),       # M past the 128-row tile
    ((512, 2560, 2560, 128), "wgmma"),
    ((256, 2600, 512, 32), "wgmma"),        # K not a multiple of 64
    ((8, 128, 128, 4), "masked"),           # r % 8
    ((64, 300, 128, 8), "masked"),          # K % 8: x's rows not 16-byte
    ((64, 256, 200, 8), "wgmma"),           # N % 8 == 0 though N % 80 != 0
    ((64, 256, 202, 8), "masked"),          # N % 8
    ((1, 8, 8, 8), "wgmma"),
    ((512, 2560, 2560, 160), "masked"),     # r past the wgmma accumulator
    ((256, 512, 256, 256), "masked"),
])
def test_path_depends_on_shape_alignment(shape, path):
    assert kops.lora_plan(*shape).path == path


@pytest.mark.parametrize("shape", [(512, 2560, 2560, 32), (100, 300, 200, 6),
                                   (3, 40, 24, 16)])
def test_plan_depends_on_shapes_and_alignment_only(shape):
    """Equal arguments give equal plans; an unaligned operand alone turns
    the TMA path into the masked one; nothing else is read."""
    plans = {kops.lora_plan(*shape) for _ in range(3)}
    assert len(plans) == 1
    assert kops.lora_plan(*shape, aligned=False).path == "masked"
    if kops.lora_plan(*shape).path == "masked":
        assert kops.lora_plan(*shape, aligned=False) == kops.lora_plan(*shape)


@pytest.mark.parametrize("k", [1, 8, 63, 64, 65, 300, 2559, 2560, 2600,
                               8192])
def test_h_splits_cover_k_in_one_cluster(k):
    """The masked path's h kernel: at most 8 K chunks (one portable
    cluster), whole 64-deep slabs, covering K with no empty chunk."""
    splits, chunk = kops.lora_h_splits(k)
    assert 1 <= splits <= kops.LORA_H_SPLITS_MAX
    assert chunk % kops.LORA_TILE == 0
    assert splits * chunk >= k > (splits - 1) * chunk


def test_blocks_and_waves_count_tiles():
    for m, k, n, r in [(1, 8, 8, 8), (4096, 2560, 2560, 32),
                       (100, 300, 200, 6)]:
        plan = kops.lora_plan(m, k, n, r)
        tm, tn = plan.tile
        assert plan.blocks == -(-m // tm) * -(-n // tn)
        assert plan.waves == -(-plan.blocks // kops.LORA_SMS)


def test_cpu_calls_count_no_path():
    """On CPU tensors the wrapper computes the plain version: neither a
    launch nor a path is counted; the counts reset together."""
    kops.reset_launch_counts()
    kops.lora_matmul(*_inputs(8, 16, 16, 8, 0), 1.0)
    assert kops.launch_counts()["lora_matmul"] == 0
    assert kops.lora_matmul.paths == {"wgmma": 0, "masked": 0}
    kops.lora_matmul.paths["wgmma"] = 5
    kops.reset_launch_counts()
    assert kops.lora_matmul.paths == {"wgmma": 0, "masked": 0}


@pytest.mark.parametrize("m", [64, 130])
def test_wgmma_path_emulation_holds_plain_version_at_full_width(m):
    _, k, n, r = FULL
    x, w, a, b = _inputs(m, k, n, r, seed=m)
    got = _emulate_wgmma_path(x, w, a, b, 3.0).to(torch.float32)
    want = kref.lora_matmul_ref(x, w, a, b, 3.0).to(torch.float32)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.parametrize("shape", [(128, 256, 192, 8), (64, 128, 128, 32),
                                   (256, 512, 256, 128)])
def test_wgmma_path_emulation_holds_jax_kernel(shape):
    m, k, n, r = shape
    x, w, a, b = _inputs(m, k, n, r, seed=r)
    got = _emulate_wgmma_path(x, w, a, b, 3.0).to(torch.float32).numpy()
    pallas = np.asarray(jops.lora_matmul(
        *(jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)
          for t in (x, w, a, b)), 3.0), np.float32)
    assert float(np.abs(got - pallas).max()) <= TOL * float(
        np.abs(pallas).max())
