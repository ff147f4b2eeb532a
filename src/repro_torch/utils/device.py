"""Device selection and numeric precision for the port's entry points."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_precision():
    """Full fp32 convolutions and matmuls (TF32 off) for the duration,
    backward passes included; the previous settings come back on exit.

    On the card cuDNN runs fp32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about
    three decimal digits. The port computes in fp32, as the JAX package
    does on the CPU."""
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device that this process
    cannot reach raises: entry points default to ``"cuda"`` and never
    fall back to the CPU on their own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available "
            "(pass device='cpu' to run on the CPU)")
    return dev


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor on ``device`` without stalling the host: to a
    CUDA device it goes through pinned memory as a non-blocking copy
    (PyTorch's blocking host-to-device copy synchronizes the stream, so
    the host would wait for every queued kernel)."""
    dev = torch.device(device)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
