"""Atomic checkpoint/resume in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpoint import CheckpointManager, \
    latest_step, restore, save
