"""Procedural vision data (no dataset download).

SyntheticVision: a learnable CIFAR-like task. Each class has a fixed
random 32x32x3 template (low-frequency, via blurred noise); samples are
template + per-sample noise + random shift/flip. A copy of the JAX
package's numpy class (``repro/data/synthetic.py``): the same seed gives
the same images in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

Array = np.ndarray


@dataclasses.dataclass
class SyntheticVision:
    n_classes: int = 10
    image: int = 32
    seed: int = 0
    noise: float = 0.35

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        raw = rng.normal(size=(self.n_classes, self.image, self.image, 3))
        # cheap low-pass: box-blur twice so templates have spatial structure
        for _ in range(2):
            raw = (raw + np.roll(raw, 1, 1) + np.roll(raw, -1, 1)
                   + np.roll(raw, 1, 2) + np.roll(raw, -1, 2)) / 5.0
        self.templates = (raw / raw.std()).astype(np.float32)

    def sample(self, rng: np.random.Generator, labels: Array) -> Array:
        """labels: (N,) -> images (N, 32, 32, 3) float32."""
        t = self.templates[labels]
        shift = rng.integers(-2, 3, size=(len(labels), 2))
        out = np.empty_like(t)
        for i in range(len(labels)):
            out[i] = np.roll(t[i], tuple(shift[i]), axis=(0, 1))
        flip = rng.random(len(labels)) < 0.5
        out[flip] = out[flip, :, ::-1]
        out += rng.normal(scale=self.noise, size=out.shape).astype(np.float32)
        return out

    def batch(self, rng: np.random.Generator, labels_pool: Array,
              batch_size: int) -> dict:
        idx = rng.integers(0, len(labels_pool), size=batch_size)
        y = labels_pool[idx]
        return {"x": self.sample(rng, y), "y": y.astype(np.int32)}
