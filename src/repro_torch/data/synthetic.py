"""Procedural datasets (no dataset download).

SyntheticVision: a learnable CIFAR-like task. Each class has a fixed
random 32x32x3 template (low-frequency, via blurred noise); samples are
template + per-sample noise + random shift/flip. A copy of the JAX
package's numpy class (``repro/data/synthetic.py``): the same seed gives
the same images in both packages.

``client_shard`` / ``linear_shard``: one client's shard generated on
demand as a pure function of ``(seed, cid)`` (the lazy fleet's data,
``fl/population.py``), bit-identical to the JAX package's.

``markov_lm_batch``: a token stream from a random sparse Markov chain
(each state's support is 8 next tokens with Zipf weights), which gives
an LM a learnable structure with an entropy floor well below ln(V);
``synthetic_lm_batch``: uniform tokens. Both draw exactly as the JAX
package's do.
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


# per-seed template banks for lazy fleet shards: client_shard() is
# called once per (seed, cid) on demand by a Population, so the heavy
# template construction must not repeat per client
_VISION_CACHE: dict = {}


def _vision_for(seed: int, n_classes: int) -> SyntheticVision:
    key = (seed, n_classes)
    if key not in _VISION_CACHE:
        _VISION_CACHE[key] = SyntheticVision(n_classes=n_classes,
                                             seed=seed)
    return _VISION_CACHE[key]


def client_shard(seed: int, cid: int, n: int = 64, n_classes: int = 10,
                 classes_per_client: int = 3) -> dict:
    """One client's synthetic-vision shard, generated ON DEMAND as a
    pure function of ``(seed, cid)`` — the lazy-population twin of the
    eager ``lda_partition`` + ``SyntheticVision.sample`` setup.

    Non-IIDness: each client draws labels from ``classes_per_client``
    dominant classes (chosen by a keyed rng, so the skew is
    deterministic per client), with Zipf-ish weights. Two calls with the
    same key return bit-identical arrays; a million-client fleet never
    materializes more shards than its engine keeps resident.
    """
    if n < 1 or not 1 <= classes_per_client <= n_classes:
        raise ValueError("need n >= 1 and 1 <= classes_per_client <= "
                         "n_classes")
    rng = np.random.default_rng([seed, 0xD5, cid])
    sv = _vision_for(seed, n_classes)
    classes = rng.choice(n_classes, size=classes_per_client,
                         replace=False)
    w = (1.0 / np.arange(1, classes_per_client + 1)) ** 1.2
    y = rng.choice(classes, p=w / w.sum(), size=n).astype(np.int32)
    return {"x": sv.sample(rng, y), "y": y}


def linear_shard(seed: int, cid: int, n: int = 24, d: int = 16,
                 n_classes: int = 10) -> dict:
    """A tiny linear-classification shard keyed by ``(seed, cid)`` — the
    cheap shard generator for million-client fleet simulations (the
    1M-client ``--fleet`` benchmark dispatches thousands of shards; a
    32x32x3 vision shard per dispatch would dominate the wall clock).
    Every client's labels come from the SAME hidden linear teacher
    (keyed by seed alone), so the fleet shares a learnable task."""
    if n < 1 or d < 1 or n_classes < 2:
        raise ValueError("need n, d >= 1 and n_classes >= 2")
    teacher = np.random.default_rng([seed, 0xD6])
    w_true = teacher.normal(size=(d, n_classes)).astype(np.float32)
    rng = np.random.default_rng([seed, 0xD7, cid])
    x = rng.normal(size=(n, d)).astype(np.float32)
    logits = x @ w_true + 0.1 * rng.normal(size=(n, n_classes))
    return {"x": x, "y": np.argmax(logits, axis=1).astype(np.int32)}


_MARKOV_CACHE: dict = {}


def _markov_tables(vocab: int, seed: int, support: int = 8):
    key = (vocab, seed, support)
    if key not in _MARKOV_CACHE:
        rng = np.random.default_rng(seed)
        nxt = rng.integers(0, vocab, size=(vocab, support))
        w = (1.0 / np.arange(1, support + 1)) ** 1.2
        w = w / w.sum()
        _MARKOV_CACHE[key] = (nxt, w)
    return _MARKOV_CACHE[key]


def markov_lm_batch(rng: np.random.Generator, vocab: int, batch: int,
                    seq: int, seed: int = 0) -> dict:
    """{'tokens': (batch, seq+1) int32} from a sparse Markov chain."""
    nxt, w = _markov_tables(vocab, seed)
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    choices = rng.choice(len(w), p=w, size=(batch, seq))
    for t in range(seq):
        toks[:, t + 1] = nxt[toks[:, t], choices[:, t]]
    return {"tokens": toks}


def synthetic_lm_batch(rng: np.random.Generator, vocab: int, batch: int,
                       seq: int) -> dict:
    """Uniform random tokens: for shape and throughput runs only."""
    return {"tokens": rng.integers(0, vocab, size=(batch, seq + 1)
                                   ).astype(np.int32)}
