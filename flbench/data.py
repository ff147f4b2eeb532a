"""The cells' inputs: CIFAR-10-sized synthetic images, the LDA split over
the clients, and the initial model, all drawn from seeds.

``templates`` and ``lda_partition`` copy the port's
``data/synthetic.py`` ``SyntheticVision`` and ``data/partition.py``: a
class is a fixed blurred-noise template; a sample is its template rolled
by a random shift of -2..2 pixels on each axis, flipped left-right with
probability 1/2, plus N(0, 0.35^2) noise. Here the per-sample draws are
vectorised and made on the device from a ``torch.Generator``, so one
seed gives the same images on one kind of device (not the port's
numpy draws). The labels and the split come from the traffic's fixed
``partition_seed``, so every ``--seed`` trains the same client sizes and
so the same schedule; ``--seed`` draws the images and the weights.
"""
from __future__ import annotations

import numpy as np
import torch

from flbench.reference import model as ref_model

TAG_IMAGES = 0x1A
TAG_WEIGHTS = 0x1B
NOISE = 0.35


def torch_seed(seed: int, tag: int) -> int:
    """A 63-bit generator seed from (seed, tag)."""
    st = np.random.SeedSequence([int(seed) % (1 << 64), tag])
    return int(st.generate_state(1, np.uint64)[0] >> np.uint64(1))


def templates(n_classes: int, image: int, channels: int,
              seed: int = 0) -> np.ndarray:
    """(classes, image, image, channels) fp32 class templates."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(n_classes, image, image, channels))
    for _ in range(2):
        raw = (raw + np.roll(raw, 1, 1) + np.roll(raw, -1, 1)
               + np.roll(raw, 1, 2) + np.roll(raw, -1, 2)) / 5.0
    return (raw / raw.std()).astype(np.float32)


def labels(n_images: int, n_classes: int, partition_seed: int) -> np.ndarray:
    return np.random.default_rng(partition_seed).integers(0, n_classes,
                                                          n_images)


def lda_partition(labels: np.ndarray, n_clients: int, alpha: float,
                  seed: int = 0, min_size: int = 2,
                  max_retries: int = 1000) -> list[np.ndarray]:
    """Per-client index arrays: each class split over the clients by a
    Dirichlet(alpha) draw (Hsu et al. 2019), redrawn until every client
    holds ``min_size``; after ``max_retries`` the last draw is repaired
    by moving indices from the largest clients."""
    if n_clients * min_size > len(labels):
        raise ValueError(f"min_size={min_size} infeasible for "
                         f"{n_clients} clients and {len(labels)} samples")
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(max(1, max_retries)):
        buckets: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for b, part in zip(buckets, np.split(idx, cuts)):
                b.extend(part.tolist())
        if min(len(b) for b in buckets) >= min_size:
            break
    else:
        for i in sorted(range(n_clients), key=lambda j: len(buckets[j])):
            while len(buckets[i]) < min_size:
                donor = max(range(n_clients), key=lambda j: len(buckets[j]))
                buckets[i].append(buckets[donor].pop())
    out = []
    for b in buckets:
        arr = np.asarray(b, np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def images(y: np.ndarray, temps: np.ndarray, seed: int,
           device) -> torch.Tensor:
    """(N, H, W, C) fp32 images of labels ``y`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(torch_seed(seed, TAG_IMAGES))
    n = len(y)
    _, h, w, c = temps.shape
    t = torch.from_numpy(temps).to(dev)
    yy = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
    shift = torch.randint(-2, 3, (n, 2), generator=gen, device=dev)
    flip = torch.rand((n,), generator=gen, device=dev) < 0.5
    rows = (torch.arange(h, device=dev)[None, :] - shift[:, :1]) % h
    cols = torch.arange(w, device=dev)[None, :].expand(n, w)
    cols = torch.where(flip[:, None], w - 1 - cols, cols)
    cols = (cols - shift[:, 1:]) % w
    x = t[yy[:, None, None], rows[:, :, None], cols[:, None, :]]
    x += NOISE * torch.randn((n, h, w, c), generator=gen, device=dev)
    return x


def split(traffic: dict, cfg: dict) -> tuple[np.ndarray, list]:
    """The labels and each client's indices, from ``partition_seed``."""
    y = labels(traffic["n_images"], cfg["n_classes"],
               traffic["partition_seed"])
    return y, lda_partition(y, traffic["n_clients"], traffic["lda_alpha"],
                            seed=traffic["partition_seed"])


def client_datasets(traffic: dict, cfg: dict, seed: int,
                    device) -> list[dict]:
    """The clients' numpy datasets ``{"x": (n, H, W, C) fp32, "y": (n,)
    int32}``, as the port's ``launch/fl_experiment.vision_data`` hands
    them to ``FLServer``."""
    y, parts = split(traffic, cfg)
    temps = templates(cfg["n_classes"], cfg["image_size"],
                      cfg["in_channels"])
    x = images(y, temps, seed, device).cpu().numpy()
    return [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]


def make_params(cfg: dict, mode: str, seed: int, device) -> dict:
    """The initial ``{"frozen", "train"}`` model, drawn on ``device`` from
    ``seed`` in one call: conv kernels and adapters' ``b`` N(0, 2/fan_in),
    the classifier N(0, 1/width), ``a``, biases and GroupNorm shifts 0,
    GroupNorm scales 1."""
    dev = torch.device(device)
    specs = ref_model.param_specs(cfg, mode)
    gen = torch.Generator(device=dev)
    gen.manual_seed(torch_seed(seed, TAG_WEIGHTS))
    n = sum(int(np.prod(s[2])) for s in specs if s[3] == "normal")
    z = torch.randn((n,), generator=gen, device=dev)
    trees = {"frozen": ref_model.skeleton(cfg),
             "train": ref_model.skeleton(cfg)}
    off = 0
    for side, path, shape, init, std in specs:
        if init == "normal":
            k = int(np.prod(shape))
            leaf = z[off: off + k].reshape(shape) * std
            off += k
        elif init == "zeros":
            leaf = torch.zeros(shape, device=dev)
        else:
            leaf = torch.ones(shape, device=dev)
        ref_model.put(trees[side], path, leaf)
    return trees
