"""Non-IID client partitioning: Latent Dirichlet Allocation split
(Hsu et al. 2019), the paper's setting with alpha = 0.5 (ResNet-8 runs)
and alpha = 1.0 (ResNet-18 runs)."""
from __future__ import annotations

import numpy as np


def lda_partition(labels: np.ndarray, n_clients: int, alpha: float,
                  seed: int = 0, min_size: int = 2,
                  max_retries: int = 1000) -> list[np.ndarray]:
    """Returns per-client index arrays. Each class's examples are split
    across clients by a Dirichlet(alpha) draw.

    The ``min_size`` retry loop is BOUNDED: adversarially small alpha
    concentrates whole classes on single clients, and when
    ``n_clients * min_size`` approaches (or exceeds) ``len(labels)`` no
    draw may ever satisfy the floor. After ``max_retries`` rejected
    draws the last draw is repaired deterministically — starved clients
    steal indices from the largest buckets — so the call always
    terminates with every index assigned exactly once."""
    if n_clients * min_size > len(labels):
        raise ValueError(
            f"min_size={min_size} infeasible: {n_clients} clients need "
            f"{n_clients * min_size} samples, have {len(labels)}")
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
        sizes = [len(b) for b in buckets]
        if min(sizes) >= min_size:
            break
    else:
        # repair the final draw: move tail indices from the fullest
        # buckets onto starved clients until everyone meets the floor
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
