"""The synchronous FLoCoRA round (paper Fig. 1) in plain PyTorch.

A round samples K clients, broadcasts the global trainable parameters
(int8-quantized on the FLoCoRA wire, fp32 under FedAvg), trains each
client locally with SGD and momentum, quantizes each uplink, keeps the
first K arrivals and takes their FedAvg weighted by image count.

``Sampler`` replays the server's numpy stream in its documented order:
``rng.choice(n_clients, K', replace=False)`` for the cohort, one
``rng.exponential(1.0)`` a survivor for its latency, then each client's
batch indices in cohort order, one permutation of its images an epoch
(topped up with ``rng.integers`` when a batch is larger than the
client) until the cohort's schedule, the largest client's step count,
is filled. A client trains only its own steps; the rest of the schedule
is masked.

The quantizer is the paper's per-channel affine round-to-nearest on
unsigned levels, channel = last axis: ``scale = (max(x_max, 0) -
min(x_min, 0)) * f32(1 / (2^bits - 1))`` (1 where the range is 0),
``zp = clip(round(-min(x_min, 0) / scale), 0, 2^bits - 1)``, ``q =
clip(round(x / scale) + zp, 0, 2^bits - 1)``, rounding half to even;
vectors travel fp32.

Besides each client's whole local run, the first round keeps its state
after the first ``EARLY`` steps (its own step count where that is
fewer) and the mean loss of those steps.
"""
from __future__ import annotations

import numpy as np
import torch

from flbench.reference import model as ref_model

# the local step counts after which the first round's state is kept
EARLY = (1, 3)


def natural_steps(n: int, batch: int, epochs: int) -> int:
    return max(1, n // batch) * epochs


def schedule_steps(sizes, batch: int, epochs: int) -> int:
    return max(natural_steps(n, batch, epochs) for n in sizes)


class Sampler:
    """The server's sampler stream, replayed round by round."""

    def __init__(self, seed: int, sizes: list[int], n_clients: int,
                 clients_per_round: int, batch: int, epochs: int):
        self.rng = np.random.default_rng(seed)
        self.sizes = sizes
        self.n_clients = n_clients
        self.k = clients_per_round
        self.batch = batch
        self.epochs = epochs
        self.steps = schedule_steps(sizes, batch, epochs)

    def _indices(self, n: int) -> np.ndarray:
        per_epoch = max(1, n // self.batch)
        got, chunks = 0, []
        while got < self.steps:
            idx = self.rng.permutation(n)
            take = per_epoch * self.batch
            if take > n:
                idx = np.concatenate([idx, self.rng.integers(0, n,
                                                             take - n)])
            chunks.append(idx[:take].reshape(per_epoch, self.batch))
            got += per_epoch
        return np.concatenate(chunks, axis=0)[: self.steps]

    def next_round(self) -> dict:
        cohort = [int(c) for c in self.rng.choice(self.n_clients,
                                                  size=self.k,
                                                  replace=False)]
        latency = [float(self.rng.exponential(1.0)) for _ in cohort]
        idx = [self._indices(self.sizes[c]) for c in cohort]
        n_steps = [min(natural_steps(self.sizes[c], self.batch,
                                     self.epochs), self.steps)
                   for c in cohort]
        order = sorted(range(len(cohort)), key=lambda i: latency[i])
        return {"cohort": cohort, "idx": idx, "n_steps": n_steps,
                "kept": [cohort[i] for i in order[: self.k]]}


def channel_first(x: torch.Tensor) -> torch.Tensor:
    """(..., C) -> (C, rest): row c holds the elements whose last index is
    c, in row-major order."""
    return torch.movedim(x, -1, 0).reshape(x.shape[-1], -1)


def from_channel_first(x2d: torch.Tensor, shape: tuple) -> torch.Tensor:
    moved = (shape[-1],) + tuple(shape[:-1])
    return torch.movedim(x2d.reshape(moved), 0, -1)


def quantize(x: torch.Tensor, bits: int):
    """x (any shape, >= 2-D) -> (levels (C, n) int64, scale (C,), zp (C,))."""
    qmax = (1 << bits) - 1
    xf = channel_first(x.to(torch.float32))
    xmin = torch.clamp(torch.amin(xf, dim=1), max=0.0)
    xmax = torch.clamp(torch.amax(xf, dim=1), min=0.0)
    rng = xmax - xmin
    inv = float(np.float32(1.0 / qmax))
    scale = torch.where(rng > 0, rng * inv, torch.ones_like(rng))
    zp = torch.clamp(torch.round(-xmin / scale), 0, qmax)
    zp = torch.where(zp > 0, zp, torch.zeros_like(zp))
    q = torch.clamp(torch.round(xf / scale[:, None]) + zp[:, None], 0, qmax)
    return q.to(torch.int64), scale, zp


def dequantize(levels: torch.Tensor, scale: torch.Tensor,
               zp: torch.Tensor, shape: tuple) -> torch.Tensor:
    x2d = (levels.to(torch.float32) - zp[:, None]) * scale[:, None]
    return from_channel_first(x2d, shape)


def encode_leaf(x: torch.Tensor, bits) -> dict:
    """One leaf's uplink: {"levels", "scale", "zp"} when it is quantized,
    {"fp"} for a vector or on an fp32 wire (``bits`` None)."""
    if bits is None or x.ndim < 2:
        return {"fp": x}
    q, s, z = quantize(x, bits)
    return {"levels": q, "scale": s, "zp": z}


def encode(train: dict, bits) -> dict:
    """A trainable tree's uplink, keyed by leaf path."""
    return {p: encode_leaf(ref_model.get(train, p), bits)
            for p in ref_model.leaf_paths(train)}


def decode(msg: dict, like: dict) -> dict:
    """A message back to a trainable tree shaped as ``like``."""
    tree = _like_skeleton(like)
    for path, m in msg.items():
        shape = tuple(ref_model.get(like, path).shape)
        x = m["fp"] if "fp" in m else dequantize(m["levels"], m["scale"],
                                                 m["zp"], shape)
        ref_model.put(tree, path, x.to(torch.float32))
    return tree


def _like_skeleton(like):
    if isinstance(like, dict):
        return {k: _like_skeleton(v) for k, v in like.items()}
    if isinstance(like, list):
        return [_like_skeleton(v) for v in like]
    return None


def wire_bytes(train: dict, bits) -> int:
    """Uplink payload bytes: each quantized leaf's levels packed
    contiguously plus fp32 scale and zero point per channel; vectors (and
    every leaf on an fp32 wire) 4 bytes a value."""
    total = 0
    for path in ref_model.leaf_paths(train):
        x = ref_model.get(train, path)
        if bits is None or x.ndim < 2:
            total += 4 * x.numel()
        else:
            c = int(x.shape[-1])
            total += (x.numel() * bits + 7) // 8 + 8 * c
    return total


def fedavg(msgs: list[dict], weights: list[float], like: dict) -> dict:
    """sum_k w_k * decode(msg_k), w normalised, folded in k order."""
    w = np.asarray(weights, np.float64)
    w = (w / w.sum()).astype(np.float32)
    acc = None
    for wk, m in zip(w, msgs):
        d = decode(m, like)
        acc = _tree_map(lambda t: float(wk) * t, d) if acc is None else \
            _tree_map2(lambda a, t: a + float(wk) * t, acc, d)
    return acc


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_tree_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def train_client(model: ref_model.Model, frozen: dict, start: dict,
                 x: torch.Tensor, y: torch.Tensor, idx: np.ndarray,
                 n_steps: int, lr: float, momentum: float):
    """One client's local run from ``start``: ``n_steps`` SGD steps with
    momentum on the batches ``idx[t]`` of its images. Returns (trained
    tree, mean loss of its steps, {T: (tree, mean loss) after the first
    min(T, n_steps) steps} for T in ``EARLY``)."""
    paths = ref_model.leaf_paths(start)
    params = [ref_model.get(start, p).detach().clone().requires_grad_(True)
              for p in paths]
    tree = _like_skeleton(start)
    for p, t in zip(paths, params):
        ref_model.put(tree, p, t)
    opt = torch.optim.SGD(params, lr=lr, momentum=momentum)
    ix = torch.from_numpy(idx[:n_steps]).to(x.device)

    def state():
        out = _like_skeleton(start)
        for p, t in zip(paths, params):
            ref_model.put(out, p, t.detach().clone())
        return out, float(torch.stack(losses).mean())

    losses, early = [], {}
    for t in range(n_steps):
        loss = model.loss(frozen, tree, x[ix[t]], y[ix[t]])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        for e in EARLY:
            if t + 1 == min(e, n_steps):
                early[e] = state()
    out, loss = state()
    return out, loss, early


def run_rounds(cfg: dict, traffic: dict, params: dict, datas: list[dict],
               seed: int, rounds: int, device,
               precision: str = "fp32") -> list[dict]:
    """``rounds`` rounds from ``params``: per round the cohort, the kept
    clients in arrival order and each cohort client's active steps; for
    the first round also the broadcast the clients trained from, each
    client's mean loss and trained tree, the same after the ``EARLY``
    steps (``early``: {T: {"losses", "trained"}}), the kept uplinks and
    the new global trainable tree. ``precision`` "fp64" trains in
    float64 from the same fp32 inputs (a witness, not the reference)."""
    dev = torch.device(device)
    bits = traffic["quant_bits"]
    dt = torch.float64 if precision == "fp64" else torch.float32
    model = ref_model.Model(cfg, emulate_tf32=(precision == "tf32"
                                               and dev.type == "cpu"))
    sizes = [len(d["y"]) for d in datas]
    sampler = Sampler(seed, sizes, traffic["n_clients"],
                      traffic["clients_per_round"], cfg["batch_size"],
                      cfg["local_epochs"])
    frozen = _tree_map(lambda t: t.to(dev, dt), params["frozen"])
    glob = _tree_map(lambda t: t.to(dev, torch.float32), params["train"])
    out = []
    for rnd in range(rounds):
        draw = sampler.next_round()
        rec = {"cohort": draw["cohort"], "kept": draw["kept"],
               "n_steps": draw["n_steps"]}
        out.append(rec)
        if rnd:
            continue
        bcast = decode(encode(glob, bits), glob)
        start = _tree_map(lambda t: t.to(dt), bcast)
        losses, trained, msgs = [], {}, {}
        early = {e: {"losses": [], "trained": []} for e in EARLY}
        with ref_model.precision(precision):
            for i, cid in enumerate(draw["cohort"]):
                x = torch.from_numpy(datas[cid]["x"]).to(dev, dt)
                y = torch.from_numpy(datas[cid]["y"]).to(dev)
                tr, loss, ear = train_client(
                    model, frozen, start, x, y, draw["idx"][i],
                    draw["n_steps"][i], cfg["lr"], cfg["momentum"])
                losses.append(loss)
                trained[cid] = tr
                msgs[cid] = encode(tr, bits)
                for e, (t_e, l_e) in ear.items():
                    early[e]["trained"].append(t_e)
                    early[e]["losses"].append(l_e)
        kept = draw["kept"]
        rec.update(bcast=bcast, losses=losses, early=early,
                   trained=[trained[c] for c in draw["cohort"]],
                   msgs=[msgs[c] for c in kept])
        rec["global"] = fedavg([msgs[c] for c in kept],
                               [sizes[c] for c in kept], glob)
    return out
