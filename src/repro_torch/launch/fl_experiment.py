"""The paper's FL experiment harness: one federated run of a ResNet on the
synthetic CIFAR-like task, with test accuracy on held-out images, round
bytes and TCC (the total communication cost over all rounds). The
counterpart of the JAX package's ``benchmarks/common.py``
``fl_experiment``, which the Table II / IV and Fig. 2 / 3 runs call.

    from repro_torch.launch.fl_experiment import fl_experiment
    res = fl_experiment(mode="fedavg", rounds=2, device="cuda")
    res["best_acc"], res["round_bytes"], res["tcc_bytes"]

``Setup`` holds one run's data and configs and builds its servers; the
quickstart (``launch/quickstart.py``) builds its modes on it too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.data import SyntheticVision, lda_partition
from repro_torch.fl import AsyncConfig, AsyncFLServer, ClientConfig, \
    FLServer, ServerConfig
from repro_torch.fl.traces import FleetTrace
from repro_torch.models import resnet
from repro_torch.utils.device import resolve_device

N_TEST = 1000


def vision_data(rng: np.random.Generator, n_images: int, n_clients: int,
                lda_alpha: float, seed: Optional[int] = None) -> list[dict]:
    """``n_images`` synthetic 32x32x3 images drawn from ``rng`` (labels,
    then images) and split over ``n_clients`` by an LDA(``lda_alpha``)
    partition; ``seed`` None keeps the partition's default seed."""
    sv = SyntheticVision(seed=0)
    y = rng.integers(0, 10, n_images)
    x = sv.sample(rng, y).astype(np.float32)
    kw = {} if seed is None else {"seed": seed}
    parts = lda_partition(y, n_clients, alpha=lda_alpha, **kw)
    return [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]


@dataclasses.dataclass(frozen=True)
class Setup:
    """One FL run's data and configs: the clients' datasets (a list of
    dicts or a lazy ``Population``), the ResNet, the server, client and
    FLoCoRA configs, and for the event-driven engine its ``AsyncConfig``
    and ``FleetTrace``. ``test`` is (images, labels) of the held-out
    set, when the run evaluates; ``seed`` seeds the model's init."""
    data: Any
    cfg: resnet.ResNetConfig
    scfg: ServerConfig
    ccfg: ClientConfig
    fcfg: FLoCoRAConfig
    acfg: Optional[AsyncConfig] = None
    trace: Optional[FleetTrace] = None
    test: Optional[tuple] = None
    seed: int = 0

    def replace(self, fl: Optional[dict] = None,
                server: Optional[dict] = None,
                client: Optional[dict] = None, **fields) -> "Setup":
        """A copy with FLoCoRAConfig (``fl``), ServerConfig (``server``)
        or ClientConfig (``client``) fields, and any of this class's own
        ``fields``, replaced."""
        out = dataclasses.replace(self, **fields)
        return dataclasses.replace(
            out, fcfg=dataclasses.replace(out.fcfg, **(fl or {})),
            scfg=dataclasses.replace(out.scfg, **(server or {})),
            ccfg=dataclasses.replace(out.ccfg, **(client or {})))

    def loss_fn(self, frozen, train, batch):
        return resnet.loss_fn(frozen, train, self.cfg, batch)

    def init(self, device="cuda") -> dict:
        """The model from the port's own init: ``resnet.init(seed, cfg)``
        draws from a seeded ``torch.Generator``, not ``jax.random``, so
        its values differ from the JAX package's (carry a JAX tree
        across with ``convert.params_from_jax`` where they must match)."""
        return resnet.init(self.seed, self.cfg, device=device)

    def eval_fn(self, device="cuda") -> Optional[Callable]:
        """``eval_fn(frozen, train) -> {"test_acc": ...}``: the argmax of
        the held-out images' logits against their labels, on ``device``
        under ``torch.no_grad()``. None when the run has no test set."""
        if self.test is None:
            return None
        xt, yt = self.test
        xt = torch.from_numpy(xt).to(resolve_device(device))

        def eval_fn(frozen, train):
            with torch.no_grad():
                pred = torch.argmax(resnet.apply(frozen, train, self.cfg,
                                                 xt), -1)
            return {"test_acc": float((pred.cpu().numpy() == yt).mean())}

        return eval_fn

    def server(self, model: Optional[dict] = None, device="cuda",
               aggregator=None):
        """The run's ``FLServer`` (``AsyncFLServer`` with an ``acfg``) on
        ``device``, from ``model`` (a ``{"frozen", "train"}`` tree on any
        device) or, when None, ``init``; ``aggregator`` replaces the
        engine's default."""
        dev = resolve_device(device)
        model = self.init(dev) if model is None else model
        ev = self.eval_fn(dev)
        if self.acfg is not None:
            return AsyncFLServer(model, self.loss_fn, self.data, self.acfg,
                                 self.ccfg, self.fcfg, trace=self.trace,
                                 eval_fn=ev, aggregator=aggregator,
                                 device=dev)
        return FLServer(model, self.loss_fn, self.data, self.scfg,
                        self.ccfg, self.fcfg, ev, aggregator=aggregator,
                        trace=self.trace, device=dev)


def experiment_setup(arch: str = "resnet8", rank: int = 32,
                     alpha: Optional[float] = None, mode: str = "flocora",
                     quant_bits: Optional[int] = None, rounds: int = 10,
                     n_clients: int = 40, clients_per_round: int = 4,
                     n_train: int = 4000, lda_alpha: float = 0.5,
                     local_epochs: int = 1, seed: int = 0,
                     stem_mode: str = "dense", fc_mode: str = "dense",
                     norms_trained: bool = True, eval_every: int = 2,
                     error_feedback: bool = False, dp=None) -> Setup:
    """``fl_experiment``'s data and configs. The numpy draws are the JAX
    harness's, in its order: ``default_rng(seed)`` gives the labels and
    images, ``lda_partition(..., seed=seed)`` the clients, then the same
    rng the 1,000 held-out labels and images."""
    rng = np.random.default_rng(seed)
    data = vision_data(rng, n_train, n_clients, lda_alpha, seed=seed)
    yt = rng.integers(0, 10, N_TEST)
    xt = SyntheticVision(seed=0).sample(rng, yt)
    a = alpha if alpha is not None else 16.0 * rank
    cfg = resnet.ResNetConfig(arch=arch, mode=mode,
                              lora=LoRAConfig(rank=rank, alpha=a),
                              stem_mode=stem_mode, fc_mode=fc_mode,
                              norms_trained=norms_trained)
    return Setup(
        data, cfg,
        ServerConfig(rounds=rounds, n_clients=n_clients,
                     clients_per_round=clients_per_round, seed=seed,
                     eval_every=eval_every),
        ClientConfig(local_epochs=local_epochs, batch_size=32, lr=0.01,
                     momentum=0.9),
        FLoCoRAConfig(rank=rank, alpha=a, quant_bits=quant_bits,
                      error_feedback=error_feedback, dp=dp),
        test=(xt, yt), seed=seed)


def summary(srv: FLServer) -> dict:
    """``fl_experiment``'s result from a server that has run its rounds:
    the history, the last and best test accuracy, the round bytes a
    client (down and up, measured) and the TCC over the configured
    rounds."""
    hist = srv.history
    accs = [h["test_acc"] for h in hist if "test_acc" in h]
    return {"history": hist,
            "final_acc": accs[-1] if accs else None,
            "best_acc": max(accs) if accs else None,
            "round_bytes": srv.round_bytes_per_client,
            "tcc_bytes": srv.scfg.rounds * srv.round_bytes_per_client}


def fl_experiment(arch: str = "resnet8", rank: int = 32,
                  alpha: Optional[float] = None, mode: str = "flocora",
                  quant_bits: Optional[int] = None, rounds: int = 10,
                  n_clients: int = 40, clients_per_round: int = 4,
                  n_train: int = 4000, lda_alpha: float = 0.5,
                  local_epochs: int = 1, seed: int = 0,
                  stem_mode: str = "dense", fc_mode: str = "dense",
                  norms_trained: bool = True, eval_every: int = 2,
                  error_feedback: bool = False, dp=None, device="cuda",
                  model: Optional[dict] = None) -> dict:
    """One FL run on the synthetic vision task; returns the history,
    ``final_acc``, ``best_acc``, ``round_bytes`` and ``tcc_bytes``.

    Runs on ``device`` (the card by default; without one it raises).
    ``model`` is the initial ``{"frozen", "train"}`` tree; without it the
    port's ``resnet.init(seed, cfg)`` draws one from a torch generator,
    whose values differ from the JAX harness's ``jax.random`` init."""
    dev = resolve_device(device)
    setup = experiment_setup(
        arch=arch, rank=rank, alpha=alpha, mode=mode, quant_bits=quant_bits,
        rounds=rounds, n_clients=n_clients,
        clients_per_round=clients_per_round, n_train=n_train,
        lda_alpha=lda_alpha, local_epochs=local_epochs, seed=seed,
        stem_mode=stem_mode, fc_mode=fc_mode, norms_trained=norms_trained,
        eval_every=eval_every, error_feedback=error_feedback, dp=dp)
    srv = setup.server(model, dev)
    srv.run()
    return summary(srv)
