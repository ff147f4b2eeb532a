"""Quickstart: FLoCoRA (paper Fig. 1) on the port. The JAX package's
``examples/quickstart.py`` on ``repro_torch``, mode for mode.

Federates a ResNet-8 over 20 clients on a synthetic CIFAR-like task,
exchanging int8-quantized LoRA adapters, and prints the communication
saving against FedAvg (paper Tables I/III).

``--hetero`` runs the heterogeneous fleet instead: 10 clients in three
rank tiers (r in {4, 8, 16}: phones, laptops, workstations), trained by
the rank-bucketed engine with per-client truncated broadcasts.

``--async`` drops round lockstep: the three-tier fleet (12 clients)
runs through the event-driven FedBuff engine on a virtual clock, and
every ``--buffer`` arrivals flush into a new global version.

``--sparse`` runs the FLASC-style sparse-delta uplink: top-k at
``--density``, survivors quantized to 4 bits, error feedback re-ships
the dropped mass.

``--dp [NOISE]`` clips each uplink's adapter delta to L2 norm 1 and adds
Gaussian noise at NOISE x clip (default 0.3) before int8 quantization;
every round's record carries the cumulative ``dp_epsilon``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--rounds 6] \\
        [--hetero | --async [--arrivals 90] [--buffer 6] \\
         | --sparse [--density 0.1] | --dp [0.3]] [--device cuda]

Runs on the card unless ``--device cpu`` is given. Each mode has a
builder (``uniform_setup``, ``hetero_setup``, ``async_setup``,
``sparse_setup``: the data, configs and trace as a
``launch.fl_experiment.Setup``) and a runner (``run_uniform``, ...)
that prints what the example prints and returns the server's history.
``model=`` (a ``{"frozen", "train"}`` tree) replaces the port's own
init, which draws from a torch generator, not ``jax.random``.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.core import flocora, messages
from repro_torch.core.flocora import FLoCoRAConfig, RankSchedule
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.quant import DPConfig, QuantConfig
from repro_torch.core.sparse import SparsityConfig
from repro_torch.fl import AsyncConfig, AvailabilityWindows, ClientConfig, \
    FleetTrace, LognormalLatency, ServerConfig, time_to_target
from repro_torch.launch.fl_experiment import Setup, vision_data
from repro_torch.models import resnet
from repro_torch.utils.device import resolve_device

TIERS = (4, 8, 16)


def quickstart_data(n_images: int, n_clients: int) -> list[dict]:
    """The example's fleet: ``n_images`` synthetic images from
    ``default_rng(0)`` over ``n_clients`` non-IID (LDA 0.5) clients, the
    partition at its default seed."""
    return vision_data(np.random.default_rng(0), n_images, n_clients, 0.5)


def _cfg(rank: int, alpha: float) -> resnet.ResNetConfig:
    return resnet.ResNetConfig(arch="resnet8",
                               lora=LoRAConfig(rank=rank, alpha=alpha))


def _client() -> ClientConfig:
    return ClientConfig(local_epochs=1, batch_size=32, lr=0.01)


def uniform_setup(rounds: int = 6, dp_noise: Optional[float] = None
                  ) -> Setup:
    """20 clients over 2000 images, ResNet-8 r = 32 (alpha = 16r), int8,
    K = 5; with ``dp_noise`` each uplink clipped to L2 norm 1 and noised
    at ``dp_noise`` x clip."""
    dp = None if dp_noise is None else DPConfig(clip_norm=1.0,
                                                noise_multiplier=dp_noise)
    return Setup(quickstart_data(2000, 20), _cfg(32, 512.0),
                 ServerConfig(rounds=rounds, n_clients=20,
                              clients_per_round=5),
                 _client(),
                 FLoCoRAConfig(rank=32, alpha=512.0, quant_bits=8, dp=dp))


def hetero_setup(rounds: int = 6) -> Setup:
    """10 clients over 1000 images in rank tiers {4, 8, 16}; the server
    holds rank-16 globals (alpha 256), int8, K = 6."""
    return Setup(quickstart_data(1000, 10), _cfg(16, 256.0),
                 ServerConfig(rounds=rounds, n_clients=10,
                              clients_per_round=6),
                 _client(),
                 FLoCoRAConfig(rank=16, alpha=256.0, quant_bits=8,
                               rank_schedule=RankSchedule.tiered(TIERS,
                                                                 10)))


def fleet_trace() -> FleetTrace:
    """The async fleet's timing: ~45 s median compute (heavier tiers
    longer), a jittery 20 Mb/s link, each client available 80% of a
    10-minute cycle."""
    return FleetTrace(seed=0,
                      latency=LognormalLatency(compute_median_s=45.0,
                                               network_mbps=20.0),
                      availability=AvailabilityWindows(period_s=600.0,
                                                       duty=0.8))


def async_setup(arrivals: int = 90, buffer_size: int = 6) -> Setup:
    """12 clients over 1000 images in rank tiers {4, 8, 16} (server rank
    16, int8) on the event-driven FedBuff engine: 6 in flight, a flush
    every ``buffer_size`` arrivals, ``fleet_trace``."""
    return Setup(quickstart_data(1000, 12), _cfg(16, 256.0),
                 ServerConfig(n_clients=12), _client(),
                 FLoCoRAConfig(rank=16, alpha=256.0, quant_bits=8,
                               rank_schedule=RankSchedule.tiered(TIERS,
                                                                 12)),
                 acfg=AsyncConfig(total_arrivals=arrivals, concurrency=6,
                                  buffer_size=buffer_size, half_life=4.0,
                                  microbatch_window=60.0, seed=0),
                 trace=fleet_trace())


def sparse_setup(rounds: int = 6, density: float = 0.1) -> Setup:
    """The uniform fleet with top-k uplinks at ``density``, int4
    survivors and error feedback."""
    return Setup(quickstart_data(2000, 20), _cfg(32, 512.0),
                 ServerConfig(rounds=rounds, n_clients=20,
                              clients_per_round=5),
                 _client(),
                 FLoCoRAConfig(rank=32, alpha=512.0, quant_bits=4,
                               error_feedback=True,
                               sparsity=SparsityConfig(density=density)))


def uniform_bytes(train) -> tuple[int, int]:
    """(FedAvg's dense fp32 message, FLoCoRA's int8 message) in bytes,
    from shapes only."""
    fedavg = resnet.init(0, resnet.ResNetConfig(arch="resnet8",
                                                mode="fedavg"),
                         device="cpu")["train"]
    return (messages.message_wire_bytes(fedavg, QuantConfig()),
            messages.message_wire_bytes(train, QuantConfig(bits=8)))


def tier_bytes(train, fcfg: FLoCoRAConfig) -> dict:
    """One-way bytes of a client message at each tier's rank."""
    return {r: flocora.client_wire_bytes(train, fcfg, r) for r in TIERS}


def sparse_bytes(train, density: float) -> tuple[int, int, int]:
    """(fp32, int4, int4 + top-k at ``density``) uplink bytes."""
    return (messages.message_wire_bytes(train, QuantConfig()),
            messages.message_wire_bytes(train, QuantConfig(bits=4)),
            messages.message_wire_bytes(train, QuantConfig(bits=4),
                                        density))


def run_uniform(rounds: int, dp_noise: Optional[float] = None,
                device="cuda", model: Optional[dict] = None) -> list:
    dev = resolve_device(device)
    setup = uniform_setup(rounds, dp_noise)
    model = setup.init(dev) if model is None else model
    fedavg_bytes, flocora_bytes = uniform_bytes(model["train"])
    print(f"message: FedAvg {fedavg_bytes/1e6:.2f} MB -> FLoCoRA+int8 "
          f"{flocora_bytes/1e6:.3f} MB "
          f"({fedavg_bytes/flocora_bytes:.1f}x smaller)")
    dp = setup.fcfg.dp
    if dp is not None:
        print(f"dp: clip L2 to {dp.clip_norm}, noise {dp.noise_multiplier}"
              f" x clip before int8 quantization (delta={dp.delta:g})")
    server = setup.server(model, dev)
    for h in server.run():
        print(h)
    return server.history


def run_hetero(rounds: int, device="cuda",
               model: Optional[dict] = None) -> list:
    """Mixed-rank fleet: 10 clients in three rank tiers."""
    dev = resolve_device(device)
    setup = hetero_setup(rounds)
    model = setup.init(dev) if model is None else model
    sched = setup.fcfg.rank_schedule
    for r, b in tier_bytes(model["train"], setup.fcfg).items():
        n = sum(1 for cr in sched.client_ranks if cr == r)
        print(f"tier r={r:2d}: {n} clients, {b / 1e3:7.1f} kB one-way")
    server = setup.server(model, dev)
    for h in server.run():
        print({k: h[k] for k in ("round", "n_agg", "client_loss",
                                 "cohort_ranks", "round_bytes",
                                 "tcc_bytes") if k in h})
    return server.history


def run_async(arrivals: int, buffer_size: int, device="cuda",
              model: Optional[dict] = None) -> list:
    """Three-tier fleet, no rounds: event-driven staleness-aware FedBuff
    over the packed wire, on a virtual clock."""
    dev = resolve_device(device)
    setup = async_setup(arrivals, buffer_size)
    model = setup.init(dev) if model is None else model
    for r, b in tier_bytes(model["train"], setup.fcfg).items():
        print(f"tier r={r:2d}: {b / 1e3:7.1f} kB one-way")
    srv = setup.server(model, dev)
    for h in srv.run():
        print({k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in h.items()
               if k in ("version", "t_virtual", "n_arrived", "client_loss",
                        "staleness_mean", "flush_ranks", "tcc_bytes")})
    last = srv.history[-1]
    print(f"virtual {last['t_virtual'] / 60:.1f} min, "
          f"{last['tcc_bytes'] / 1e6:.2f} MB total")
    hit = time_to_target(srv.history, "client_loss",
                         1.5 * last["client_loss"])
    if hit:
        print(f"reached 1.5x final loss at {hit['t_virtual'] / 60:.1f} "
              f"min / {hit['tcc_bytes'] / 1e6:.2f} MB")
    return srv.history


def run_sparse(rounds: int, density: float, device="cuda",
               model: Optional[dict] = None) -> list:
    """Sparse-delta uplink: top-k int4 adapters with error feedback, over
    the uniform quickstart's 20-client fleet. Raises if the measured
    uplink differs from the static sparse accounting."""
    dev = resolve_device(device)
    setup = sparse_setup(rounds, density)
    model = setup.init(dev) if model is None else model
    fp, q4, sp = sparse_bytes(model["train"], density)
    print(f"uplink: fp32 {fp / 1e3:.1f} kB -> int4 {q4 / 1e3:.1f} kB "
          f"-> int4+top-k({density:.0%}) {sp / 1e3:.1f} kB "
          f"({fp / sp:.1f}x smaller; EF re-ships the dropped mass)")
    server = setup.server(model, dev)
    for h in server.run():
        print({k: h[k] for k in ("round", "n_agg", "client_loss",
                                 "uplink_density", "down_bytes",
                                 "up_bytes", "tcc_bytes") if k in h})
    hist = server.history
    print(f"round bytes down/up: {hist[-1]['down_bytes']} / "
          f"{hist[-1]['up_bytes']} "
          f"(dense wire would up {hist[-1]['down_bytes']})")
    if hist[-1]["up_bytes_measured"] != sp:
        raise RuntimeError(f"measured uplink {hist[-1]['up_bytes_measured']}"
                           f" B != the static sparse accounting {sp} B")
    return hist


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--hetero", action="store_true",
                    help="mixed-rank cohort (10 clients, 3 rank tiers)")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="event-driven FedBuff fleet (virtual clock)")
    ap.add_argument("--sparse", action="store_true",
                    help="FLASC-style top-k sparse uplink with EF")
    ap.add_argument("--density", type=float, default=0.1,
                    help="sparse: fraction of adapter entries uplinked")
    ap.add_argument("--arrivals", type=int, default=90,
                    help="async: total virtual arrivals")
    ap.add_argument("--buffer", type=int, default=6,
                    help="async: FedBuff buffer size")
    ap.add_argument("--dp", type=float, nargs="?", const=0.3,
                    default=None, metavar="NOISE",
                    help="uniform quickstart with DP uplinks: clip + "
                         "Gaussian noise at NOISE x clip (default 0.3)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.sparse and not 0.0 < args.density <= 1.0:
        ap.error("--density must be in (0, 1]")
    if args.sparse:
        return run_sparse(args.rounds, args.density, args.device)
    if args.async_:
        return run_async(args.arrivals, args.buffer, args.device)
    if args.hetero:
        return run_hetero(args.rounds, args.device)
    return run_uniform(args.rounds, dp_noise=args.dp, device=args.device)


if __name__ == "__main__":
    main()
