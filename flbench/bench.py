"""One run of one cell: set-up, the measured window, the traced slices and
the comparison with the plain reference.

Set-up, in order: the flat wire's kernels are built or loaded (their
cache is ``build/kernels/`` in the checkout), the clients' data and the
initial model are drawn from ``--seed``, the ``FLServer`` is built, and
its first round runs through ``run_round`` with its outputs recorded
(``capture.Capture``); it warms every shape. The window then runs whole
rounds of the same server until ``--seconds`` have passed and ends at
the ``torch.cuda.synchronize()`` after the round in which they did.
``peak_mem_gib`` is the peak over the window's first ``MEMORY_ROUNDS``
rounds (over all of a shorter window): the FLoCoRA ResNet-8 cell's peak
grows by about 10 MB a round, so a peak over the whole window would
grow with the rounds a faster program fits into it. With ``--trace 1``
the program's tracer records the window's spans and two profiled slices
of ``PROFILE_ROUNDS`` rounds each follow it. Once the window has closed
and the peak memory is read, the server is freed and the reference runs
the recorded round again (``judge.compare``).
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

import torch

from flbench import capture, cells, data, judge, yardstick
from flbench.reference import fl as ref_fl

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the rounds that set-up runs and the reference follows
CHECKED_ROUNDS = 1
# whole rounds in each of the traced run's two profiled slices
PROFILE_ROUNDS = 2
# the window's rounds over which ``peak_mem_gib`` is read
MEMORY_ROUNDS = 6


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _port_configs(cfg: dict, traffic: dict, seed: int):
    from repro_torch.core.flocora import FLoCoRAConfig
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.fl import ClientConfig, ServerConfig
    from repro_torch.models import resnet
    rcfg = resnet.ResNetConfig(
        arch=cfg["arch"], n_classes=cfg["n_classes"],
        gn_groups=cfg["gn_groups"],
        lora=LoRAConfig(rank=cfg["lora_rank"], alpha=cfg["lora_alpha"]),
        mode=traffic["mode"], stem_mode=cfg["stem_mode"],
        fc_mode=cfg["fc_mode"], norms_trained=cfg["norms_trained"])
    scfg = ServerConfig(rounds=1 << 30, n_clients=traffic["n_clients"],
                        clients_per_round=traffic["clients_per_round"],
                        seed=seed, eval_every=1 << 30)
    ccfg = ClientConfig(local_epochs=cfg["local_epochs"],
                        batch_size=cfg["batch_size"], lr=cfg["lr"],
                        momentum=cfg["momentum"])
    fcfg = FLoCoRAConfig(rank=cfg["lora_rank"], alpha=cfg["lora_alpha"],
                         quant_bits=traffic["quant_bits"])
    return rcfg, scfg, ccfg, fcfg


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def prepare(cell: dict, seed: int, dev, trace: bool = False) -> dict:
    """Set-up up to the first round: the kernels, the data, the initial
    model (its host copy kept for the reference) and the server."""
    cfg, traffic = cell["config"], cell["traffic"]
    from repro_torch.fl import FLServer
    from repro_torch.models import resnet
    from repro_torch.obs.metrics import MetricsRegistry
    from flbench.trace import AnnotatingTracer
    if dev.type == "cuda" and traffic["quant_bits"] is not None:
        from repro_torch.kernels.build import LIBRARY
        LIBRARY.build(["quant_pack", "dequant_agg"])
    datas = data.client_datasets(traffic, cfg, seed, dev)
    params = data.make_params(cfg, traffic["mode"], seed, dev)
    start = _tree_to(params, "cpu")
    rcfg, scfg, ccfg, fcfg = _port_configs(cfg, traffic, seed)

    def loss_fn(frozen, train, batch):
        return resnet.loss_fn(frozen, train, rcfg, batch)

    tracer = AnnotatingTracer(enabled=trace)
    server = FLServer(params, loss_fn, datas, scfg, ccfg, fcfg,
                      tracer=tracer, registry=MetricsRegistry(enabled=trace),
                      device=dev)
    return {"datas": datas, "sizes": [len(d["y"]) for d in datas],
            "start": start, "server": server, "tracer": tracer}


def checked_rounds(cell: dict, run: dict) -> tuple[list, int]:
    """The first rounds through ``run_round``, recorded. Returns (the
    recorded rounds, how many had a loss that is not finite)."""
    cap = capture.Capture(run["server"], run["start"]["train"],
                          cell["traffic"]["quant_bits"])
    failed = 0
    try:
        for _ in range(CHECKED_ROUNDS):
            rec = cap.run_round()
            failed += not math.isfinite(rec["client_loss"])
    finally:
        cap.close()
    return cap.rounds, failed


def reference_rounds(cell: dict, run: dict, seed: int, dev,
                     precision: str = "fp32") -> list:
    return ref_fl.run_rounds(cell["config"], cell["traffic"], run["start"],
                             run["datas"], seed, CHECKED_ROUNDS, dev,
                             precision)


def numbers(cell: dict, run: dict, port: list, ref: list) -> dict:
    return judge.compare(port, ref, run["start"]["train"], cell["traffic"],
                         run["sizes"])


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None) -> dict:
    """One run; returns the result object (without printing it)."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cfg, traffic = cell["config"], cell["traffic"]
    bits, mode = traffic["quant_bits"], traffic["mode"]
    run = prepare(cell, seed, dev, trace)
    server, tracer, sizes = run["server"], run["tracer"], run["sizes"]
    port, failed = checked_rounds(cell, run)
    tracer.reset()
    _sync(dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # the measured window
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t0
    rounds, peak_rounds = 0, None
    mem = (lambda: torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else (lambda: 0)
    while True:
        rec = server.run_round()
        rounds += 1
        failed += not math.isfinite(rec["client_loss"])
        if rounds == MEMORY_ROUNDS:
            peak_rounds = mem()
        if time.perf_counter() - t_w0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t_w0
    peak = mem()
    peak_rounds = peak if peak_rounds is None else peak_rounds
    done = CHECKED_ROUNDS + rounds

    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if not trace:
        values = {"round_s": window_s / rounds,
                  "peak_mem_gib": peak_rounds / 2 ** 30,
                  "setup_s": setup_s}
        for m in cell["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        from flbench import trace as tr
        spans = tr.span_totals(tracer)
        n_prof = PROFILE_ROUNDS
        slice_dev = tr.profile_rounds(server, n_prof, host=False)
        slice_host = tr.profile_rounds(server, n_prof, host=True)
        sampler = ref_fl.Sampler(seed, sizes, traffic["n_clients"],
                                 traffic["clients_per_round"],
                                 cfg["batch_size"], cfg["local_epochs"])
        per_round = [sum(sampler.next_round()["n_steps"])
                     for _ in range(done + 2 * n_prof)]
        pk = yardstick.peaks(device_info["kind"]) or {}
        lo = yardstick.layout(cfg, mode, bits) if bits is not None else None
        k = traffic["clients_per_round"]
        ctx = {
            "spans": spans, "window_rounds": rounds,
            "slice_device": slice_dev, "slice_host": slice_host,
            "peaks": pk,
            "active_client_steps": sum(per_round[done: done + n_prof]),
            "schedule_steps": ref_fl.schedule_steps(
                sizes, cfg["batch_size"], cfg["local_epochs"]),
            "batch": cfg["batch_size"],
            "flops_per_image": yardstick.flops_per_image(cfg, mode),
            "b1_bytes": yardstick.b1_bytes(lo) if lo else None,
            "b2_bytes": yardstick.b2_bytes(lo, k) if lo else None,
            "packs_per_round": k}
        for m in cell["per_layer"]:
            v = cells.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=slice_dev["busy_s"],
                           window_s=slice_dev["wall_s"])
        top = lambda d: [[n, s] for n, s in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        breakdown = {"device_ops": top(slice_dev["by_name"]),
                     "idle_gaps": top(slice_host["idle_by_span"])}
        print(f"power limit: {power_limit()}", file=sys.stderr)

    # the comparison, once the program's state is freed
    del server
    run.pop("server")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_rounds(cell, run, seed, dev)
    correct, checks = judge.verdict(numbers(cell, run, port, ref),
                                    cell["limits"])
    result = {"correct": bool(correct and failed == 0),
              "attempted": done, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def report(result: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        if not math.isfinite(c["value"]):
            c["value"] = None
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
