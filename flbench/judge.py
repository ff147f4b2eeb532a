"""The comparison that decides ``correct``.

The port's first round (``capture.Capture``: what the cohort trainer,
the uplinks and the aggregate produced, and the server's state after the
round) is held against the plain reference (``reference.fl``) run on the
same inputs. Local training is held by the gap between the norm of a
client's change of a leaf (trained minus the broadcast it started from)
and the reference's, relative to the larger of the reference leaf's
norm and the client's median leaf norm ("a leaf's gap"). Leaves whose
reference change is under a thousandth of the client's median leaf's
are left out: they move by round-off alone. The numbers:

* ``loss_early``: the largest relative gap, over the cohort, of the mean
  loss of a client's first step and of its first three steps;
* ``step1_worst``: the largest leaf's gap after one local step (the
  first gradient as the optimizer takes it, times the learning rate),
  over the cohort's leaves;
* ``step3_worst``: the same after three local steps;
* ``update_median``: after the whole local run, the median leaf's gap
  over the cohort's leaves;
* ``wire``: the count of levels, scales, zero points, fp32 values and
  measured message sizes on which an uplink differs from the
  reference's encoding of that client's own trained parameters (the
  wire stage held alone, from the program's state);
* ``aggregate``: the largest gap, by leaf, of the server's new global
  parameters to the reference's FedAvg of the kept uplinks as sent,
  relative to the leaf's largest magnitude (the aggregation stage held
  alone).

The whole run's worst leaf (``update_worst``), the worst client's
median leaf then (``client_median``) and each client's mean loss over
the run (``loss_worst``) are reported beside them but not compared:
fp32 round-off grows over a client's local steps, in some clients until
their whole run parts, and there the reference run in float64 parts
from the reference in fp32 as far as sound runs of the program do. A
fault of one client or of one group of leaves is held after one and
three steps, where round-off has not grown.

Norms are taken in fp64.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from flbench.reference import fl as ref_fl
from flbench.reference import model as ref_model

NAMES = ("loss_early", "step1_worst", "step3_worst", "update_median",
         "wire", "aggregate")
EXCLUDE = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float64)))


def update_gaps(p_new: dict, p_old: dict, r_new, r_old, paths) -> list:
    """Per leaf, | |p_new - p_old| - |r_new - r_old| | / max(|r_new -
    r_old|, median leaf), ``p_*`` dicts keyed by path, ``r_*`` trees."""
    ref = {}
    for path in paths:
        r = ref_model.get(r_new, path)
        ref[path] = _norm(r - ref_model.get(r_old, path).to(r.device))
    med = float(np.median(list(ref.values())))
    gaps = []
    for path in paths:
        if ref[path] < EXCLUDE * med:
            continue
        dev = ref_model.get(r_new, path).device
        got = _norm(p_new[path].to(dev) - p_old[path].to(dev))
        gaps.append(abs(got - ref[path]) / max(ref[path], med, 1e-30))
    return gaps


def _bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    a = a.detach().to("cpu", torch.float32).contiguous()
    b = b.detach().to("cpu", torch.float32).contiguous()
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def wire_mismatches(msg: dict, trained: dict, bits) -> int:
    """Entries of ``msg`` (reference message form) that differ from the
    reference's encoding of ``trained`` (a dict keyed by path)."""
    bad = 0
    for path, x in trained.items():
        w = ref_fl.encode_leaf(x, bits)
        got = msg.get(path)
        if got is None:
            bad += x.numel()
            continue
        if "fp" in w:
            bad += _bits_differ(got.get("fp", torch.empty(0)), w["fp"]) \
                if "fp" in got else w["fp"].numel()
            continue
        if "levels" not in got or got["levels"].shape != w["levels"].shape:
            bad += w["levels"].numel()
            continue
        bad += int((got["levels"].cpu() != w["levels"].cpu()).sum())
        bad += _bits_differ(got["scale"], w["scale"])
        bad += _bits_differ(got["zp"], w["zp"])
    return bad


def client_gaps(p: dict, r: dict, paths) -> list[list]:
    """Each client's leaf gaps, ``p`` and ``r`` records with "trained"
    (a list of trees or of {path: leaf}) beside the round's "bcast"."""
    return [update_gaps(pt, p["bcast"], rt, r["bcast"], paths)
            for pt, rt in zip(p["trained"], r["trained"])]


def _loss_gap(got: list, want: list) -> float:
    return max((abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want)),
               default=0.0)


def compare(port: list[dict], ref: list[dict], start: dict,
            traffic: dict, sizes: list[int]) -> dict:
    """The numbers ``NAMES`` and the three reported beside them; ``port``
    from ``capture.Capture.rounds``, ``ref`` from
    ``reference.fl.run_rounds`` over as many rounds (its first round
    trained), ``start`` the initial trainable tree."""
    bits = traffic["quant_bits"]
    paths = ref_model.leaf_paths(start)
    p1, r1 = port[0], ref[0]
    out = dict.fromkeys(("loss_early", "step1_worst", "step3_worst",
                         "update_median", "client_median", "update_worst",
                         "loss_worst"), math.inf)
    early = sorted(r1["early"])
    if list(p1["n_steps"]) == list(r1["n_steps"]) \
            and len(p1["trained"]) == len(r1["trained"]) \
            and sorted(p1.get("early", {})) == early:
        full = client_gaps(p1, r1, paths)
        flat = [g for c in full for g in c]
        out.update(update_median=float(np.median(flat)),
                   client_median=max(float(np.median(c)) for c in full),
                   update_worst=max(flat),
                   loss_worst=_loss_gap(p1["losses"], r1["losses"]))
        for e in early:
            pe = dict(p1["early"][e], bcast=p1["bcast"])
            re = dict(r1["early"][e], bcast=r1["bcast"])
            out[f"step{e}_worst"] = max(
                g for c in client_gaps(pe, re, paths) for g in c)
        out["loss_early"] = max(_loss_gap(p1["early"][e]["losses"],
                                          r1["early"][e]["losses"])
                                for e in early)
    wire, agg_gap = int(len(port) != len(ref)), 0.0
    want_bytes = ref_fl.wire_bytes(start, bits)
    for p, r in zip(port, ref):
        pos = {c: i for i, c in enumerate(r["cohort"])}
        wire += int(len(p["msgs"]) != len(r["kept"]))
        for cid, msg in zip(r["kept"], p["msgs"]):
            wire += wire_mismatches(msg, p["trained"][pos[cid]], bits)
        wire += int(p["up_bytes"] != want_bytes)
        agg = ref_fl.fedavg(p["msgs"], [sizes[c] for c in r["kept"]], start)
        for path in paths:
            a = ref_model.get(agg, path).to(torch.float64).cpu()
            g = p["global"][path].to(torch.float64).cpu()
            top = float(a.abs().max()) if a.numel() else 0.0
            agg_gap = max(agg_gap, float((g - a).abs().max()) / max(top,
                                                                    1e-30))
    out.update(wire=float(wire), aggregate=agg_gap)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number
    is finite and at most its limit."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in NAMES}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
