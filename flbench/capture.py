"""What the port's first rounds produce, recorded for the comparison.

``Capture`` wraps the server's cohort trainer and its aggregator's
``aggregate`` for the rounds it is open: each call passes straight
through, and a host copy of its inputs and outputs is kept. In the
first round the trainer is also called on the same broadcast and batches
cut to the first ``EARLY`` steps of the schedule (each client's active
count clipped to them), so that the state after one and after three
local steps can be held too. After each round it records the server's
new global trainable parameters and the round's measured uplink size. ``close`` puts the server back as it was,
so the measured window runs the unwrapped server.
"""
from __future__ import annotations

import torch

from flbench.reference import fl as ref_fl
from flbench.reference import model as ref_model
from flbench.reference import wire as ref_wire


def host_leaves(tree) -> dict:
    """{path: host fp32 tensor} of a tree's leaves."""
    return {p: ref_model.get(tree, p).detach().to("cpu").clone()
            for p in ref_model.leaf_paths(tree)}


def host_message(msg, like: dict, bits) -> dict:
    """One uplink as the reference's message form (host tensors). A flat
    packed message is read as the wire lays it out; an fp32 uplink is
    its tree."""
    if bits is None:
        return {p: {"fp": t} for p, t in host_leaves(msg).items()}
    return ref_wire.decode(
        msg.payload.view(torch.int32).cpu(),
        msg.scale.detach().cpu(), msg.zp.detach().cpu(),
        [t.detach().cpu() for t in msg.fp_leaves], like, bits)


def _per_client(trained, losses) -> dict:
    """A cohort trainer's output as {"trained": [{path: leaf}] a client,
    "losses": [float] a client}, on the host."""
    leaves = host_leaves(trained)
    k = int(losses.shape[0])
    return {"trained": [{p: t[i] for p, t in leaves.items()}
                        for i in range(k)],
            "losses": [float(v) for v in losses.detach().cpu()]}


class Capture:
    """Records the rounds of ``server`` run while it is open."""

    def __init__(self, server, like: dict, bits):
        self.server = server
        self.like = like
        self.bits = bits
        self.rounds: list[dict] = []
        self._cur: dict = {}
        self._trainer = server.trainer
        server.trainer = self._train
        server.aggregator.aggregate = self._aggregate

    def _train(self, frozen, start, batches, n_steps):
        trained, losses = self._trainer(frozen, start, batches, n_steps)
        self._cur.update(n_steps=[int(v) for v in n_steps.cpu()],
                         bcast=host_leaves(start),
                         **_per_client(trained, losses))
        if not self.rounds:
            self._cur["early"] = {
                e: _per_client(*self._trainer(
                    frozen, start, {k: v[:, :e] for k, v in batches.items()},
                    torch.clamp(n_steps, max=e)))
                for e in ref_fl.EARLY}
        return trained, losses

    def _aggregate(self, msgs, weights):
        out = type(self.server.aggregator).aggregate(
            self.server.aggregator, msgs, weights)
        self._cur["msgs"] = [host_message(m, self.like, self.bits)
                             for m in msgs]
        return out

    def run_round(self) -> dict:
        rec = self.server.run_round()
        self._cur["global"] = host_leaves(self.server.global_train)
        self._cur["up_bytes"] = rec["up_bytes_measured"] \
            if "up_bytes_measured" in rec \
            else rec["up_bytes"] // max(rec["n_agg"] + rec["n_straggled"], 1)
        self.rounds.append(self._cur)
        self._cur = {}
        return rec

    def close(self) -> None:
        self.server.trainer = self._trainer
        del self.server.aggregator.aggregate
