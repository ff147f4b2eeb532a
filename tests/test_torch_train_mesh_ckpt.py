"""Checkpoint and resume of the sharded LM training entry point
(``repro_torch.launch.train`` ``sharded_loop`` / ``--mesh``) on
minitron-4b's smoke config.

One spawn of 4 gloo ranks on a (2, 2) ``("data", "model")`` mesh runs
``sharded_loop`` for 2 steps with a checkpoint every step, then a fresh
3-step ``sharded_loop`` on a copy of that directory: the resumed run
restores step 2's ``train`` and ``opt`` onto the live run's placements,
each rank's block bit-identical to the live run's, and its one step is
bit-identical to a sharded step from the live state on the FIRST batch
of ``default_rng(0)`` (the loop draws anew at every start) and unlike
a step on the third. The (2, 2) run's file then resumes on one card
(``train_loop``), and a one-card run's file under ``--mesh host``, each
with values bit-identical to the file.

Against the JAX package: a checkpoint written by its ``launch/train.py
--mesh host`` resumes under the port's ``--mesh host`` bit for bit, and
the file the port writes there reads back in the JAX package's
``checkpoint.restore`` as the port's values."""
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import checkpoint as C
from repro_torch.launch import train
from repro_torch.utils.tree import flatten_with_names
from test_torch_sharding import spawn_ranks

torch.set_num_threads(2)

ARCH, BATCH, SEQ = "minitron-4b", 2, 16
ARGV = ["--arch", ARCH, "--smoke", "--batch", str(BATCH), "--seq",
        str(SEQ), "--checkpoint-every", "1", "--device", "cpu"]

_BODY = """
import shutil
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import registry
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.utils.sharding import tree_shardings
from repro_torch.utils.tree import flatten_with_names, tree_map
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
entry = registry.get("minitron-4b")
cfg = entry.smoke()
argv = json.loads(os.environ["ARGV"])


def args(steps, d):
    return train.parse_args(argv + ["--steps", str(steps),
                                    "--checkpoint-dir", d])


def run(steps, d):
    p = lm.init(0, cfg, device="cpu")
    return train.sharded_loop(p["frozen"], p["train"], cfg, entry,
                              args(steps, d), np.random.default_rng(0),
                              mesh)


def blocks(trees):
    # this rank's block of every leaf, copied (a step writes into them)
    return {f"{g}/{n}": (x.to_local().clone(), tuple(x.placements))
            for g, t in sorted(trees.items())
            for n, x in flatten_with_names(t)}


def same(a, b):
    return [k for k in sorted(set(a) | set(b))
            if k not in a or k not in b or a[k][1] != b[k][1]
            or a[k][0].dtype != b[k][0].dtype
            or not torch.equal(a[k][0], b[k][0])]


A, B = os.environ["DIR_A"], os.environ["DIR_B"]
live = run(2, A)
live_blocks = blocks({"train": live["train"], "opt": live["opt"]})
if RANK == 0:
    shutil.copytree(A, B)
dist.barrier()
seen = {}
restore_latest = train.CheckpointManager.restore_latest


def spy(self, like, shardings=None, device=None):
    got = restore_latest(self, like, shardings, device)
    seen["blocks"] = blocks(got[1])
    seen["meshes"] = all(x.device_mesh is mesh
                         for t in got[1].values()
                         for _, x in flatten_with_names(t))
    return got


train.CheckpointManager.restore_latest = spy
resumed = run(3, B)
train.CheckpointManager.restore_latest = restore_latest
got_blocks = blocks({"train": resumed["train"], "opt": resumed["opt"]})

# one sharded step from the live run's state, on batch 1 and on batch 3
p = lm.init(0, cfg, device="cpu")
frozen = S._distribute(p["frozen"], tree_shardings(
    lm.logical(cfg)["frozen"], p["frozen"], mesh), mesh)
step = train.sharded_step(cfg, entry.kind, args(3, B), mesh)
rng = np.random.default_rng(0)
batches = [train.draw_batch(rng, cfg, entry.kind, 2, 16, "cpu")
           for _ in range(3)]
ref, ref_loss = {}, {}
for i in (0, 2):
    tr, op = tree_map(torch.clone, live["train"]), \\
        tree_map(torch.clone, live["opt"])
    tr, op, loss = step(frozen, tr, op, batches[i])
    ref[i], ref_loss[i] = blocks({"train": tr, "opt": op}), float(loss)
json.dump({"live_start": live["start"], "start": resumed["start"],
           "losses": resumed["losses"], "ref_losses": ref_loss,
           "restored_differ": same(seen["blocks"], live_blocks),
           "restored_on_mesh": seen["meshes"],
           "n_leaves": len(live_blocks),
           "count": [str(seen["blocks"]["opt/count"][0].dtype),
                     int(seen["blocks"]["opt/count"][0])],
           "first_differ": same(ref[0], got_blocks),
           "third_differ": same(ref[2], got_blocks)},
          open(os.path.join(OUT, f"rank{RANK}.json"), "w"))
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    import json
    tmp = tmp_path_factory.mktemp("train_mesh_ckpt")
    out = spawn_ranks(_BODY, 4, tmp, env={
        "ARGV": json.dumps(ARGV), "DIR_A": str(tmp / "a"),
        "DIR_B": str(tmp / "b")})
    return tmp, [json.load(open(out / f"rank{r}.json")) for r in range(4)]


def test_resume_restores_each_ranks_block(mesh_runs):
    _, ranks = mesh_runs
    for r, res in enumerate(ranks):
        assert res["live_start"] == 0 and res["start"] == 2, (r, res)
        assert len(res["losses"]) == 1, (r, res)
        assert res["n_leaves"] > 3 and res["restored_on_mesh"], (r, res)
        assert res["restored_differ"] == [], (r, res["restored_differ"])
        # AdamW's step count: int32 in the file, replicated, exact
        assert res["count"] == ["torch.int32", 2], (r, res["count"])


def test_resumed_step_is_a_step_on_the_first_batch(mesh_runs):
    _, ranks = mesh_runs
    for r, res in enumerate(ranks):
        assert res["first_differ"] == [], (r, res["first_differ"])
        assert res["losses"][0] == res["ref_losses"]["0"], (r, res)
        # the planted fault: the batch an uninterrupted run would draw
        assert any(k.startswith("train/") for k in res["third_differ"]), r
        assert res["losses"][0] != res["ref_losses"]["2"], (r, res)


def _spy(monkeypatch) -> dict:
    """Patches ``CheckpointManager.restore_latest`` to keep a copy of
    the global value of every leaf it restores."""
    seen = {}
    restore_latest = CheckpointManager.restore_latest

    def spy(self, like, shardings=None, device=None):
        got = restore_latest(self, like, shardings, device)
        seen["step"] = got[0]
        seen["trees"] = {
            f"{g}::{n}": (x.full_tensor() if isinstance(x, DTensor)
                          else x).clone()
            for g, t in got[1].items() for n, x in flatten_with_names(t)}
        seen["dtensor"] = [isinstance(x, DTensor) for t in got[1].values()
                           for _, x in flatten_with_names(t)]
        return got

    monkeypatch.setattr(CheckpointManager, "restore_latest", spy)
    return seen


def _equal_to_file(seen: dict, path: str) -> list:
    """The names whose restored value is not the file's, bit for bit."""
    with np.load(path) as saved:
        assert set(saved.files) == set(seen["trees"])
        return [k for k, x in seen["trees"].items()
                if x.dtype != C._tensor(saved[k]).dtype
                or not torch.equal(x, C._tensor(saved[k]))]


def test_mesh_file_resumes_on_one_card(mesh_runs, tmp_path, monkeypatch,
                                       capsys):
    tmp, _ = mesh_runs
    d = str(tmp_path / "ckpt")
    shutil.copytree(tmp / "a", d)
    seen = _spy(monkeypatch)
    got = train.main(ARGV + ["--steps", "3", "--checkpoint-dir", d])
    assert "resumed from step 2" in capsys.readouterr().out
    assert got["start"] == 2 and seen["step"] == 2
    assert not any(seen["dtensor"])
    assert _equal_to_file(seen, os.path.join(d, "ckpt_00000002.npz")) == []


def test_one_card_file_resumes_under_mesh_host(tmp_path, monkeypatch,
                                               capsys):
    d = str(tmp_path / "ckpt")
    train.main(ARGV + ["--steps", "2", "--checkpoint-dir", d])
    seen = _spy(monkeypatch)
    got = train.main(ARGV + ["--steps", "3", "--checkpoint-dir", d,
                             "--mesh", "host"])
    assert not dist.is_initialized()
    assert "resumed from step 2" in capsys.readouterr().out
    assert got["start"] == 2 and all(seen["dtensor"])
    assert _equal_to_file(seen, os.path.join(d, "ckpt_00000002.npz")) == []


def test_jax_mesh_host_file_resumes_in_the_port(tmp_path, monkeypatch,
                                                capsys):
    import jax
    from repro import checkpoint as jckpt
    from repro.configs import registry as JR
    from repro.launch import train as jtrain
    from repro.models import lm as JLM
    from repro.optim import adamw as jadamw
    d = str(tmp_path / "ckpt")
    monkeypatch.setattr(sys, "argv", [
        "train.py", "--arch", ARCH, "--mesh", "host", "--smoke", "--steps",
        "2", "--batch", str(BATCH), "--seq", str(SEQ), "--checkpoint-dir",
        d, "--checkpoint-every", "1"])
    jtrain.main()
    assert "step 2:" in capsys.readouterr().out
    seen = _spy(monkeypatch)
    got = train.main(ARGV + ["--steps", "3", "--checkpoint-dir", d,
                             "--mesh", "host"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert got["start"] == 2 and all(seen["dtensor"])
    assert _equal_to_file(seen, os.path.join(d, "ckpt_00000002.npz")) == []
    # the port's step-3 file, read by the JAX package
    cfg = JR.get(ARCH).smoke()
    like = jax.eval_shape(lambda k: (lambda t: {
        "train": t, "opt": jadamw().init(t)})(JLM.init(k, cfg)["train"]),
        jax.random.PRNGKey(0))
    back, man = jckpt.restore(d, 3, like)
    assert man["step"] == 3
    ours = {f"{g}::{n}": x.full_tensor()
            for g in ("train", "opt")
            for n, x in flatten_with_names(got[g])}
    theirs = {f"{g}::{n}": np.asarray(x)
              for g, t in back.items() for n, x in flatten_with_names(t)}
    assert set(ours) == set(theirs)
    for k, x in ours.items():
        assert theirs[k].dtype == C._host(x).dtype, k
        assert np.array_equal(theirs[k], C._host(x)), k
