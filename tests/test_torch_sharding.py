"""The logical sharding rules (``repro_torch.utils.sharding``) and the
models' logical annotation trees against the JAX package's.

``logical_to_spec`` gives the JAX package's spec for every leaf of the
frozen and train logical trees of all ten archs, full and smoke, on
meshes (1, 1), (16, 16), (2, 16, 16), (2, 2, 2) and (4,) ``clients``,
with ``DEFAULT_RULES`` and ``fl_round``'s stacked-client rules (the
reference reads only ``mesh.axis_names`` and ``mesh.devices.shape``, the
port only ``mesh_dim_names`` and ``shape``, so stand-in objects serve);
the port's logical trees equal the JAX package's and fit the port's
``init`` trees on ``meta``; ``placements`` lays a spec out in DTensor
placements and refuses one against the mesh order; and on a 4-rank
(2, 2) gloo mesh every rank's local shard is the numpy slice its spec
names.

:func:`spawn_ranks` (used by the other scale-out test files) runs a
script in ``world`` processes over gloo with a ``file://`` store under
the test's temporary directory."""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as JR
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro.utils import sharding as JS
from repro_torch.configs import registry as TR
from repro_torch.models import encdec as TED
from repro_torch.models import lm as TLM
from repro_torch.utils import sharding as TS
from repro_torch.utils.tree import flatten_with_names

ROOT = Path(__file__).resolve().parents[1]

_PRELUDE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])
OUT = os.environ["OUT"]
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=RANK,
                        world_size=WORLD)
try:
{body}
    dist.barrier()
finally:
    dist.destroy_process_group()
"""


def spawn_ranks(body: str, world: int, tmp, timeout: float = 240.0,
                env: dict | None = None) -> Path:
    """Run ``body`` (indented into a try block after a gloo process group
    of ``world`` ranks is up; ``RANK``, ``WORLD``, ``OUT`` are defined)
    in ``world`` processes at once; every one must exit 0. Returns
    ``OUT``, a directory the ranks write their results to."""
    tmp = Path(tmp)
    out = tmp / "out"
    out.mkdir(exist_ok=True)
    code = _PRELUDE.format(body=textwrap.indent(textwrap.dedent(body),
                                                "    "))
    base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    base.update(PYTHONPATH=str(ROOT / "src"), WORLD_SIZE=str(world),
                INIT=f"file://{tmp / 'pg_store'}", OUT=str(out),
                **(env or {}))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(base, RANK=str(r)), cwd=tmp,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    errs = []
    for r, p in enumerate(procs):
        try:
            so, se = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(f"rank {r} exit {p.returncode}:\n{so[-2000:]}\n"
                        f"{se[-4000:]}")
    assert not errs, "\n".join(errs)
    return out


# ---------------------------------------------------------------------------
# Specs against the JAX package's
# ---------------------------------------------------------------------------

MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("pod", "data", "model"), (2, 2, 2)), (("clients",), (4,))]
FL_RULES = {**JS.DEFAULT_RULES, "__pod": "pod", "__kp": "data"}


def _meshes(names, shape):
    jmesh = types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(shape, np.int8))
    tmesh = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    return jmesh, tmesh


def _named(tree, prefix="") -> dict:
    """{path: leaf} of a tree whose leaves are tuples (annotations or
    specs), with ``flatten_with_names``' path strings."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, list):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_named(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _models(arch):
    e, je = TR.get(arch), JR.get(arch)
    if e.kind == "encdec":
        return e, je, TED, JED
    return e, je, TLM, JLM


def test_default_rules_are_the_references():
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES


@pytest.mark.parametrize("arch", sorted(JR.REGISTRY))
def test_specs_match_jax(arch):
    e, je, mod, jmod = _models(arch)
    n = 0
    for which in ("smoke", "full"):
        cfg = getattr(e, which)()
        logical = mod.logical(cfg)
        params = mod.init(0, cfg, device="meta")
        for names, shape in MESHES:
            jmesh, tmesh = _meshes(names, shape)
            for group in ("frozen", "train"):
                lg = _named(logical[group])
                for name, x in flatten_with_names(params[group]):
                    ann = lg[name]
                    sh = tuple(x.shape)
                    assert TS.logical_to_spec(ann, sh, tmesh) == tuple(
                        JS.logical_to_spec(ann, sh, jmesh)), (name, shape)
                    st = (2, 16) + sh
                    sann = ("__pod", "__kp") + ann
                    assert TS.logical_to_spec(sann, st, tmesh, FL_RULES) \
                        == tuple(JS.logical_to_spec(sann, st, jmesh,
                                                    FL_RULES)), (name, shape)
                    n += 1
    assert n > 50


@pytest.mark.parametrize("arch", sorted(JR.REGISTRY))
def test_logical_trees_match_jax_and_init(arch):
    e, je, mod, jmod = _models(arch)
    for which in ("smoke", "full"):
        cfg, jcfg = getattr(e, which)(), getattr(je, which)()
        logical = mod.logical(cfg)
        assert logical == jmod.logical(jcfg)
        params = mod.init(0, cfg, device="meta")
        for group in ("frozen", "train"):
            names = [n for n, _ in flatten_with_names(params[group])]
            got = _named(logical[group])
            assert sorted(got) == sorted(names), group
            for name, x in flatten_with_names(params[group]):
                assert len(got[name]) == x.ndim, (name, got[name], x.shape)


def test_tree_shardings_and_axis_sizes():
    cfg = TR.get("minitron-4b").smoke()
    _, tmesh = _meshes(("pod", "data", "model"), (2, 2, 2))
    params = TLM.init(0, cfg, device="meta")
    pls = TS.tree_shardings(TLM.logical(cfg)["train"], params["train"],
                            tmesh)
    assert pls["head"]["b"] == (Replicate(), Replicate(), Shard(1))
    assert len(TS.placement_leaves(pls)) == len(
        flatten_with_names(params["train"]))
    assert TS.mesh_axis_size(tmesh, "data") == 2
    assert TS.mesh_axis_size(tmesh, "clients") == 1
    assert TS.num_chips(tmesh) == 8


def test_placements_in_mesh_order_and_refusals():
    _, mesh = _meshes(("pod", "data", "model"), (2, 2, 2))
    assert TS.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert TS.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="against the mesh"):
        TS.placements((("model", "data"), None), mesh)
    # the reference's kv_seq rule resolves against the mesh order
    spec = TS.logical_to_spec(("kv_seq",), (8,), mesh)
    assert spec == (("model", "data"),)
    with pytest.raises(ValueError, match="against the mesh"):
        TS.placements(spec, mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        TS.placements(("clients",), mesh)
    with pytest.raises(ValueError, match="twice"):
        TS.placements(("data", "data"), mesh)


# ---------------------------------------------------------------------------
# Local shards on a 4-rank (2, 2) gloo mesh
# ---------------------------------------------------------------------------

SHARD_CASES = [((4, 6), ("data", "model")), ((4, 6), ("model", None)),
               ((8, 3), (("data", "model"), None)),
               ((2, 4, 6), (None, "data", "model")), ((5, 4), (None, None)),
               ((6, 4), (None, ("data", "model")))]

_SHARD_BODY = """
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.utils import sharding
from repro_torch.utils.tree import flatten_with_names
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cases = json.loads(os.environ["CASES"])
got = {}
for i, (shape, spec) in enumerate(cases):
    spec = tuple(tuple(s) if isinstance(s, list) else s for s in spec)
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    d = distribute_tensor(full, mesh, list(sharding.placements(spec, mesh)))
    got[f"case{i}"] = d.to_local().numpy()
    assert torch.equal(d.full_tensor(), full)
cfg = registry.get("minitron-4b").smoke()
p = lm.init(0, cfg, device="cpu")
pls = sharding.tree_shardings(lm.logical(cfg)["train"], p["train"], mesh)
for (name, x), pl in zip(flatten_with_names(p["train"]),
                         sharding.placement_leaves(pls)):
    got["train/" + name] = distribute_tensor(x, mesh, list(pl)).to_local(
        ).numpy()
np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **got)
"""


def _slice(full: np.ndarray, spec, coords: dict, sizes: dict) -> np.ndarray:
    idx = []
    for d, entry in enumerate(spec):
        if entry is None:
            idx.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos, n = 0, 1
        for ax in axes:
            pos, n = pos * sizes[ax] + coords[ax], n * sizes[ax]
        blk = full.shape[d] // n
        idx.append(slice(pos * blk, (pos + 1) * blk))
    return full[tuple(idx)]


@pytest.fixture(scope="module")
def shards_4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard4")
    cases = json.dumps([[list(s), list(p)] for s, p in SHARD_CASES])
    out = spawn_ranks(_SHARD_BODY, 4, tmp, env={"CASES": cases})
    return {r: dict(np.load(out / f"rank{r}.npz")) for r in range(4)}


@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_local_shard_is_the_specs_numpy_slice(shards_4, case):
    shape, spec = SHARD_CASES[case]
    full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    sizes = {"data": 2, "model": 2}
    for r in range(4):
        coords = {"data": r // 2, "model": r % 2}
        np.testing.assert_array_equal(shards_4[r][f"case{case}"],
                                      _slice(full, spec, coords, sizes))


def test_model_leaves_shard_as_their_logical_specs(shards_4):
    cfg = TR.get("minitron-4b").smoke()
    p = TLM.init(0, cfg, device="cpu")
    _, tmesh = _meshes(("data", "model"), (2, 2))
    spec_of = _named(TS.map_logical(
        lambda a, x: TS.logical_to_spec(a, tuple(x.shape), tmesh),
        TLM.logical(cfg)["train"], p["train"]))
    sizes = {"data": 2, "model": 2}
    n_split = 0
    for name, x in flatten_with_names(p["train"]):
        full = x.numpy()
        for r in range(4):
            coords = {"data": r // 2, "model": r % 2}
            want = _slice(full, spec_of[name], coords, sizes)
            np.testing.assert_array_equal(shards_4[r]["train/" + name],
                                          want)
        n_split += any(e is not None for e in spec_of[name])
    assert n_split >= 5


def test_meshes_on_one_rank(tmp_path):
    """``launch/mesh.py`` needs the caller's process group, builds its
    meshes over it (the client mesh spans the whole group) and refuses a
    production mesh larger than the group."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_host_mesh(device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        host = M.make_host_mesh(device="cpu")
        assert host.mesh_dim_names == ("data", "model")
        assert tuple(host.shape) == (1, 1) and host.device_type == "cpu"
        assert tuple(M.make_client_mesh(device="cpu").shape) == (1,)
        with pytest.raises(RuntimeError):
            M.make_production_mesh(multi_pod=True, device="cpu")
    finally:
        dist.destroy_process_group()
