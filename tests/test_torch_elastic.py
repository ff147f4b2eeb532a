"""Elastic restore (``repro_torch.fl.elastic.elastic_restore``): the JAX
package's two tests of tests/test_fl_system.py (a logical checkpoint
restores onto a new mesh; a checkpoint written under one mesh restores
onto another shape with every leaf equal and the new mesh's placements),
ported on a one-rank gloo group; then one spawn of 4 gloo ranks restores
a port-written and a JAX-written checkpoint of minitron-4b's smoke trees
onto a (2, 2) mesh, every rank holding the numpy slice of each leaf that
its logical annotation names."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro import checkpoint as jckpt
from repro.configs import registry as JR
from repro.models import lm as JLM
from repro_torch.checkpoint import save
from repro_torch.configs import registry as TR
from repro_torch.fl.elastic import elastic_restore
from repro_torch.models import lm as TLM
from repro_torch.utils.sharding import logical_to_spec, placements, \
    tree_shardings
from repro_torch.utils.tree import flatten_with_names
from test_torch_sharding import _named, _slice, spawn_ranks


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_elastic_restore_onto_new_mesh(tmp_path, one_rank):
    """Checkpoint saved logically restores onto a different mesh shape."""
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.arange(32.0).reshape(4, 8)}
    save(d, 5, {"train": tree})
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    got = elastic_restore(d, {"train": tree},
                          {"train": {"w": ("fsdp", "mlp")}}, mesh)
    assert got is not None
    step, trees, _ = got
    assert step == 5
    np.testing.assert_allclose(trees["train"]["w"].full_tensor().numpy(),
                               tree["w"].numpy())
    assert elastic_restore(str(tmp_path / "none"), {"train": tree},
                           {"train": {"w": ("fsdp", "mlp")}}, mesh) is None


def test_elastic_restore_cross_mesh_shardings(tmp_path, one_rank):
    """A checkpoint written under a 1-rank ('data',) mesh restores onto a
    DIFFERENT mesh shape with leaf equality AND the new mesh's placements
    on every restored leaf."""
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.arange(32.0).reshape(4, 8), "b": torch.arange(8.0)}
    logical = {"train": {"w": ("fsdp", "mlp"), "b": (None,)}}
    init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    save(d, 5, {"train": tree})
    mesh2 = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    got = elastic_restore(d, {"train": tree}, logical, mesh2)
    assert got is not None
    step, trees, _ = got
    assert step == 5
    expect = _named(tree_shardings(logical["train"], tree, mesh2))
    restored = dict(flatten_with_names(trees["train"]))
    assert set(restored) == {"w", "b"}
    for name, leaf in restored.items():
        assert isinstance(leaf, DTensor)
        np.testing.assert_array_equal(leaf.full_tensor().numpy(),
                                      tree[name].numpy())
        assert leaf.device_mesh == mesh2
        assert tuple(leaf.placements) == expect[name], name


def test_other_groups_land_on_the_host(tmp_path, one_rank):
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.ones(2, 2)}
    save(d, 1, {"train": tree, "opt": {"m": torch.zeros(3)}})
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    step, trees, _ = elastic_restore(
        d, {"train": tree, "opt": {"m": torch.ones(3)}},
        {"train": {"w": (None, "mlp")}}, mesh)
    assert isinstance(trees["train"]["w"], DTensor)
    assert not isinstance(trees["opt"]["m"], DTensor)
    assert torch.equal(trees["opt"]["m"], torch.zeros(3))


# ---------------------------------------------------------------------------
# 4 ranks onto a (2, 2) mesh, from the port's and the JAX package's files
# ---------------------------------------------------------------------------

_BODY = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import registry
from repro_torch.fl.elastic import elastic_restore
from repro_torch.models import lm
from repro_torch.utils.tree import flatten_with_names
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = registry.get("minitron-4b").smoke()
like = lm.init(1, cfg, device="cpu")
log = lm.logical(cfg)
got = {}
for src in ("port", "jax"):
    step, trees, _ = elastic_restore(os.path.join(os.environ["CKPT"], src),
                                     like, log, mesh)
    assert step == 3, step
    for g in ("frozen", "train"):
        for name, x in flatten_with_names(trees[g]):
            got[f"{src}/{g}/{name}"] = x.to_local().float().numpy()
            if RANK == 0:
                got[f"{src}/{g}/{name}/full"] = x.full_tensor().float(
                    ).numpy()
            else:
                x.full_tensor()
np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **got)
"""


def _ref_trees():
    cfg = TR.get("minitron-4b").smoke()
    return cfg, TLM.init(0, cfg, device="cpu")


@pytest.fixture(scope="module")
def restored_4(tmp_path_factory):
    import jax
    tmp = tmp_path_factory.mktemp("elastic4")
    cfg, p = _ref_trees()
    save(str(tmp / "port"), 3, {g: p[g] for g in ("frozen", "train")})
    # the same values written by the JAX package (bf16 leaves as bf16)
    je = JR.get("minitron-4b")
    jp = jax.eval_shape(lambda k: {g: t for g, t in JLM.init(
        k, je.smoke()).items() if g in ("frozen", "train")},
        jax.random.PRNGKey(0))
    jtrees = {}
    for g in ("frozen", "train"):
        # one flatten order in both packages (sorted keys)
        shapes, td = jax.tree_util.tree_flatten(jp[g])
        jtrees[g] = jax.tree_util.tree_unflatten(td, [
            jax.numpy.asarray(x.float().numpy()).astype(s.dtype)
            for (_, x), s in zip(flatten_with_names(p[g]), shapes)])
    jckpt.save(str(tmp / "jax"), 3, jtrees)
    out = spawn_ranks(_BODY, 4, tmp, env={"CKPT": str(tmp)})
    return cfg, p, {r: dict(np.load(out / f"rank{r}.npz")) for r in range(4)}


@pytest.mark.parametrize("src", ["port", "jax"])
def test_four_ranks_restore_onto_2x2(restored_4, src):
    cfg, p, got = restored_4
    logical = TLM.logical(cfg)
    sizes = {"data": 2, "model": 2}
    mesh = type("M", (), {"mesh_dim_names": ("data", "model"),
                          "shape": (2, 2)})()
    n_split = 0
    for g in ("frozen", "train"):
        ann = _named(logical[g])
        for name, x in flatten_with_names(p[g]):
            full = x.float().numpy()
            np.testing.assert_array_equal(got[0][f"{src}/{g}/{name}/full"],
                                          full)
            spec = logical_to_spec(ann[name], tuple(x.shape), mesh)
            placements(spec, mesh)
            for r in range(4):
                coords = {"data": r // 2, "model": r % 2}
                np.testing.assert_array_equal(
                    got[r][f"{src}/{g}/{name}"],
                    _slice(full, spec, coords, sizes))
            n_split += any(e is not None for e in spec)
    assert n_split >= 10
