"""The sharded cohort reduce (``kernels/ops.py``
``dequant_agg_rows_sharded``, ``core/flat.py``
``fedavg_packed_flat_sharded``) over gloo at world 4 and 8, against the
JAX package's single-device ``dequant_agg_rows`` (rtol 1e-5, atol 1e-6)
and ``aggregation.fedavg_packed`` (rtol 3e-5, atol 1e-6), the limits of
tests/test_streaming_agg.py's sharded check. K in {13, 16} at bits 2
and 8: K = 13 is no multiple of the axis, so zero-weight phantom clients
pad it. One spawn of 8 ranks runs every case: world 8 over
``make_client_mesh``, world 4 over the first four ranks
(``DeviceMesh.from_group``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import messages as jmsg
from repro.core.quant import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro_torch.core import messages as tmsg
from repro_torch.core.quant import QuantConfig
from repro_torch.utils.tree import flatten_with_names
from test_torch_sharding import spawn_ranks

K_MAX = 16
CASES = [(w, b, k) for w in (4, 8) for b in (2, 8) for k in (13, 16)]


def _tree(i: int, rank: int = 8) -> dict:
    rng = np.random.default_rng(100 + i)
    return {"blk": {"a": rng.normal(size=(13, rank)).astype(np.float32),
                    "b": rng.normal(size=(rank, 21)).astype(np.float32)},
            "norm": rng.normal(size=(7,)).astype(np.float32)}


def _weights(k: int) -> np.ndarray:
    return np.linspace(0.5, 2.0, k, dtype=np.float32)


_BODY = """
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.core import flat, messages
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.utils import comm
from repro_torch.utils.tree import flatten_with_names
meshes = {8: make_client_mesh(device="cpu")}
g4 = dist.new_group(ranks=[0, 1, 2, 3])
if RANK < 4:
    meshes[4] = DeviceMesh.from_group(g4, "cpu", mesh_dim_names=("clients",))
inp = np.load(os.environ["INPUTS"])
trees = [{"blk": {"a": torch.from_numpy(inp[f"{i}/a"]),
                  "b": torch.from_numpy(inp[f"{i}/b"])},
          "norm": torch.from_numpy(inp[f"{i}/norm"])} for i in range(16)]
got = {}
for world, mesh in meshes.items():
    for bits in (2, 8):
        for k in (13, 16):
            msgs = [messages.pack_message(tr, QuantConfig(bits=bits),
                                          flat=True) for tr in trees[:k]]
            w = inp[f"w{k}"]
            tag = f"w{world}_b{bits}_k{k}"
            with comm.record_collectives() as log:
                out = flat.fedavg_packed_flat_sharded(msgs, w, mesh)
                lo = msgs[0].layout
                r2 = kops.dequant_agg_rows_sharded(
                    torch.stack([m.payload for m in msgs]),
                    torch.stack([m.scale for m in msgs]),
                    torch.stack([m.zp for m in msgs]), w,
                    lo.n_valid_vec(), bits, mesh)
            assert [r["kind"] for r in log] == ["all-reduce"] * 2, log
            assert all(r["group_size"] == world for r in log), log
            for name, x in flatten_with_names(out):
                got[f"{tag}/fedavg/{name}"] = x.numpy()
            got[f"{tag}/rows"] = r2.numpy()
np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **got)
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_agg")
    inputs = {f"w{k}": _weights(k) for k in (13, 16)}
    for i in range(K_MAX):
        t = _tree(i)
        inputs.update({f"{i}/a": t["blk"]["a"], f"{i}/b": t["blk"]["b"],
                       f"{i}/norm": t["norm"]})
    np.savez(tmp / "inputs.npz", **inputs)
    out = spawn_ranks(_BODY, 8, tmp, env={"INPUTS": str(tmp / "inputs.npz")})
    return {r: dict(np.load(out / f"rank{r}.npz")) for r in range(8)}


def _jax_refs(bits: int, k: int):
    qcfg = JQuantConfig(bits=bits)
    msgs = [jmsg.pack_message(_tree(i), qcfg, flat=True) for i in range(k)]
    w = jnp.asarray(_weights(k))
    fed = jagg.fedavg_packed(msgs, w)
    rows = jops.dequant_agg_rows(
        jnp.stack([m.payload for m in msgs]),
        jnp.stack([m.scale for m in msgs]),
        jnp.stack([m.zp for m in msgs]), w,
        jnp.asarray(msgs[0].layout.n_valid_vec(), jnp.int32), bits)
    return fed, np.asarray(rows), msgs


@pytest.mark.parametrize("world,bits,k", CASES)
def test_sharded_reduce_matches_jax(port, world, bits, k):
    fed, rows, _ = _jax_refs(bits, k)
    tag = f"w{world}_b{bits}_k{k}"
    for r in range(world):
        np.testing.assert_allclose(port[r][f"{tag}/rows"], rows,
                                   rtol=1e-5, atol=1e-6)
        for name, x in flatten_with_names(fed):
            np.testing.assert_allclose(port[r][f"{tag}/fedavg/{name}"],
                                       np.asarray(x), rtol=3e-5, atol=1e-6)
    # every rank of the axis holds the same all-reduced sum
    for r in range(1, world):
        np.testing.assert_array_equal(port[r][f"{tag}/rows"],
                                      port[0][f"{tag}/rows"])


def test_port_messages_are_the_jax_packages():
    """The ranks pack with the port's codec: the same words and sidecars
    as the JAX package's, so both sides reduce the same cohort."""
    for bits in (2, 8):
        jm = jmsg.pack_message(_tree(3), JQuantConfig(bits=bits), flat=True)
        tm = tmsg.pack_message(
            {"blk": {a: torch.from_numpy(v)
                     for a, v in _tree(3)["blk"].items()},
             "norm": torch.from_numpy(_tree(3)["norm"])},
            QuantConfig(bits=bits), flat=True)
        assert np.array_equal(tm.payload.view(torch.int32).numpy(),
                              np.asarray(jm.payload).view(np.int32))
        assert np.array_equal(tm.scale.numpy(), np.asarray(jm.scale))
        assert np.array_equal(tm.zp.numpy(), np.asarray(jm.zp))
