"""Round parity: the port's FLServer vs the JAX package's on the tiny
linear model of tests/test_packed_codec.py, from one seed.

Both engines must sample the same cohorts and batches (the numpy RNG
stream is consumed in the same order), count identical wire bytes per
round, report client losses within rtol=1e-4 and hold global trees
within one quantization step (an fp32 tie can flip one level). Plus a
port-only ResNet-8 round on the CPU, the options the port refuses, and
FLoCoRAConfig's validations against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flocora import FLoCoRAConfig as JFLoCoRAConfig
from repro.fl import ClientConfig as JClientConfig
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro_torch.core import messages as tmsg
from repro_torch.core.flocora import FLoCoRAConfig, RankSchedule
from repro_torch.core.quant import DPConfig
from repro_torch.core.sparse import SparsityConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.data import SyntheticVision, lda_partition
from repro_torch.fl import ClientConfig, FLServer, ServerConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import resnet as tresnet

torch.set_num_threads(1)


def _tiny_setup(n=96, n_clients=4, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(16, 10)).astype(np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = np.argmax(x @ w_true + 0.1 * rng.normal(size=(n, 10)), axis=1)
    parts = np.array_split(rng.permutation(n), n_clients)
    data = [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]
    model = {"frozen": {"mu": np.zeros((16,), np.float32)},
             "train": {"w": (0.01 * rng.normal(size=(16, 10))
                             ).astype(np.float32),
                       "b": np.zeros((10,), np.float32)}}
    return data, model


def _jax_loss(frozen, train, batch):
    logits = (batch["x"] - frozen["mu"]) @ train["w"] + train["b"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, batch["y"][:, None],
                                         axis=1)), {}


def _torch_loss(frozen, train, batch):
    logits = (batch["x"] - frozen["mu"]) @ train["w"] + train["b"]
    logp = torch.log_softmax(logits, dim=-1)
    y = batch["y"].to(torch.int64)
    return -torch.mean(torch.gather(logp, 1, y[:, None])), {}


class _Recorder:
    """Proxy for a server's numpy Generator that records each cohort."""

    def __init__(self, rng):
        self.rng = rng
        self.cohorts = []

    def choice(self, *a, **kw):
        out = self.rng.choice(*a, **kw)
        self.cohorts.append(sorted(int(c) for c in out))
        return out

    def __getattr__(self, name):
        return getattr(self.rng, name)


BYTE_KEYS = ("down_bytes", "up_bytes", "up_bytes_measured", "tcc_bytes",
             "round_bytes", "wasted_bytes", "n_agg", "n_dropped",
             "n_straggled")


@pytest.mark.parametrize("bits,n_clients,oversample,p_fail", [
    (4, 4, 1.0, 0.0), (8, 4, 1.0, 0.0), (8, 6, 1.5, 0.2),
    (None, 4, 1.0, 0.0)])
def test_round_parity_with_jax(bits, n_clients, oversample, p_fail):
    data, model = _tiny_setup(n_clients=n_clients)
    scfg = dict(rounds=3, n_clients=n_clients, clients_per_round=2,
                oversample=oversample, p_client_failure=p_fail, seed=3)
    ccfg = dict(local_epochs=2, batch_size=8, lr=0.2)
    fcfg = dict(rank=8, alpha=128.0, quant_bits=bits)
    js = JFLServer(jax.tree.map(jnp.asarray, model), _jax_loss, data,
                   JServerConfig(**scfg), JClientConfig(**ccfg),
                   JFLoCoRAConfig(**fcfg))
    ts = FLServer(model, _torch_loss, data, ServerConfig(**scfg),
                  ClientConfig(**ccfg), FLoCoRAConfig(**fcfg), device="cpu")
    js.rng, ts.rng = _Recorder(js.rng), _Recorder(ts.rng)
    for _ in range(3):
        jr, tr = js.run_round(), ts.run_round()
        assert set(tr) == set(jr)
        for key in BYTE_KEYS:
            assert tr.get(key) == jr.get(key), key
        np.testing.assert_allclose(tr["client_loss"], jr["client_loss"],
                                   rtol=1e-4)
        jw = np.asarray(js.global_train["w"])
        if bits is None:                 # fp wire: fp32 tolerance
            np.testing.assert_allclose(ts.global_train["w"].numpy(), jw,
                                       rtol=1e-4, atol=1e-5)
        else:                            # one step of each column's range
            step = (np.maximum(jw.max(0), 0)
                    - np.minimum(jw.min(0), 0)) / ((1 << bits) - 1)
            assert (np.abs(ts.global_train["w"].numpy() - jw)
                    <= step[None, :] + 1e-6).all()
        np.testing.assert_allclose(ts.global_train["b"].numpy(),
                                   np.asarray(js.global_train["b"]),
                                   rtol=1e-4, atol=1e-4)
    assert ts.rng.cohorts == js.rng.cohorts
    assert ts.rng.bit_generator.state == js.rng.bit_generator.state
    assert ts.wire.wasted == js.wire.wasted
    assert ts.initial_model_bytes == js.initial_model_bytes
    assert ts.round_bytes_per_client == js.round_bytes_per_client


def test_resnet8_round_on_cpu():
    """Port only: ResNet-8 r=4, 2 clients, 1 local step, 16x16 images.
    Measured uplink bytes equal the static accounting; the loss is
    finite; on the CPU no kernel is launched."""
    rng = np.random.default_rng(0)
    sv = SyntheticVision(image=16, seed=0)
    y = rng.integers(0, 10, 64)
    x = sv.sample(rng, y)
    parts = lda_partition(y, 2, alpha=100.0)
    data = [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]
    cfg = tresnet.ResNetConfig(lora=LoRAConfig(rank=4, alpha=64.0))
    model = tresnet.init(0, cfg, device="cpu")
    kops.reset_launch_counts()
    srv = FLServer(model, lambda f, t, b: tresnet.loss_fn(f, t, cfg, b),
                   data, ServerConfig(rounds=1, n_clients=2,
                                      clients_per_round=2),
                   ClientConfig(local_epochs=1, batch_size=32, lr=0.01),
                   FLoCoRAConfig(rank=4, alpha=64.0, quant_bits=8),
                   device="cpu")
    rec = srv.run_round()
    static = tmsg.message_wire_bytes(model["train"], QuantConfig(bits=8))
    assert rec["up_bytes_measured"] == static
    assert rec["up_bytes"] == rec["down_bytes"] == 2 * static
    assert rec["n_agg"] == 2 and np.isfinite(rec["client_loss"])
    assert kops.launch_counts() == {"quant_pack_rows": 0,
                                    "dequant_agg_rows": 0,
                                    "dequant_agg": 0,
                                    "multi_lora_matmul": 0,
                                    "multi_lora_matmul_packed": 0,
                                    "lora_matmul": 0}


@pytest.mark.parametrize("kw,match", [
    (dict(dp=DPConfig(noise_multiplier=0.3), error_feedback=True),
     "incompatible"),
    (dict(rank=8, rank_schedule=RankSchedule.uniform(16, 4)),
     "exceeds the server rank"),
    (dict(sparsity=SparsityConfig(density=0.1)), "needs error_feedback")],
    ids=["dp_noise_with_ef", "schedule_above_rank", "sparse_requires_ef"])
def test_flocora_config_validations(kw, match):
    """The three refusals of the JAX package's FLoCoRAConfig, message
    for message; each option on its own constructs."""
    with pytest.raises(ValueError, match=match):
        FLoCoRAConfig(quant_bits=8, **kw)
    with pytest.raises(ValueError, match=match):
        JFLoCoRAConfig(quant_bits=8, **_kw_jax(kw))
    ok = {k: v for k, v in kw.items() if k not in ("error_feedback",
                                                   "rank")}
    FLoCoRAConfig(quant_bits=8, error_feedback="dp" not in ok, **ok)


def _kw_jax(kw: dict) -> dict:
    """The same options as the JAX package's config objects."""
    from repro.core import flocora as jfl, quant as jq, sparse as jsp
    out = dict(kw)
    if "dp" in kw:
        out["dp"] = jq.DPConfig(**vars(kw["dp"]))
    if "rank_schedule" in kw:
        out["rank_schedule"] = jfl.RankSchedule(**vars(kw["rank_schedule"]))
    if "sparsity" in kw:
        out["sparsity"] = jsp.SparsityConfig(**vars(kw["sparsity"]))
    return out


def test_unported_server_options_raise():
    """The fleet options the port once refused (a FleetTrace, a lazy
    population) are ported: a trace orders a deadline cohort, and what
    still raises is a population whose tiers exceed the server rank."""
    from repro_torch.fl import FleetTrace
    data, model = _tiny_setup()
    args = (model, _torch_loss, data)
    cfgs = (ClientConfig(local_epochs=1, batch_size=8),
            FLoCoRAConfig(rank=8, quant_bits=8))
    srv = FLServer(*args, ServerConfig(n_clients=4, clients_per_round=2,
                                       oversample=2.0), *cfgs,
                   trace=FleetTrace(seed=1), device="cpu")
    rec = srv.run_round()
    assert rec["n_agg"] == 2 and rec["n_straggled"] == 2
    assert rec["wasted_bytes"] == srv.wire.wasted > 0

    class LazyPopulation(list):
        max_rank = 64

        def rank_for(self, cid):
            return 8

    with pytest.raises(ValueError, match="exceeds the server rank"):
        FLServer(model, _torch_loss, LazyPopulation(data),
                 ServerConfig(n_clients=4), *cfgs, device="cpu")


def test_batch_stackers_match_jax():
    """The numpy batch gathering is the JAX package's, draw for draw."""
    from repro.fl import client as jclient
    from repro_torch.fl import client as tclient
    data, _ = _tiny_setup(n=100, n_clients=3)
    data[0] = {k: v[:5] for k, v in data[0].items()}   # < one batch
    jc, tc = JClientConfig(local_epochs=2, batch_size=8), \
        ClientConfig(local_epochs=2, batch_size=8)
    assert tclient.cohort_steps(data, tc) == jclient.cohort_steps(data, jc)
    assert [tclient.natural_steps(d, tc) for d in data] == \
        [jclient.natural_steps(d, jc) for d in data]
    jb, jn = jclient.stack_cohort_batches(np.random.default_rng(4), data, jc)
    tb, tn = tclient.stack_cohort_batches(np.random.default_rng(4), data, tc)
    np.testing.assert_array_equal(tn, jn)
    for key in jb:
        np.testing.assert_array_equal(tb[key], jb[key])
    jp = jclient.pad_cohort_batches(jb, jn, jclient.pow2_pad(3))
    tp = tclient.pad_cohort_batches(tb, tn, tclient.pow2_pad(3))
    np.testing.assert_array_equal(tp[1], jp[1])
    np.testing.assert_array_equal(tp[0]["x"], jp[0]["x"])


# ---------------------------------------------------------------------------
# The multi-pod round (launch/fl_round.py) over gloo against the JAX
# package's build_fl_round on 4 fake XLA host devices
# ---------------------------------------------------------------------------

ROUND_VARIANTS = [("fp32", None, None), ("int8", 8, None),
                  ("int2", 2, None), ("int8_async", 8, 2.0)]

_JAX_ROUND = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import registry
import repro.configs.minitron_4b as m
from repro.core import messages
from repro.core.quant import QuantConfig
from repro.launch.fl_round import build_fl_round
from repro.models import lm as LM
inp = dict(np.load(sys.argv[1]))
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2, 1),
            ("pod", "data", "model"))
entry = registry.ArchEntry("minitron-4b", "lm", m.smoke, m.smoke, False)
shapes = jax.eval_shape(lambda k: LM.init(k, m.smoke())["train"],
                        jax.random.PRNGKey(0))
n, td = len(jax.tree.leaves(shapes)), jax.tree.structure(shapes)
stacked = jax.tree.unflatten(td, [jnp.asarray(inp[f"c{i}"])
                                  for i in range(n)])
w, s = jnp.asarray(inp["w"]), jnp.asarray(inp["s"])


@jax.jit
def pod_partials(stacked, wd, bits_arr):
    # each pod's stage-1 partial and its stage-2 scales: where a level
    # may flip (a rounding tie) and the tolerance's quantization step
    qcfg = QuantConfig(bits=bits_arr.shape[0])
    recon = jax.vmap(jax.vmap(lambda t: messages.roundtrip(t, qcfg)))(stacked)
    wn = wd / jnp.maximum(jnp.sum(wd, axis=1, keepdims=True), 1e-8)
    part = jax.tree.map(lambda x: jnp.sum(
        x * wn.reshape(wn.shape + (1,) * (x.ndim - 2)), axis=1), recon)
    scales = []
    for p in range(2):
        enc = messages.pack_message(jax.tree.map(lambda x: x[p], part), qcfg,
                                    use_kernel=False)
        scales.append([leaf.scale if messages.is_packed_leaf(leaf)
                       else jnp.zeros(()) for leaf in jax.tree.leaves(
                           enc, is_leaf=messages.is_packed_leaf)])
    return jax.tree.leaves(part), [jnp.stack(sc) for sc in zip(*scales)]


out = {}
for tag, bits, hl in %r:
    built = build_fl_round(entry, mesh, clients_per_pod=2, bits=bits,
                           staleness_half_life=hl)
    args = (stacked, w) + ((s,) if hl else ())
    with mesh:
        got = jax.jit(built["fn"], in_shardings=built["in_shardings"])(*args)
    for i, x in enumerate(jax.tree.leaves(got)):
        out[f"{tag}/{i}"] = np.asarray(x)
    if bits:
        wd = w * jnp.exp2(-s / hl) if hl else w
        parts, scales = pod_partials(stacked, wd, jnp.zeros(bits))
        for i, (pt, sc) in enumerate(zip(parts, scales)):
            out[f"{tag}/part/{i}"] = np.asarray(pt)      # (P, *leaf)
            out[f"{tag}/scale/{i}"] = np.asarray(sc)     # (P, channels)
np.savez(sys.argv[2], **out)
print("ALL_OK")
""" % (ROUND_VARIANTS,)

_PORT_ROUND = """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import registry
from repro_torch.launch import fl_round
from repro_torch.utils import comm
from repro_torch.utils.sharding import placement_leaves
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten
e = registry.get("minitron-4b")
e = dataclasses.replace(e, full=e.smoke)
inp = dict(np.load(os.environ["INPUTS"]))
variants = json.loads(os.environ["VARIANTS"])
got, logs = {}, {}
for mshape in ((2, 2, 1), (2, 1, 2)):
    mesh = init_device_mesh("cpu", mshape,
                            mesh_dim_names=("pod", "data", "model"))
    mtag = "x".join(map(str, mshape))
    for tag, bits, hl in variants:
        built = fl_round.build_fl_round(e, mesh, clients_per_pod=2,
                                        bits=bits, staleness_half_life=hl)
        td = tree_flatten(built["args"][0])[1]
        pls = placement_leaves(built["in_placements"][0])
        stacked = tree_unflatten(td, [distribute_tensor(
            torch.from_numpy(inp[f"c{i}"]), mesh, list(pl))
            for i, pl in enumerate(pls)])
        wpl = list(built["in_placements"][1])
        args = (stacked, distribute_tensor(torch.from_numpy(inp["w"]), mesh,
                                           wpl))
        if hl:
            args += (distribute_tensor(torch.from_numpy(inp["s"]), mesh,
                                       wpl),)
        with comm.record_collectives() as log:
            out = built["fn"](*args)
        logs[f"{mtag}/{tag}"] = log
        for i, x in enumerate(tree_leaves(out)):
            full = x.full_tensor()
            got[f"{mtag}/{tag}/{i}"] = full.numpy()
np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **got)
with open(os.path.join(OUT, f"log{RANK}.json"), "w") as f:
    json.dump(logs, f)
"""


def _round_inputs():
    from repro_torch.configs import registry as treg
    from repro_torch.models import lm as tlm
    from repro_torch.utils.tree import tree_leaves
    cfg = treg.get("minitron-4b").smoke()
    shapes = tree_leaves(tlm.init(0, cfg, device="meta")["train"])
    rng = np.random.default_rng(25)
    inputs = {f"c{i}": (0.05 * rng.normal(size=(2, 2) + tuple(x.shape))
                        + 0.01 * i).astype(np.float32)
              for i, x in enumerate(shapes)}
    inputs["w"] = np.asarray([[1.0, 3.0], [2.0, 5.0]], np.float32)
    inputs["s"] = np.asarray([[0.0, 1.0], [2.0, 3.0]], np.float32)
    return shapes, inputs


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    import json
    import os
    import subprocess
    import sys
    from test_torch_sharding import ROOT, spawn_ranks
    tmp = tmp_path_factory.mktemp("fl_round")
    shapes, inputs = _round_inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_ROUND, str(tmp / "inputs.npz"),
         str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out = spawn_ranks(_PORT_ROUND, 4, tmp, env={
            "INPUTS": str(tmp / "inputs.npz"),
            "VARIANTS": json.dumps(ROUND_VARIANTS)})
    finally:
        so, se = jax_run.communicate(timeout=300)
    assert "ALL_OK" in so, so[-2000:] + se[-4000:]
    with open(out / "log0.json") as f:
        logs = json.load(f)
    return (shapes, dict(np.load(tmp / "jax.npz")),
            dict(np.load(out / "rank0.npz")), logs)


@pytest.mark.parametrize("tag,bits,hl", ROUND_VARIANTS)
def test_multipod_round_matches_jax(rounds, tag, bits, hl):
    """(pod 2, data 2, model 1), Kp = 2: fp32 within fp32 tolerance.
    Quantized, every element within fp32 tolerance too, except a stage-2
    level that flips where a pod's partial lies on a rounding tie (its
    value over its channel's scale within 1e-3 of a half level, where
    the packages' partials part by an ulp): such an element is off by at
    most one step of the pods' scales, and at most 2% of a leaf's
    elements are (measured: 6 of 512 at int2, at exact ties of the
    int2 grid's weighted means)."""
    shapes, jax_out, port, _ = rounds
    for i, x in enumerate(shapes):
        want, got = jax_out[f"{tag}/{i}"], port[f"2x2x1/{tag}/{i}"]
        assert got.shape == want.shape == tuple(x.shape)
        if bits is None or x.ndim < 2:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            continue
        scales = jax_out[f"{tag}/scale/{i}"]        # (P, channels)
        ratio = jax_out[f"{tag}/part/{i}"] / scales.reshape(
            (2,) + (1,) * (x.ndim - 1) + (-1,))
        tie = np.any(np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) < 1e-3,
                     axis=0)
        flip = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
        assert not np.any(flip & ~tie), (tag, i, int(np.sum(flip & ~tie)))
        assert np.sum(flip) <= 0.02 * x.numel(), (tag, i, int(np.sum(flip)))
        step = np.max(scales, axis=0)
        err = np.abs(got - want)[flip]
        assert np.all(err <= np.broadcast_to(step, x.shape)[flip]
                      * (1 + 1e-5) + 1e-7), (tag, i)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pod_message_codec_is_the_wire_codec(bits):
    """``pack_pod_message`` / ``unpack_pod_message`` (the compact word
    and fp32 buffers of stage 2) decode to exactly what the per-leaf
    codec's ``unpack_message(pack_message(x))`` gives, leaf by leaf: odd
    channel lengths leave sub-byte tails between leaves, and an empty
    leaf (nothing sent) and 1-D leaves ride along. The words are the
    leaves' ``PackedLeaf.to_wire`` payloads back to back, and the buffers
    hold the codec's bytes of the live leaves, the payload rounded up to
    a word."""
    from repro_torch.core import messages as tm
    from repro_torch.launch import fl_round
    rng = np.random.default_rng(bits)
    leaves = [torch.from_numpy((s * rng.normal(size=shape) + o)
                               .astype(np.float32))
              for shape, s, o in (((3, 7, 5), 0.1, 0.02), ((13,), 1.0, 0.0),
                                  ((5, 3), 2.0, -1.0), ((0, 4), 1.0, 0.0),
                                  ((2, 9, 11), 0.01, 0.5), ((4, 1), 1.0, 0.3))]
    words, floats, slots = fl_round.pack_pod_message(leaves, bits)
    assert words.dtype == torch.int32 and floats.dtype == torch.float32
    got = fl_round.unpack_pod_message(words, floats, slots, bits)
    live = [x for x in leaves if x.numel()]
    msg = tm.pack_message(live, QuantConfig(bits=bits))
    stream = np.concatenate([m.to_wire()["payload"] for m in msg
                             if tm.is_packed_leaf(m)])
    np.testing.assert_array_equal(
        words.view(torch.uint8).numpy()[: stream.size], stream)
    want = iter(tm.unpack_message(msg))
    for x, g in zip(leaves, got):
        assert g.shape == x.shape
        if x.numel():
            torch.testing.assert_close(g, next(want), rtol=0, atol=0)
    assert 4 * words.numel() + 4 * floats.numel() - 3 <= \
        tm.message_wire_bytes(live, QuantConfig(bits=bits)) \
        <= 4 * words.numel() + 4 * floats.numel()


@pytest.mark.parametrize("tag,bits,hl", ROUND_VARIANTS)
def test_model_axis_layout_leaves_values_alone(rounds, tag, bits, hl):
    """(pod 2, data 1, model 2) splits every leaf's channels over two
    ranks and reduces both clients on one: the same values as (pod 2,
    data 2, model 1)."""
    shapes, _, port, _ = rounds
    for i in range(len(shapes)):
        np.testing.assert_array_equal(port[f"2x1x2/{tag}/{i}"],
                                      port[f"2x2x1/{tag}/{i}"])


def _codec_bytes(shapes, bits):
    """(payload, sidecars + 1-D leaves) bytes of one pod's message, from
    the codec's accounting (``messages.message_wire_bytes``)."""
    from repro_torch.core import messages as m
    total = m.message_wire_bytes(shapes, QuantConfig(bits=bits))
    fp = sum(4 * x.numel() for x in shapes if x.ndim < 2)
    side = sum(8 * x.shape[-1] for x in shapes if x.ndim >= 2)
    return total - fp - side, fp + side


def test_cross_pod_bytes_are_the_codecs(rounds):
    """Rank 0 of (2, 2, 1) hands the pod all-gather its pod's whole
    message: the packed payload (rounded up to an int32 word) and the fp32
    sidecars and 1-D leaves, as the codec counts them; int2 < int8 <
    fp32 (tests/test_dryrun_small.py's order)."""
    shapes, _, _, logs = rounds
    cross = {}
    for tag, bits, _ in ROUND_VARIANTS:
        log = logs[f"2x2x1/{tag}"]
        pod = [r for r in log if r["axis"] == "pod"]
        assert all(r["kind"] == "all-gather" and r["group_size"] == 2
                   for r in pod), pod
        data = [r for r in log if r["axis"] == "data"]
        assert [r["kind"] for r in data] == ["all-reduce"], data
        cross[tag] = sum(r["bytes"] for r in pod)
        if bits is None:
            assert [r["dtype"] for r in pod] == ["float32"]
            assert cross[tag] == 4 * sum(x.numel() for x in shapes)
            continue
        payload, floats = _codec_bytes(shapes, bits)
        assert [(r["dtype"], r["bytes"]) for r in pod] == [
            ("int32", 4 * -(-payload // 4)), ("float32", floats)]
        # (2, 1, 2): each model rank hands its channels' share
        half = sum(r["bytes"] for r in logs[f"2x1x2/{tag}"]
                   if r["axis"] == "pod")
        assert half < cross[tag]
        assert not [r for r in logs[f"2x1x2/{tag}"] if r["axis"] == "data"]
    assert cross["int2"] < cross["int8"] < cross["fp32"]
    assert cross["int8_async"] == cross["int8"]


def test_fl_round_dry_run_on_the_fake_512_mesh(monkeypatch, tmp_path):
    """``dryrun_lib.run_fl_round`` on the (2, 16, 16) mesh over the fake
    backend, on minitron-4b's smoke config: every collective recorded,
    the bytes between pods equal to the codec's count of rank 0's share,
    int2 < int4 < int8 < fp32; the CLI prints one line a width."""
    import dataclasses
    from repro_torch.configs import registry as treg
    from repro_torch.launch import dryrun, dryrun_lib
    e = treg.get("minitron-4b")
    monkeypatch.setitem(treg.REGISTRY, "minitron-4b",
                        dataclasses.replace(e, full=e.smoke))
    monkeypatch.setattr(dryrun_lib, "RESULTS_DIR", str(tmp_path))
    cross = {}
    for bits in (None, 8, 4, 2):
        rec = dryrun_lib.run_fl_round("minitron-4b", bits=bits)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["chips"] == 512
        cross[bits] = rec["cross_pod_wire_bytes_per_chip"]
        assert cross[bits] == rec["cross_pod_bytes_per_chip"]   # 2 pods
        assert 0 <= cross[bits] - rec["message_wire_bytes_per_chip"] <= 3
        kinds = {(r["kind"], r["axis"]) for r in rec["records"]}
        assert kinds == {("all-reduce", "data"), ("all-gather", "pod")}
        t = rec["roofline"]
        assert t["n_collectives"] == len(rec["records"])
        assert t["t_collective_s"] == pytest.approx(
            rec["collective_total"] / 450e9)
    assert cross[2] < cross[4] < cross[8] < cross[None]
    assert len(dryrun_lib.load_all(str(tmp_path))) == 4
    assert dryrun.main(["--fl-round", "--bits", "8"]) == 0


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "minitron-4b"])
def test_one_pod_round_matches_jax_in_process(arch, tmp_path):
    """The enc-dec branch and the LM branch on a one-rank (1, 1, 1) mesh
    (gloo; the JAX package's round on its one CPU device): one pod, so
    the round returns stage 1's partial, within fp32 tolerance of the
    reference's."""
    import dataclasses
    import jax
    import torch.distributed as dist
    from jax.sharding import Mesh
    from repro.configs import registry as jreg
    from repro.launch.fl_round import build_fl_round as jbuild
    from repro_torch.configs import registry as treg
    from repro_torch.launch import fl_round
    from repro_torch.utils.tree import tree_flatten, tree_leaves, \
        tree_unflatten
    from torch.distributed.device_mesh import init_device_mesh
    je, te = jreg.get(arch), treg.get(arch)
    je = dataclasses.replace(je, full=je.smoke)
    te = dataclasses.replace(te, full=te.smoke)
    jm = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
              ("pod", "data", "model"))
    jb = jbuild(je, jm, clients_per_pod=2, bits=8)
    shapes, td = jax.tree.flatten(jb["args"][0])
    rng = np.random.default_rng(3)
    xs = [(0.05 * rng.normal(size=s.shape)).astype(np.float32)
          for s in shapes]
    w = np.asarray([[1.0, 2.0]], np.float32)
    with jm:
        want = jax.jit(jb["fn"], in_shardings=jb["in_shardings"])(
            jax.tree.unflatten(td, xs), w)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        tb = fl_round.build_fl_round(te, mesh, clients_per_pod=2, bits=8)
        ttd = tree_flatten(tb["args"][0])[1]
        got = tb["fn"](tree_unflatten(ttd, [torch.from_numpy(x)
                                            for x in xs]),
                       torch.from_numpy(w))
        got = [x.to_local().numpy() for x in tree_leaves(got)]
    finally:
        dist.destroy_process_group()
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
