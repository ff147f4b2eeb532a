"""The port stands alone: every module of ``repro_torch`` (and
``chip_smoke.py``) imports with ``jax`` and ``repro`` made unimportable,
and the default-device entry points raise without a CUDA device instead
of running on the CPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import lora
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.fl import ClientConfig, FLServer, ServerConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers, resnet
from repro_torch import serve

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert {{"repro_torch.utils.pcontext", "repro_torch.launch.spmd",
         "repro_torch.launch.steps"}} <= set(names)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
"""


def _run(code: str, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax_or_reference(tmp_path):
    out = _run(_IMPORT_ALL.format(src=str(ROOT / "src"), root=str(ROOT)),
               tmp_path)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


_USE_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
{body}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""

_USES = {
    "checkpoint": """
import tempfile, torch
from repro_torch import checkpoint
d = tempfile.mkdtemp()
checkpoint.CheckpointManager(d).save(1, {"train": {"w": torch.ones(2)}})
assert checkpoint.latest_step(d) == 1
""",
    "leaf_kernels": """
import torch
from repro_torch.kernels import ops
ops.dequant_agg(torch.zeros((2, 3, 4), dtype=torch.int32).view(torch.uint32),
                torch.ones((2, 3)), torch.zeros((2, 3)), [1.0, 1.0], 8)
x = torch.zeros((4, 8), dtype=torch.bfloat16)
ops.lora_matmul(x, torch.zeros((8, 8), dtype=torch.bfloat16),
                torch.zeros((8, 2), dtype=torch.bfloat16),
                torch.zeros((2, 8), dtype=torch.bfloat16), 1.0)
""",
    "error_feedback": """
import torch
from repro_torch.core import flocora
tree = {"w": torch.randn(4, 6), "b": torch.zeros(6)}
for flat in (True, False):
    cfg = flocora.FLoCoRAConfig(quant_bits=4, error_feedback=True,
                                flat_wire=flat)
    msg, res = flocora.client_uplink(tree, cfg)
""",
    "sparse_wire": """
import torch
from repro_torch.core import aggregation, flocora, messages
from repro_torch.core.sparse import SparsityConfig
tree = {"w": torch.randn(8, 6), "b": torch.zeros(6)}
cfg = flocora.FLoCoRAConfig(quant_bits=4, error_feedback=True,
                            sparsity=SparsityConfig(density=0.25))
msgs = [flocora.client_uplink(tree, cfg)[0] for _ in range(2)]
assert messages.message_density(msgs[0]) == 0.25
assert messages.packed_wire_bytes(msgs[0]) == messages.message_wire_bytes(
    tree, cfg.qcfg, 0.25)
aggregation.fedavg_packed(msgs, [1.0, 2.0])
""",
    "dp": """
import torch
from repro_torch.core import flocora
from repro_torch.core.quant import DPConfig, gaussian_epsilon
tree = {"w": torch.randn(4, 6), "b": torch.zeros(6)}
cfg = flocora.FLoCoRAConfig(quant_bits=8, dp=DPConfig(1.0, 0.3))
msg, _ = flocora.client_uplink(tree, cfg, start=tree, dp_key=(0, 1))
assert gaussian_epsilon(0.3, 1) == 21.559841619903807
""",
    "hetero": """
import torch
from repro_torch.core import aggregation, flocora, lora, messages
from repro_torch.core.quant import QuantConfig
def tree(r):
    return {"fc": {"a": torch.randn(8, r), "b": torch.randn(r, 5)},
            "n": torch.zeros(5)}
sched = flocora.RankSchedule.tiered((2, 4), 4)
cfg = flocora.FLoCoRAConfig(rank=4, quant_bits=8, rank_schedule=sched)
msgs = [flocora.server_downlink(tree(4), cfg, r) for r in (2, 4, 2)]
out = aggregation.FedAvgAggregator(QuantConfig(bits=8), 4).aggregate(
    msgs, [1.0, 2.0, 3.0])
assert lora.tree_ranks(out) == (4,)
svd = aggregation.SVDRecombinationAggregator(QuantConfig(bits=8), 4)
svd.aggregate(msgs, [1.0, 2.0, 3.0])
assert set(svd.served_ranks) == {"fc"}
""",
    "optim_schedule": """
import torch
from repro_torch import optim
f = optim.cosine_warmup(0.1, 2, 10)
assert isinstance(f(3), float) and f(torch.tensor(3)).shape == ()
opt = optim.adamw(weight_decay=0.1)
p = {"w": torch.ones(3)}
g, _ = optim.clip_by_global_norm({"w": torch.ones(3)}, 1.0)
p, st = opt.update(g, opt.init(p), p, optim.constant(0.01)(0))
""",
    "cohort_engines": """
import torch
from repro_torch.fl import ClientConfig, make_cohort_trainer, \
    make_local_trainer, make_staggered_cohort_trainer
def loss(frozen, train, batch):
    return torch.mean((batch["x"] @ train["w"] - batch["y"]) ** 2), {}
cfg = ClientConfig(fedprox_mu=0.1)
tr = {"w": torch.ones(4, 2)}
b = {"x": torch.ones(3, 2, 5, 4), "y": torch.zeros(3, 2, 5, 2)}
n = torch.tensor([2, 1, 0])
t, l = make_cohort_trainer(loss, cfg)({}, tr, b, n)
assert t["w"].shape == (3, 4, 2) and l.shape == (3,)
t, l = make_staggered_cohort_trainer(loss, cfg)({}, t, b, n)
t, l = make_local_trainer(loss, cfg)({}, tr, {k: v[0] for k, v in b.items()})
""",
    "async_fleet": """
import torch
from repro_torch.core import lora
from repro_torch.core.aggregation import FedBuffAggregator
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.data.synthetic import client_shard, linear_shard
from repro_torch.fl import AsyncConfig, AsyncFLServer, ClientConfig, \
    FLServer, FleetTrace, Population, PopulationTrace, ServerConfig, \
    default_tiers
g = torch.Generator().manual_seed(0)
fz, tr = lora.linear_init(g, 16, 10, "lora", LoRAConfig(rank=16, alpha=16.0),
                          base_dtype=torch.float32, device="cpu")
model = {"frozen": {"lin": fz}, "train": {"lin": tr}}
def loss(f, t, b):
    y = lora.linear_apply(f["lin"], t["lin"], b["x"], 1.0, torch.float32)
    return torch.nn.functional.cross_entropy(y, b["y"].long()), {}
pop = Population(10 ** 6, default_tiers(), shard_size=16,
                 shard_fn=lambda s, c: linear_shard(s, c, n=16, d=16),
                 cache_clients=8)
fcfg = FLoCoRAConfig(rank=16, alpha=16.0, quant_bits=8)
ccfg = ClientConfig(local_epochs=1, batch_size=8)
srv = AsyncFLServer(model, loss, pop, AsyncConfig(
    total_arrivals=6, concurrency=4, buffer_size=3, streaming_agg=True,
    microbatch_window=1e9), ccfg, fcfg, trace=PopulationTrace(population=pop),
    device="cpu")
assert len(srv.run()) == 2 and pop.peak_resident <= 8
FLServer(model, loss, pop, ServerConfig(n_clients=10 ** 6,
         clients_per_round=2, oversample=1.5), ccfg, fcfg,
         trace=FleetTrace(), aggregator=FedBuffAggregator(),
         device="cpu").run_round()
assert client_shard(0, 5, n=4)["x"].shape == (4, 32, 32, 3)
""",
    "lm_serve_and_telemetry": """
import torch
from repro_torch import obs
from repro_torch.configs import registry
from repro_torch.launch import lm_federated, serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve import generate
cfg = registry.get("gemma3-4b").smoke()
p = lm.init(0, cfg, device="cpu")
toks, t = generate(p["frozen"], p["train"], cfg, [[1, 2, 3] * 3], 3,
                   device="cpu")
assert toks.shape == (1, 3) and t["decode_steps"] == 2
out = launch_serve.main(["--arch", "qwen1.5-110b", "--smoke", "--gen", "2",
                         "--device", "cpu"])
assert out["tokens"].shape == (2, 2)
tiny = lm_federated.make_cfg(False)
q = lm.init(0, tiny, device="cpu")
res = lm_federated.run(q["frozen"], q["train"], tiny, 1, 1, 1, 2, 8, log=None)
assert res["rounds"][0]["mean_loss"] > 0
with obs.CompileWatchdog(0):
    lm.forward(p["frozen"], p["train"], cfg, toks)
assert obs.run_meta()["backend"] == "cpu"
""",
    "lm_mla_moe": """
import torch
from repro_torch import utils
from repro_torch.configs import registry, resnet_paper
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
for arch in ("deepseek-v2-236b", "llama4-maverick-400b-a17b"):
    cfg = registry.get(arch).smoke()
    p = lm.init(0, cfg, device="cpu")
    loss, m = lm.loss_fn(p["frozen"], p["train"], cfg,
                         {"tokens": [[1, 2, 3, 4, 5, 6]]})
    assert float(m["aux"]) > 0
    out = launch_serve.main(["--arch", arch, "--smoke", "--gen", "2",
                             "--device", "cpu"])
    assert out["tokens"].shape == (2, 2)
t = {"a": torch.ones(2), "b": [torch.zeros(3)]}
s = utils.tree_weighted_sum([t, utils.tree_scale(t, 2.0)], [0.5, 0.25])
assert float(s["a"][0]) == 1.0
assert resnet_paper.resnet18(rank=64).lora.alpha == 1024.0
""",
    "encdec_prefix_train": """
import numpy as np, tempfile, torch
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.models import encdec, lm
cfg = registry.get("seamless-m4t-medium").smoke()
p = encdec.init(0, cfg, device="cpu")
f, t = p["frozen"], p["train"]
mem = encdec.encode(f, t, cfg, np.ones((1, 5, cfg.d_model), np.float32))
cross = encdec.cross_cache(f, t, cfg, mem)
caches = encdec.self_cache_init(cfg, 1, 4, device="cpu")
lg, _ = encdec.decode_step(f, t, cfg, [[1]], caches, cross, 0)
assert lg.shape == (1, 1, cfg.vocab)
cfg = registry.get("paligemma-3b").smoke()
q = lm.init(0, cfg, device="cpu")
pre = torch.zeros((1, cfg.prefix_len, cfg.d_model))
lp, _, pos = lm.prefill(q["frozen"], q["train"], cfg, [[1, 2]], pre)
assert pos == cfg.prefix_len + 2
d = tempfile.mkdtemp()
for steps in (1, 2):
    out = train.main(["--arch", "seamless-m4t-medium", "--smoke", "--steps",
                      str(steps), "--batch", "1", "--seq", "8", "--device",
                      "cpu", "--checkpoint-dir", d, "--checkpoint-every",
                      "1"])
assert out["start"] == 1 and len(out["losses"]) == 1
""",
    "step_builder_dryrun": """
import dataclasses, os, tempfile
os.environ["DRYRUN_RESULTS"] = tempfile.mkdtemp()
from repro_torch.configs import registry
from repro_torch.core.lora import quantize_frozen_tree
from repro_torch.launch import dryrun, dryrun_lib, perf_iter, serve_quantized
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.roofline import analyze_step
e = registry.get("gemma3-4b")
registry.SHAPES["decode_32k"] = {"seq": 32, "batch": 2, "step": "decode"}
b = steps.build_cell(e, "decode_32k", cfg_override=e.smoke(), device="cpu")
r = analyze_step(b["fn"], *b["args"])
assert r["flops"] > 0 and r["peak_bytes"] >= r["argument_bytes"] > 0
p = lm.init(0, e.full(), device="meta")
assert quantize_frozen_tree(p["frozen"])["embed"]["w_q8"].is_meta
registry.REGISTRY["gemma3-4b"] = dataclasses.replace(e, full=e.smoke)
assert dryrun.main(["--arch", "gemma3-4b", "--shape", "decode_32k"]) == 0
assert dryrun_lib.load_all()[0]["status"] == "ok"
assert "int8_base" in perf_iter.variants_for("gemma3-4b", "decode_32k")
out = serve_quantized.run(serve_quantized.edge_cfg(), "cpu", log=None)
assert out["err"] <= 1e-4 * float(out["y_oracle"].abs().max())
""",
    "scale_out": """
import dataclasses, os, tempfile, torch
import torch.distributed as dist
os.environ["DRYRUN_RESULTS"] = tempfile.mkdtemp()
from repro_torch.checkpoint import save
from repro_torch.configs import registry
from repro_torch.core import flat, messages
from repro_torch.core.quant import QuantConfig
from repro_torch.fl.elastic import elastic_restore
from repro_torch.kernels import ops
from repro_torch.launch import dryrun_lib, fl_round, mesh as meshes
from repro_torch.models import lm
d = tempfile.mkdtemp()
dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=0,
                        world_size=1)
cm = meshes.make_client_mesh(device="cpu")
tree = {"w": torch.randn(4, 6), "b": torch.zeros(6)}
msgs = [messages.pack_message(tree, QuantConfig(bits=8), flat=True)] * 3
out = flat.fedavg_packed_flat_sharded(msgs, [1.0, 2.0, 3.0], cm)
assert out["w"].shape == (4, 6)
e = registry.get("minitron-4b")
e = dataclasses.replace(e, full=e.smoke)
m3 = meshes.make_host_mesh(device="cpu")
built = fl_round.build_fl_round(e, m3, clients_per_pod=2, bits=8)
assert built["args"][0]["head"]["b"].shape[:2] == (1, 2)
cfg = e.smoke()
p = lm.init(0, cfg, device="cpu")
save(os.path.join(d, "ck"), 1, {"train": p["train"]})
step, trees, _ = elastic_restore(os.path.join(d, "ck"),
                                 {"train": p["train"]},
                                 {"train": lm.logical(cfg)["train"]}, m3)
assert step == 1
dist.destroy_process_group()
registry.REGISTRY["minitron-4b"] = e
assert dryrun_lib.run_fl_round("minitron-4b", bits=2)["status"] == "ok"
""",
}


@pytest.mark.parametrize("use", sorted(_USES))
def test_slice_modules_run_without_jax_or_reference(use, tmp_path):
    """The checkpoint subpackage, the per-leaf and LoRA kernel wrappers,
    the EF uplink, the sparse wire, DP uplinks, the mixed-rank
    aggregators, the optimizers and schedules, the local-training
    engines, the async engine over a lazy fleet (with the sync server's
    deadline cohorts and FedBuff), the LM's serving, its launch entry
    points and the telemetry, the MLA and MoE archs with the tree
    algebra and the paper's ResNet configs, and the enc-dec model, the
    prefix-LM and the training entry point with its resume run, and the
    step builder, the dry run, the roofline counts, the int8 base and the
    quantized-serving driver, and the scale-out layer (meshes, the
    sharded cohort reduce, the multi-pod round, elastic restore and the
    round's dry run on the fake backend) (on the CPU) with jax and repro
    unimportable."""
    out = _run(_USE_WITHOUT_JAX.format(src=str(ROOT / "src"),
                                       body=_USES[use]), tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def test_port_sources_never_name_jax_or_reference():
    pat = ("import jax", "from jax", "import repro.", "from repro.",
           "import repro\n", "from repro ")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    for f in files:
        text = f.read_text()
        assert not any(p in text for p in pat), f


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the repo, the smoke script exits
    nonzero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("entry", ["resnet_init", "fl_server",
                                   "params_from_jax", "make_store",
                                   "cache_stage", "serving_engine",
                                   "groupnorm_init", "conv_lora_init",
                                   "dense_lora_init", "sparse_from_wire",
                                   "linear_init", "async_server",
                                   "streaming_accumulator", "lm_init",
                                   "generate", "launch_serve",
                                   "launch_lm_federated", "encdec_init",
                                   "launch_train", "build_cell",
                                   "serve_quantized", "make_client_mesh",
                                   "build_fl_round", "elastic_restore",
                                   "dequant_agg_rows_sharded",
                                   "launch_quickstart", "fl_experiment"])
def test_default_device_entry_points_raise_without_cuda(entry):
    _no_cuda()
    cfg = resnet.ResNetConfig(lora=LoRAConfig(rank=4, alpha=64.0))
    if entry in ("cache_stage", "serving_engine"):
        weights, store = serve.make_store(2, d_model=16, device="cpu")
        cache = serve.AdapterCache(1 << 20, store.qcfg)
        cache.put(0, store.msgs[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "make_store":
            serve.make_store(2, d_model=16)
        elif entry == "cache_stage":
            cache.stage([0])
        elif entry == "serving_engine":
            serve.AdapterServingEngine(weights, 0.5, store.qcfg, cache)
        elif entry == "resnet_init":
            resnet.init(0, cfg)
        elif entry == "params_from_jax":
            convert.params_from_jax({"w": np.zeros((2, 2), np.float32)})
        elif entry == "groupnorm_init":
            layers.groupnorm_init(8)
        elif entry == "conv_lora_init":
            lora.conv_lora_init(torch.Generator(), 3, 3, 4, 8, cfg.lora)
        elif entry == "dense_lora_init":
            lora.dense_lora_init(torch.Generator(), 4, 8, cfg.lora)
        elif entry == "linear_init":
            lora.linear_init(torch.Generator(), 4, 8, "lora", cfg.lora)
        elif entry == "lm_init":
            from repro_torch.configs import registry
            from repro_torch.models import lm
            lm.init(0, registry.get("gemma3-4b").smoke())
        elif entry == "generate":
            from repro_torch.configs import registry
            from repro_torch.models import lm
            cfg = registry.get("gemma3-4b").smoke()
            p = lm.init(0, cfg, device="cpu")
            serve.generate(p["frozen"], p["train"], cfg, [[1, 2]], 2)
        elif entry == "launch_serve":
            from repro_torch.launch import serve as launch_serve
            launch_serve.main(["--arch", "gemma3-4b", "--smoke"])
        elif entry == "launch_lm_federated":
            from repro_torch.launch import lm_federated
            lm_federated.main(["--rounds", "1"])
        elif entry == "encdec_init":
            from repro_torch.configs import registry
            from repro_torch.models import encdec
            encdec.init(0, registry.get("seamless-m4t-medium").smoke())
        elif entry == "launch_train":
            from repro_torch.launch import train
            train.main(["--arch", "paligemma-3b", "--smoke", "--steps",
                        "1"])
        elif entry == "build_cell":
            from repro_torch.configs import registry
            from repro_torch.launch import steps
            e = registry.get("gemma3-4b")
            steps.build_cell(e, "decode_32k", cfg_override=e.smoke())
        elif entry == "make_client_mesh":
            from repro_torch.launch.mesh import make_client_mesh
            make_client_mesh()
        elif entry == "build_fl_round":
            from repro_torch.configs import registry
            from repro_torch.launch.fl_round import build_fl_round
            build_fl_round(registry.get("minitron-4b"))
        elif entry == "elastic_restore":
            from repro_torch.fl.elastic import elastic_restore
            elastic_restore("no_such_dir", {"train": {}}, {"train": {}})
        elif entry == "dequant_agg_rows_sharded":
            kops.dequant_agg_rows_sharded(
                torch.zeros((2, 3, 4), dtype=torch.int32).view(torch.uint32),
                torch.ones((2, 3)), torch.zeros((2, 3)), [1.0, 1.0],
                [16, 16, 16], 8)
        elif entry == "serve_quantized":
            from repro_torch.launch import serve_quantized
            serve_quantized.main([])
        elif entry == "launch_quickstart":
            from repro_torch.launch import quickstart
            quickstart.main(["--rounds", "1"])
        elif entry == "fl_experiment":
            from repro_torch.launch.fl_experiment import fl_experiment
            fl_experiment(rounds=1, n_train=40, n_clients=2)
        elif entry == "streaming_accumulator":
            from repro_torch.core import flat
            from repro_torch.core.aggregation import \
                StreamingFlatAccumulator
            StreamingFlatAccumulator.for_layout(
                flat.layout_for({"w": torch.zeros(4, 8)}, 8))
        elif entry == "async_server":
            from repro_torch.fl import AsyncConfig, AsyncFLServer
            model = resnet.init(0, cfg, device="cpu")
            data = [{"x": np.zeros((4, 8, 8, 3), np.float32),
                     "y": np.zeros((4,), np.int32)}] * 2
            AsyncFLServer(model, lambda f, t, b: resnet.loss_fn(f, t, cfg, b),
                          data, AsyncConfig(), ClientConfig(),
                          FLoCoRAConfig(rank=4, quant_bits=8))
        elif entry == "sparse_from_wire":
            from repro_torch.core.sparse import SparseLeaf
            SparseLeaf.from_wire({"idx": np.zeros(1, np.uint32),
                                  "values": np.zeros(1, np.float32)},
                                 (2, 2), torch.float32, None)
        else:
            model = resnet.init(0, cfg, device="cpu")
            data = [{"x": np.zeros((4, 8, 8, 3), np.float32),
                     "y": np.zeros((4,), np.int32)}] * 2
            FLServer(model, lambda f, t, b: resnet.loss_fn(f, t, cfg, b),
                     data, ServerConfig(n_clients=2, clients_per_round=1),
                     ClientConfig(), FLoCoRAConfig(rank=4, quant_bits=8))


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros((2, 512), device="meta")
    with pytest.raises(ValueError):
        kops.quant_pack_rows(x, torch.tensor([1, 2], device="meta"), 8)
