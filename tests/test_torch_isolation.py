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
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.fl import ClientConfig, FLServer, ServerConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import resnet
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
                                   "cache_stage", "serving_engine"])
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
