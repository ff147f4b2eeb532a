"""``launch.quickstart`` against the JAX package's
``examples/quickstart.py``, whose setup is rebuilt here from ``repro``'s
own modules: each mode's builder at the example's full size gives the
example's data bit for bit, and the bytes it prints (FedAvg against
FLoCoRA + int8, the rank tiers, the sparse uplink's fp32 / int4 / int4 +
top-k) equal ``repro.core.messages.message_wire_bytes`` and
``repro.core.flocora.client_wire_bytes``. ``main`` runs the
mixed-rank, DP and async modes on the CPU to a finite history. Round 1
of ``run_uniform`` and ``run_sparse`` against the JAX server, cut in
size, is in ``test_torch_quickstart_rounds.py`` and ``_sparse.py``."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import flocora as jflocora
from repro.core import messages as jmessages
from repro.core.flocora import FLoCoRAConfig as JFLoCoRAConfig
from repro.core.flocora import RankSchedule as JRankSchedule
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.quant import QuantConfig as JQuantConfig
from repro.data import SyntheticVision as JSyntheticVision
from repro.data import lda_partition as jlda_partition
from repro.models import resnet as jresnet
from repro_torch.launch import quickstart

torch.set_num_threads(1)

# mode -> (images, clients, server rank, alpha)
FLEETS = {"uniform": (2000, 20, 32, 512.0), "hetero": (1000, 10, 16, 256.0),
          "async": (1000, 12, 16, 256.0), "sparse": (2000, 20, 32, 512.0)}
BUILDERS = {"uniform": quickstart.uniform_setup,
            "hetero": quickstart.hetero_setup,
            "async": quickstart.async_setup,
            "sparse": quickstart.sparse_setup}


def jax_data(n_images: int, n_clients: int) -> list[dict]:
    """The example's data, as each of its modes draws it."""
    rng = np.random.default_rng(0)
    sv = JSyntheticVision(seed=0)
    y = rng.integers(0, 10, n_images)
    x = sv.sample(rng, y)
    parts = jlda_partition(y, n_clients, alpha=0.5)
    return [{"x": x[p], "y": y[p].astype(np.int32)} for p in parts]


def jax_model(rank: int, alpha: float, mode: str = "flocora",
              shapes: bool = False):
    """The JAX example's init (``shapes``: its shapes only)."""
    cfg = jresnet.ResNetConfig(arch="resnet8", mode=mode,
                               lora=JLoRAConfig(rank=rank, alpha=alpha))
    if shapes:
        return jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0),
                                                   cfg))
    init = jax.jit(lambda key: jresnet.init(key, cfg))
    return jax.device_get(init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mode", list(FLEETS))
def test_builder_data_and_configs(mode):
    n, clients, rank, alpha = FLEETS[mode]
    setup = BUILDERS[mode]()
    want = jax_data(n, clients)
    assert len(setup.data) == len(want) == clients
    for got, ref in zip(setup.data, want):
        assert got["x"].dtype == ref["x"].dtype == np.float32
        np.testing.assert_array_equal(got["x"], ref["x"])
        np.testing.assert_array_equal(got["y"], ref["y"])
        assert got["y"].dtype == np.int32
    assert (setup.cfg.arch, setup.cfg.lora.rank, setup.cfg.lora.alpha) == \
        ("resnet8", rank, alpha)
    assert (setup.fcfg.rank, setup.fcfg.alpha) == (rank, alpha)
    assert (setup.ccfg.local_epochs, setup.ccfg.batch_size,
            setup.ccfg.lr) == (1, 32, 0.01)
    if mode in ("hetero", "async"):
        assert setup.fcfg.rank_schedule.client_ranks == \
            JRankSchedule.tiered((4, 8, 16), clients).client_ranks
    if mode == "async":
        assert setup.acfg.total_arrivals == 90
        assert setup.acfg.buffer_size == 6
    else:
        assert setup.scfg.n_clients == clients
        assert setup.scfg.clients_per_round == (6 if mode == "hetero"
                                                else 5)


def test_uniform_bytes_and_printed_line(capsys):
    train = jax_model(32, 512.0, shapes=True)["train"]
    fedavg = jmessages.message_wire_bytes(
        jax_model(32, 512.0, "fedavg", shapes=True)["train"],
        JQuantConfig())
    flocora = jmessages.message_wire_bytes(train, JQuantConfig(bits=8))
    setup = quickstart.uniform_setup()
    assert quickstart.uniform_bytes(setup.init("cpu")["train"]) == \
        (fedavg, flocora)
    assert quickstart.main(["--rounds", "0", "--device", "cpu"]) == []
    line = capsys.readouterr().out.splitlines()[0]
    assert line == (f"message: FedAvg {fedavg/1e6:.2f} MB -> FLoCoRA+int8 "
                    f"{flocora/1e6:.3f} MB "
                    f"({fedavg/flocora:.1f}x smaller)")


@pytest.mark.parametrize("mode", ["hetero", "async"])
def test_tier_bytes(mode):
    n, clients, rank, alpha = FLEETS[mode]
    setup = BUILDERS[mode]()
    jfcfg = JFLoCoRAConfig(rank=rank, alpha=alpha, quant_bits=8,
                           rank_schedule=JRankSchedule.tiered((4, 8, 16),
                                                              clients))
    train = jax_model(rank, alpha)["train"]
    want = {r: jflocora.client_wire_bytes(train, jfcfg, r)
            for r in (4, 8, 16)}
    assert quickstart.tier_bytes(setup.init("cpu")["train"],
                                 setup.fcfg) == want
    assert want == {4: 57_400, 8: 88_888, 16: 151_864}


def test_sparse_bytes():
    train = jax_model(32, 512.0, shapes=True)["train"]
    want = (jmessages.message_wire_bytes(train, JQuantConfig()),
            jmessages.message_wire_bytes(train, JQuantConfig(bits=4)),
            jmessages.message_wire_bytes(train, JQuantConfig(bits=4), 0.1))
    setup = quickstart.sparse_setup()
    assert quickstart.sparse_bytes(setup.init("cpu")["train"], 0.1) == want
    assert want[1:] == (150_744, 55_419)


def run_main(argv, capsys, monkeypatch) -> list:
    """``main(argv + ["--device", "cpu"])`` on a fifth of the mode's
    images (``quickstart_data`` draws 5 times fewer, the same way: the
    tier-1 run's CPU time; ``chip_smoke.py`` runs every mode at full
    size): a finite history, and the mode's own checks."""
    real = quickstart.quickstart_data
    monkeypatch.setattr(quickstart, "quickstart_data",
                        lambda n, clients: real(n // 5, clients))
    hist = quickstart.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert hist and all(math.isfinite(h["client_loss"]) for h in hist)
    if "--hetero" in argv or "--async" in argv:
        assert "tier r=16" in out
    if "--hetero" in argv:
        assert len(hist) == 1 and hist[0]["n_agg"] == 6
    if "--dp" in argv:
        assert "dp: clip L2 to 1.0" in out
        assert hist[-1]["dp_epsilon"] > 0
        assert hist[-1]["up_bytes_measured"] == 277_816
    if "--async" in argv:
        assert hist[-1]["n_arrived"] == 6 and len(hist) == 2
    return hist


@pytest.mark.parametrize("argv", [["--hetero", "--rounds", "1"],
                                  ["--dp", "--rounds", "1"],
                                  ["--async", "--arrivals", "6",
                                   "--buffer", "3"]])
def test_main_runs_modes_on_cpu(argv, capsys, monkeypatch):
    run_main(argv, capsys, monkeypatch)
