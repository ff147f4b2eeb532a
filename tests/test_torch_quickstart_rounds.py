"""Round 1 of ``launch.quickstart``'s ``run_uniform`` (here) and
``run_sparse`` (``test_torch_quickstart_sparse.py``) on the CPU, from
the JAX init, against the JAX package's ``FLServer`` on the example's
setup rebuilt from ``repro`` (ResNet-8 r = 32, 20 clients, the example's
configs): every record key, the byte keys equal and ``client_loss``
within rtol 1e-4 (``test_torch_mode_rounds._hold_records``).

Cut to fit the tier-1 run: 400 of the 2,000 images (``quickstart_data``
draws ``CUT`` times fewer, the same way) and a cohort of ``K`` = 2 of
the example's 5. The JAX package's local step costs ~23 s of one CPU
core a client here (XLA's 32x32 convolution gradients inside its
scanned local run), and its round at full size 125-180 s. The
builders' full-size data and configs are held to the example's in
``test_torch_quickstart.py``, and ``chip_smoke.py`` runs both modes at
full size on the card against the port's CPU replay."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.flocora import FLoCoRAConfig as JFLoCoRAConfig
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.sparse import SparsityConfig as JSparsityConfig
from repro.fl import ClientConfig as JClientConfig
from repro.fl import FLServer as JFLServer
from repro.fl import ServerConfig as JServerConfig
from repro.models import resnet as jresnet
from repro_torch import convert
from repro_torch.launch import quickstart
from test_torch_mode_rounds import _hold_records
from test_torch_quickstart import jax_data, jax_model

torch.set_num_threads(1)

CUT = 5
K = 2
FCFG = {"uniform": dict(quant_bits=8),
        "sparse": dict(quant_bits=4, error_feedback=True,
                       sparsity=JSparsityConfig(density=0.1))}


def hold_round1(mode: str, capsys, monkeypatch) -> None:
    """``run_uniform(1)`` or ``run_sparse(1, 0.1)`` against the JAX
    server's round 1 on the cut data."""
    real, server_cfg = quickstart.quickstart_data, quickstart.ServerConfig
    monkeypatch.setattr(quickstart, "quickstart_data",
                        lambda n, clients: real(n // CUT, clients))
    monkeypatch.setattr(quickstart, "ServerConfig", lambda **kw: server_cfg(
        **{**kw, "clients_per_round": K}))
    cfg = jresnet.ResNetConfig(arch="resnet8",
                               lora=JLoRAConfig(rank=32, alpha=512.0))
    model = jax_model(32, 512.0)
    js = JFLServer(jax.tree.map(jnp.asarray, model),
                   lambda f, t, b: jresnet.loss_fn(f, t, cfg, b),
                   jax_data(2000 // CUT, 20),
                   JServerConfig(rounds=1, n_clients=20,
                                 clients_per_round=K),
                   JClientConfig(local_epochs=1, batch_size=32, lr=0.01),
                   JFLoCoRAConfig(rank=32, alpha=512.0, **FCFG[mode]))
    want = js.run_round()
    ours = convert.params_from_jax(model, "cpu")
    if mode == "uniform":
        hist = quickstart.run_uniform(1, device="cpu", model=ours)
    else:
        hist = quickstart.run_sparse(1, 0.1, device="cpu", model=ours)
    assert len(hist) == 1 and hist[0]["n_agg"] == K
    _hold_records(want, hist[0])
    out = capsys.readouterr().out
    assert str(hist[0]["round"]) in out


@pytest.mark.parametrize("mode", ["uniform"])
def test_round1_matches_jax_server(mode, capsys, monkeypatch):
    hold_round1(mode, capsys, monkeypatch)
