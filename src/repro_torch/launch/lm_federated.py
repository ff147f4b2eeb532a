"""Federated FROM-SCRATCH training of a decoder LM with FLoCoRA: a frozen
random base, LoRA adapters and norms trained, an int8 adapter exchange
between clients. The loop of the JAX package's
``examples/train_lm_federated.py`` on the port's API: each round the
server's tree goes down quantized (``messages.roundtrip``), each client
takes ``local_steps`` SGD steps (momentum 0.9, lr 0.05) on Markov-chain
token batches, its tree comes back quantized, and ``fedavg`` weighs the
clients by their tokens.

    PYTHONPATH=src python -m repro_torch.launch.lm_federated \\
        [--rounds 4] [--local-steps 8] [--full] [--device cuda]

``--full`` is the ~110M-parameter config (12L x 768, vocab 32,768);
the default is the reduced ``lm-tiny``. Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import aggregation, messages
from repro_torch.core.flocora import FLoCoRAConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.data.synthetic import markov_lm_batch
from repro_torch.models import lm as LM
from repro_torch.optim import sgd
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_flatten, tree_size, tree_unflatten

LR = 0.05


def make_cfg(full: bool) -> LM.LMConfig:
    if full:   # ~110M params
        return LM.LMConfig(name="lm-110m", n_layers=12, d_model=768,
                           n_heads=12, n_kv_heads=4, head_dim=64,
                           d_ff=3072, vocab=32768,
                           lora=LoRAConfig(rank=16, alpha=256.0),
                           head_mode="lora")
    return LM.LMConfig(name="lm-tiny", n_layers=4, d_model=128, n_heads=4,
                       n_kv_heads=2, head_dim=32, d_ff=512, vocab=512,
                       lora=LoRAConfig(rank=8, alpha=128.0),
                       head_mode="lora")


def make_local_train(frozen: dict, cfg: LM.LMConfig) -> Callable:
    """``local_train(train0, tokens) -> (trained, per-step losses)``:
    one SGD step (momentum 0.9, ``LR``) per batch of ``tokens`` (steps,
    B, S+1), from a fresh optimizer state, as the example's scanned
    ``local_train``."""
    opt = sgd(momentum=0.9)

    def local_train(train0: Any, tokens) -> tuple[Any, torch.Tensor]:
        tr, st, losses = train0, opt.init(train0), []
        for batch in tokens:
            leaves, treedef = tree_flatten(tr)
            leaves = [t.detach().requires_grad_(True) for t in leaves]
            loss, _ = LM.loss_fn(frozen, tree_unflatten(treedef, leaves),
                                 cfg, {"tokens": batch})
            grads = torch.autograd.grad(loss, leaves)
            tr, st = opt.update(tree_unflatten(treedef, list(grads)), st,
                                tree_unflatten(treedef, [t.detach()
                                                         for t in leaves]),
                                LR)
            losses.append(loss.detach())
        return tr, torch.stack(losses)

    return local_train


def client_tokens(rng: np.random.Generator, cfg: LM.LMConfig, client: int,
                  local_steps: int, batch: int, seq: int) -> np.ndarray:
    """(local_steps, batch, seq+1) tokens of ``client``'s Markov chain,
    drawn from the run's ``rng`` exactly as the example draws them."""
    return np.stack([markov_lm_batch(rng, cfg.vocab, batch, seq,
                                     seed=client)["tokens"]
                     for _ in range(local_steps)])


def run(frozen: dict, train: dict, cfg: LM.LMConfig, rounds: int,
        clients: int, local_steps: int, batch: int, seq: int,
        log: Optional[Callable[[str], None]] = print) -> dict:
    """The federated loop from ``(frozen, train)`` on their device.
    Returns {'train': the final global tree, 'msg_bytes': the static
    int8 message size, 'rounds': [{'round', 'mean_loss',
    'client_losses' (clients x local_steps), 'wall_s'}]}."""
    fcfg = FLoCoRAConfig(rank=cfg.lora.rank, alpha=cfg.lora.alpha,
                         quant_bits=8)
    dev = LM.param_device(frozen)
    msg = messages.message_wire_bytes(train, fcfg.qcfg)
    local_train = make_local_train(frozen, cfg)
    rng = np.random.default_rng(0)
    gtrain, history = train, []
    for rnd in range(rounds):
        t0 = time.perf_counter()
        g_bcast = messages.roundtrip(gtrain, fcfg.qcfg)   # server -> client
        client_trees, losses, sizes = [], [], []
        for c in range(clients):
            toks = torch.from_numpy(client_tokens(rng, cfg, c, local_steps,
                                                  batch, seq)).to(dev)
            trained, step_losses = local_train(g_bcast, toks)
            client_trees.append(messages.roundtrip(trained, fcfg.qcfg))
            losses.append(step_losses)
            sizes.append(local_steps * batch * seq)
        gtrain = aggregation.fedavg(aggregation.stack_trees(client_trees),
                                    np.asarray(sizes, np.float32))
        client_losses = torch.stack(losses).cpu().numpy()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec = {"round": rnd + 1,
               "mean_loss": float(client_losses.mean(axis=1).mean()),
               "client_losses": client_losses,
               "wall_s": time.perf_counter() - t0}
        history.append(rec)
        if log is not None:
            log(f"round {rnd + 1}: mean client loss = "
                f"{rec['mean_loss']:.4f} (cumulative TCC "
                f"{2 * (rnd + 1) * msg / 1e6:.2f} MB/client) in "
                f"{rec['wall_s']:.3f} s")
    return {"train": gtrain, "msg_bytes": msg, "rounds": history}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = make_cfg(args.full)
    params = LM.init(0, cfg, device=dev)
    frozen, train = params["frozen"], params["train"]
    n_total = tree_size(frozen) + tree_size(train)
    n_train = tree_size(train)
    msg = messages.message_wire_bytes(
        train, FLoCoRAConfig(quant_bits=8).qcfg)
    print(f"params: total={n_total / 1e6:.1f}M trainable="
          f"{n_train / 1e6:.2f}M ({100 * n_train / n_total:.1f}%)")
    print(f"round message: {msg / 1e6:.2f} MB vs full-model "
          f"{n_total * 4 / 1e6:.1f} MB -> {n_total * 4 / msg:.1f}x "
          "reduction")
    return run(frozen, train, cfg, args.rounds, args.clients,
               args.local_steps, args.batch, args.seq)


if __name__ == "__main__":
    main()
