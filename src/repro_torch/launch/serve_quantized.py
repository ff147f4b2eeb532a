"""Serving with quantized FLoCoRA adapters: the driver of the JAX
package's ``examples/serve_quantized.py`` in the port.

The server ships int4 adapter messages to an edge node, which decodes
them and serves a decoder LM through ``serve.generate`` (one tenant: the
adapters beside the frozen base). Then the other deployment: one base
hosting many tenants' adapters, where merging is impossible. The
multi-tenant engine keeps every adapter in its packed wire form
(``serve.AdapterCache``) and serves a mixed-rank batch through the fused
gather + dequant + matmul kernel (``multi_lora_matmul_packed``), held to
the per-row merged ``oracle_step``. The store's flat messages are packed
by ``quant_pack_rows``.

    PYTHONPATH=src python -m repro_torch.launch.serve_quantized \\
        [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given; without a card the
default raises. The weights are random (seed 0); the example's adapters,
moved off their init by ``jax.random``, are moved here by a
``torch.Generator`` (other draws).
"""
from __future__ import annotations

import argparse
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import serve
from repro_torch.core import messages
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.models import lm as LM
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map

TENANTS = 8


def edge_cfg() -> LM.LMConfig:
    """The example's ``edge-lm``."""
    return LM.LMConfig(name="edge-lm", n_layers=4, d_model=128, n_heads=4,
                       n_kv_heads=2, head_dim=32, d_ff=512, vocab=512,
                       lora=LoRAConfig(rank=8, alpha=128.0),
                       head_mode="lora")


def trained_params(cfg: Any, device) -> dict:
    """Seed-0 parameters whose adapters are moved off their init (as if
    trained): 0.02 * N(0, 1) added to every trained leaf."""
    dev = resolve_device(device)
    p = LM.init(0, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    train = tree_map(lambda x: x + 0.02 * torch.randn(
        x.shape, generator=gen, device=dev, dtype=x.dtype), p["train"])
    return {"frozen": p["frozen"], "train": train}


def run(cfg: Any, device="cuda", params: Optional[dict] = None,
        log=print) -> dict:
    """The example's three steps at ``cfg``'s width. ``params``
    ({'frozen', 'train'}) defaults to ``trained_params(cfg, device)``.
    Returns the wire bytes (int4 and fp32), the decoded adapters, the
    generated tokens and timings, and the multi-tenant step against its
    oracle."""
    dev = resolve_device(device)
    if params is None:
        params = trained_params(cfg, dev)
    frozen, train = params["frozen"], params["train"]
    log = log or (lambda *a: None)

    # the wire: server -> edge, int4
    qcfg = QuantConfig(bits=4)
    wire_bytes = messages.message_wire_bytes(train, qcfg)
    fp_bytes = messages.message_wire_bytes(train, QuantConfig())
    log(f"adapter download: {wire_bytes / 1e3:.1f} KB int4 "
        f"(vs {fp_bytes / 1e3:.1f} KB fp32, {fp_bytes / wire_bytes:.1f}x)")
    train_edge = messages.roundtrip(train, qcfg)   # what the edge decodes

    # generate with the dequantized adapters (one tenant)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    toks, timing = serve.generate(frozen, train_edge, cfg, prompt, gen=9,
                                  max_seq=32, device=dev)
    log(f"generated: {toks.cpu().numpy().tolist()}")
    log(f"  prefill {timing['prefill_s']:.2f}s, {timing['decode_steps']} "
        f"decode steps {timing['decode_s']:.2f}s")

    # multi-tenant: many adapters, one base, no merging. A fleet of 8
    # clients uplinks rank-4 / rank-8 adapters for a 2-layer (d, d)
    # chain; the engine serves a mixed batch from the packed wire bytes
    weights, store = serve.make_store(n_clients=TENANTS,
                                      d_model=cfg.d_model, n_layers=2,
                                      ranks=(4, 8), bits=4, seed=0,
                                      device=dev)
    cache = serve.AdapterCache(capacity_bytes=1 << 20, qcfg=store.qcfg)
    engine = serve.AdapterServingEngine(weights, scale=0.5,
                                        qcfg=store.qcfg, cache=cache,
                                        fetch=store.fetch, device=dev)
    cids = list(range(TENANTS))              # even: rank 4, odd: rank 8
    engine.admit(cids)
    x = torch.from_numpy(rng.standard_normal((TENANTS, cfg.d_model)) * 0.5
                         ).to(device=dev, dtype=torch.float32)
    y = engine.step(x, cids)
    y_oracle = engine.oracle_step(x, cids)   # per-row merged dense
    err = float((y - y_oracle).abs().max())
    log(f"multi-tenant fused serving vs merged oracle ({TENANTS} tenants, "
        f"ranks 4+8): maxerr={err:.2e}")
    log(f"  cache: {cache.stats()}")
    return {"wire_bytes": wire_bytes, "fp_bytes": fp_bytes,
            "train_edge": train_edge, "prompt": prompt, "tokens": toks,
            "timing": timing, "x": x, "y": y, "y_oracle": y_oracle,
            "err": err, "cache": cache.stats(), "store": store}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(edge_cfg(), args.device)


if __name__ == "__main__":
    main()
