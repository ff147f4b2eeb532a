"""Serving entry point: prefill + batched autoregressive decode of a decoder
LM with its FLoCoRA adapters beside the frozen base. The token loop is
``serve.generate()``; the weights are random, drawn from seed 0.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma3-4b --smoke --prompt-len 16 --gen 16 [--device cuda]

Runs on the card unless ``--device cpu`` is given; without a card the
default raises.
"""
import argparse

import numpy as np

from repro_torch.configs import registry
from repro_torch.models import lm as LM
from repro_torch.serve import generate
from repro_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    entry = registry.get(args.arch)
    if entry.kind != "lm":
        raise SystemExit("serve drives decoder LMs, as the JAX package's "
                         "does; the enc-dec model serves through "
                         "models/encdec.py (encode, cross_cache, "
                         "self_cache_init, decode_step)")
    cfg = entry.smoke() if args.smoke else entry.full()
    params = LM.init(0, cfg, device=dev)
    frozen, train = params["frozen"], params["train"]

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    toks, timing = generate(frozen, train, cfg, prompt, args.gen,
                            temperature=args.temperature, seed=0,
                            device=dev)
    print(f"prefill({args.prompt_len} tokens): "
          f"{timing['prefill_s']:.2f}s")
    dt = timing["decode_s"]
    print(f"decode: {timing['decode_steps']} steps in {dt:.2f}s "
          f"({timing['decode_steps'] * args.batch / max(dt, 1e-9):.1f} "
          f"tok/s)")
    for b in range(args.batch):
        print(f"  seq{b}: {toks[b].tolist()}")
    return {"tokens": toks, **timing}


if __name__ == "__main__":
    main()
