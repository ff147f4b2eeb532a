"""Repeated measurements on the card that one ``chip_smoke.py`` run
cannot give.

    python3 scripts/chip_repeats.py cohort N [--deterministic]
    python3 scripts/chip_repeats.py lm-decode

``cohort``: tests/test_torch_cuda.py's vmapped cohort engine against
``make_local_trainer`` (ResNet-8 r=8, K=3, 16x16 images), N times in one
process; each repetition prints the worst tree leaf's gap and the loss
gap, each as a share of the test's 1e-4 limit (above 1 fails), and the
leaves that differ bit for bit from the first repetition in either
engine. ``--deterministic`` runs cuDNN's deterministic algorithms.

``lm-decode``: ``chip_smoke.lm_full_phase`` once (gemma3-4b at its full
size) and its prefill and decode times, to set two trees side by side
in one call (parent, change, change, parent).

Run from the root of a checkout, on a machine with a CUDA device.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cohort(reps: int, deterministic: bool) -> None:
    import numpy as np
    import torch
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.fl import ClientConfig, make_cohort_trainer, \
        make_local_trainer
    from repro_torch.models import resnet
    from repro_torch.utils.tree import flatten_with_names, tree_map

    torch.backends.cudnn.deterministic = deterministic
    cuda = torch.device("cuda")
    cfg = resnet.ResNetConfig(arch="resnet8",
                              lora=LoRAConfig(rank=8, alpha=128.0))
    model = resnet.init(0, cfg, device=cuda)
    gen = torch.Generator().manual_seed(1)
    train0 = tree_map(lambda p: p + 0.05 * torch.randn(
        p.shape, generator=gen).to(cuda), model["train"])
    rng = np.random.default_rng(2)
    batches = {"x": torch.from_numpy(rng.normal(size=(3, 3, 8, 16, 16, 3))
                                     .astype(np.float32)).to(cuda),
               "y": torch.from_numpy(rng.integers(0, 10, (3, 3, 8))
                                     .astype(np.int32)).to(cuda)}
    n_steps = [3, 2]
    steps = torch.tensor(n_steps + [0], dtype=torch.int32, device=cuda)
    loss = lambda f, t, b: resnet.loss_fn(f, t, cfg, b)
    ccfg = ClientConfig(local_epochs=1, batch_size=8, lr=0.01)
    coh = make_cohort_trainer(loss, ccfg)
    local = make_local_trainer(loss, ccfg)
    first = None
    for rep in range(reps):
        trained, losses = coh(model["frozen"], train0, batches, steps)
        got = {f"{k}:{n}": t[k] for k in range(2)
               for n, t in flatten_with_names(trained)}
        want, worst, lworst = {}, (0.0, ""), 0.0
        for k, n in enumerate(n_steps):
            w, wl = local(model["frozen"], train0,
                          {key: v[k, :n] for key, v in batches.items()})
            lworst = max(lworst, abs(float(losses[k]) - float(wl))
                         / (1e-4 * abs(float(wl))))
            for name, t in flatten_with_names(w):
                want[f"{k}:{name}"] = t
                gap = float((got[f"{k}:{name}"] - t).abs().max()) \
                    / (1e-4 * float(t.abs().max()))
                worst = max(worst, (gap, f"{k}:{name}"))
        if first is None:
            first = (got, want)
        varied = sorted({n for n in got if not torch.equal(got[n],
                                                           first[0][n])}
                        | {n for n in want if not torch.equal(want[n],
                                                              first[1][n])})
        print(f"rep {rep}: worst leaf {worst[0]:.4g} ({worst[1]}), loss "
              f"{lworst:.4g}; differing from rep 0: {varied[:4]}")


def lm_decode() -> None:
    import torch
    import chip_smoke
    r = chip_smoke.lm_full_phase(torch.device("cuda"))
    print(f"gemma3-4b: prefill {1e3 * r['prefill_s']:.1f} ms warm, decode "
          f"{r['decode_ms']:.3f} ms a step warm / {r['decode_cold_ms']:.3f} "
          f"cold, 16-token prompt decode {r['short_decode_ms']:.3f} ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    c = sub.add_parser("cohort")
    c.add_argument("reps", type=int)
    c.add_argument("--deterministic", action="store_true")
    sub.add_parser("lm-decode")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_repeats: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    print(f"{chip_smoke._card_line()}; checkout {ROOT.name}")
    if args.what == "cohort":
        cohort(args.reps, args.deterministic)
    else:
        lm_decode()


if __name__ == "__main__":
    main()
