"""Repeated measurements on the card that one ``chip_smoke.py`` run
cannot give.

    python3 scripts/chip_repeats.py cohort N [--deterministic]
    python3 scripts/chip_repeats.py lm-decode
    python3 scripts/chip_repeats.py ssm-noise
    python3 scripts/chip_repeats.py encdec-noise

``cohort``: tests/test_torch_cuda.py's vmapped cohort engine against
``make_local_trainer`` (ResNet-8 r=8, K=3, 16x16 images), N times in one
process; each repetition prints the worst tree leaf's gap and the loss
gap, each as a share of the test's 1e-4 limit (above 1 fails), and the
leaves that differ bit for bit from the first repetition in either
engine. ``--deterministic`` runs cuDNN's deterministic algorithms.

``lm-decode``: ``chip_smoke.lm_full_phase`` once (gemma3-4b at its full
size) and its prefill and decode times, to set two trees side by side
in one call (parent, change, change, parent).

``ssm-noise``: how far the Mamba-2 archs part from themselves under
another summation order, beside what ``chip_smoke.py`` phase 4d holds:
zamba2-2.7b's width at depth 6 (seed 1, adapters moved off init), each
layer's output card against CPU on one bf16 input (1 x 512), the logits
card against CPU, card against card (batch 1 against a row of batch 2)
and CPU against CPU (8 threads against 1); then the decode logits
against the teacher-forced forward (2 x 2,048 + 32, seed 0) at cut
depths of mamba2-370m (12, 24, 48) and zamba2-2.7b (18, 36, 54), the
whole run and steps 1, 15 and 31.

``encdec-noise``: the same for seamless-m4t-medium whole, beside what
``chip_smoke.py`` phase 4e holds (seed 1, adapters moved off init, 1 x
256 frames and 64 target tokens): each encoder layer's output card
against CPU on one bf16 input, then the encoder output and the
teacher-forced logits card against CPU, card against card (batch 1
against a row of batch 2) and CPU against CPU (8 threads against 1).

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


def ssm_noise() -> None:
    import dataclasses
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import registry
    from repro_torch.models import lm as LM
    from repro_torch.serve import generate
    from repro_torch.utils.tree import tree_to

    dev = torch.device("cuda")

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).abs().max() / b.abs().max())

    cfg = dataclasses.replace(registry.get("zamba2-2.7b").full(), n_layers=6)
    p = LM.init(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
    fz, tr = p["frozen"], cs._move_b(p["train"], 2, dev)
    fzc, trc = tree_to(fz, "cpu"), tree_to(tr, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 512)))
    x = torch.randn((1, 512, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3)).to(torch.bfloat16)
    pos = torch.arange(512)[None]

    def logits(f, t, tk):
        h, _ = LM.forward(f, t, cfg, tk)
        return LM._head_logits(f, t, cfg, h)

    with torch.no_grad():
        for (_, _, pi, spec, f, t), (*_, fc, tc) in zip(
                LM._layers(fz, tr, cfg), LM._layers(fzc, trc, cfg)):
            yg, _ = LM._apply_layer(cfg, spec, f, t, x.to(dev), pos.to(dev))
            yc, _ = LM._apply_layer(cfg, spec, fc, tc, x, pos)
            print(f"zamba2 depth 6 layer {pi} ({spec.mixer}): output card "
                  f"vs CPU {rel(yg - x.to(dev), yc - x):.4g} of its max")
        lg = logits(fz, tr, toks.to(dev))
        lg2 = logits(fz, tr, torch.cat([toks, toks.flip(1)]).to(dev))[:1]
        threads = torch.get_num_threads()
        lc = logits(fzc, trc, toks)
        torch.set_num_threads(1)
        lc1 = logits(fzc, trc, toks)
        torch.set_num_threads(threads)
    print(f"zamba2 depth 6 logits: card vs CPU {rel(lg, lc):.4g}; card "
          f"batch 1 vs a row of batch 2 {rel(lg2, lg):.4g}; CPU "
          f"{threads} threads vs 1 {rel(lc1, lc):.4g} (of max|logit|)")
    del p, fz, tr, fzc, trc
    cs._free_cuda()
    for arch, depths in (("mamba2-370m", (12, 24, 48)),
                         ("zamba2-2.7b", (18, 36, 54))):
        for d in depths:
            cfg = dataclasses.replace(registry.get(arch).full(), n_layers=d)
            p = LM.init(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
            fz, tr = p["frozen"], p["train"]
            prompt = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab, (2, 2048))).to(dev)
            out, _ = generate(fz, tr, cfg, prompt, 32, device=dev)
            got = cs._serve_logits(LM, fz, tr, cfg, prompt, out)
            with torch.no_grad():
                seq = torch.cat([prompt, out[:, :-1].to(prompt.dtype)], 1)
                h, _ = LM.forward(fz, tr, cfg, seq)
                fwd = LM._head_logits(fz, tr, cfg, h[:, 2047:])
            step = (got - fwd).abs().amax(dim=(0, 2)).cpu() \
                / float(fwd.abs().max())
            print(f"{arch} depth {d}: decode vs forward {rel(got, fwd):.4g} "
                  f"of max|logit|; steps 1 / 15 / 31: "
                  f"{float(step[1]):.4g} / {float(step[15]):.4g} / "
                  f"{float(step[31]):.4g}")
            del p, fz, tr, h
            cs._free_cuda()


def encdec_noise() -> None:
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import registry
    from repro_torch.core.lora import linear_apply
    from repro_torch.models import encdec as ED
    from repro_torch.utils.tree import tree_to

    dev = torch.device("cuda")

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).abs().max() / b.abs().max())

    cfg = registry.get("seamless-m4t-medium").full()
    p = ED.init(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
    fz, tr = p["frozen"], cs._move_b(p["train"], 2, dev)
    fzc, trc = tree_to(fz, "cpu"), tree_to(tr, "cpu")
    rng = np.random.default_rng(6)
    src = torch.from_numpy(rng.standard_normal(
        (2, 256, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    tgt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
    rope = ED._rope(cfg, torch.arange(256))
    x = src[:1]

    def run(f, t, s, tg):
        mem = ED.encode(f, t, cfg, s)
        h = ED.decode_train(f, t, cfg, tg, mem)
        return mem, linear_apply(f["head"], t["head"], h, cfg.lora.scale)

    with torch.no_grad():
        for i in range(cfg.n_enc_layers):
            f, t = ED._at(fz["enc"], i), ED._at(tr["enc"], i)
            fc, tc = ED._at(fzc["enc"], i), ED._at(trc["enc"], i)
            yg = ED._enc_layer(cfg, f, t, x.to(dev),
                               tuple(r.to(dev) for r in rope))
            yc = ED._enc_layer(cfg, fc, tc, x, rope)
            print(f"seamless encoder layer {i}: output card vs CPU "
                  f"{rel(yg - x.to(dev), yc - x):.4g} of its max")
        mg, lg = run(fz, tr, x.to(dev), tgt[:1].to(dev))
        mg2, lg2 = (t[:1] for t in run(fz, tr, src.to(dev), tgt.to(dev)))
        threads = torch.get_num_threads()
        mc, lc = run(fzc, trc, x, tgt[:1])
        torch.set_num_threads(1)
        mc1, lc1 = run(fzc, trc, x, tgt[:1])
        torch.set_num_threads(threads)
    for what, g, g2, c, c1 in (("encoder output", mg, mg2, mc, mc1),
                               ("logits", lg, lg2, lc, lc1)):
        print(f"seamless {what}: card vs CPU {rel(g, c):.4g}; card batch 1 "
              f"vs a row of batch 2 {rel(g2, g):.4g}; CPU {threads} threads "
              f"vs 1 {rel(c1, c):.4g} (of its max)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    c = sub.add_parser("cohort")
    c.add_argument("reps", type=int)
    c.add_argument("--deterministic", action="store_true")
    sub.add_parser("lm-decode")
    sub.add_parser("ssm-noise")
    sub.add_parser("encdec-noise")
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
    elif args.what == "ssm-noise":
        ssm_noise()
    elif args.what == "encdec-noise":
        encdec_noise()
    else:
        lm_decode()


if __name__ == "__main__":
    main()
