"""Paper-faithful ResNet-8 / ResNet-18 (CIFAR variants) with FLoCoRA.

The structure is the JAX package's (``repro/models/resnet.py``):
  * ResNet-8: 3x3 stem conv 3->64 + GN; one basic block per stage with
    widths (64, 128, 256), stride-2 + 1x1 downsample on stages 2/3; GAP;
    FC 256->10 (bias). Base params: 1,227,594.
  * ResNet-18: two basic blocks per stage, widths (64, 128, 256, 512).
FLoCoRA rules (Table I: 69,450 trained at r=8): the stem conv, the
GroupNorms and the final FC train densely; every other conv (1x1
downsamples included) carries a conv-LoRA adapter.

The parameter tree is the JAX package's at the public boundary: HWIO
kernels, ``a``/``b`` adapter names, a ``{"frozen", "train"}`` split, and
NHWC images into ``apply``. Inside ``apply`` activations run NCHW and
kernels are permuted to OIHW, so the trainable tree, and with it the
wire, is the reference's exactly. Convolutions pad as XLA's "SAME" does
(``core.lora.conv2d_nchw``) and run in full fp32
(``utils.device.fp32_precision``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.lora import LoRAConfig, conv2d_nchw, \
    conv_lora_apply_nchw, conv_lora_init, dense_lora_init
from repro_torch.models import layers as L
from repro_torch.utils.device import fp32_precision, resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    arch: str = "resnet8"            # 'resnet8' | 'resnet18'
    n_classes: int = 10
    gn_groups: int = 32
    lora: LoRAConfig = LoRAConfig(rank=32, alpha=512.0)
    mode: str = "flocora"            # 'fedavg' | 'flocora'
    stem_mode: str = "dense"         # 'dense' | 'lora'   (Table II ablation)
    fc_mode: str = "dense"           # 'dense' | 'lora' | 'frozen'
    norms_trained: bool = True

    @property
    def stages(self) -> tuple:
        if self.arch == "resnet8":
            return ((64, 1, 1), (128, 1, 2), (256, 1, 2))
        if self.arch == "resnet18":
            return ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))
        raise ValueError(self.arch)

    @property
    def final_width(self) -> int:
        return self.stages[-1][0]


def _conv_init(gen, kh, kw, cin, cout, mode, lora, device):
    fan = kh * kw * cin
    w = (torch.randn((kh, kw, cin, cout), generator=gen)
         * (2.0 / fan) ** 0.5).to(device)
    if mode == "dense":
        return {}, {"w": w}
    if mode == "frozen":
        return {"w": w}, {}
    return {"w": w}, conv_lora_init(gen, kh, kw, cin, cout, lora, device)


def _norm_init(c, trained, device):
    p = L.groupnorm_init(c, device)
    return ({}, p) if trained else (p, {})


def init(seed, cfg: ResNetConfig, device="cuda") -> dict:
    """Random frozen base + adapters -> {"frozen": ..., "train": ...}.
    ``seed`` is an int or a CPU ``torch.Generator``; the draws differ
    from ``jax.random``'s (``convert.params_from_jax`` carries a JAX
    tree across where the two must match)."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) \
        else torch.Generator().manual_seed(int(seed))
    lora = cfg.lora
    conv_mode = "dense" if cfg.mode == "fedavg" else "lora"
    stem_mode = "dense" if cfg.mode == "fedavg" else cfg.stem_mode
    fc_mode = "dense" if cfg.mode == "fedavg" else cfg.fc_mode
    norms_tr = True if cfg.mode == "fedavg" else cfg.norms_trained

    frozen: dict = {}
    train: dict = {}
    f, t = _conv_init(gen, 3, 3, 3, 64, stem_mode, lora, dev)
    nf, nt = _norm_init(64, norms_tr, dev)
    frozen["stem"] = {"conv": f, "norm": nf}
    train["stem"] = {"conv": t, "norm": nt}

    fb, tb = [], []
    cin = 64
    for width, n_blocks, stride in cfg.stages:
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            blk_f, blk_t = {}, {}
            for name, k_in in (("1", cin), ("2", width)):
                f, t = _conv_init(gen, 3, 3, k_in, width, conv_mode, lora,
                                  dev)
                nf, nt = _norm_init(width, norms_tr, dev)
                blk_f["conv" + name], blk_t["conv" + name] = f, t
                blk_f["norm" + name], blk_t["norm" + name] = nf, nt
            if s != 1 or cin != width:
                f, t = _conv_init(gen, 1, 1, cin, width, conv_mode, lora,
                                  dev)
                nf, nt = _norm_init(width, norms_tr, dev)
                blk_f["ds"], blk_t["ds"] = f, t
                blk_f["ds_norm"], blk_t["ds_norm"] = nf, nt
            fb.append(blk_f)
            tb.append(blk_t)
            cin = width
    frozen["blocks"] = fb
    train["blocks"] = tb

    w = (torch.randn((cfg.final_width, cfg.n_classes), generator=gen)
         * cfg.final_width ** -0.5).to(dev)
    bias = torch.zeros((cfg.n_classes,), dtype=torch.float32, device=dev)
    if fc_mode == "dense":
        frozen["fc"], train["fc"] = {}, {"w": w, "b": bias}
    elif fc_mode == "frozen":
        frozen["fc"], train["fc"] = {"w": w, "b": bias}, {}
    else:  # lora on FC (Table II "vanilla")
        frozen["fc"] = {"w": w, "b": bias}
        train["fc"] = dense_lora_init(gen, cfg.final_width, cfg.n_classes,
                                      lora, dev)
    return {"frozen": frozen, "train": train}


def _conv_apply(fz, tr, x, stride, lora_scale):
    w = tr["w"] if "w" in tr else fz["w"]
    y = conv2d_nchw(x, w, stride)
    if "b" in tr and "a" in tr:       # conv-LoRA side chain
        y = y + conv_lora_apply_nchw(x, tr["b"], tr["a"], lora_scale,
                                     stride)
    return y


def apply(frozen: dict, train: dict, cfg: ResNetConfig,
          x: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, 3) NHWC -> logits (N, n_classes)."""
    sc = cfg.lora.scale
    g = cfg.gn_groups

    def norm(fz, tr, h):
        return L.groupnorm_nchw(tr if tr else fz, h, groups=g)

    with fp32_precision():
        h = x.permute(0, 3, 1, 2)
        h = _conv_apply(frozen["stem"]["conv"], train["stem"]["conv"], h,
                        1, sc)
        h = F.relu(norm(frozen["stem"]["norm"], train["stem"]["norm"], h))
        bi = 0
        for width, n_blocks, stride in cfg.stages:
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                fz, tr = frozen["blocks"][bi], train["blocks"][bi]
                idn = h
                y = _conv_apply(fz["conv1"], tr["conv1"], h, s, sc)
                y = F.relu(norm(fz["norm1"], tr["norm1"], y))
                y = _conv_apply(fz["conv2"], tr["conv2"], y, 1, sc)
                y = norm(fz["norm2"], tr["norm2"], y)
                if "ds" in fz or "ds" in tr:
                    idn = _conv_apply(fz.get("ds", {}), tr.get("ds", {}),
                                      idn, s, sc)
                    idn = norm(fz.get("ds_norm", {}), tr.get("ds_norm", {}),
                               idn)
                h = F.relu(y + idn)
                bi += 1
        h = torch.mean(h, dim=(2, 3))                    # GAP
        fz, tr = frozen["fc"], train["fc"]
        if "w" in tr:
            return h @ tr["w"] + tr["b"]
        if "a" in tr:                                     # lora fc
            return h @ (fz["w"] + sc * (tr["a"] @ tr["b"])) + fz["b"]
        return h @ fz["w"] + fz["b"]


def loss_fn(frozen: dict, train: dict, cfg: ResNetConfig,
            batch: dict) -> tuple[torch.Tensor, dict]:
    logits = apply(frozen, train, cfg, batch["x"])
    labels = batch["y"].to(torch.int64)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None])[:, 0])
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, {"acc": acc}
