"""Plain ResNet-8 / ResNet-18 (the CIFAR variants) with conv-LoRA, as the
FLoCoRA paper (arXiv:2406.14082) describes them.

* ResNet-8: a 3x3 stem conv (3 -> 64) with GroupNorm, one basic block a
  stage at widths (64, 128, 256), the later stages at stride 2 with a
  1x1 downsample, global average pooling, a 256 -> 10 classifier.
  ResNet-18: two basic blocks a stage at widths (64, 128, 256, 512).
* FLoCoRA: the stem conv, the GroupNorms and the classifier train
  densely; every other conv is frozen and carries a conv-LoRA adapter
  (Huh et al.): ``b`` (kh, kw, c_in, r), then a 1x1 ``a`` (1, 1, r,
  c_out), added as (alpha / r) * conv1x1(conv(x, b), a), the stride on
  ``b``. FedAvg trains every parameter and has no adapter.

Parameters are a ``{"frozen": tree, "train": tree}`` pair of nested
dicts in the paper's reference layout: HWIO kernels, ``b``/``a``
adapters, GroupNorm ``scale``/``bias``, a ``blocks`` list, and every
module present in both trees (empty where it holds nothing). Images are
NHWC. Convolutions pad as XLA's "SAME" does: the smaller half of the
padding first. Everything runs in fp32 with TF32 off; ``precision``
switches the card's products to TF32 for the control.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

GN_EPS = 1e-5


def stages(cfg: dict) -> list[tuple[int, int, int]]:
    """(width, blocks, stride) of each stage."""
    return list(zip(cfg["widths"], cfg["blocks_per_stage"], cfg["strides"]))


def lora_scale(cfg: dict) -> float:
    return float(cfg["lora_alpha"]) / float(cfg["lora_rank"])


def param_specs(cfg: dict, mode: str) -> list[tuple]:
    """Every leaf as (side, path, shape, init, std): ``side`` "frozen" or
    "train", ``init`` "normal", "zeros" or "ones" (``std`` for
    "normal"), in the order the modules appear."""
    if mode not in ("flocora", "fedavg"):
        raise ValueError(f"mode must be 'flocora' or 'fedavg': {mode!r}")
    lora = mode == "flocora"
    r = int(cfg["lora_rank"])
    out = []

    def conv(path, kh, cin, cout, kind):
        fan = kh * kh * cin
        if kind == "dense":
            out.append(("train", path + ("w",), (kh, kh, cin, cout),
                        "normal", (2.0 / fan) ** 0.5))
        else:
            out.append(("frozen", path + ("w",), (kh, kh, cin, cout),
                        "normal", (2.0 / fan) ** 0.5))
            out.append(("train", path + ("b",), (kh, kh, cin, r), "normal",
                        (2.0 / fan) ** 0.5))
            out.append(("train", path + ("a",), (1, 1, r, cout), "zeros",
                        0.0))

    def norm(path, c):
        side = "train" if (not lora or cfg["norms_trained"]) else "frozen"
        out.append((side, path + ("scale",), (c,), "ones", 0.0))
        out.append((side, path + ("bias",), (c,), "zeros", 0.0))

    stem_kind = "dense" if not lora else cfg["stem_mode"]
    conv(("stem", "conv"), 3, cfg["in_channels"], cfg["widths"][0],
         stem_kind)
    norm(("stem", "norm"), cfg["widths"][0])
    kind = "lora" if lora else "dense"
    cin, bi = cfg["widths"][0], 0
    for width, n_blocks, stride in stages(cfg):
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            p = ("blocks", bi)
            conv(p + ("conv1",), 3, cin, width, kind)
            norm(p + ("norm1",), width)
            conv(p + ("conv2",), 3, width, width, kind)
            norm(p + ("norm2",), width)
            if s != 1 or cin != width:
                conv(p + ("ds",), 1, cin, width, kind)
                norm(p + ("ds_norm",), width)
            cin, bi = width, bi + 1
    if lora and cfg["fc_mode"] != "dense":
        raise ValueError("only a dense classifier is described here")
    out.append(("train", ("fc", "w"), (cin, cfg["n_classes"]), "normal",
                cin ** -0.5))
    out.append(("train", ("fc", "b"), (cfg["n_classes"],), "zeros", 0.0))
    return out


def skeleton(cfg: dict) -> dict:
    """One tree with every module as an empty dict."""
    blocks = []
    cin = cfg["widths"][0]
    for width, n_blocks, stride in stages(cfg):
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            blk = {"conv1": {}, "norm1": {}, "conv2": {}, "norm2": {}}
            if s != 1 or cin != width:
                blk.update(ds={}, ds_norm={})
            blocks.append(blk)
            cin = width
    return {"stem": {"conv": {}, "norm": {}}, "blocks": blocks, "fc": {}}


def put(tree: dict, path: tuple, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def leaf_paths(tree, prefix: tuple = ()) -> list[tuple]:
    """Paths of every leaf, dict keys sorted and lists walked in order:
    the order in which the paper's reference code flattens a tree."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                            prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, prefix + (i,))]
    return [prefix]


def path_name(path: tuple) -> str:
    return "/".join(str(k) for k in path)


@contextlib.contextmanager
def precision(kind: str):
    """"fp32": full fp32 products (TF32 off); "tf32": the card's TF32
    products, which round each operand to a 10-bit mantissa; "fp64":
    TF32 off, for a model run in float64."""
    if kind not in ("fp32", "tf32", "fp64"):
        raise ValueError(f"precision must be 'fp32', 'tf32' or 'fp64': "
                         f"{kind!r}")
    on = kind == "tf32"
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest value with a 10-bit mantissa (ties away from
    zero), what a TF32 product reads."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Operand(torch.autograd.Function):
    """An operand of a TF32 product: rounded going forward; its gradient,
    the fp32 result of a product, passes back as it is."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _TF32Result(torch.autograd.Function):
    """The result of a TF32 product (fp32 accumulation): unchanged going
    forward; the gradient that enters the product's backward, one of its
    operands there, rounded."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Model:
    """The forward pass and the loss of one configuration. ``emulate_tf32``
    rounds the operands of every convolution and product to TF32, going
    forward and back: the CPU's stand-in for the card's TF32 mode, which
    the CPU does not have."""

    def __init__(self, cfg: dict, emulate_tf32: bool = False):
        self.cfg = cfg
        self.scale = lora_scale(cfg)
        self.groups = int(cfg["gn_groups"])
        self.emulate = emulate_tf32

    def _op(self, t: torch.Tensor) -> torch.Tensor:
        return _TF32Operand.apply(t) if self.emulate else t

    def _res(self, t: torch.Tensor) -> torch.Tensor:
        return _TF32Result.apply(t) if self.emulate else t

    def conv(self, x: torch.Tensor, w: torch.Tensor, stride: int):
        kh, kw = int(w.shape[0]), int(w.shape[1])
        ph = _same_pads(int(x.shape[2]), kh, stride)
        pw = _same_pads(int(x.shape[3]), kw, stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return self._res(F.conv2d(self._op(x),
                                  self._op(w.permute(3, 2, 0, 1)),
                                  stride=stride))

    def conv_unit(self, fz: dict, tr: dict, x, stride: int):
        y = self.conv(x, tr["w"] if "w" in tr else fz["w"], stride)
        if "a" in tr:
            y = y + self.scale * self.conv(self.conv(x, tr["b"], stride),
                                           tr["a"], 1)
        return y

    def norm(self, fz: dict, tr: dict, x):
        p = tr if tr else fz
        g = min(self.groups, int(x.shape[1]))
        return F.group_norm(x, g, p["scale"], p["bias"], GN_EPS)

    def apply(self, frozen: dict, train: dict, x: torch.Tensor):
        """x (N, H, W, C) -> logits (N, classes)."""
        h = x.permute(0, 3, 1, 2)
        h = self.conv_unit(frozen["stem"]["conv"], train["stem"]["conv"],
                           h, 1)
        h = F.relu(self.norm(frozen["stem"]["norm"], train["stem"]["norm"],
                             h))
        bi = 0
        for width, n_blocks, stride in stages(self.cfg):
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                fz, tr = frozen["blocks"][bi], train["blocks"][bi]
                y = self.conv_unit(fz["conv1"], tr["conv1"], h, s)
                y = F.relu(self.norm(fz["norm1"], tr["norm1"], y))
                y = self.conv_unit(fz["conv2"], tr["conv2"], y, 1)
                y = self.norm(fz["norm2"], tr["norm2"], y)
                if "ds" in fz:
                    idn = self.conv_unit(fz["ds"], tr["ds"], h, s)
                    idn = self.norm(fz["ds_norm"], tr["ds_norm"], idn)
                else:
                    idn = h
                h = F.relu(y + idn)
                bi += 1
        h = torch.mean(h, dim=(2, 3))
        fc = train["fc"] if "w" in train["fc"] else frozen["fc"]
        return self._res(self._op(h) @ self._op(fc["w"])) + fc["b"]

    def loss(self, frozen: dict, train: dict, x, y) -> torch.Tensor:
        return F.cross_entropy(self.apply(frozen, train, x), y.long())
