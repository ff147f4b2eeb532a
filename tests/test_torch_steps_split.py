"""The sharded LM step's split of the attention heads and the MoE experts
over ``model`` (``launch/spmd.py`` ``LocalStep.head_block`` /
``ExpertSplit``), counted per chip.

On torch's ``fake`` backend at world 4, a (2, 2) (data, model) mesh on
``meta`` (shapes only), at the smoke configs with the shapes of
tests/test_torch_steps_sharded.py, ``analyze_step(..., sites=True)``
counts each sharded step's FLOPs on rank 0 by the lines that issued
them, beside the one-card step's:

* the MoE banks' products (``moe._expert_ffn``) are the one-card step's
  divided by the ranks that the ``expert`` rule splits them over,
  exactly: ``model`` by experts, and ``data`` by capacity rows where a
  dispatch chunk spans the data ranks and they divide its capacity (4),
  else ``model`` alone (2: a batch-1 decode, every model rank holding
  the same token);
* the attention cores' products (q·k and p·v in
  ``layers.attention_chunked`` and ``local_attention_blocked``) are the
  one-card step's divided by the rows' split over ``data`` and the head
  split over ``model`` (4), where the heads split: a prefill (GQA with
  padded heads, MLA, sliding-window layers on the whole sequence under
  sequence parallelism) and a train step whose rows ``model`` does not
  split;
* a decode step splits no heads: its attention (``decode_attention``)
  is the one-card step's divided by the rows over ``data`` and the
  split-KV cache's sequence over ``model``, as before the head split.
"""
import contextlib
import inspect

import pytest

from test_torch_steps_sharded import cut_shapes, fake_world
from repro_torch.configs import registry as TR
from repro_torch.launch import steps as TS
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.roofline.op_cost import analyze_step

# (arch, shape, microbatch, seq_parallel, batch, bank split, attention
#  split, the attention cores of the cell)
CELLS = [
    ("deepseek-v2-236b", "train_4k", 2, False, None, 4, None, ()),
    ("deepseek-v2-236b", "train_4k", 2, True, None, 4, None, ()),
    ("deepseek-v2-236b", "train_4k", 4, False, None, 4, 4,
     ("attention_chunked",)),
    ("deepseek-v2-236b", "prefill_32k", 1, False, None, 4, 4,
     ("attention_chunked",)),
    ("deepseek-v2-236b", "decode_32k", 1, False, None, 4, None, ()),
    ("deepseek-v2-236b", "decode_32k", 1, False, 1, 2, None, ()),
    ("llama4-maverick-400b-a17b", "prefill_32k", 1, False, None, 4, 4,
     ("attention_chunked",)),
    ("minitron-4b", "prefill_32k", 1, False, None, None, 4,
     ("attention_chunked",)),
    ("minitron-4b", "train_4k", 4, False, None, None, 4,
     ("attention_chunked",)),
    ("gemma3-4b", "prefill_32k", 1, True, None, None, 4,
     ("attention_chunked", "local_attention_blocked")),
    ("gemma3-4b", "decode_32k", 1, False, None, None, 4,
     ("decode_attention",)),
    ("paligemma-3b", "prefill_32k", 1, False, None, None, 4,
     ("attention_chunked",)),
]


def _lines(fn) -> tuple[str, range]:
    src, first = inspect.getsourcelines(fn)
    path = inspect.getsourcefile(fn)
    rel = path[path.rfind("repro_torch/") + len("repro_torch/"):]
    return rel, range(first, first + len(src))


def _flops_in(rec: dict, fns) -> int:
    """The FLOPs issued from inside any of ``fns`` (by either of a
    site's two lines)."""
    spans = [_lines(f) for f in fns]
    total = 0
    for (_, site), f in rec["by_site"].items():
        for line in site.split(" < "):
            rel, _, no = line.rpartition(":")
            if any(rel == r and int(no) in span for r, span in spans):
                total += f
                break
    return total


@contextlib.contextmanager
def _mesh():
    from torch.distributed.device_mesh import init_device_mesh
    with cut_shapes(), fake_world(4):
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))


@pytest.fixture(scope="module")
def counts():
    out = []
    with _mesh() as mesh:
        for arch, shape, mb, sp, batch, *_ in CELLS:
            e = TR.get(arch)
            plan = TS.CellPlan(microbatch=mb, seq_parallel=sp)
            recs = []
            for m in (None, mesh):
                b = TS.build_cell(e, shape, m, plan=plan,
                                  cfg_override=e.smoke(), device="meta",
                                  batch=batch)
                recs.append((analyze_step(b["fn"], *b["args"], sites=True),
                             b))
            out.append(recs)
    return out


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_bank_and_attention_flops_per_chip(counts, i):
    arch, shape, mb, sp, batch, banks, attn, cores = CELLS[i]
    (one, _), (chip, built) = counts[i]
    assert 0 < chip["flops"] < one["flops"]
    if banks is not None:
        f1 = _flops_in(one, [MOE._expert_ffn])
        fc = _flops_in(chip, [MOE._expert_ffn])
        assert f1 > 0 and fc * banks == f1, (fc, f1)
        assert built["expert_axes"] == ("model",)
        blocks = built["split_log"]["experts"]
        assert {(e0, eb) for e0, eb, *_ in blocks} == {(0, 4)}
    else:
        assert built["expert_axes"] == ()
    if cores:
        fns = [getattr(L, c) for c in cores]
        f1, fc = _flops_in(one, fns), _flops_in(chip, fns)
        assert f1 > 0 and fc * attn == f1, (fc, f1)
    decode = built["step"] == "decode"
    assert built["head_axes"] == (() if decode or not cores else
                                  ("model",))
    assert ("heads" in built["split_log"]) == (not decode and bool(cores))
