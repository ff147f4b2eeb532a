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
  split-KV cache's sequence over ``model``, as before the head split;
* a Mamba mixer's head block (``ssm_block``): its ``wz`` / ``wx`` /
  ``wo`` base products (``ssm._proj``) and its SSD's
  (``mamba_forward``, ``mamba_decode``) are the one-card step's divided
  by the rows over ``data`` and the heads over ``model`` (4), in train
  (on the whole sequence under ``seq_parallel`` too), prefill and
  decode steps; B, C and dt (``ssm._bc_dt``) and the chunks' C·B scores
  (one group, no head dim: every head block computes them, as the
  reference's ``ssm_heads`` rule leaves them) by the rows alone (2);
* the vocab over ``model``: the head's base product in the loss
  (``layers.chunked_xent``) and in the logits (``layers.head_logits``)
  is the one-card step's divided by the rows over ``data`` and the
  vocab over ``model`` (4) where the vocab splits, by the rows and the
  sequence block (4) under ``seq_parallel``, where the vocab stays
  whole, and by the rows alone (2) where ``model`` does not divide the
  vocab (509); these cells take ``xent_chunk`` 16, so that neither the
  sequence (64) nor its block (32) pads a loss chunk;
* on a (pod 2, data 2, model 2) mesh at world 8, a MoE prefill whose
  dispatch chunks (of 2 rows) span 2 of the 4 batch blocks: each rank
  dispatches only the chunk its block holds, so its bank products are
  the one-card step's over 8 (2 chunks, the experts over ``model``, the
  capacity rows over the chunk's 2 holders) and its all-to-all bytes
  half of those of the same step that dispatches every chunk on every
  batch block (the layout without a holders mesh).
"""
import contextlib
import dataclasses
import inspect

import pytest

from test_torch_steps_sharded import cut_shapes, fake_world
from repro_torch.configs import registry as TR
from repro_torch.launch import steps as TS
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.roofline.op_cost import analyze_step
from repro_torch.utils import comm

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


def _line_of(fn, text: str) -> str:
    """``rel:line`` of the line of ``fn`` that holds ``text``."""
    rel, span = _lines(fn)
    src = inspect.getsourcelines(fn)[0]
    return f"{rel}:{span[0] + next(i for i, x in enumerate(src) if text in x)}"


def _flops_at(rec: dict, line: str) -> int:
    """The FLOPs issued from ``line`` (by either of a site's lines)."""
    return sum(f for (_, site), f in rec["by_site"].items()
               if line in site.split(" < "))


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


# (arch, shape, microbatch, seq_parallel, vocab or None, the Mamba split,
#  the head's split in the loss or the logits)
SSM_VOCAB_CELLS = [
    ("mamba2-370m", "train_4k", 4, False, None, 4, 4),
    ("mamba2-370m", "train_4k", 2, True, None, 4, 4),
    ("mamba2-370m", "train_4k", 4, False, 509, 4, 2),
    ("mamba2-370m", "prefill_32k", 1, False, None, 4, 4),
    ("mamba2-370m", "decode_32k", 1, False, None, 4, 4),
    ("zamba2-2.7b", "train_4k", 4, False, None, 4, 4),
    ("minitron-4b", "train_4k", 4, False, None, None, 4),
    ("gemma3-4b", "decode_32k", 1, False, None, None, 4),
]


@pytest.fixture(scope="module")
def ssm_vocab_counts():
    out = []
    with _mesh() as mesh:
        for arch, shape, mb, sp, vocab, *_ in SSM_VOCAB_CELLS:
            e = TR.get(arch)
            cfg = dataclasses.replace(e.smoke(), xent_chunk=16,
                                      vocab=vocab or e.smoke().vocab)
            plan = TS.CellPlan(microbatch=mb, seq_parallel=sp)
            recs = []
            for m in (None, mesh):
                b = TS.build_cell(e, shape, m, plan=plan, cfg_override=cfg,
                                  device="meta")
                recs.append((analyze_step(b["fn"], *b["args"], sites=True),
                             b))
            out.append(recs)
    return out


@pytest.mark.parametrize("i", range(len(SSM_VOCAB_CELLS)))
def test_mamba_and_vocab_flops_per_chip(ssm_vocab_counts, i):
    arch, shape, mb, sp, vocab, mamba, head = SSM_VOCAB_CELLS[i]
    (one, _), (chip, built) = ssm_vocab_counts[i]
    if mamba is not None:
        # the chunks' C.B scores (a prefill's and a train step's)
        cb = _line_of(SSM.mamba_forward, '"bclgn,bcsgn->bcls"')
        for fns, sub in (([SSM._proj], False),
                         ([SSM.mamba_forward, SSM.mamba_decode], True)):
            f1 = _flops_in(one, fns) - sub * _flops_at(one, cb)
            fc = _flops_in(chip, fns) - sub * _flops_at(chip, cb)
            assert f1 > 0 and fc * mamba == f1, (fns, fc, f1)
        f1, fc = _flops_in(one, [SSM._bc_dt]), _flops_in(chip, [SSM._bc_dt])
        assert f1 > 0 and fc * 2 == f1, (fc, f1)
        assert _flops_at(chip, cb) * 2 == _flops_at(one, cb)
        assert built["ssm_axes"] == ("model",)
        assert built["split_log"]["ssm_heads"] == {(8, 0, 4)}
    else:
        assert built["ssm_axes"] == () and "ssm_heads" not in \
            built["split_log"]
    fns = [L.chunked_xent if built["step"] == "train" else L.head_logits]
    f1, fc = _flops_in(one, fns), _flops_in(chip, fns)
    assert f1 > 0 and fc * head == f1, (fc, f1)
    split = not sp and vocab is None
    assert built["vocab_axes"] == (("model",) if split else ())
    assert ("vocab" in built["split_log"]) == split


@pytest.fixture(scope="module")
def holder_counts():
    """deepseek-v2-236b's prefill at its smoke config with 2-row (128
    token) dispatch chunks, one card and on the world-8 mesh with and
    without the holders mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    e = TR.get("deepseek-v2-236b")
    cfg = e.smoke()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, max_chunk_tokens=128))
    out = {}
    with cut_shapes(), fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        for name, m in (("one", None), ("holders", mesh),
                        ("every block", mesh)):
            with contextlib.ExitStack() as stack:
                if name == "every block":
                    stack.enter_context(pytest.MonkeyPatch.context()).\
                        setattr(TS, "_holders", lambda *a: {})
                b = TS.build_cell(e, "prefill_32k", m, cfg_override=cfg,
                                  device="meta")
                log = stack.enter_context(comm.record_collectives())
                if m is not None:
                    stack.enter_context(comm.record_funcol(m))
                rec = analyze_step(b["fn"], *b["args"], sites=True)
            rec["a2a"] = sum(r["bytes"] for r in log
                             if r["kind"] == "all-to-all")
            out[name] = (rec, b)
    return out


def test_chunks_dispatched_only_by_their_holders(holder_counts):
    one, _ = holder_counts["one"]
    chip, built = holder_counts["holders"]
    every, built_e = holder_counts["every block"]
    f1 = _flops_in(one, [MOE._expert_ffn])
    assert f1 > 0 and _flops_in(chip, [MOE._expert_ffn]) * 8 == f1
    assert _flops_in(every, [MOE._expert_ffn]) * 4 == f1
    assert built["batch_axes"] == ("pod", "data")
    # rank 0 dispatches one chunk of the two, its capacity rows half
    assert {x[3] for x in built["split_log"]["experts"]} == {1}
    assert {x[3] for x in built_e["split_log"]["experts"]} == {2}
    (first, rows, cap), = built["split_log"]["capacity"]
    assert first == 0 and 2 * rows == cap
    assert chip["a2a"] > 0 and 2 * chip["a2a"] == every["a2a"]
