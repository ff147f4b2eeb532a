"""The port's dry run (``repro_torch.launch.dryrun_lib``, the
``dryrun`` and ``perf_iter`` CLIs) on the CPU: ``_active_params`` equal
to the JAX package's for all 10 full configs (shapes only, nothing
traced), and the records, the skips, the JSON cache and both CLIs on the
smoke configs with the shapes cut (train 8 x 64, prefill 4 x 64, decode
8 x 128, long 1 x 256), traced on ``meta``."""
import dataclasses
import json

import pytest
import torch

from repro.configs import registry as JR
from repro.launch import dryrun_lib as JD
from repro_torch.configs import registry as TR
from repro_torch.launch import dryrun, dryrun_lib, perf_iter
from repro_torch.launch import steps as TS
from repro_torch.roofline import analysis
from repro_torch.roofline.op_cost import analyze_step
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

CUT = {"train_4k": {"seq": 64, "batch": 8, "step": "train"},
       "prefill_32k": {"seq": 64, "batch": 4, "step": "prefill"},
       "decode_32k": {"seq": 128, "batch": 8, "step": "decode"},
       "long_500k": {"seq": 256, "batch": 1, "step": "decode"}}


@pytest.mark.parametrize("arch", sorted(JR.REGISTRY))
def test_active_params_match_jax(arch):
    want = JD._active_params(JR.get(arch), JR.get(arch).full())
    assert dryrun_lib._active_params(TR.get(arch), TR.get(arch).full()) \
        == want


@pytest.fixture
def smoke(monkeypatch, tmp_path):
    """Every registry entry's full config is its smoke config, the
    shapes are cut, the records go to ``tmp_path``."""
    for a, e in list(TR.REGISTRY.items()):
        monkeypatch.setitem(TR.REGISTRY, a,
                            dataclasses.replace(e, full=e.smoke))
    for k, v in CUT.items():
        monkeypatch.setitem(TR.SHAPES, k, v)
    monkeypatch.setattr(dryrun_lib, "RESULTS_DIR", str(tmp_path))
    return tmp_path


def test_run_cell_record(smoke):
    rec = dryrun_lib.run_cell("gemma3-4b", "train_4k")
    assert rec["status"] == "ok", rec.get("traceback")
    assert (rec["chips"], rec["mesh"], rec["tag"], rec["step"]) == \
        (1, "h100x1", "baseline", "train")
    assert rec["plan"]["microbatch"] == 4 and rec["batch"] == 8
    e = TR.get("gemma3-4b")
    b = TS.build_cell(e, "train_4k", device="meta")
    cost = analyze_step(b["fn"], *b["args"])
    t = rec["roofline"]
    assert t["hlo_flops_per_chip"] == rec["hlo_flops_global"] == \
        cost["flops"]
    # no fusion-boundary count: the least and the eager bytes have keys
    # of their own
    assert t["hlo_bytes_per_chip"] is None
    assert t["eager_bytes_per_chip"] == cost["bytes"]
    assert t["min_bytes_per_chip"] == \
        cost["argument_bytes"] + cost["output_bytes"]
    assert t["t_compute_s"] == cost["flops"] / analysis.HW["peak_flops"]
    assert t["t_memory_s"] == \
        t["min_bytes_per_chip"] / analysis.HW["hbm_bw"]
    assert t["t_memory_eager_s"] == cost["bytes"] / analysis.HW["hbm_bw"]
    # a train step returns the new train tree, AdamW's state and the loss
    new_train, opt, metrics = cost["out"]
    assert cost["output_bytes"] == sum(
        x.untyped_storage().nbytes() for x in
        tree_leaves((new_train, opt, metrics)))
    assert rec["memory"] == {"argument_bytes": cost["argument_bytes"],
                             "output_bytes": cost["output_bytes"],
                             "peak_bytes": cost["peak_bytes"]}
    assert rec["fits_one_card"] is True
    total, active = dryrun_lib._active_params(e, e.smoke())
    assert (rec["params_total"], rec["params_active"]) == (total, active)
    assert rec["model_flops_global"] == 6.0 * active * 8 * 64
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["model_flops_global"] / cost["flops"])
    assert rec["trace_s"] >= 0
    saved = dryrun_lib.load_all()
    assert saved == [json.loads(json.dumps(rec, default=str))]


@pytest.mark.parametrize("arch,shape", [
    (c["arch"], c["shape"]) for c in JR.cells() if c["skip"]] + [
    ("mamba2-370m", "decode_32k"), ("zamba2-2.7b", "long_500k"),
    ("paligemma-3b", "prefill_32k"), ("deepseek-v2-236b", "decode_32k"),
    ("seamless-m4t-medium", "train_4k")])
def test_cell_traces_or_is_skipped(smoke, arch, shape):
    """The 7 full-attention archs' long_500k cells are skipped with the
    registry's reason; a cell of each family and step kind traces on
    meta (the sweep of all 40 at full size is the CLI's)."""
    r = dryrun_lib.run_cell(arch, shape, save=False)
    if shape == "long_500k" and not TR.get(arch).long_500k_ok:
        assert r["status"] == "skipped"
        assert r["skip_reason"] == TR.get(arch).skip_reason != ""
        return
    assert r["status"] == "ok", r.get("traceback")
    tokens = r["batch"] * (1 if r["step"] == "decode"
                           else CUT[shape]["seq"])
    assert r["model_flops_global"] == (
        6.0 if r["step"] == "train" else 2.0) * r["params_active"] * tokens
    assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0
    assert r["roofline"]["dominant"] in ("compute", "memory")


def test_least_bytes_leave_out_caches_written_in_place(smoke):
    """A decode step's caches are arguments written in place: its new
    output is the logits alone, and its least bytes are the arguments
    and the logits, far below its eager bytes."""
    b = TS.build_cell(TR.get("gemma3-4b"), "decode_32k", device="meta")
    cost = analyze_step(b["fn"], *b["args"])
    logits, caches = cost["out"]
    assert cost["output_bytes"] == logits.untyped_storage().nbytes() > 0
    args = {x.untyped_storage()._cdata for x in tree_leaves(b["args"])}
    assert all(x.untyped_storage()._cdata in args
               for x in tree_leaves(caches))
    assert cost["argument_bytes"] + cost["output_bytes"] < cost["bytes"]


def test_fits_one_card_is_the_peak_against_the_card(smoke, monkeypatch):
    rec = dryrun_lib.run_cell("seamless-m4t-medium", "prefill_32k",
                              save=False)
    monkeypatch.setitem(analysis.HW, "hbm_bytes",
                        rec["memory"]["peak_bytes"] - 1)
    small = dryrun_lib.run_cell("seamless-m4t-medium", "prefill_32k",
                                save=False)
    assert rec["fits_one_card"] and not small["fits_one_card"]


def test_int8_base_variant_shrinks_the_frozen_bytes(smoke):
    """perf_iter's ``int8_base`` on gemma3-4b decode: the frozen linears
    go from bf16 to int8 levels plus fp16 scales, the step's FLOPs do not
    change."""
    vs = perf_iter.variants_for("gemma3-4b", "decode_32k")
    base = dryrun_lib.run_cell("gemma3-4b", "decode_32k", save=False)
    q = dryrun_lib.run_cell("gemma3-4b", "decode_32k",
                            plan=vs["int8_base"], tag="int8_base")
    assert q["plan"]["quantize_base"] and q["status"] == "ok"
    assert q["hlo_flops_global"] == base["hlo_flops_global"]
    assert q["memory"]["argument_bytes"] < base["memory"]["argument_bytes"]
    assert [r["tag"] for r in dryrun_lib.load_all()] == ["int8_base"]


def test_dryrun_cli(smoke, capsys):
    assert dryrun.main(["--list"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 40
    assert dryrun.main(["--arch", "mamba2-370m", "--microbatch", "2",
                        "--tag", "m2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4
    assert all(line.startswith("[h100x1] mamba2-370m x ") and " ok " in
               line and "dominant=" in line for line in lines)
    recs = {r["shape"]: r for r in dryrun_lib.load_all()}
    assert recs["train_4k"]["plan"]["microbatch"] == 2
    assert dryrun.main(["--arch", "qwen1.5-110b", "--shape",
                        "long_500k"]) == 0
    assert "skipped (pure full attention)" in capsys.readouterr().out


def test_perf_iter_cli(smoke, capsys):
    assert perf_iter.main(["--cell", "deepseek-v2-236b:train_4k",
                           "--variant", "list"]) == 0
    names = capsys.readouterr().out.split()
    assert names[0] == "int8_base" and "cap1.0_int8" in names
    # deepseek-v2's train plan is sequence-parallel: its variant turns it
    # off, as the reference's
    assert [n for n in names if n.startswith("sp_")] == ["sp_off"]
    assert perf_iter.main(["--cell", "gemma3-4b:prefill_32k",
                           "--variant", "no_remat"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("gemma3-4b x prefill_32k [no_remat]: peak=")
    assert "tcoll=0.000e+00" in out
