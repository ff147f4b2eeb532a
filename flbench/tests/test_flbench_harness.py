"""The harness: found by name from data files, no card no result, and
nothing of the JAX package or JAX loaded or imported."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from flbench import bench, cells
from flbench.tests.tiny import TINY_LIMITS, tiny_cell

FLBENCH = cells.HERE
REPO = cells.ROOT
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__":
            out.add("__import__")
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in FLBENCH.rglob("*.py"):
        assert not _imports(path) & BANNED, path


def test_reference_imports_nothing_of_the_program():
    for path in (FLBENCH / "reference").rglob("*.py"):
        mods = _imports(path)
        assert mods <= {"__future__", "contextlib", "numpy", "torch",
                        "flbench"}, (path, mods)
        text = path.read_text()
        assert "repro_torch" not in text, path
        for line in text.splitlines():
            if line.startswith("from flbench"):
                assert line.startswith("from flbench.reference"), line


def test_no_file_outside_reads_the_jax_harness():
    for path in FLBENCH.rglob("*.py"):
        if path == Path(__file__).resolve():
            continue
        text = path.read_text()
        for name in ("benchmarks/", "src/repro/", "examples/"):
            assert name not in text, (path, name)


def test_cells_in_the_benchmark_are_found():
    for w in cells.benchmark()["workloads"]:
        cell = cells.load(w["name"])
        assert set(cell["limits"]) == set(bench.judge.NAMES)
        for m in cell["per_layer"]:
            assert callable(cells.reader(m["name"]))


def test_a_new_cell_is_data_only(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a metric added
    as new files under a copy of flbench/ are found by name, and the new
    cell runs, with no edit to any file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(FLBENCH, root / "flbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "flbench").rglob("*")
              if p.is_file()}
    bench_json = json.loads((REPO / "BENCHMARK.json").read_text())
    small = tiny_cell()
    (root / "flbench" / "configs" / "tiny8.json").write_text(
        json.dumps(small["config"]))
    (root / "flbench" / "workloads" / "two-clients.json").write_text(
        json.dumps(small["traffic"]))
    (root / "flbench" / "limits" / "tiny8-two.json").write_text(
        json.dumps({"limits": TINY_LIMITS}))
    (root / "flbench" / "metrics" / "rounds_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['window_rounds'])\n")
    bench_json["workloads"].append({"name": "tiny8-two", "config": "tiny8",
                                    "traffic": "two-clients", "chips": 1,
                                    "why": "test"})
    bench_json["per_layer"].append({"name": "rounds_seen", "unit": "n",
                                    "better": "higher",
                                    "source": "program_span",
                                    "layer": "engine", "moves": "round_s",
                                    "workloads": ["tiny8-two"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(root)!r}, {str(REPO / 'src')!r}]\n"
        "import torch\n"
        "torch.set_num_threads(4)\n"
        "from flbench import bench, cells\n"
        "cell = cells.load('tiny8-two')\n"
        "assert [m['name'] for m in cell['per_layer']][-1] == 'rounds_seen'\n"
        "assert cells.reader('rounds_seen')({'window_rounds': 3}) == 3.0\n"
        "res = bench.run_cell(cell, 1, 0.0, False, 'cpu')\n"
        "print(json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    for p, content in before.items():
        assert p.read_bytes() == content, p


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(FLBENCH / "run.py"), "--workload",
         "resnet8-flocora-k10", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env=env, cwd=REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_only_benchmark_files_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and flbench/ cannot
    run the port, and says so without a result."""
    shutil.copytree(FLBENCH, tmp_path / "flbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "flbench/run.py", "--workload",
         "resnet8-flocora-k10", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_are_named(monkeypatch):
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.fl", object())
    assert bench.forbidden_modules() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro.fl")
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert bench.forbidden_modules() == []


def test_metric_readers_leave_out_what_they_cannot_read():
    empty = {"spans": {}, "window_rounds": 1, "peaks": {},
             "slice_device": {"ops": 0, "wall_s": 1.0, "busy_s": 0.0,
                              "rounds": 2},
             "slice_host": {"by_span": {}, "rounds": 2},
             "active_client_steps": 0, "schedule_steps": 33, "batch": 32,
             "flops_per_image": 1.0, "b1_bytes": None, "b2_bytes": None,
             "packs_per_round": 10}
    for m in cells.benchmark()["per_layer"]:
        assert cells.reader(m["name"])(empty) is None, m["name"]
