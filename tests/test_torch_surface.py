"""The port's surface covers the JAX package's: every public top-level
name of a ``src/repro/`` module (function, class, module-level name, and
each public method of a class) has its counterpart, under the same name,
in the same module of ``src/repro_torch/``, and every ``examples/*.py``
has an entry point in ``repro_torch.launch``. Read from the sources'
ASTs; nothing is imported.

Exempt is only what belongs to JAX: the pytree hooks, the aliases of JAX
types, the Pallas kernel modules and the HLO cost reader (``EXEMPT``)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

# reference module -> (its counterpart in the port or None, why)
EXEMPT = {
    "kernels/quant_pack.py": (None, "a Pallas kernel module: its kernel is "
                              "csrc/quant_pack.cu behind kernels/ops.py"),
    "kernels/dequant_agg.py": (None, "Pallas kernel modules: theirs are "
                               "csrc/dequant_agg.cu behind kernels/ops.py"),
    "kernels/lora_matmul.py": (None, "Pallas kernel modules: csrc/"
                               "lora_matmul.cu and multi_lora_matmul.cu "
                               "behind kernels/ops.py"),
    "roofline/hlo_cost.py": ("roofline/op_cost.py", "reads the costs of "
                             "XLA's compiled HLO; the port counts the "
                             "step's aten ops instead"),
}
# methods by which JAX flattens and rebuilds a registered pytree node
PYTREE_HOOKS = {"tree_flatten", "tree_unflatten"}
# examples/<name>.py -> repro_torch/launch/<module>.py where they differ
EXAMPLES = {"train_lm_federated": "lm_federated"}


def _is_jax_alias(value) -> bool:
    """``Array = jax.Array`` and the like: a name bound to a JAX type."""
    while isinstance(value, ast.Attribute):
        value = value.value
    return isinstance(value, ast.Name) and value.id in ("jax", "jnp")


def public_names(path: Path, port: bool = False) -> set:
    """Public top-level names of ``path``: functions, classes and their
    public methods (``Class.method``), assigned names; in the port also
    the names it imports (a counterpart may live elsewhere)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out |= {f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    and (port or m.name not in PYTREE_HOOKS)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)) and (
                port or node.value is None
                or not _is_jax_alias(node.value)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif port and isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.split(".")[-1].startswith("_")}


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_MODULES)
def test_module_has_its_counterpart(rel):
    if rel in EXEMPT:
        other, why = EXEMPT[rel]
        assert why
        if other is not None:
            assert (PORT / other).is_file(), other
        return
    port = PORT / rel
    assert port.is_file(), f"src/repro_torch/{rel} is missing"
    missing = public_names(REF / rel) - public_names(port, port=True)
    assert not missing, f"src/repro_torch/{rel} lacks {sorted(missing)}"


def test_exemptions_are_reference_modules():
    assert set(EXEMPT) <= set(REF_MODULES)


@pytest.mark.parametrize("example", sorted(
    p.stem for p in (ROOT / "examples").glob("*.py")))
def test_example_has_a_launch_entry_point(example):
    path = PORT / "launch" / f"{EXAMPLES.get(example, example)}.py"
    assert path.is_file(), f"examples/{example}.py has no {path.name}"
    assert "main" in public_names(path)
