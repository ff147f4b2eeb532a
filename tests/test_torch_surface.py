"""The port's surface covers the JAX package's: every public top-level
name of a ``src/repro/`` module (function, class, module-level name, and
each public method of a class) has its counterpart, under the same name,
in the same module of ``src/repro_torch/``, and every ``examples/*.py``
has an entry point in ``repro_torch.launch``. Every parameter of a
public function or method (``__init__`` included) has a same-named
parameter in its counterpart. Read from the sources' ASTs; nothing is
imported.

Exempt is only what belongs to JAX: the pytree hooks, the aliases of JAX
types, the Pallas kernel modules and the HLO cost reader (``EXEMPT``),
and the parameters of ``EXEMPT_PARAMS``, each with its reason."""
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

_KEY = ("JAX's PRNG key: the port draws from a torch.Generator (or a "
        "seed) passed in its place")
_TILE = "a Pallas tile size: the CUDA kernels choose their own tiling"
_USE_KERNEL = ("chooses the Pallas kernel or the jnp path: the port "
               "picks by the tensor's device")
_HLO = ("reads collectives from XLA's HLO text: the port counts the "
        "collectives of its step's records")
# (reference module, parameter) -> why the port's counterpart lacks it
EXEMPT_PARAMS = {
    ("core/lora.py", "key"): _KEY,
    ("models/attention.py", "key"): _KEY,
    ("models/encdec.py", "key"): _KEY,
    ("models/layers.py", "key"): _KEY,
    ("models/lm.py", "key"): _KEY,
    ("models/moe.py", "key"): _KEY,
    ("models/resnet.py", "key"): _KEY,
    ("models/ssm.py", "key"): _KEY,
    ("kernels/ops.py", "block_c"): _TILE,
    ("kernels/ops.py", "block_k"): _TILE,
    ("core/messages.py", "use_kernel"): _USE_KERNEL,
    ("core/sparse.py", "use_kernel"): _USE_KERNEL,
    ("roofline/analysis.py", "hlo_text"): _HLO,
    ("roofline/analysis.py", "coll"): _HLO,
    ("roofline/analysis.py", "chips"): _HLO,
    ("roofline/analysis.py", "link_bw"): _HLO,
    ("launch/mesh.py", "n_devices"): "make_client_mesh spans the process "
                                     "group, not a count of JAX devices",
    ("models/moe.py", "lora"): "moe_init's LoRA config is named lora_cfg "
                               "in the port",
}


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


def public_defs(path: Path) -> dict:
    """{name or ``Class.method``: its def} of the public functions and
    methods of ``path`` (``__init__`` included)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out.update({f"{node.name}.{m.name}": m for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))})
    return {n: f for n, f in out.items() if n.endswith(".__init__")
            or not any(part.startswith("_") for part in n.split("."))}


def parameters(fn) -> set:
    """The parameter names of ``fn``."""
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs} - {
        "self", "cls"}


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


def missing_parameters(rel: str) -> dict:
    """{function: the parameters its counterpart in the port lacks} for
    the reference module ``rel`` (exemptions not applied)."""
    out = {}
    port = public_defs(PORT / rel)
    for name, fn in public_defs(REF / rel).items():
        other = port.get(name)
        if other is None:       # test_module_has_its_counterpart's case
            continue
        lacks = parameters(fn) - parameters(other)
        if lacks:
            out[name] = lacks
    return out


@pytest.mark.parametrize("rel", REF_MODULES)
def test_functions_keep_their_parameters(rel):
    if rel in EXEMPT or not (PORT / rel).is_file():
        return
    lacks = {name: sorted(p for p in ps if (rel, p) not in EXEMPT_PARAMS)
             for name, ps in missing_parameters(rel).items()}
    lacks = {name: ps for name, ps in lacks.items() if ps}
    assert not lacks, f"src/repro_torch/{rel} lacks parameters: {lacks}"


def test_parameter_exemptions_are_needed():
    """Every entry of ``EXEMPT_PARAMS`` gives a reason and names a
    parameter that some counterpart in its module lacks."""
    used = {(rel, p) for rel in {r for r, _ in EXEMPT_PARAMS}
            for ps in missing_parameters(rel).values() for p in ps}
    for entry, why in EXEMPT_PARAMS.items():
        assert why, entry
        assert entry in used, f"{entry} is exempt but not missing"


@pytest.mark.parametrize("example", sorted(
    p.stem for p in (ROOT / "examples").glob("*.py")))
def test_example_has_a_launch_entry_point(example):
    path = PORT / "launch" / f"{EXAMPLES.get(example, example)}.py"
    assert path.is_file(), f"examples/{example}.py has no {path.name}"
    assert "main" in public_names(path)
