"""The import guard: no module of the benchmark imports JAX or the JAX
package, and the reference imports nothing of the program. Module names
are compared by their top-level name, whole: the port's name begins with
the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cusmc_tpu"}
MODULES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert top_level_imports(path) & FORBIDDEN == set()


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "cusmc_tpu_torch" not in names
    assert names <= {"__future__", "importlib", "math", "numpy", "torch"}


def test_the_guard_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom cusmc_tpu.ops import x\n"
                   "import cusmc_tpu_torch\n")
    assert top_level_imports(bad) & FORBIDDEN == {"jax", "cusmc_tpu"}
