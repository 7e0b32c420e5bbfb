"""The port's import rule: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, at module
level or inside a function.  ``scripts/`` and ``tests/`` are the
oracle's side and stay exempt."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def forbidden_imports(source: str, filename: str = "<source>"):
    """``(line, module)`` of every import of a forbidden top-level
    package anywhere in the module's AST."""
    found = []
    for node in ast.walk(ast.parse(source, filename)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in FORBIDDEN]
    return sorted(found)


@pytest.mark.parametrize(
    "path", PORT + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert forbidden_imports(path.read_text(), str(path)) == []


def test_the_lint_sees_every_form_of_import():
    src = ("import jax\n"
           "def f():\n"
           "    from repro.core import fleet\n"
           "    import jax.numpy as jnp, numpy\n"
           "from . import repro\n"          # relative: the port's own
           "import repro_torch.core\n"
           "from jaxlib import xla_client\n")
    assert forbidden_imports(src) == [(1, "jax"), (3, "repro.core"),
                                      (4, "jax.numpy"), (7, "jaxlib")]
    assert len(PORT) > 20
