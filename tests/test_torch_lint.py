"""The port's lint: the repo-specific rules of ``tools/analysis/rules.py``
carried over to ``src/repro_torch/`` (stdlib ``ast`` only; the import rule
is ``tests/test_torch_imports.py``).

  * ``host-read`` — ``src/repro_torch/kernels/``: ``.cpu()``,
    ``.numpy()``, ``.item()``, ``.tolist()``, ``.to("cpu")`` and
    ``torch.cuda.synchronize()`` read device data on the host (or wait for
    the card), so they stand only in the boundary functions of
    ``BOUNDARY`` (the query plane's entry points, which copy the
    estimates out after the transfer guard, and the update wrappers' small
    host tables).
  * ``unseeded-random`` — ``src/repro_torch/{net,runtime,core}/``: the
    reference's numpy constructors called with no seed, ``np.random``'s
    global state, stdlib ``random``; and the torch forms: a
    ``torch.Generator()`` that is never seeded, and ``torch.rand*``,
    ``randint``, ``randn``, ``randperm``, ``multinomial``, ``bernoulli``
    without ``generator=``.
  * ``protocol-write`` — ``src/repro_torch/runtime/{control,export}.py``:
    a write to a ``version`` or ``seq`` field is an increment, a ``max``
    merge, a compare-guarded set or an initialisation (``__init__``, a
    class body).

The reference's other rules (mutable default, bare or silent except,
unused import) already lint all of ``src/``, and so the port
(``tests/test_analysis.py::test_live_repo_is_clean``).  Each rule here
fires on a fixture source first (its positive control), then every port
module must be clean.
"""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))

#: The only functions of ``src/repro_torch/kernels/`` where device data may
#: reach the host, by repo-relative path (the port's
#: ``tools/analysis/rules.py::KERNEL_BOUNDARY_FUNCS``).
BOUNDARY = {
    "src/repro_torch/kernels/sketch_query/engine.py": {
        # query entry points: host tables staged in before the guard,
        # (K,) / (L, K) estimates or one G-sum scalar out after it
        "fleet_window_query_device", "um_window_query_device",
        "um_gsum_device",
        # validates the host parameter tables only
        "_prep_window_params",
    },
    "src/repro_torch/kernels/sketch_update/fleet.py": {
        # a small int32 table (params, block map) on the host for checks
        "_host_i32",
        # the per-row loop baseline reads each row's parameters
        "fleet_update_loop",
    },
}

_HOST_METHODS = {"cpu", "numpy", "item", "tolist"}
_SEEDED_CTORS = {"default_rng", "RandomState", "SeedSequence", "Generator",
                 "PCG64", "MT19937", "Philox"}
_TORCH_RANDOM = re.compile(r"^(rand\w*|multinomial|bernoulli)$")
_PROTO_FIELDS = {"version", "seq"}


def _chain(node):
    """``['torch', 'cuda', 'synchronize']`` for ``torch.cuda.synchronize``;
    ``[]`` when the root is not a plain name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return [node.id] + parts[::-1]
    return []


def _field(target) -> str:
    if isinstance(target, ast.Attribute):
        return target.attr
    if isinstance(target, ast.Name):
        return target.id
    return ""


def _is_cpu(node) -> bool:
    """``"cpu"``, ``torch.device("cpu")`` or ``device="cpu"``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and _chain(node.func)[-1:] == ["device"]
            and any(_is_cpu(a) for a in node.args))


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, tree: ast.Module):
        self.path, self.findings = path, []
        self.funcs, self.if_fields = [], []
        self.in_kernels = path.startswith("src/repro_torch/kernels/")
        self.in_seeded = any(path.startswith(f"src/repro_torch/{d}/")
                             for d in ("net", "runtime", "core"))
        self.proto = path in ("src/repro_torch/runtime/control.py",
                              "src/repro_torch/runtime/export.py")
        self.boundary = BOUNDARY.get(path, set())
        self.imports_random = any(
            isinstance(n, ast.Import) and any(a.name == "random"
                                              for a in n.names)
            for n in ast.walk(tree))
        # generators seeded somewhere: the receivers of ``.manual_seed``,
        # by source text (a name or attribute) or, chained, the call itself
        receivers = [n.func.value for n in ast.walk(tree)
                     if isinstance(n, ast.Call)
                     and isinstance(n.func, ast.Attribute)
                     and n.func.attr == "manual_seed"]
        self.seeded = {ast.unparse(r) for r in receivers
                       if not isinstance(r, ast.Call)}
        self.seeded_calls = {id(r) for r in receivers}
        self.assigned = {}      # id(Generator call) -> its target's source
        for n in ast.walk(tree):
            if isinstance(n, (ast.Assign, ast.AnnAssign)) and \
                    isinstance(n.value, ast.Call):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                self.assigned[id(n.value)] = {ast.unparse(t)
                                              for t in targets}

    def emit(self, rule, node, msg):
        self.findings.append((rule, node.lineno, msg))

    def visit_FunctionDef(self, node):
        self.funcs.append(node.name)
        self.generic_visit(node)
        self.funcs.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_If(self, node):
        self.visit(node.test)
        self.if_fields.append({f for f in (_field(n) for n in
                                           ast.walk(node.test))
                               if f in _PROTO_FIELDS})
        for child in node.body:
            self.visit(child)
        self.if_fields.pop()
        for child in node.orelse:
            self.visit(child)

    # -- host-read + unseeded-random -----------------------------------

    def visit_Call(self, node):
        chain = _chain(node.func)
        if self.in_kernels and not self.boundary.intersection(self.funcs):
            attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                else ""
            to_cpu = attr == "to" and (
                any(_is_cpu(a) for a in node.args)
                or any(k.arg == "device" and _is_cpu(k.value)
                       for k in node.keywords))
            if attr in _HOST_METHODS or to_cpu or \
                    chain == ["torch", "cuda", "synchronize"]:
                self.emit("host-read", node,
                          f"{ast.unparse(node.func)}() reads device data on "
                          "the host outside a boundary function")
        if self.in_seeded:
            self._check_random(node, chain)
        self.generic_visit(node)

    def _check_random(self, node, chain):
        kws = {k.arg for k in node.keywords}
        if chain[:2] in (["np", "random"], ["numpy", "random"]) \
                and len(chain) == 3:
            if chain[2] not in _SEEDED_CTORS:
                self.emit("unseeded-random", node,
                          f"global-state np.random.{chain[2]}()")
            elif not node.args and not node.keywords:
                self.emit("unseeded-random", node,
                          f"np.random.{chain[2]}() without a seed")
        elif chain[:1] == ["random"] and len(chain) == 2 \
                and self.imports_random:
            self.emit("unseeded-random", node,
                      f"stdlib random.{chain[1]}() uses hidden global state")
        elif chain == ["torch", "Generator"]:
            if id(node) not in self.seeded_calls and not (
                    self.assigned.get(id(node), set()) & self.seeded):
                self.emit("unseeded-random", node,
                          "torch.Generator() that is never seeded")
        elif len(chain) == 2 and chain[0] == "torch" \
                and _TORCH_RANDOM.match(chain[1]) \
                and "generator" not in kws:
            self.emit("unseeded-random", node,
                      f"torch.{chain[1]}() without generator= uses the "
                      "global generator")

    # -- protocol-write --------------------------------------------------

    def _proto_write(self, node, targets, value, increment):
        if not self.proto:
            return
        for t in targets:
            field = _field(t)
            if field not in _PROTO_FIELDS or increment:
                continue
            if not self.funcs or self.funcs[-1] == "__init__":
                continue                       # class body / __init__
            if isinstance(value, ast.Call) and \
                    isinstance(value.func, ast.Name) and \
                    value.func.id == "max":
                continue                       # max merge
            if any(field in fields for fields in self.if_fields):
                continue                       # compare-guarded set
            self.emit("protocol-write", node,
                      f"write to protocol field `{field}` is not an "
                      "increment, max merge, guarded compare or init")

    def visit_Assign(self, node):
        self._proto_write(node, node.targets, node.value, False)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._proto_write(node, [node.target], node.value, False)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._proto_write(node, [node.target], node.value,
                          isinstance(node.op, ast.Add))
        self.generic_visit(node)


def lint(path: str, source: str):
    """``(rule, line, message)`` of every finding in ``source``, which is
    linted as the repo-relative ``path``."""
    tree = ast.parse(source, path)
    linter = _Linter(path, tree)
    linter.visit(tree)
    return linter.findings


def _hits(path, source):
    return {(rule, line) for rule, line, _ in lint(path, source)}


# -- positive controls ---------------------------------------------------------

def test_host_read_rule_fires():
    src = ("import torch\n"
           "def bad(x):\n"
           "    a = x.cpu()\n"                         # 3
           "    b = x.numpy()\n"                       # 4
           "    c = x.sum().item()\n"                  # 5
           "    d = x.tolist()\n"                      # 6
           "    torch.cuda.synchronize()\n"            # 7
           "    e = x.to('cpu')\n"                     # 8
           "    f = x.to(device=torch.device('cpu'))\n"  # 9
           "    return x.to('cuda'), x.to(torch.float64)\n"
           "def fleet_window_query_device(x):\n"
           "    return x.cpu().numpy()\n")
    path = "src/repro_torch/kernels/sketch_query/engine.py"
    assert _hits(path, src) == {("host-read", n) for n in range(3, 10)}
    # the same reads outside kernels/ are the host boundary at work
    assert not _hits("src/repro_torch/core/query.py", src)
    # a boundary name counts only in its own file
    assert ("host-read", 12) in _hits(
        "src/repro_torch/kernels/sketch_update/fleet.py", src)


def test_unseeded_random_rule_fires():
    src = ("import random\n"
           "import numpy as np\n"
           "import torch\n"
           "a = np.random.default_rng()\n"             # 4: unseeded
           "b = np.random.default_rng(7)\n"
           "c = np.random.rand(3)\n"                   # 6: global state
           "d = random.random()\n"                     # 7: stdlib
           "g = torch.Generator()\n"                   # 8: never seeded
           "h = torch.Generator(device='cpu')\n"
           "h.manual_seed(3)\n"
           "k = torch.Generator().manual_seed(4)\n"
           "x = torch.randn(3)\n"                      # 12: no generator
           "y = torch.randint(0, 5, (3,), generator=h)\n"
           "z = torch.multinomial(x.abs(), 2)\n"       # 14: no generator
           "w = torch.bernoulli(x, generator=k)\n"
           "p = torch.randperm(5)\n"                   # 16: no generator
           "def f(rng: np.random.RandomState):\n"
           "    return rng.rand(3)\n")
    want = {("unseeded-random", n) for n in (4, 6, 7, 8, 12, 14, 16)}
    for d in ("net", "runtime", "core"):
        assert _hits(f"src/repro_torch/{d}/t.py", src) == want
    assert not _hits("src/repro_torch/models/t.py", src)


def test_protocol_write_rule_fires():
    src = ("class S:\n"
           "    seq: int = 0\n"                        # class body: init
           "    def __init__(self):\n"
           "        self.version = 0\n"                # init
           "    def bump(self):\n"
           "        self.version += 1\n"               # increment
           "    def merge(self, other):\n"
           "        self.version = max(self.version, other)\n"
           "    def clobber(self, v):\n"
           "        self.version = v\n"                # 10: flagged
           "    def guarded(self, m):\n"
           "        if m.seq > self.seq:\n"
           "            self.seq = m.seq\n"            # guarded compare
           "    def reset(self):\n"
           "        self.seq -= 1\n")                  # 15: flagged
    want = {("protocol-write", 10), ("protocol-write", 15)}
    for name in ("control", "export"):
        assert _hits(f"src/repro_torch/runtime/{name}.py", src) == want
    assert not _hits("src/repro_torch/runtime/chaos.py", src)


# -- the port ------------------------------------------------------------------

def test_boundary_functions_exist():
    """Every boundary name is a function of its file: a renamed entry
    point must not leave a stale exemption behind."""
    for rel, names in BOUNDARY.items():
        tree = ast.parse((ROOT / rel).read_text())
        defined = {n.name for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)}
        assert names <= defined, (rel, names - defined)


@pytest.mark.parametrize("path", PORT, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_is_clean(path):
    rel = path.relative_to(ROOT).as_posix()
    assert lint(rel, path.read_text()) == []
