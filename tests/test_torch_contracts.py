"""The port's contracts and dead-module sweep: the checks of
``tools/analysis/contracts.py`` and ``tools/analysis/deadcode.py`` that
are not TPU geometry, carried over to ``src/repro_torch/``.

  * ``packing`` — the packed-ts layout (level id in bits [24, 29), the
    §4.4 single-hop flag in bit 31) is the reference's, the port's packer
    folds the same words, and the shipped defaults satisfy
    ``log2_te <= 24`` and ``n_levels <= 32``;
  * ``peak-guard`` — every ``return`` of ``kernels/sketch_update/ops.py::
    sketch_update`` is a ``_guard_peak(...)`` call, ``_guard_peak`` calls
    ``check_output_peak``, and ``FleetEpochRunner.run_epoch`` and
    ``run_window`` call ``self._check_peak``, which calls it too: every
    update path holds its counters to the f32 exact-integer bound (2^24);
  * ``dead-module`` — every module of ``src/repro_torch`` is reached from
    a root (``tests/test_torch_*.py``, ``chip_smoke.py``, ``scripts/``,
    ``python -m repro_torch.launch.{train,serve,dryrun}``) through the
    import graph of ``tools.analysis.deadcode``, or is listed in
    ``QUARANTINE`` with its reason.

The reference's ``vmem-budget``, ``pow2-width``, ``eval-shape`` and
``sharded-*`` contracts size TPU VMEM tiles, MXU-aligned blocks and the
mesh's pad rows.  The port has none of them: its kernels are one
packet-parallel pass without a shared-memory tile, and its sharded
windows are unpadded row groups.  So they have no counterpart here.
"""
import ast
import inspect
from pathlib import Path

import numpy as np
import pytest

from repro.core import fleet as RF
from repro.kernels.sketch_update import kernel as RK
from repro_torch.core import fleet as TF
from repro_torch.core.disketch import DiSketchSystem
from repro_torch.kernels.sketch_update import kernel as TK
from repro_torch.net import traffic
from tools.analysis.deadcode import _edges, _py_modules

ROOT = Path(__file__).resolve().parents[1]

#: Port modules kept though no root reaches them, each with its reason.
QUARANTINE = {}

ENTRY_POINTS = ("repro_torch.launch.train", "repro_torch.launch.serve",
                "repro_torch.launch.dryrun")


# -- packing -------------------------------------------------------------------

def test_packed_ts_layout_is_the_references():
    assert (TK.LVL_SHIFT, TK.LVL_FIELD_MASK, TK.SH_SHIFT) == (24, 0x1F, 31)
    assert (TK.LVL_SHIFT, TK.LVL_FIELD_MASK, TK.SH_SHIFT) == \
        (RK.LVL_SHIFT, RK.LVL_FIELD_MASK, RK.SH_SHIFT)


def test_shipped_defaults_fit_the_layout():
    max_levels = TK.LVL_FIELD_MASK + 1
    n_levels = inspect.signature(DiSketchSystem.__init__).parameters[
        "n_levels"].default
    assert isinstance(n_levels, int) and n_levels <= max_levels
    for fn in (traffic.linear_path_workload, traffic.gen_workload):
        log2_te = inspect.signature(fn).parameters["log2_te"].default
        assert isinstance(log2_te, int) and log2_te <= TK.LVL_SHIFT, fn


@pytest.mark.parametrize("n_levels,mitigation,log2_te",
                         [(16, False, 16), (32, True, 24), (1, True, 20),
                          (4, True, 12)])
def test_packer_folds_the_references_words(n_levels, mitigation, log2_te):
    """``fold_packet_flags`` writes the reference's ts words: the level id
    of every key in bits [24, 29), the single-hop flag in bit 31, the low
    ``log2_te`` bits of the timestamp below."""
    rng = np.random.default_rng(n_levels * 100 + log2_te)
    p = 4096
    fields = dict(keys=rng.integers(0, 2**32, p, dtype=np.uint64).astype(
        np.uint32), values=np.ones(p, np.int64),
        ts=rng.integers(0, 2**31, p).astype(np.int64),
        offsets=np.array([0, p // 2, p]), frag_order=(0, 1),
        single_hop=rng.random(p) < 0.3)
    kw = dict(n_levels=n_levels, level_seed=7777, mitigation=mitigation)
    got = TF.fold_packet_flags(TF.FleetPacket(**fields), log2_te, **kw).ts
    want = RF.fold_packet_flags(RF.FleetPacket(**fields), log2_te, **kw).ts
    np.testing.assert_array_equal(got, want)
    got = np.asarray(got, np.int64)
    assert ((got >> TK.LVL_SHIFT) & TK.LVL_FIELD_MASK < n_levels).all()
    assert np.array_equal((got >> TK.SH_SHIFT) & 1,
                          fields["single_hop"] & mitigation)
    assert np.array_equal(got & ((1 << log2_te) - 1),
                          fields["ts"] & ((1 << log2_te) - 1))


# -- peak-guard ----------------------------------------------------------------

def _functions(tree):
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)}


def _returns_of(fn):
    """Return statements of ``fn`` itself (not of nested functions)."""
    out, stack = [], list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Return):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _calls(fn, name):
    """Whether ``fn`` calls ``name`` (a plain name or an attribute)."""
    return any(isinstance(n, ast.Call) and (
        getattr(n.func, "id", None) == name
        or getattr(n.func, "attr", None) == name) for n in ast.walk(fn))


def peak_guard_findings(ops_src: str, fleet_src: str):
    """``(file, line, message)`` of every update path that bypasses the
    2^24 exact-integer guard."""
    out = []
    fns = _functions(ast.parse(ops_src))
    su, gp = fns.get("sketch_update"), fns.get("_guard_peak")
    if su is None:
        out.append(("ops.py", 1, "sketch_update not found"))
    else:
        out += [("ops.py", r.lineno, "sketch_update return bypasses "
                 "_guard_peak") for r in _returns_of(su)
                if not (isinstance(r.value, ast.Call)
                        and getattr(r.value.func, "id", None)
                        == "_guard_peak")]
    if gp is None or not _calls(gp, "check_output_peak"):
        out.append(("ops.py", getattr(gp, "lineno", 1),
                    "_guard_peak does not call check_output_peak"))
    runner = next((n for n in ast.walk(ast.parse(fleet_src))
                   if isinstance(n, ast.ClassDef)
                   and n.name == "FleetEpochRunner"), None)
    if runner is None:
        return out + [("fleet.py", 1, "FleetEpochRunner not found")]
    methods = {n.name: n for n in runner.body
               if isinstance(n, ast.FunctionDef)}
    for name in ("run_epoch", "run_window"):
        fn = methods.get(name)
        if fn is None or not _calls(fn, "_check_peak"):
            out.append(("fleet.py", getattr(fn, "lineno", runner.lineno),
                        f"FleetEpochRunner.{name} does not call "
                        "self._check_peak"))
    check = methods.get("_check_peak")
    if check is None or not _calls(check, "check_output_peak"):
        out.append(("fleet.py", getattr(check, "lineno", runner.lineno),
                    "_check_peak does not call check_output_peak"))
    return out


_OPS = ("def _guard_peak(out, check):\n"
        "    check_output_peak(float(out.abs().max()))\n"
        "    return out\n"
        "def sketch_update(x, backend):\n"
        "    if backend == 'ref':\n"
        "        return _guard_peak(x, True)\n"
        "    return x\n")                              # 7: bypass
_FLEET = ("class FleetEpochRunner:\n"
          "    def _check_peak(self, groups):\n"
          "        check_output_peak(1.0)\n"
          "    def run_epoch(self):\n"
          "        self._check_peak([])\n"
          "    def run_window(self):\n"                # 6: no check
          "        return None\n")


def test_peak_guard_fires():
    assert peak_guard_findings(_OPS, _FLEET) == [
        ("ops.py", 7, "sketch_update return bypasses _guard_peak"),
        ("fleet.py", 6, "FleetEpochRunner.run_window does not call "
         "self._check_peak")]
    assert peak_guard_findings(_OPS.replace("    return x\n", ""),
                               _FLEET.replace("return None",
                                              "self._check_peak([])")) == []


def test_update_paths_keep_the_peak_guard():
    src = ROOT / "src" / "repro_torch"
    assert peak_guard_findings(
        (src / "kernels" / "sketch_update" / "ops.py").read_text(),
        (src / "core" / "fleet.py").read_text()) == []


# -- dead modules --------------------------------------------------------------

def dead_modules(root: Path):
    """Port modules under ``root/src/repro_torch`` that no root of the port
    reaches, less the quarantined ones; and the stale quarantine entries
    (reachable again)."""
    modules = {m: p for m, p in _py_modules(str(root / "src")).items()
               if m.split(".")[0] == "repro_torch"}
    known = set(modules)
    edges = {m: _edges(p, m, known) for m, p in modules.items()}
    files = (sorted(root.glob("tests/test_torch_*.py"))
             + sorted(root.glob("chip_smoke.py"))
             + sorted(root.glob("scripts/**/*.py")))
    # ``python -m a.b.c`` imports the packages a and a.b first
    roots = {".".join(m.split(".")[:i]) for m in ENTRY_POINTS
             for i in range(1, m.count(".") + 2)} & known
    for f in files:
        roots |= _edges(str(f), f.stem, known)
    live, stack = set(), list(roots)
    while stack:
        m = stack.pop()
        if m not in live:
            live.add(m)
            stack.extend(edges[m])
    dead = sorted(set(modules) - live - set(QUARANTINE))
    return dead, sorted(set(QUARANTINE) & live)


def test_dead_module_sweep_fires(tmp_path):
    files = {
        "src/repro_torch/__init__.py": "",
        "src/repro_torch/live.py": "from . import helper\n",
        "src/repro_torch/helper.py": "x = 1\n",
        "src/repro_torch/zombie.py": "y = 2\n",
        "src/repro_torch/launch/__init__.py": "",
        "src/repro_torch/launch/serve.py": "import importlib\n"
                                           "importlib.import_module("
                                           "'repro_torch.dyn')\n",
        "src/repro_torch/dyn.py": "z = 3\n",
        "src/repro/orphan.py": "w = 4\n",
        "tests/test_torch_x.py": "import repro_torch.live\n",
        "tests/test_other.py": "import repro_torch.zombie\n",
    }
    for rel, text in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    assert dead_modules(tmp_path) == (["repro_torch.zombie"], [])
    (tmp_path / "chip_smoke.py").write_text(
        "def f():\n    from repro_torch import zombie\n")
    assert dead_modules(tmp_path) == ([], [])


def test_every_port_module_is_reached():
    dead, stale = dead_modules(ROOT)
    assert dead == [], "unreached port modules: delete them or quarantine"
    assert stale == [], "quarantined modules that are reached again"
