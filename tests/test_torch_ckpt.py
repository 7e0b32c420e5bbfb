"""The port's checkpoints (``repro_torch.ckpt``) against the JAX package's.

The reference's own suite (``tests/test_ckpt.py``: roundtrip, atomicity,
integrity, pruning, torn-step fallback) carried over with the tree built
in numpy, then the two cross-reads: a checkpoint written by one package
restores through the other's ``restore_checkpoint`` (a list of numpy
arrays as ``like_tree``) with equal arrays and ``extra``.  The port keeps
the reference's on-disk layout, and loads without ``jax``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as RC
from repro_torch.ckpt.checkpoint import (latest_step, restore_checkpoint,
                                         save_checkpoint)


def _tree():
    return {"a": np.arange(12.0, dtype=np.float32).reshape(3, 4),
            "b": {"c": np.ones(5, np.int32),
                  "d": np.float32(3.5)}}


# -- the reference's suite, on the port ----------------------------------------

def test_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    save_checkpoint(d, 7, tree, extra={"note": "x"})
    like = {"a": np.zeros((3, 4), np.float32),
            "b": {"c": np.zeros(5, np.int32), "d": np.float32(0)}}
    out, step, extra = restore_checkpoint(d, like)
    assert step == 7 and extra == {"note": "x"}
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["d"] == np.float32(3.5)


def test_partial_checkpoint_ignored(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    save_checkpoint(d, 5, tree)
    # simulate a crash mid-save at step 9: no _COMMITTED marker
    os.makedirs(os.path.join(d, "step_000000009"))
    with open(os.path.join(d, "step_000000009", "manifest.json"), "w") as f:
        f.write("{}")
    assert latest_step(d) == 5
    out, step, _ = restore_checkpoint(d, tree)
    assert step == 5


def test_checksum_detects_corruption(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    path = save_checkpoint(d, 3, tree)
    # corrupt one array file
    victim = os.path.join(path, "arr_00000.npy")
    with open(victim, "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\xFF")
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(d, tree)


def test_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, _tree())
    bad = {"a": np.zeros((4, 4), np.float32),
           "b": {"c": np.zeros(5, np.int32), "d": np.float32(0)}}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, bad)


def test_prune_keeps_newest(tmp_path):
    d = str(tmp_path / "ck")
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(d, s, _tree(), keep=2)
    steps = sorted(int(n[5:]) for n in os.listdir(d)
                   if n.startswith("step_"))
    assert steps == [4, 5]


def test_restore_empty_dir(tmp_path):
    out, step, extra = restore_checkpoint(str(tmp_path / "none"), _tree())
    assert out is None and step is None


def test_torn_trailing_step_falls_back(tmp_path):
    # A crash that slipped a bad step past _COMMITTED (lost sectors under
    # power failure) must degrade the restart to the previous good step,
    # not take it down.
    d = str(tmp_path / "ck")
    tree = _tree()
    save_checkpoint(d, 1, tree)
    path2 = save_checkpoint(d, 2, tree)
    with open(os.path.join(path2, "arr_00000.npy"), "r+b") as f:
        f.truncate(8)                        # torn array file
    out, step, _ = restore_checkpoint(d, tree)
    assert step == 1
    np.testing.assert_array_equal(out["a"], tree["a"])
    # an explicitly requested corrupt step still raises
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(d, tree, step=2)


def test_corrupt_manifest_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    save_checkpoint(d, 1, tree)
    path2 = save_checkpoint(d, 2, tree)
    with open(os.path.join(path2, "manifest.json"), "w") as f:
        f.write("{ not json")
    out, step, _ = restore_checkpoint(d, tree)
    assert step == 1 and out is not None


# -- the port's own: the layout, tensors, and the other package -------------------

def _cells():
    """Export-plane payloads: int32 cells of differing shapes."""
    rng = np.random.default_rng(5)
    return [rng.integers(-9, 9, shape).astype(np.int32)
            for shape in [(1, 2, 7), (1, 1, 13), (4, 2, 3), (1, 8, 5)]]


def test_layout_and_manifest_match_reference(tmp_path):
    cells = _cells()
    extra = {"applied": [[0, 1], [2, 3]], "now": 4}
    path = save_checkpoint(str(tmp_path / "t"), 42, cells, extra=extra)
    rpath = RC.save_checkpoint(str(tmp_path / "r"), 42, cells, extra=extra)
    assert os.path.basename(path) == os.path.basename(rpath) == \
        "step_000000042"
    assert sorted(os.listdir(path)) == sorted(os.listdir(rpath))
    with open(os.path.join(path, "manifest.json")) as f:
        got = json.load(f)
    with open(os.path.join(rpath, "manifest.json")) as f:
        want = json.load(f)
    assert set(got) == set(want)
    got.pop("treedef"), want.pop("treedef")     # each package's own string
    assert got == want
    for name in os.listdir(path):
        if name.endswith(".npy"):
            with open(os.path.join(path, name), "rb") as a, \
                    open(os.path.join(rpath, name), "rb") as b:
                assert a.read() == b.read(), name


def test_torch_leaves_save_through_numpy(tmp_path):
    d = str(tmp_path / "ck")
    tree = (torch.arange(6, dtype=torch.int32).reshape(2, 3),
            [torch.ones(4, requires_grad=True), np.int64(7)])
    save_checkpoint(d, 1, tree)
    out, step, _ = restore_checkpoint(
        d, (np.zeros((2, 3), np.int32), [np.zeros(4, np.float32),
                                         np.int64(0)]))
    assert step == 1 and isinstance(out, tuple) and isinstance(out[1], list)
    np.testing.assert_array_equal(out[0], np.arange(6).reshape(2, 3))
    assert out[0].dtype == np.int32
    np.testing.assert_array_equal(out[1][0], np.ones(4, np.float32))
    assert out[1][1] == 7


def test_port_checkpoint_restores_through_reference(tmp_path):
    d = str(tmp_path / "ck")
    cells = _cells()
    extra = {"applied": [[3, 0], [1, 2], [0, 5], [2, 2]],
             "dedup": [[0, 5, 0], [1, 2, 1]], "now": 9}
    save_checkpoint(d, 3, cells, keep=2, extra=extra)
    like = [np.zeros(c.shape, np.int32) for c in cells]
    out, step, got_extra = RC.restore_checkpoint(d, like)
    assert step == 3 and got_extra == extra
    assert len(out) == len(cells)
    for a, b in zip(out, cells):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_restores_through_port(tmp_path):
    d = str(tmp_path / "ck")
    cells = _cells()
    extra = {"applied": [[3, 0], [1, 2], [0, 5], [2, 2]],
             "dedup": [[0, 5, 0], [1, 2, 1]], "now": 9}
    RC.save_checkpoint(d, 3, cells, keep=2, extra=extra)
    like = [np.zeros(c.shape, np.int32) for c in cells]
    out, step, got_extra = restore_checkpoint(d, like)
    assert step == 3 and got_extra == extra
    assert isinstance(out, list) and len(out) == len(cells)
    for a, b in zip(out, cells):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_ckpt_loads_without_jax():
    """The port's checkpoints import no ``jax`` (nor ``repro``): with both
    blocked in ``sys.modules`` the package loads and round-trips."""
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    code = (
        "import sys, tempfile\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "import repro_torch.ckpt as C\n"
        "import repro_torch.runtime.export\n"
        "d = tempfile.mkdtemp()\n"
        "C.save_checkpoint(d, 1, [np.arange(3)])\n"
        "out, step, _ = C.restore_checkpoint(d, [np.zeros(3, np.int64)])\n"
        "assert step == 1 and out[0].tolist() == [0, 1, 2]\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "import shutil; shutil.rmtree(d)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
