"""The port's checkpoints (``repro_torch.ckpt``) against the JAX package's.

The reference's own suite (``tests/test_ckpt.py``: roundtrip, atomicity,
integrity, pruning, torn-step fallback) carried over with the tree built
in numpy, then the two cross-reads: a checkpoint written by one package
restores through the other's ``restore_checkpoint`` (a list of numpy
arrays as ``like_tree``) with equal arrays and ``extra``.  The port keeps
the reference's on-disk layout, and loads without ``jax``.

Then training states: ``NamedTuple``s rebuilt by their fields; bfloat16
leaves written as the reference writes them (``'<V2'``, dtype name
``"bfloat16"``, the same file bytes) and read back bit for bit; a
``TrainState`` of the reference's (f32 and bf16, after a step, with the
compressor's residual) restored by the port onto tensors, and the port's
f32 one restored by the reference; a restore onto a device from a tree of
``meta`` tensors.  Every comparison is exact.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

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


# -- training states ----------------------------------------------------------

def _bits(t):
    """A leaf's bytes as integers (bfloat16 through its 16-bit pattern)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                ).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _same(got, want):
    from repro_torch.tree import leaves
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_namedtuple_train_state_roundtrip(tmp_path):
    from repro_torch.train.compress import CompressorState
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.train_step import TrainState
    from repro_torch.tree import leaves, tree_map

    def tree(draw):
        return {"w": draw(3, 2), "layers": [{"b": draw(4)}]}

    st = TrainState(tree(torch.randn), OptState(
        tree(torch.randn), tree(torch.rand),
        torch.tensor(5, dtype=torch.int32)),
        CompressorState(tree(torch.randn)), torch.tensor(7, dtype=torch.int32))
    save_checkpoint(str(tmp_path), 7, st)
    out, step, _ = restore_checkpoint(str(tmp_path),
                                      tree_map(torch.zeros_like, st))
    assert step == 7 and isinstance(out, TrainState)
    assert isinstance(out.opt, OptState)
    assert isinstance(out.comp, CompressorState)
    assert isinstance(out.params["layers"], list)
    for a, b in zip(leaves(out), leaves(st)):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)


def _bf16_values():
    x = torch.tensor([0.0, -0.0, 1.0, -2.5, 3.14159, 1e-40, -1e-38, 65504.0,
                      3e38, float("inf"), -float("inf")]).bfloat16()
    return torch.cat([x, torch.randn(37).bfloat16()])


def test_bf16_roundtrip_bit_for_bit(tmp_path):
    x = _bf16_values().reshape(4, 12)
    tree = {"x": x, "y": torch.ones(3)}
    path = save_checkpoint(str(tmp_path / "p"), 1, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)["leaves"]
    assert [m["dtype"] for m in meta] == ["bfloat16", "float32"]
    out, _, _ = restore_checkpoint(str(tmp_path / "p"), {
        "x": torch.zeros(4, 12, dtype=torch.bfloat16), "y": torch.zeros(3)})
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"].view(torch.int16), x.view(torch.int16))
    # into a numpy float32 like leaf: the exact widening
    out, _, _ = restore_checkpoint(str(tmp_path / "p"), {
        "x": np.zeros((4, 12), np.float32), "y": np.zeros(3, np.float32)})
    np.testing.assert_array_equal(out["x"], x.float().numpy())
    # the reference writes the same file for the same values
    ref = x.float().numpy().astype(ml_dtypes.bfloat16)
    rpath = RC.save_checkpoint(str(tmp_path / "r"), 1, {
        "x": jnp.asarray(ref), "y": jnp.ones(3)})
    with open(os.path.join(rpath, "manifest.json")) as f:
        assert json.load(f)["leaves"] == meta
    for name in ("arr_00000.npy", "arr_00001.npy"):
        with open(os.path.join(path, name), "rb") as a, \
                open(os.path.join(rpath, name), "rb") as b:
            assert a.read() == b.read(), name


def _states(dtype):
    """A reference ``TrainState`` after one jitted step (with the
    compressor) and the port's like tree of the same structure."""
    import dataclasses
    from repro.configs import get_config as rget
    from repro.configs import reduced as rred
    from repro.train import optimizer as RO
    from repro.train import train_step as RT
    from repro.train.compress import DisketchCompressor as RComp
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import convert
    from repro_torch.models import model as PM
    from repro_torch.train.compress import DisketchCompressor as PComp
    from repro_torch.train.train_step import init_train_state
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")), n_layers=2)
    rcfg = dataclasses.replace(rred(rget("gemma2-2b")), n_layers=2)
    params = PM.init_params(np.random.default_rng(0), cfg, dtype=dtype,
                            device="cpu")
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rparams = jax.tree.map(lambda a: jnp.asarray(np.array(a), jd),
                           convert.to_numpy(params))
    rc = RComp(width=1024, n_sub=2, k_frac=0.05)
    rst = RT.init_train_state(rparams, rc)
    step = jax.jit(RT.make_train_step(rcfg, RO.cosine_schedule(1e-3, 0, 4),
                                      compressor=rc, sp=False))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16))
    rst, _ = step(rst, {"tokens": jnp.asarray(toks, jnp.int32),
                        "labels": jnp.asarray(toks, jnp.int32)})
    return rst, init_train_state(params, PComp(width=1024, n_sub=2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_port_restores_reference_train_state(tmp_path, dtype):
    from repro_torch.train.train_step import TrainState
    rst, like = _states(dtype)
    RC.save_checkpoint(str(tmp_path), 1, rst)
    out, step, _ = restore_checkpoint(str(tmp_path), like)
    assert step == 1 and isinstance(out, TrainState)
    assert out.params["embed"].dtype == dtype
    assert out.opt.m["embed"].dtype == torch.float32
    assert int(out.step) == int(out.opt.step) == 1
    _same(out, rst)


def test_reference_restores_port_train_state(tmp_path):
    rst, _ = _states(torch.float32)
    port = restore_checkpoint(str(tmp_path / "none"), rst)
    assert port == (None, None, None)
    # the port's state (restored from the reference's, then saved again)
    RC.save_checkpoint(str(tmp_path / "r"), 1, rst)
    _, like = _states(torch.float32)
    state, _, _ = restore_checkpoint(str(tmp_path / "r"), like)
    save_checkpoint(str(tmp_path / "p"), 2, state)
    zeros = jax.tree.map(jnp.zeros_like, rst)
    out, step, _ = RC.restore_checkpoint(str(tmp_path / "p"), zeros)
    assert step == 2 and type(out).__name__ == "TrainState"
    _same(state, out)


def test_restore_onto_a_device_from_meta_tensors(tmp_path):
    from repro_torch.tree import leaves, tree_map
    tree = {"a": torch.randn(5, 3), "b": [torch.arange(4, dtype=torch.int32),
                                          _bf16_values()]}
    save_checkpoint(str(tmp_path), 3, tree)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)
    out, step, _ = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert step == 3
    for a, b in zip(leaves(out), leaves(tree)):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
