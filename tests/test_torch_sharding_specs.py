"""The port's sharding spec tables (``repro_torch.launch.shardings``) held
to the reference's ``repro.launch.shardings`` leaf by leaf, on both
production meshes as ``AbstractMesh``es (names and sizes, no devices).

Every table of every arch (``param_specs`` with FSDP on and off,
``decode_state_specs`` for decode_32k and, for the long-context archs,
long_500k, the batch specs of every shape, ``opt_state_specs``) must be
equal, path by path; the paths are ``jax.tree_util.keystr``'s.  Then the
reference's own four ``tests/test_sharding_specs.py`` tests, run on the
port's tables.  Exact comparisons: the tables are data."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.data.pipeline import batch_specs as r_batch_specs
from repro.launch import shardings as RSH
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.data.pipeline import batch_specs
from repro_torch.launch import abstract_production_mesh, data_axis_size
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as PM
from repro_torch.models.sharding import P
from repro_torch.tree import leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from reference_pins import (SHARDING_MESHES, _abstract_mesh,  # noqa: E402
                            reference_param_shapes, reference_spec_tables)

MESHES = {"single": abstract_production_mesh(),
          "multi": abstract_production_mesh(multi_pod=True)}
ARCHS = list_configs()


def _ref_mesh(name):
    return _abstract_mesh(*SHARDING_MESHES[name])


def _canon(spec):
    return [None if e is None else ([e] if isinstance(e, str) else list(e))
            for e in spec]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tables_equal_the_reference(arch, mesh_name):
    got = SH.spec_tables(get_config(arch), MESHES[mesh_name])
    want = reference_spec_tables(arch, mesh_name)
    assert list(got) == list(want)
    for table in want:
        assert len(got[table]) == len(want[table]), table
        for g, w in zip(got[table], want[table]):
            assert g == w, f"{arch} {mesh_name} {table}: {g} != {w}"


@pytest.mark.parametrize("arch", ARCHS)
def test_keystr_paths_are_jax_keystr(arch):
    """The port's parameter paths, the strings ``_param_spec`` matches,
    are ``jax.tree_util.keystr`` of the reference's pytree."""
    cfg = get_config(arch)
    ref = reference_param_shapes(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    port = SH.keystr_paths(PM.init_params(None, cfg, device="meta"))
    assert [p for p, _ in port] == [jax.tree_util.keystr(k)
                                    for k, _ in flat]
    assert [tuple(x.shape) for _, x in port] == [tuple(a.shape)
                                                 for _, a in flat]


DIV_CASES = [((256, 4096), P(("pod", "data"), None)),
             ((8, 4096), P(("pod", "data"), None)),
             ((24, 7), P("data", "model")),
             ((1, 524288, 4, 256), P(None, "data", "model", None)),
             ((128, 32768, 8, 128), P(("pod", "data"), None, "model", None)),
             ((48,), P("model")),
             ((6, 10), P(None, ("data", "model"))),
             ((3,), P(("pod",), "model"))]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape,spec", DIV_CASES)
def test_div_spec(shape, spec, mesh_name):
    got = SH.div_spec(MESHES[mesh_name], shape, spec)
    want = RSH.div_spec(_ref_mesh(mesh_name), shape, JP(*spec))
    assert _canon(got) == _canon(want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("batch", [1, 8, 24, 32, 128])
@pytest.mark.parametrize("arch", ["granite-8b", "codeqwen1.5-7b",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_cache_specs_any_batch(arch, batch, mesh_name):
    cfg = get_config(arch)
    mesh, rmesh = MESHES[mesh_name], _ref_mesh(mesh_name)
    for seq in (False, True):
        assert _canon(SH.kv_cache_spec(cfg, batch, mesh, seq_shard=seq)) \
            == _canon(RSH.kv_cache_spec(r_get_config(arch), batch, rmesh,
                                        seq_shard=seq))
    if cfg.ssm_version:
        got = SH.mamba_state_spec(cfg, batch, mesh)
        want = RSH.mamba_state_spec(r_get_config(arch), batch, rmesh)
        assert [_canon(s) for s in got] == [_canon(s) for s in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match(arch):
    """``data/pipeline.py::batch_specs``: meta tensors of the reference's
    ``ShapeDtypeStruct`` shapes and dtypes."""
    for name in SHAPES:
        got = batch_specs(get_config(arch), SHAPES[name])
        want = r_batch_specs(r_get_config(arch), R_SHAPES[name])
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_meshes_and_data_axis_size():
    assert MESHES["single"].shape == {"data": 16, "model": 16}
    assert MESHES["multi"].shape == {"pod": 2, "data": 16, "model": 16}
    assert data_axis_size(MESHES["single"]) == 16
    assert data_axis_size(MESHES["multi"]) == 32
    assert data_axis_size(AbstractMesh((4,), ("model",))) == 1
    tree = {"b": P("data"), "a": [P(), P(None, "model")]}
    got = SH.tree_shardings(tree, MESHES["single"])
    assert list(got["b"]) == [Shard(0), Replicate()]
    assert list(got["a"][0]) == [Replicate(), Replicate()]
    assert list(got["a"][1]) == [Replicate(), Shard(1)]


# --- the reference's tests/test_sharding_specs.py on the port's tables ----

def _check_tree(specs, shapes, mesh, where):
    flat_s, flat_a = leaves(specs), leaves(shapes)
    assert len(flat_s) == len(flat_a)
    for spec, arr in zip(flat_s, flat_a):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            prod = int(np.prod([mesh.shape[a] for a in names]))
            assert arr.shape[dim] % prod == 0, \
                f"{where}: dim {dim} of {tuple(arr.shape)} not divisible " \
                f"by {prod} ({spec})"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divide(arch, mesh_name):
    cfg = get_config(arch)
    mesh = MESHES[mesh_name]
    params = PM.init_params(None, cfg, device="meta")
    specs = SH.param_specs(params, cfg, mesh, fsdp=True)
    _check_tree(specs, params, mesh, f"{arch}/{mesh_name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tp_actually_shards_big_leaves(arch):
    """On the single-pod mesh, the big weights must not be replicated:
    per-device bytes must be <= total/256 x 4."""
    cfg = get_config(arch)
    mesh = MESHES["single"]
    params = PM.init_params(None, cfg, device="meta")
    specs = SH.param_specs(params, cfg, mesh, fsdp=True)
    total = sum(x.numel() * 2 for x in leaves(params))
    per_dev = 0
    for spec, arr in zip(leaves(specs), leaves(params)):
        shards = 1
        for entry in spec:
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            shards *= int(np.prod([mesh.shape[a] for a in names]))
        per_dev += arr.numel() * 2 // shards
    assert per_dev <= total / 256 * 4, \
        f"{arch}: per-device param bytes {per_dev/2**20:.0f}MiB vs " \
        f"total {total/2**20:.0f}MiB — sharding too weak"
    # absolute HBM sanity: fits a 16 GB chip with f32 moments (~5x bf16)
    assert per_dev * 5 < 16 * 2 ** 30


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["granite-8b", "gemma2-2b",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_decode_state_specs_divide(arch, mesh_name):
    cfg = get_config(arch)
    mesh = MESHES[mesh_name]
    for shape_name in ("decode_32k", "long_500k"):
        if shape_name == "long_500k" and arch not in (
                "falcon-mamba-7b", "zamba2-2.7b"):
            continue
        shp = SHAPES[shape_name]
        params = PM.init_params(None, cfg, device="meta")
        state = PM.init_decode_state(params, cfg, shp.global_batch,
                                     shp.seq_len)
        specs = SH.decode_state_specs(cfg, shp.global_batch, mesh,
                                      seq_shard=shape_name == "long_500k")
        _check_tree(specs.caches, state.caches, mesh,
                    f"{arch}/{shape_name}/{mesh_name}")


def test_kv_spec_prefers_heads_then_dhead():
    cfg_kv = get_config("codeqwen1.5-7b")   # kv=32 divisible
    mesh = MESHES["single"]
    spec = SH.kv_cache_spec(cfg_kv, 128, mesh)
    assert spec[2] == "model"
    cfg_dh = get_config("granite-8b")       # kv=8 -> shard d_head=128
    spec = SH.kv_cache_spec(cfg_dh, 128, mesh)
    assert spec[2] is None and spec[3] == "model"
