"""The port's sharding vocabulary (``repro_torch.models.sharding``) held to
the reference's ``repro.models.sharding``: ``norm_spec`` and
``batch_spec`` on the same specs under environments of the same axis
names, ``active_axes``/``active_sizes``, ``placements``, and ``shard``
as the identity with no environment or on a plain tensor (the unsharded
path stays bit for bit what it was).  No process group is started here:
``shard`` on DTensors runs in ``test_torch_distributed.py``'s ranks.
Exact comparisons throughout."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.models import sharding as RS
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as PM
from repro_torch.models import sharding as S
from repro_torch.models.sharding import P

MESHES = {"host": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "pod": ((2, 2, 2), ("pod", "data", "model")),
          "model": ((4,), ("model",))}
SPECS = [(), (None,), ("data",), (("pod", "data"), None),
         (("pod", "data"), None, "model"), (None, "model", None, None),
         ("pod",), (("data", "model"),), ("switch", "model"),
         (("pod",), ("switch",), None)]


def _canon(spec):
    return None if spec is None else [
        None if e is None else ([e] if isinstance(e, str) else list(e))
        for e in spec]


@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_norm_spec_matches_reference(mesh, spec):
    sizes, names = MESHES[mesh]
    rmesh = jax.make_mesh(sizes, names)
    with RS.sharding_env(rmesh):
        want = RS.norm_spec(JP(*spec))
        want_b = [RS.batch_spec(n) for n in (1, 3)]
    with S.sharding_env(AbstractMesh(sizes, names)):
        got = S.norm_spec(P(*spec))
        got_b = [S.batch_spec(n) for n in (1, 3)]
    assert _canon(got) == _canon(want)
    assert [_canon(b) for b in got_b] == [_canon(b) for b in want_b]
    assert S.norm_spec(P(*spec)) is None          # no env: inactive


def test_active_axes_and_sizes_nest():
    assert S.active_axes() == () and S.active_sizes() == {}
    assert S.active_mesh() is None
    outer = AbstractMesh((2, 4), ("data", "model"))
    inner = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    with S.sharding_env(outer):
        assert S.active_axes() == ("data", "model")
        assert S.active_sizes() == {"data": 2, "model": 4}
        with S.sharding_env(inner):
            assert S.active_axes() == ("pod", "data", "model")
            assert S.active_mesh() is inner
        assert S.active_sizes() == {"data": 2, "model": 4}
    assert S.active_axes() == ()


def test_shard_is_the_identity_without_a_sharded_tensor():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert S.shard(x, S.BATCH_AXES, None, S.MODEL_AXIS) is x
    with S.sharding_env(AbstractMesh((2, 2), ("data", "model"))):
        assert S.shard(x, S.BATCH_AXES, None, S.MODEL_AXIS) is x
        assert S.shard(x, "model") is x


def test_unsharded_model_is_unchanged_under_an_env():
    """A plain-tensor forward inside an env equals the forward outside
    it bit for bit (every annotation passes plain tensors through)."""
    cfg = reduced(get_config("gemma2-2b"), n_layers=2)
    params = PM.init_params(np.random.default_rng(0), cfg,
                            dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)))
    want, _ = PM.forward(params, toks, cfg)
    with S.sharding_env(AbstractMesh((2, 2), ("data", "model"))):
        got, _ = PM.forward(params, toks, cfg, sp=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("spec,mesh,want", [
    (P(("pod", "data"), None, "model"), "pod",
     [Shard(0), Shard(0), Shard(2)]),
    (P(None, "model"), "2x2", [Replicate(), Shard(1)]),
    (P("data", "model"), "host", [Replicate(), Replicate()]),
    (P(), "pod", [Replicate()] * 3),
    (P(None, None, ("data",)), "2x2", [Shard(2), Replicate()]),
    (P("model", "switch"), "model", [Shard(0)]),
], ids=str)
def test_placements(spec, mesh, want):
    assert S.placements(spec, AbstractMesh(*MESHES[mesh])) == want


def test_placements_refuse_one_axis_on_two_dims():
    with pytest.raises(ValueError, match="shards two"):
        S.placements(P("data", "data"), AbstractMesh(*MESHES["2x2"]))


@pytest.mark.parametrize("shape,spec,want", [
    ((8, 6), P(("pod", "data"), "model"), P(("pod", "data"), None)),
    ((6, 8), P(("pod", "data"), "model"), P(None, "model")),
    ((4,), P("data", "model"), P("data", None)),
    ((3, 4, 5), P(None, None, None), P(None, None, None)),
], ids=str)
def test_divisible_spec(shape, spec, want):
    sizes = {"pod": 2, "data": 2, "model": 4}
    assert S.divisible_spec(spec, shape, sizes) == want


def test_zeros_without_an_env_is_torch_zeros():
    z = S.zeros((2, 3), P("data", None), torch.bfloat16, "cpu")
    assert type(z) is torch.Tensor and z.dtype == torch.bfloat16
    assert torch.equal(z, torch.zeros(2, 3, dtype=torch.bfloat16))


def test_local_shape():
    mesh = AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    assert S.local_shape((8, 12, 5), [Shard(0), Shard(0), Shard(1)],
                         mesh) == (2, 3, 5)
    with pytest.raises(ValueError, match="evenly"):
        S.local_shape((6, 5), [Replicate(), Replicate(), Shard(1)], mesh)
