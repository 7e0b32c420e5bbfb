"""The sharded model on real ranks: a gloo process group of 4 CPU ranks
and ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``("data", "model")`` meshes
over it, the parameters, batches and decode state DTensors placed by
``launch/shardings.py``, each run held to the port's own unsharded run
from the same numpy-seeded f32 weights (rank 0 reports).

Tolerances (the reference's own, ``tests/test_models.py`` and
``tests/test_distributed.py``):
  * forward (``sp`` on and off, FSDP on) and prefill: 2e-4, decode 3e-4
    (absolute and relative);
  * a train step (FSDP, ``sp``, remat): loss and grad norm 1e-5
    relative; parameters 1e-5 of the tree's largest |value|, but for at
    most 1 coordinate in 10^4, all within twice the learning rate
    (Adam's eps-scale gradients, as the train phase's rule);
  * ``moe_ffn_ep`` against ``moe_ffn_gspmd``: 2e-5 forward, 1e-4 aux,
    5e-5 gradients; ``set_attn_opt`` decode against the baseline: 2e-4;
  * the data-parallel compressor (``axis_names``) on the 4 ranks of
    ``(4, 1)`` against the reference inside ``jax.shard_map`` over 4 host
    devices (ROADMAP C18): bit for bit.  The gradients are multiples of
    1/8 below 2^10, so every sketch sum is exact in f32 in any order:
    the psum's order and the all-reduce's cannot differ;
  * the port's ``(2, 2)`` sharded forward against the reference's sharded
    forward on an Auto mesh of 4 forced host devices (ROADMAP C16): 2e-4.

One spawn of 4 ranks runs the three meshes in turn, each a
``DeviceMesh`` over the same gloo group.  The group lives only in the
child processes (``launch.process_group`` with a ``FileStore`` under the
test's temporary directory, so parallel test workers never share a
port); this file is also the children's script.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
# per mesh: archs for forward/prefill/decode, archs for a train step
PLAN = {"2x2": (["gemma2-2b", "granite-8b", "olmoe-1b-7b", "zamba2-2.7b",
                 "falcon-mamba-7b"], ["gemma2-2b", "olmoe-1b-7b"]),
        "1x4": (["gemma2-2b", "zamba2-2.7b"], ["gemma2-2b"]),
        "4x1": (["granite-8b", "falcon-mamba-7b"], ["granite-8b"])}
LR = 1e-3


# --- the child side ---------------------------------------------------------

def _cfg(arch):
    from repro_torch.configs import get_config, reduced
    return reduced(get_config(arch), n_layers=2)


def _inputs(cfg, b=4, s=32, seed=1):
    import torch
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return torch.from_numpy(rng.standard_normal((b, s, cfg.d_model),
                                                    dtype=np.float32))
    return torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))


def _rel(got, want):
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-30))


def _err(got, want):
    """max |got - want| / (1 + |want|): 1 means off by atol + rtol."""
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def _model_checks(mesh, out):
    import torch

    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as PM
    from repro_torch.models.sharding import sharding_env

    archs, train_archs = PLAN[out["mesh"]]
    for arch in archs:
        cfg = _cfg(arch)
        params = PM.init_params(np.random.default_rng(0), cfg,
                                dtype=torch.float32, device="cpu")
        toks = _inputs(cfg)
        want, _ = PM.forward(params, toks, cfg)
        dp = SH.place(params, SH.param_specs(params, cfg, mesh), mesh)
        dt = SH.place({"t": toks}, SH.batch_specs_of({"t": toks}, mesh),
                      mesh)["t"]
        for sp in (False, True):
            with sharding_env(mesh):
                got, _ = PM.forward(dp, dt, cfg, sp=sp)
            out[f"forward {arch} sp={sp}"] = _err(got.full_tensor(), want)
        st = PM.init_decode_state(params, cfg, 4, 40, dtype=torch.float32)
        lp, st = PM.prefill(params, toks[:, :-1], cfg, st)
        ld, _ = PM.decode_step(params, toks[:, -1], cfg, st)
        dp = SH.place(params, SH.param_specs(params, cfg, mesh, fsdp=False),
                      mesh)
        with sharding_env(mesh):
            st = PM.init_decode_state(dp, cfg, 4, 40, dtype=torch.float32,
                                      specs=SH.decode_state_specs(cfg, 4,
                                                                  mesh))
            lp2, st = PM.prefill(dp, dt[:, :-1], cfg, st)
            ld2, st = PM.decode_step(dp, dt[:, -1], cfg, st)
        out[f"prefill {arch}"] = _err(lp2.full_tensor(), lp)
        out[f"decode {arch}"] = _err(ld2.full_tensor(), ld)
        if arch == "gemma2-2b" and out["mesh"] == "2x2":
            np.save(out["dir"] + "/c16_logits.npy",
                    got.full_tensor().numpy())          # sp on, FSDP on
    for arch in train_archs:
        out.update(_train_check(mesh, arch))


def _train_check(mesh, arch):
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as PM
    from repro_torch.models.sharding import sharding_env
    from repro_torch.train.optimizer import cosine_schedule
    from repro_torch.train.train_step import init_train_state, \
        make_train_step
    from repro_torch.tree import leaves

    cfg = _cfg(arch)
    batch = {k: torch.from_numpy(v).long() for k, v in
             SyntheticLM(cfg.vocab, 32, 4, seed=3).batch(0).items()}
    step = make_train_step(cfg, cosine_schedule(LR, 0, 10), remat=True,
                           sp=True)

    def fresh():
        return PM.init_params(np.random.default_rng(0), cfg,
                              dtype=torch.float32, device="cpu")

    s0, m0 = step(init_train_state(fresh()), batch)
    p1 = fresh()
    dp = SH.place(p1, SH.param_specs(p1, cfg, mesh, fsdp=True), mesh)
    db = SH.place(batch, SH.batch_specs_of(batch, mesh), mesh)
    with sharding_env(mesh):
        s1, m1 = step(init_train_state(dp), db)
    want = [p.float() for p in leaves(s0.params)]
    got = [p.full_tensor().float() for p in leaves(s1.params)]
    top = max(float(w.abs().max()) for w in want)
    errs = [(g - w).abs() for g, w in zip(got, want)]
    return {f"train {arch} loss": abs(float(m1["loss"]) / float(m0["loss"])
                                      - 1),
            f"train {arch} grad_norm": abs(float(m1["grad_norm"])
                                           / float(m0["grad_norm"]) - 1),
            f"train {arch} params off": sum(int((e > 1e-5 * top).sum())
                                            for e in errs),
            f"train {arch} params n": sum(e.numel() for e in errs),
            f"train {arch} params worst": max(float(e.max()) for e in errs)}


def _moe_checks(mesh, out):
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import shardings as SH
    from repro_torch.models import moe as X
    from repro_torch.models.sharding import sharding_env
    from repro_torch.tree import flatten

    cfg = reduced(get_config("olmoe-1b-7b"), n_experts=8, top_k=2,
                  d_model=64, d_expert=32)
    p = X.init_moe(np.random.default_rng(0), cfg, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, 64), dtype=np.float32))
    specs = {k: SH._param_spec(f"['moe'][{k!r}]", tuple(v.shape), mesh)
             for k, v in p.items()}
    dp = SH.place(p, specs, mesh)
    dx = SH.place({"x": x}, SH.batch_specs_of({"x": x}, mesh), mesh)["x"]
    res = {}
    with sharding_env(mesh):
        for impl in ("gspmd", "ep"):
            X.set_impl(impl)
            o, a = X.moe_ffn(dx, dp, cfg)
            res[impl] = (o.full_tensor(), float(a.full_tensor()))
    X.set_impl("gspmd")
    out["ep forward"] = _rel(res["ep"][0], res["gspmd"][0])
    out["ep aux"] = abs(res["ep"][1] / res["gspmd"][1] - 1)

    cfg = reduced(get_config("deepseek-moe-16b"), n_experts=8, top_k=2,
                  d_model=64, d_expert=32, n_shared_experts=1)
    p = X.init_moe(np.random.default_rng(2), cfg, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, 64), dtype=np.float32))
    leaves_, treedef = flatten(p)
    paths = SH.keystr_paths(p)
    specs = treedef.unflatten([SH._param_spec("['moe']" + k, tuple(v.shape),
                                              mesh) for k, v in paths])
    dx = SH.place({"x": x}, SH.batch_specs_of({"x": x}, mesh), mesh)["x"]
    grads = {}
    for impl in ("gspmd", "ep"):
        X.set_impl(impl)
        dp = SH.place(p, specs, mesh)
        ins = [t.detach().requires_grad_() for t in flatten(dp)[0]]
        with sharding_env(mesh):
            o, a = X.moe_ffn(dx, treedef.unflatten(ins), cfg)
            loss = (o ** 2).mean() + 0.01 * a
            gs = torch.autograd.grad(loss, ins)
        grads[impl] = [g.full_tensor() for g in gs]
    X.set_impl("gspmd")
    out["ep grads"] = max(_err(g, w) for g, w in zip(grads["ep"],
                                                     grads["gspmd"]))
    out["ep engaged"] = (mesh.size(1) > 1)


def _attn_opt_checks(mesh, out):
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import shardings as SH
    from repro_torch.models import layers as LY
    from repro_torch.models import model as PM
    from repro_torch.models.sharding import sharding_env

    # kv=2 against model=4 (1x4) exercises the d_head path
    cfg = reduced(get_config("granite-8b"), n_heads=4, n_kv_heads=2,
                  d_head=32, n_layers=2)
    params = PM.init_params(np.random.default_rng(0), cfg,
                            dtype=torch.float32, device="cpu")
    toks = _inputs(cfg, 4, 24)
    dp = SH.place(params, SH.param_specs(params, cfg, mesh, fsdp=False),
                  mesh)
    dt = SH.place({"t": toks}, SH.batch_specs_of({"t": toks}, mesh),
                  mesh)["t"]
    outs = {}
    for opt in (False, True):
        LY.set_attn_opt(opt)
        with sharding_env(mesh):
            st = PM.init_decode_state(dp, cfg, 4, 32, dtype=torch.float32,
                                      specs=SH.decode_state_specs(cfg, 4,
                                                                  mesh))
            lp, st = PM.prefill(dp, dt[:, :-1], cfg, st)
            ld, _ = PM.decode_step(dp, dt[:, -1], cfg, st)
        outs[opt] = (lp.full_tensor(), ld.full_tensor())
    LY.set_attn_opt(False)
    out["attn_opt prefill"] = _err(outs[True][0], outs[False][0])
    out["attn_opt decode"] = _err(outs[True][1], outs[False][1])


def compressor_grads(rank, shapes=((8, 6), (40,), (5, 5, 3))):
    """Rank ``rank``'s gradients: multiples of 1/8 in [-64, 64)."""
    rng = np.random.default_rng(100 + rank)
    return [rng.integers(-512, 512, s).astype(np.float32) / 8
            for s in shapes]


COMP = dict(width=16, depth=3, n_sub=2, k_frac=0.2, seed=3)


def _compressor_check(mesh, out, rank):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.sharding import sharding_env
    from repro_torch.train.compress import DisketchCompressor

    comp = DisketchCompressor(axis_names=("data",), **COMP)
    grads = [torch.from_numpy(g) for g in compressor_grads(rank)]
    state = comp.init(grads)
    res = []
    with sharding_env(mesh):
        for step in range(2):
            g, state = comp.apply([t.clone() for t in grads], state,
                                  torch.tensor(step))
            res.append([t.numpy().tolist() for t in g])
    allres = [None] * dist.get_world_size()
    dist.all_gather_object(allres, res)
    out["compressor"] = allres
    placed = [distribute_tensor(t, mesh, [Shard(0), Replicate()])
              for t in grads]
    try:
        comp.apply(placed, comp.init(grads), torch.tensor(0))
        out["compressor refuses DTensors"] = ""
    except TypeError as e:
        out["compressor refuses DTensors"] = str(e)


WORLD = 4


def _rank(rank, store, outdir):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import make_mesh, process_group

    torch.set_num_threads(1)
    with process_group("gloo", WORLD, rank,
                       store=dist.FileStore(store, WORLD)):
        for name, shape in MESHES.items():
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            out = {"mesh": name, "dir": outdir}
            _model_checks(mesh, out)
            if name in ("2x2", "1x4"):
                _moe_checks(mesh, out)
                _attn_opt_checks(mesh, out)
            if name == "4x1":
                _compressor_check(mesh, out, rank)
            if rank == 0:
                with open(os.path.join(outdir, f"{name}.json"), "w") as f:
                    json.dump(out, f)


def _main(argv):
    import torch.multiprocessing as mp

    outdir = argv[0]
    mp.spawn(_rank, args=(os.path.join(outdir, "store"), outdir),
             nprocs=WORLD)


# --- the test side ----------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run the 4 ranks over the three meshes; their reports by mesh."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    d = tmp_path_factory.mktemp("world")
    p = subprocess.run([sys.executable, __file__, str(d)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, f"{p.stdout[-3000:]}\n{p.stderr[-6000:]}"
    return {name: json.loads((d / f"{name}.json").read_text())
            for name in MESHES}


def _cases(kind):
    return [(m, a) for m, (archs, train) in PLAN.items()
            for a in (train if kind == "train" else archs)]


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("mesh,arch", _cases("model"))
def test_sharded_forward(worlds, mesh, arch, sp):
    assert worlds[mesh][f"forward {arch} sp={sp}"] <= 2e-4


@pytest.mark.parametrize("mesh,arch", _cases("model"))
def test_sharded_prefill_and_decode(worlds, mesh, arch):
    assert worlds[mesh][f"prefill {arch}"] <= 2e-4
    assert worlds[mesh][f"decode {arch}"] <= 3e-4


@pytest.mark.parametrize("mesh,arch", _cases("train"))
def test_sharded_train_step(worlds, mesh, arch):
    w = worlds[mesh]
    assert w[f"train {arch} loss"] <= 1e-5
    assert w[f"train {arch} grad_norm"] <= 1e-5
    assert w[f"train {arch} params off"] <= 1e-4 * w[f"train {arch} params n"]
    assert w[f"train {arch} params worst"] <= 2 * LR


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_moe_ep_matches_gspmd(worlds, mesh):
    w = worlds[mesh]
    assert w["ep engaged"]
    assert w["ep forward"] <= 2e-5
    assert w["ep aux"] <= 1e-4


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_moe_ep_gradients_match(worlds, mesh):
    assert worlds[mesh]["ep grads"] <= 5e-5


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_attn_opt_matches_baseline(worlds, mesh):
    assert worlds[mesh]["attn_opt prefill"] <= 2e-4
    assert worlds[mesh]["attn_opt decode"] <= 2e-4


def test_data_parallel_compressor_refuses_dtensor_grads(worlds):
    """The data-parallel compressor takes each rank's own gradients; global
    (DTensor) gradients are refused, pointing at ``axis_names``."""
    assert "axis_names" in worlds["4x1"]["compressor refuses DTensors"]


def test_data_parallel_compressor_matches_shard_map(worlds, multidevice):
    """C18: the reference's compressor runs with ``axis_names`` only inside
    ``jax.shard_map``; there, over 4 host devices, each worker's output is
    the port's rank's, bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.train.compress import CompressorState, DisketchCompressor

    comp = DisketchCompressor(axis_names=("data",), **COMP)
    per = [compressor_grads(r) for r in range(4)]
    stacked = [jnp.asarray(np.stack([p[i] for p in per]))
               for i in range(len(per[0]))]
    mesh = jax.make_mesh((4,), ("data",), devices=jax.devices()[:4])

    def worker(gs, rs, step):
        gs = [g[0] for g in gs]
        st = CompressorState(residual=[r[0] for r in rs])
        out, st = comp.apply(gs, st, step)
        return [o[None] for o in out], [r[None] for r in st.residual]

    f = jax.jit(jax.shard_map(worker, mesh=mesh,
                              in_specs=(JP("data"), JP("data"), JP()),
                              out_specs=(JP("data"), JP("data"))))
    resid = [jnp.zeros_like(g) for g in stacked]
    want = []
    for step in range(2):
        out, resid = f(stacked, resid, jnp.int32(step))
        want.append([np.asarray(o) for o in out])
    got = worlds["4x1"]["compressor"]
    for r in range(4):
        for step in range(2):
            for g, w in zip(got[r][step], want[step]):
                np.testing.assert_array_equal(np.asarray(g, np.float32),
                                              w[r])
    assert any(np.any(w[0] != 0) for w in want[0])


def test_sharded_forward_matches_the_reference_sharded(worlds, multidevice):
    """C16: the reference's sharded forward, on a mesh built with Auto axis
    types (its own meshes fail under this jax), of the same weights and
    tokens, against the port's (2, 2) sharded forward."""
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import AxisType

    from repro.configs import get_config, reduced
    from repro.models import model as RM
    from repro.models import sharding as RS
    from repro_torch.models import convert
    from repro_torch.models import model as PM

    params = PM.init_params(np.random.default_rng(0), _cfg("gemma2-2b"),
                            dtype=torch.float32, device="cpu")
    cfg = reduced(get_config("gemma2-2b"), n_layers=2)
    rp = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                      convert.to_numpy(params))
    toks = jnp.asarray(_inputs(_cfg("gemma2-2b")).numpy().astype(np.int32))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    with RS.sharding_env(mesh):
        want, _ = jax.jit(lambda p, t: RM.forward(p, t, cfg, sp=True))(
            rp, toks)
    want = np.asarray(want)
    got = np.load(Path(worlds["2x2"]["dir"]) / "c16_logits.npy")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    _main(sys.argv[1:])
