"""The port's training substrate (``repro_torch.train``: AdamW, the LR
schedules, ``loss_fn`` and its gradients, remat) against the JAX package's.

Weights are drawn from a numpy seed (``init_params`` with a
``numpy.random.Generator``) and copied into the reference's pytree.
Tolerances:

* AdamW, one to three updates on the same inputs: f32 parameters and the
  moments within 2e-6 relative (the same formula op for op, f32 rounding
  in a different order); bf16 parameters within one bf16 ulp (2^-8
  relative: the f32 result may fall on the other side of a rounding
  boundary); the grad norm within 1e-6 relative.
* Schedules: within 1e-6 relative (f32 ``cos``/``pow`` of two libraries).
* ``loss_fn`` for every arch at ``reduced``: the loss within 1e-5
  relative, each gradient leaf within 5e-5 of that leaf's largest
  gradient (f32 backward passes summed in other orders).
* ``remat=True`` against ``remat=False``: bit-equal (the same ops rerun).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_configs as ref_list_configs
from repro.configs import reduced as ref_reduced
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro_torch.configs import get_config, reduced
from repro_torch.models import convert
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.train import optimizer as PO
from repro_torch.train import train_step as PT
from repro_torch.tree import flatten, leaves
from torch_threads import one_thread  # noqa: F401

ARCHS = ref_list_configs()
CPU = torch.device("cpu")
B, S = 2, 32


def port_params(cfg, seed=0):
    return PM.init_params(np.random.default_rng(seed), cfg,
                          dtype=torch.float32, device=CPU)


def ref_tree(params):
    """A copy in the reference's pytree (no memory shared with ``params``,
    which the port updates in place)."""
    return jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                        convert.to_numpy(params))


def batch(cfg, seed=1):
    """Token ids (or (B, S, D) embeddings) and labels, the first three
    positions masked (< 0)."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    else:
        x = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    y = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    y[:, :3] = -1
    return x, y


def as_port(x):
    t = torch.from_numpy(np.asarray(x))
    return t if t.is_floating_point() else t.long()


def assert_leaves_close(got, want, rtol, what=""):
    """Each leaf within ``rtol`` of that leaf's largest |value|."""
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, f"{what} {i}: {err} > {rtol} x {scale}"


# -- the reference's suite, on the port ----------------------------------------

def test_adamw_minimizes_quadratic():
    target = torch.tensor([3.0, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = PO.adamw_init(params)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = PO.adamw_update(params, grads, state, lr=0.05,
                                           weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    state = PO.adamw_init(params)
    huge = {"w": torch.full((4,), 1e9)}
    _, state, gnorm = PO.adamw_update(params, huge, state, lr=1.0,
                                      grad_clip=1.0, weight_decay=0.0)
    assert float(gnorm) == pytest.approx(2e9, rel=1e-3)
    # after clipping, first-step |m_hat| <= 1 per coordinate group
    assert float(state.m["w"].abs().max()) <= 0.5 + 1e-6


def test_schedules():
    cos = PO.cosine_schedule(1.0, warmup=10, total=100, min_frac=0.1)
    assert float(cos(0)) == 0.0
    assert float(cos(10)) == pytest.approx(1.0)
    assert float(cos(100)) == pytest.approx(0.1, abs=1e-6)
    wsd = PO.wsd_schedule(1.0, warmup=10, stable=50, decay=20, min_frac=0.01)
    assert float(wsd(30)) == pytest.approx(1.0)
    assert float(wsd(60 + 20)) == pytest.approx(0.01, rel=1e-3)


# -- AdamW and the schedules against the reference ----------------------------

def _opt_case(seed, bf16):
    """A small parameter tree (a dict, a nested list) and three gradient
    trees, numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (7, 5), "layers": [{"a": (3,), "b": (4, 2)}, {"a": (3,),
                                                                 "b": (4, 2)}]}

    def draw(scale):
        def mk(s):
            if isinstance(s, dict):
                return {k: mk(v) for k, v in s.items()}
            if isinstance(s, list):
                return [mk(v) for v in s]
            return (rng.standard_normal(s) * scale).astype(np.float32)
        return mk(shapes)

    params = draw(0.5)
    if bf16:      # values exactly representable in bfloat16
        params = jax.tree.map(lambda a: np.asarray(
            torch.from_numpy(a).bfloat16().float()), params)
    return params, [draw(10.0 ** e) for e in (-3, 1, -9)]


def _port_tree(tree, dtype):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                        tree)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
@pytest.mark.parametrize("clip", [1.0, 1e6])
def test_adamw_matches_reference(bf16, lr_kind, clip):
    params, grad_steps = _opt_case(3, bf16)
    dtype = torch.bfloat16 if bf16 else torch.float32
    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    pp = _port_tree(params, dtype)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jdtype), params)
    pst, rst = PO.adamw_init(pp), RO.adamw_init(rp)
    for i, g in enumerate(grad_steps):
        lr = 1e-2 * (i + 1)
        plr = torch.tensor(lr) if lr_kind == "tensor" else lr
        pg = _port_tree(g, dtype)
        rg = jax.tree.map(lambda a: jnp.asarray(a, jdtype), g)
        pp, pst, pn = PO.adamw_update(pp, pg, pst, lr=plr, grad_clip=clip)
        rp, rst, rn = RO.adamw_update(rp, rg, rst, lr=jnp.float32(lr),
                                      grad_clip=clip)
        assert float(pn) == pytest.approx(float(rn), rel=1e-6)
        assert int(pst.step) == int(rst.step) == i + 1
        for what, a, b in (("m", pst.m, rst.m), ("v", pst.v, rst.v)):
            assert_leaves_close(leaves(a), jax.tree.leaves(b), 2e-6, what)
        for got, want in zip(leaves(pp), jax.tree.leaves(rp)):
            assert got.dtype == dtype
            w = np.asarray(want.astype(jnp.float32))
            g_ = got.float().numpy()
            if bf16:
                np.testing.assert_allclose(g_, w, rtol=2.0 ** -8, atol=0)
            else:
                np.testing.assert_allclose(g_, w, rtol=2e-6, atol=1e-7)


def test_adamw_updates_in_place_and_keeps_dtypes():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2)}
    ptrs = [t.data_ptr() for t in leaves(params)]
    st = PO.adamw_init(params)
    assert all(t.dtype == torch.float32 for t in leaves(st.m) + leaves(st.v))
    assert st.step.dtype == torch.int32
    out, st2, _ = PO.adamw_update(params, {"a": torch.ones(3),
                                           "b": torch.ones(2)}, st, lr=0.1)
    assert [t.data_ptr() for t in leaves(out)] == ptrs
    assert out["a"].dtype == torch.bfloat16 and st2.m is st.m
    assert float(out["b"][0]) < 1.0


def test_adamw_chunks_cover_every_leaf(monkeypatch):
    """The update in chunks of 10 elements (pieces of leaves, and chunks
    spanning leaves) equals the update in one chunk, bit for bit."""
    params, grad_steps = _opt_case(5, False)
    small = _port_tree(params, torch.float32)
    whole = _port_tree(params, torch.float32)
    s1, s2 = PO.adamw_init(small), PO.adamw_init(whole)
    g = _port_tree(grad_steps[0], torch.float32)
    monkeypatch.setattr(PO, "GROUP", 10)
    PO.adamw_update(small, g, s1, lr=0.1)
    monkeypatch.setattr(PO, "GROUP", 1 << 28)
    PO.adamw_update(whole, g, s2, lr=0.1)
    for a, b in zip(leaves((small, s1)), leaves((whole, s2))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,make", [
    ("cosine", lambda M: M.cosine_schedule(3e-4, 10, 100)),
    ("cosine min_frac", lambda M: M.cosine_schedule(1.0, 0, 7, 0.2)),
    ("wsd", lambda M: M.wsd_schedule(1e-3, 10, 70, 20)),
    ("wsd no warmup", lambda M: M.wsd_schedule(0.5, 0, 3, 5, 0.05)),
])
def test_schedules_match_reference(name, make):
    port, ref = make(PO), make(RO)
    for step in list(range(0, 120, 3)) + [9, 10, 11, 79, 80, 81, 99, 100]:
        want = float(ref(jnp.int32(step)))
        for got in (port(step), port(torch.tensor(step, dtype=torch.int32))):
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


# -- the loss and its gradients ----------------------------------------------------

@pytest.fixture(scope="module")
def ref_grad_fns():
    cache = {}

    def get(name):
        if name not in cache:
            rcfg = ref_reduced(ref_get_config(name))
            cache[name] = jax.jit(jax.value_and_grad(
                lambda p, x, y: RT.loss_fn(p, x, y, rcfg), has_aux=True))
        return cache[name]
    return get


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name, ref_grad_fns):
    cfg = reduced(get_config(name))
    params = port_params(cfg)
    x, y = batch(cfg)
    (rtotal, (rloss, raux)), rgrads = ref_grad_fns(name)(
        ref_tree(params), jnp.asarray(x), jnp.asarray(y))
    grads, loss, aux = PT.grads_of(params, as_port(x), as_port(y), cfg)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    assert float(aux) == pytest.approx(float(raux), rel=1e-5, abs=1e-7)
    total, _ = PT.loss_fn(params, as_port(x), as_port(y), cfg)
    assert float(total) == pytest.approx(float(rtotal), rel=1e-5)
    got, want = leaves(grads), jax.tree.leaves(rgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    assert_leaves_close(got, want, 5e-5, name)


@pytest.mark.parametrize("name", ["musicgen-medium", "internvl2-76b"])
def test_unused_embedding_gets_zero_grad(name):
    """An ``embed_inputs`` arch never reads its embedding table: torch
    gives ``None``, jax zeros; the port gives zeros."""
    cfg = reduced(get_config(name))
    params = port_params(cfg)
    x, y = batch(cfg)
    grads, _, _ = PT.grads_of(params, as_port(x), as_port(y), cfg)
    assert grads["embed"].shape == params["embed"].shape
    assert not grads["embed"].any()
    assert grads["lm_head"].any()


@pytest.mark.parametrize("name", ARCHS)
def test_remat_equals_no_remat(name):
    cfg = reduced(get_config(name))
    params = port_params(cfg)
    x, y = batch(cfg)
    a = PT.grads_of(params, as_port(x), as_port(y), cfg, remat=False)
    b = PT.grads_of(params, as_port(x), as_port(y), cfg, remat=True)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    for g, h in zip(leaves(a[0]), leaves(b[0])):
        assert torch.equal(g, h)
    la, _ = PM.forward(params, as_port(x), cfg, remat=False)
    lb, _ = PM.forward(params, as_port(x), cfg, remat=True)
    assert torch.equal(la, lb)


def test_softcap_backward_through_gemma2():
    """gemma2's softcaps (attention 50, final 30) sit on the backward path;
    tanh's saved output must survive the multiply."""
    x = torch.linspace(-200.0, 200.0, 101, requires_grad=True)
    PL.softcap(x, 30.0).sum().backward()
    want = 1.0 - torch.tanh(x.detach() / 30.0) ** 2
    torch.testing.assert_close(x.grad, want, rtol=1e-6, atol=1e-7)
    cfg = reduced(get_config("gemma2-2b"))
    assert cfg.attn_softcap and cfg.final_softcap
    params = port_params(cfg)
    x, y = batch(cfg)
    grads, loss, _ = PT.grads_of(params, as_port(x), as_port(y), cfg)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in leaves(grads))


def test_eval_step_is_the_loss():
    cfg = reduced(get_config("granite-8b"))
    params = port_params(cfg)
    x, y = batch(cfg)
    b = {"tokens": as_port(x), "labels": as_port(y)}
    got = PT.make_eval_step(cfg)(params, b)
    assert not got.requires_grad
    _, (want, _) = PT.loss_fn(params, b["tokens"], b["labels"], cfg)
    assert torch.equal(got, want)


def test_train_state_leaf_order_is_the_reference():
    """``TrainState``'s leaves flatten in ``jax.tree.flatten``'s order, so
    checkpoints and the compressor's coordinate offsets agree."""
    from repro.train.compress import DisketchCompressor as RC
    from repro_torch.train.compress import DisketchCompressor as PC
    cfg = reduced(get_config("zamba2-2.7b"))
    params = port_params(cfg)
    pst = PT.init_train_state(params, PC(width=64))
    rst = RT.init_train_state(ref_tree(params), RC(width=64))
    got, want = leaves(pst), jax.tree.leaves(rst)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert [str(t.dtype).split(".")[-1] for t in got] == \
        [str(w.dtype) for w in want]
    flat = flatten(pst.params)[0]
    for t, (_, w) in zip(flat, jax.tree_util.tree_flatten_with_path(
            rst.params)[0]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_tree_walks_leave_no_cycle():
    """``flatten``, ``unflatten``, ``tree_map`` and ``str(treedef)`` free
    their leaves as soon as the caller drops them, with the garbage
    collector off: a walk that held them in a reference cycle kept a
    full-width state's tensors alive until a full collection."""
    import gc
    import weakref

    from repro_torch.tree import tree_map
    t = torch.zeros(3)
    ref = weakref.ref(t)
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        tree = {"b": [t, (t,)], "a": PO.OptState(t, t, t)}
        xs, treedef = flatten(tree)
        str(treedef)
        back = treedef.unflatten(xs)
        mapped = tree_map(lambda x: x, back)
        assert isinstance(mapped["a"], PO.OptState) and len(xs) == 5
        del t, tree, xs, treedef, back, mapped
        assert ref() is None
    finally:
        if was:
            gc.enable()
