"""The port's DiSketch gradient compressor (``repro_torch.train.compress``)
against the JAX package's.

The reference's own compressor tests (``tests/test_train.py``) carried
over, then parity on the same inputs: the hash, ``sketch``, ``estimate``
(depth 3 and 4: the even-depth median is the midpoint of the two middle
rows) and three ``apply`` steps, with chunks smaller than a leaf and
chunks spanning several leaves.  The CPU's ``index_add_`` adds in index
order, as XLA's scatter does on the CPU, so every comparison here is
exact (``array_equal``).  Then the port's own parts: the radix select
against ``torch.topk`` (ties and zeros included), the coordinate keys (the
low 32 bits of int64 offsets in ``jax.tree.flatten`` order, past 2^32),
and the refusal of ``axis_names``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.compress import CompressorState as RS
from repro.train.compress import DisketchCompressor as RC
from repro_torch.train import compress as PCm
from repro_torch.train.compress import CompressorState as PS
from repro_torch.train.compress import DisketchCompressor as PC
from repro_torch.tree import chunks, flatten, leaves, tree_map
from torch_threads import one_thread  # noqa: F401


# -- the reference's suite, on the port ----------------------------------------

def test_compressor_recovers_heavy_coords():
    comp = PC(width=1 << 12, depth=5, n_sub=1, k_frac=0.02)
    params = {"a": torch.zeros(5000), "b": torch.zeros((100, 50))}
    state = comp.init(params)
    a, b = torch.zeros(5000), torch.zeros((100, 50))
    a[7], a[99], b[3, 4] = 50.0, -80.0, 120.0
    out, state = comp.apply({"a": a, "b": b}, state, torch.tensor(0))
    assert float(out["a"][99]) == pytest.approx(-80.0, rel=0.05)
    assert float(out["b"][3, 4]) == pytest.approx(120.0, rel=0.05)
    # residual retains what was not applied
    resid_mass = sum(float(r.abs().sum()) for r in leaves(state.residual))
    assert resid_mass < 60.0  # most mass applied


def test_compressor_error_feedback_accumulates():
    """A coordinate below top-k threshold accumulates until recovered."""
    comp = PC(width=1 << 10, depth=5, n_sub=1,
              k_frac=0.001)  # k=1: only the heaviest
    state = comp.init({"a": torch.zeros(2000)})
    applied = np.zeros(2000)
    for step in range(6):
        g = torch.zeros(2000)
        g[11], g[500] = 10.0, 4.0
        out, state = comp.apply({"a": g}, state, torch.tensor(step))
        applied += out["a"].numpy()
    # heavy coord 11 applied ~every step; coord 500 eventually surfaces
    assert applied[11] > 30.0
    resid = float(state.residual["a"][500])
    assert applied[500] + resid == pytest.approx(24.0, rel=0.1)


def test_compressor_subepochs_partition_coords():
    comp = PC(width=1 << 10, depth=3, n_sub=4, k_frac=0.5)
    state = comp.init({"a": torch.zeros(4096)})
    touched = np.zeros(4096, bool)
    per_step = []
    for step in range(4):
        out, state = comp.apply({"a": torch.ones(4096)}, state,
                                torch.tensor(step))
        nz = out["a"].numpy() != 0
        per_step.append(nz.sum())
        touched |= nz
    # temporal confinement: each step touches only ~1/n_sub of coords
    assert max(per_step) < 4096 / 4 * 1.3
    # over one full epoch every subepoch class was eligible; sketch
    # sign-collisions may drop some below the top-k threshold
    assert touched.mean() > 0.75


# -- parity with the reference ----------------------------------------------------

SHAPES = {"embed": (300, 16), "final_norm": (16,),
          "layers": [{"attn": {"wq": (16, 2, 8), "wk": (16, 1, 8),
                               "wv": (16, 1, 8), "wo": (2, 8, 16)},
                      "ln1": (16,)} for _ in range(2)],
          "lm_head": (16, 300)}


def _draw(rng, scale=1.0):
    def mk(s):
        if isinstance(s, dict):
            return {k: mk(v) for k, v in s.items()}
        if isinstance(s, list):
            return [mk(v) for v in s]
        x = rng.standard_normal(s) * scale
        x[rng.random(s) < 0.9] *= 1e-3           # a few heavy coordinates
        return x.astype(np.float32)
    return mk(SHAPES)


def _port(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _ref(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.array(a)), tree)


def _hashes(comp, idx, seeds):
    return [comp._hash(idx, s) for s in seeds]


def test_hash_matches_reference():
    keys = np.concatenate([np.arange(1000), [2 ** 31 - 1, 2 ** 31,
                                             2 ** 32 - 1]]).astype(np.uint32)
    port, ref = PC(seed=7), RC(seed=7)
    seeds = [port._row_seed(r) for r in range(4)] + [7 * 31 + 5]
    got = _hashes(port, torch.from_numpy(keys.astype(np.int64)), seeds)
    want = _hashes(ref, jnp.asarray(keys), seeds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))
    for r in range(4):
        col, sgn = port._col_sign(torch.from_numpy(keys.astype(np.int64)),
                                  port._row_seed(r))
        rcol, rsgn = ref._col_sign(jnp.asarray(keys), ref._row_seed(r))
        np.testing.assert_array_equal(col.numpy(), np.asarray(rcol))
        np.testing.assert_array_equal(sgn.numpy(), np.asarray(rsgn))


@pytest.mark.parametrize("depth", [3, 4, 5])
def test_sketch_and_estimate_match_reference(depth):
    rng = np.random.default_rng(depth)
    d, width = 5000, 257
    vec = rng.standard_normal(d).astype(np.float32)
    active = rng.random(d) < 0.6
    idx = np.arange(d, dtype=np.uint32)
    port, ref = PC(width=width, depth=depth, seed=2), \
        RC(width=width, depth=depth, seed=2)
    pidx = torch.from_numpy(idx.astype(np.int64))
    sk = port.sketch(torch.from_numpy(vec), pidx, torch.from_numpy(active))
    rsk = ref.sketch(jnp.asarray(vec), jnp.asarray(idx), jnp.asarray(active))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(rsk))
    # in chunks, added into one sketch: the same sums in the same order
    again = torch.zeros_like(sk)
    for lo in range(0, d, 1234):
        port.sketch(torch.from_numpy(vec[lo:lo + 1234]), pidx[lo:lo + 1234],
                    torch.from_numpy(active[lo:lo + 1234]), out=again)
    np.testing.assert_array_equal(again.numpy(), sk.numpy())
    est = port.estimate(sk, pidx)
    np.testing.assert_array_equal(est.numpy(),
                                  np.asarray(ref.estimate(rsk,
                                                          jnp.asarray(idx))))


def test_even_depth_median_is_the_midpoint():
    """Depth 4: the mean of the two middle row estimates, not
    ``torch.median``'s lower one."""
    comp = PC(width=64, depth=4)
    idx = torch.arange(50)
    sk = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 64)).astype(np.float32))
    rows = torch.stack([sk[r][comp._col_sign(idx, comp._row_seed(r))[0]]
                        * comp._col_sign(idx, comp._row_seed(r))[1]
                        for r in range(4)])
    srt = rows.sort(dim=0).values
    want = (srt[1] + srt[2]) * 0.5
    got = comp.estimate(sk, idx)
    assert torch.equal(got, want)
    assert not torch.equal(got, rows.median(dim=0).values)


@pytest.mark.parametrize("depth,n_sub,chunk", [(4, 2, 1 << 26), (4, 2, 1000),
                                              (3, 1, 777), (4, 4, 4800),
                                              (5, 2, 64)])
def test_apply_matches_reference(depth, n_sub, chunk, monkeypatch):
    """Three steps: the recovered gradients and the residual equal the
    reference's; a chunk may be a part of a leaf or span several."""
    monkeypatch.setattr(PCm, "CHUNK", chunk)
    rng = np.random.default_rng(depth * 10 + n_sub)
    port = PC(width=512, depth=depth, n_sub=n_sub, k_frac=0.03, seed=1)
    ref = RC(width=512, depth=depth, n_sub=n_sub, k_frac=0.03, seed=1)
    pst, rst = port.init(_port(_draw(rng))), ref.init(_ref(_draw(rng)))
    for step in range(3):
        g = _draw(rng)
        out, pst = port.apply(_port(g), pst, torch.tensor(step,
                                                          dtype=torch.int32))
        rout, rst = ref.apply(_ref(g), rst, jnp.int32(step))
        kept = [int((o != 0).sum()) for o in leaves(out)]
        rkept = [int((np.asarray(o) != 0).sum()) for o in
                 jax.tree.leaves(rout)]
        assert kept == rkept
        for a, b in zip(leaves(out), jax.tree.leaves(rout)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(leaves(pst.residual), jax.tree.leaves(rst.residual)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("ties", [False, True])
def test_apply_counts_kept_and_tied(ties):
    """``apply`` leaves (kept, tied) on the compressor: kept is the
    reference's count of recovered coordinates, at least k, and above k
    only by estimates equal to the threshold.  With ``ties`` most
    estimates are exactly 1 (a wide sketch over a constant gradient)."""
    rng = np.random.default_rng(7)
    g = _draw(rng)
    if ties:
        g = jax.tree.map(np.ones_like, g)
    port = PC(width=1 << 14, depth=3, n_sub=2, k_frac=0.05, seed=2)
    ref = RC(width=1 << 14, depth=3, n_sub=2, k_frac=0.05, seed=2)
    d = sum(v.size for v in jax.tree.leaves(g))
    out, _ = port.apply(_port(g), port.init(_port(g)), 1)
    rout, _ = ref.apply(_ref(g), ref.init(_ref(g)), jnp.int32(1))
    kept, tied = (int(c) for c in port.kept)
    k = port.k_of(d)
    assert kept == sum(int((np.asarray(o) != 0).sum())
                       for o in jax.tree.leaves(rout))
    assert kept >= k and kept - tied < k
    assert (tied > k) == ties


def test_apply_keeps_bf16_grads_and_f32_residual():
    rng = np.random.default_rng(3)
    g = _draw(rng, 10.0)
    port, ref = PC(width=256, k_frac=0.05), RC(width=256, k_frac=0.05)
    bf = tree_map(lambda a: torch.from_numpy(a).bfloat16(), g)
    st = port.init(bf)
    ptrs = [t.data_ptr() for t in leaves(bf)]
    out, st = port.apply(bf, st, 0)
    assert [t.data_ptr() for t in leaves(out)] == ptrs        # in place
    assert all(t.dtype == torch.bfloat16 for t in leaves(out))
    assert all(t.dtype == torch.float32 for t in leaves(st.residual))
    rg = jax.tree.map(lambda a: jnp.asarray(
        torch.from_numpy(a).bfloat16().float().numpy(), jnp.bfloat16), g)
    rout, rst = ref.apply(rg, ref.init(rg), jnp.int32(0))
    for a, b in zip(leaves(out), jax.tree.leaves(rout)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    for a, b in zip(leaves(st.residual), jax.tree.leaves(rst.residual)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- the port's own parts --------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_kth_largest_equals_topk(seed, monkeypatch):
    """The chunked radix select is exactly ``torch.topk(x, k)[0][-1]``:
    heavy ties, zeros (inactive coordinates), k past the nonzeros."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 20_000))
    x = np.abs(rng.standard_normal(n)).astype(np.float32)
    x[rng.random(n) < 0.4] = 0.0
    x[rng.random(n) < 0.2] = x[0]                        # ties
    x[rng.random(n) < 0.05] = np.float32(2.0 ** -140)    # subnormals
    t = torch.from_numpy(x)
    monkeypatch.setattr(PCm, "CHUNK", int(rng.integers(1, 5000)))
    comp = PC()
    chunks = lambda: iter(t.split(PCm.CHUNK))
    for k in sorted({1, 2, n // 7 + 1, n // 2 + 1, n, int(
            rng.integers(1, n + 1))}):
        got = comp.kth_largest(k, chunks)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(torch.topk(t, k).values[-1]), k


def test_keys_are_low_32_bits_of_flatten_offsets(monkeypatch):
    """The key of a coordinate is its offset in ``jax.tree.flatten``'s
    order (not the tree's insertion order), cut to 32 bits past 2^32."""
    tree = {"layers": [{"wv": np.zeros(3), "wk": np.zeros(2)}],
            "embed": np.zeros(4), "lm_head": np.zeros(1),
            "final_norm": np.zeros(5)}
    ref_sizes = [a.size for a in jax.tree.leaves(tree)]
    assert [a.size for a in flatten(tree)[0]] == ref_sizes == [4, 5, 2, 3, 1]
    monkeypatch.setattr(PCm, "CHUNK", 4)
    comp = PC()
    assert chunks(ref_sizes, 4) == [[(0, 0, 4)], [(1, 0, 4)], [(1, 4, 5), (2, 0, 2),
                                                 (3, 0, 1)], [(3, 1, 3),
                                                              (4, 0, 1)]]
    grads = [torch.zeros(n) for n in ref_sizes]
    got = torch.cat([idx for _, idx, _, _ in comp._passes(grads, grads, 0)])
    np.testing.assert_array_equal(got.numpy(), np.arange(15))
    start = 2 ** 32 - 3
    keys = comp._keys(start, 6, torch.device("cpu"))
    np.testing.assert_array_equal(
        keys.numpy(), np.arange(start, start + 6, dtype=np.int64).astype(
            np.uint32).astype(np.int64))


def test_axis_names_without_env_is_identity():
    """``axis_names`` is no longer refused (the data-parallel sketch sum
    is ported): without a sharding environment, or in one without those
    mesh axes, it sums over nothing, so the compressor equals one without
    it bit for bit (the 4-rank sum: ``test_torch_distributed.py``)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.sharding import sharding_env

    rng = np.random.default_rng(5)
    grads = {"a": torch.from_numpy(rng.standard_normal(3000,
                                                       dtype=np.float32)),
             "b": torch.from_numpy(rng.standard_normal((40, 30),
                                                       dtype=np.float32))}
    outs = []
    for names, env in ((None, None), (("data",), None),
                       (("pod", "data"), AbstractMesh((4,), ("model",)))):
        comp = PC(width=1 << 8, depth=4, n_sub=2, k_frac=0.05,
                  axis_names=names)
        assert comp.axis_names == names
        state = comp.init(grads)
        got = []
        for step in range(2):
            g = {k: v.clone() for k, v in grads.items()}
            if env is None:
                o, state = comp.apply(g, state, torch.tensor(step))
            else:
                with sharding_env(env):
                    o, state = comp.apply(g, state, torch.tensor(step))
            got.append(o)
        outs.append(got)
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_state_is_the_reference_layout():
    params = _port(_draw(np.random.default_rng(0)))
    st = PC().init(params)
    assert isinstance(st, PS) and st._fields == RS._fields
    assert [tuple(t.shape) for t in leaves(st)] == \
        [tuple(t.shape) for t in leaves(params)]
