"""The port's model configs and decoder (``repro_torch.configs``,
``repro_torch.models``) against the JAX package's.

Weights are drawn from a numpy seed (``init_params`` with a
``numpy.random.Generator``, on the CPU), carried into the reference's
pytree with ``convert.to_numpy`` and run through both packages on the same
inputs.  Tolerances: the port against the reference within 2e-4 (forward,
prefill) and 3e-4 (decode), those of ``tests/test_models.py``; the layer
cases within 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LONG_CONTEXT_OK as REF_LONG_CONTEXT_OK
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import list_configs as ref_list_configs
from repro.configs import reduced as ref_reduced
from repro.configs.all_configs import ALL_ARCHS as REF_ALL_ARCHS
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import moe as RX
from repro_torch.configs import LONG_CONTEXT_OK, SHAPES, get_config, \
    list_configs, reduced
from repro_torch.configs.all_configs import ALL_ARCHS
from repro_torch.models import convert
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import moe as PX

ARCHS = ref_list_configs()
B, S = 2, 32
CPU = torch.device("cpu")


def port_params(cfg, seed=0):
    return PM.init_params(np.random.default_rng(seed), cfg,
                          dtype=torch.float32, device=CPU)


def ref_tree(params):
    return jax.tree.map(jnp.asarray, convert.to_numpy(params))


def inputs(cfg, seed=1, b=B, s=S):
    """Token ids, or (B, S, D) embeddings for the frontend-stub archs."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def as_port(x):
    t = torch.from_numpy(np.asarray(x))
    return t if t.is_floating_point() else t.long()


def no_drop(cfg):
    """The MoE capacity with no drops (cf = E/K), as ``tests/test_models.py``
    sets it for decode: capacity dropping depends on the batch context."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(
        cfg, moe_capacity_factor=float(cfg.n_experts / cfg.top_k))


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference(name):
    for port, ref in ((get_config(name), ref_get_config(name)),
                      (reduced(get_config(name)),
                       ref_reduced(ref_get_config(name)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for attr in ("d_inner", "dt_rank", "n_ssm_heads"):
            assert getattr(port, attr) == getattr(ref, attr)
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()


def test_config_registry_matches_reference():
    assert list_configs() == ARCHS and sorted(ALL_ARCHS) == ARCHS
    assert ALL_ARCHS == REF_ALL_ARCHS
    assert LONG_CONTEXT_OK == REF_LONG_CONTEXT_OK
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    kw = dict(n_layers=2, local_window=16, moe_capacity_factor=2.0)
    assert dataclasses.asdict(reduced(get_config("gemma2-2b"), **kw)) == \
        dataclasses.asdict(ref_reduced(ref_get_config("gemma2-2b"), **kw))
    gemma = get_config("gemma2-2b")
    assert (gemma.n_layers, gemma.d_model, gemma.n_heads, gemma.n_kv_heads,
            gemma.d_head, gemma.d_ff, gemma.vocab, gemma.local_window,
            gemma.attn_softcap, gemma.final_softcap) == \
        (26, 2304, 8, 4, 256, 9216, 256000, 4096, 50.0, 30.0)


# -- the weight carry-over ---------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_carry_over_round_trip(name):
    """The port's tree has the reference's paths and shapes, and the
    carry-over is a path map: numpy -> port -> numpy is the identity."""
    cfg = reduced(get_config(name))
    shapes = jax.eval_shape(
        lambda k: RM.init_params(k, cfg, dtype=jnp.float32),
        jax.random.PRNGKey(0))
    params = port_params(cfg)
    tree = convert.to_numpy(params)
    ref_paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    port_paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [(p, s.shape, s.dtype) for p, s in ref_paths] == \
        [(p, a.shape, a.dtype) for p, a in port_paths]
    back = convert.to_numpy(convert.from_numpy(tree, CPU))
    for (p, a), (q, b) in zip(port_paths,
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        assert p == q
        np.testing.assert_array_equal(a, b)
    # the port's names are the reference's pytree paths, dotted
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                      for k in path) for path, _ in ref_paths]
    assert sorted(convert.flatten(params)) == sorted(names)
    assert "layers.0.attn.wq" in names or "layers.0.mamba.in_proj" in names


def test_carry_over_reads_bfloat16():
    """The reference's default bfloat16 tree comes across bit for bit."""
    cfg = reduced(get_config("gemma2-2b"))
    tree = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(3),
                                                   cfg))
    params = convert.from_numpy(tree, CPU)
    assert params["embed"].dtype == torch.bfloat16
    back = convert.to_numpy(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a.astype(np.float32), b)


# -- forward, prefill and decode of every family -----------------------------

def ref_entry_points(cfg):
    """The reference's forward, prefill and decode_step for ``cfg``, each
    under ``jax.jit`` (as its server and ``decode_loop`` run them), which
    here costs less than its op-by-op dispatch."""
    return (jax.jit(lambda p, x: RM.forward(p, x, cfg)[0]),
            jax.jit(lambda p, x, st: RM.prefill(p, x, cfg, st)),
            jax.jit(lambda p, x, st: RM.decode_step(p, x, cfg, st)))


@pytest.fixture(scope="module")
def runs():
    """Per arch, lazily: the reference's and the port's forward logits,
    prefill logits, and decode-step logits (prefill S-1 tokens, then one
    step, with the MoE capacity at E/K)."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        cfg = reduced(get_config(name))
        params = port_params(cfg)
        rp, x = ref_tree(params), inputs(cfg)
        forward, prefill, _ = ref_entry_points(cfg)
        out = {}
        out["forward"] = (np.asarray(forward(rp, jnp.asarray(x))),
                          PM.forward(params, as_port(x), cfg)[0].numpy())
        st = RM.init_decode_state(rp, cfg, B, S, dtype=jnp.float32)
        ps = PM.init_decode_state(params, cfg, B, S, dtype=torch.float32)
        out["prefill"] = (
            np.asarray(prefill(rp, jnp.asarray(x), st)[0]),
            PM.prefill(params, as_port(x), cfg, ps)[0].numpy())
        dcfg = no_drop(cfg)
        _, prefill, decode_step = ref_entry_points(dcfg)
        tok = x[:, S - 1] if not cfg.embed_inputs else x[:, S - 1:S]
        st = RM.init_decode_state(rp, dcfg, B, S, dtype=jnp.float32)
        _, st = prefill(rp, jnp.asarray(x[:, :S - 1]), st)
        ref_d, st = decode_step(rp, jnp.asarray(tok), st)
        ps = PM.init_decode_state(params, dcfg, B, S, dtype=torch.float32)
        _, ps = PM.prefill(params, as_port(x[:, :S - 1]), dcfg, ps)
        port_d, ps = PM.decode_step(params, as_port(tok), dcfg, ps)
        assert ps.length == int(st.length) == S
        out["decode"] = (np.asarray(ref_d), port_d.numpy())
        cache[name] = out
        return out

    return get


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("entry,tol", [("forward", 2e-4), ("prefill", 2e-4),
                                       ("decode", 3e-4)])
def test_entry_point_matches_reference(runs, name, entry, tol):
    ref, port = runs(name)[entry]
    assert port.shape == ref.shape
    # tests/test_models.py's tolerances (2e-4 prefill, 3e-4 decode)
    np.testing.assert_allclose(port, ref, rtol=tol, atol=tol)


def test_mamba_state_carries_sequence():
    """The reference's test on the port: a prefill in two halves == one
    prefill (state carry)."""
    cfg = reduced(get_config("falcon-mamba-7b"))
    params = port_params(cfg)
    tokens = as_port(inputs(cfg, b=1, s=16))
    st = PM.init_decode_state(params, cfg, 1, 16, dtype=torch.float32)
    la, _ = PM.prefill(params, tokens, cfg, st)
    st2 = PM.init_decode_state(params, cfg, 1, 16, dtype=torch.float32)
    _, st2 = PM.prefill(params, tokens[:, :8], cfg, st2)
    lb, _ = PM.prefill(params, tokens[:, 8:], cfg, st2)
    np.testing.assert_allclose(la[:, -1].numpy(), lb[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)


# -- attention: the chunk loop, the cache clamp, the refusal -----------------

def _attn_case(seed=0, b=1, s=256, **overrides):
    cfg = reduced(get_config("gemma2-2b"), **overrides)
    params = port_params(cfg, seed)
    p = params["layers"][0]["attn"]
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s, cfg.d_model), dtype=np.float32)
    return cfg, p, jax.tree.map(jnp.asarray, convert.to_numpy(p)), x


def test_gemma2_chunked_local_attention():
    """s = 256 in chunks of 32 with a window of 64: local layers' keys start
    at the 128-aligned ``kv_lo`` (128 from the chunk at 192 on)."""
    cfg, p, rp, x = _attn_case()
    pos = np.arange(256)
    ref, (rk, _) = jax.jit(lambda x, p: RL.attention(
        x, p, cfg, positions=jnp.asarray(pos), window=64, q_chunk=32))(
        jnp.asarray(x), rp)
    out, (k, _) = PL.attention(torch.from_numpy(x), p, cfg,
                               positions=torch.from_numpy(pos), window=64,
                               q_chunk=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), rtol=2e-5,
                               atol=2e-5)
    # a window that reaches back past the chunk's own keys changes the
    # answer: the band mask cuts
    full, _ = PL.attention(torch.from_numpy(x), p, cfg,
                           positions=torch.from_numpy(pos), q_chunk=32)
    assert not torch.allclose(full, out, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_cache_write_clamps_as_dynamic_update_slice(s):
    """A write of s tokens at cache_len = T - 1 lands at T - s (for s > 1
    the start is clamped), while the mask and positions keep cache_len."""
    t = 16
    cfg, p, rp, x = _attn_case(seed=5, b=2, s=s)
    rng = np.random.default_rng(7)
    ck, cv = (rng.standard_normal((2, t, cfg.n_kv_heads, cfg.d_head),
                                  dtype=np.float32) for _ in range(2))
    pos = np.arange(t - 1, t - 1 + s)
    ref, (rck, rcv) = RL.attention(
        jnp.asarray(x), rp, cfg, positions=jnp.asarray(pos), window=0,
        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_len=jnp.int32(t - 1))
    out, (pck, pcv) = PL.attention(
        torch.from_numpy(x), p, cfg, positions=torch.from_numpy(pos),
        window=0, kv_cache=(torch.from_numpy(ck.copy()),
                            torch.from_numpy(cv.copy())), cache_len=t - 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(pck.numpy(), np.asarray(rck), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(pcv.numpy(), np.asarray(rcv), rtol=2e-5,
                               atol=2e-5)
    # the rows before the clamped start are untouched
    np.testing.assert_array_equal(pck.numpy()[:, :t - s], ck[:, :t - s])


@pytest.mark.parametrize("s,q_chunk,ok", [(96, 32, True), (65, 32, False),
                                          (100, 32, False),
                                          (2049, 1024, False)])
def test_chunk_lengths_refused_as_the_reference_refuses(s, q_chunk, ok):
    """The chunk loop covers (s // q_chunk) chunks of s // (s // q_chunk)
    tokens; the reference fails at its reshape when they fall short of s,
    and the port refuses the same lengths with a clear message."""
    cfg, p, rp, x = _attn_case(s=s)
    pos = np.arange(s)

    def ref():                  # under jit a bad length fails as it traces
        return jax.jit(lambda x, p: RL.attention(
            x, p, cfg, positions=jnp.asarray(pos), q_chunk=q_chunk))(
            jnp.asarray(x), rp)

    def port():
        return PL.attention(torch.from_numpy(x), p, cfg,
                            positions=torch.from_numpy(pos), q_chunk=q_chunk)

    if ok:
        np.testing.assert_allclose(port()[0].numpy(), np.asarray(ref()[0]),
                                   rtol=2e-5, atol=2e-5)
        return
    with pytest.raises(TypeError):
        ref()
    with pytest.raises(ValueError, match="not a multiple of its chunk"):
        port()


# -- MoE routing ties, the device default ------------------------------------

def test_route_topk_tie_order_matches_lax_top_k():
    """A zero router makes every gate probability equal: both packages pick
    experts 0..k-1 in ascending order."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    x = np.random.default_rng(0).standard_normal((2, 5, cfg.d_model),
                                                 dtype=np.float32)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 3] = router[:, 6] = 1e-3      # two experts above the ties
    rw, ri, _ = RX.route_topk(jnp.asarray(x), jnp.asarray(router), 4)
    pw, pi, _ = PX.route_topk(torch.from_numpy(x), torch.from_numpy(router),
                              4)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pw.numpy(), np.asarray(rw), rtol=1e-6)


def test_moe_ffn_matches_reference_with_drops():
    """The capacity dispatch at the default factor, drops included, and the
    aux loss."""
    cfg = reduced(get_config("deepseek-moe-16b"))
    p = PX.init_moe(np.random.default_rng(2), cfg, torch.float32, CPU)
    rp = jax.tree.map(jnp.asarray, convert.to_numpy(p))
    x = np.random.default_rng(3).standard_normal((2, 64, cfg.d_model),
                                                 dtype=np.float32)
    ref, raux = RX.moe_ffn(jnp.asarray(x), rp, cfg)
    out, aux = PX.moe_ffn(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    PX.set_impl("ep")                      # no mesh: the same dispatch
    try:
        torch.testing.assert_close(PX.moe_ffn(torch.from_numpy(x), p, cfg)[0],
                                   out, rtol=0, atol=0)
    finally:
        PX.set_impl("gspmd")


def test_init_params_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.init_params(np.random.default_rng(0),
                       reduced(get_config("gemma2-2b")))
