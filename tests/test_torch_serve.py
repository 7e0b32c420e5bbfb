"""The port's serving path (``repro_torch.serve.decode``,
``repro_torch.launch.serve``) against the JAX package's.

Weights come from a numpy seed and are carried into both packages as in
``tests/test_torch_models.py``.  ``decode_loop``'s greedy tokens must equal
the reference's exactly.  The server's finished requests are held, step by
step, to the reference's own decode of each prompt at the server's cache
dtype (f32; the reference's ``decode_loop`` allocates bfloat16 caches
through ``make_prefill_step``, its server f32): the reference's
``prefill`` and jitted ``make_serve_step`` on the request alone.  A step
is compared while the reference's top-2 logit margin exceeds 1e-4 of its
top logit; past a closer call the two greedy paths may part, and the test
reports where each request stopped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro.serve import decode as RS
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.launch import serve as SV
from repro_torch.models import convert
from repro_torch.models import model as PM
from repro_torch.serve import decode as PS

CPU = torch.device("cpu")
MARGIN = 1e-4              # relative top-2 margin below which steps stop


def setup(name, seed=0):
    cfg = reduced(get_config(name))
    params = PM.init_params(np.random.default_rng(seed), cfg,
                            dtype=torch.float32, device=CPU)
    return cfg, params, jax.tree.map(jnp.asarray, convert.to_numpy(params))


@pytest.mark.parametrize("name", list_configs())
def test_decode_loop_matches_reference(name):
    cfg, params, rp = setup(name)
    rng = np.random.default_rng(1)
    if cfg.embed_inputs:
        prompt = rng.standard_normal((2, 8, cfg.d_model), dtype=np.float32)
        port_prompt = torch.from_numpy(prompt)
    else:
        prompt = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
        port_prompt = torch.from_numpy(prompt).long()
    ref = np.asarray(RS.decode_loop(rp, cfg, jnp.asarray(prompt), 12))
    got = PS.decode_loop(params, cfg, port_prompt, 12).numpy()
    np.testing.assert_array_equal(got, ref)


def requests(cfg, n, prompt_len, max_new, seed=0):
    rng = np.random.RandomState(seed)
    return [SV.Request(i, rng.randint(0, cfg.vocab, size=prompt_len
                                      ).astype(np.int32), max_new)
            for i in range(n)]


def reference_decoder(cfg, rp, max_len):
    """The reference's greedy decode of one prompt at the server's cache
    dtype: ``decode(prompt, n_steps)`` gives its tokens and each step's
    relative top-2 margin."""
    prefill = jax.jit(lambda p, x, st: RM.prefill(p, x, cfg, st))
    step = jax.jit(RS.make_serve_step(cfg))

    def decode(prompt, n_steps):
        st = RM.init_decode_state(rp, cfg, 1, max_len, dtype=jnp.float32)
        logits, st = prefill(rp, jnp.asarray(prompt[None]), st)
        logits = logits[:, -1]
        toks, margins = [], []
        for i in range(n_steps):
            top2 = np.sort(np.asarray(logits[0]))[-2:]
            margins.append((top2[1] - top2[0]) / abs(top2[1]))
            tok = RS.sample_greedy(logits)
            toks.append(int(tok[0]))
            if i < n_steps - 1:
                _, logits, st = step(rp, tok, st)
        return toks, margins

    return decode


@pytest.mark.parametrize("name", ["gemma2-2b", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
def test_server_matches_reference_decode(name, capsys):
    """6 requests through 4 slots (a second refill with two zero-prompt
    slots); every finished request's tokens == the reference's decode of
    its prompt, step by step while the margin holds."""
    cfg, params, rp = setup(name)
    reqs = requests(cfg, 6, prompt_len=8, max_new=10)
    done, stats = SV.serve(cfg, params, reqs, batch=4, max_len=24,
                           device="cpu")
    assert [r.rid for r in done] == list(range(6))
    assert stats.steps == 2 * 9 and len(stats.prefill_s) == 2
    compared, decode = 0, reference_decoder(cfg, rp, max_len=24)
    for r in done:
        assert len(r.out) == r.max_new
        toks, margins = decode(r.prompt, r.max_new)
        stop = next((i for i, m in enumerate(margins) if m <= MARGIN),
                    len(margins))
        if stop < len(margins):
            with capsys.disabled():
                print(f"\n{name} request {r.rid}: compared {stop} of "
                      f"{len(margins)} steps (margin {margins[stop]:.2e})")
        assert r.out[:stop] == toks[:stop]
        compared += stop
    assert compared >= 0.9 * 6 * 10


def test_server_stats_and_timings():
    cfg, params, _ = setup("gemma2-2b")
    reqs = requests(cfg, 5, prompt_len=4, max_new=3)
    for r in reqs:
        r.t_enqueue = 0.0
    done, stats = SV.serve(cfg, params, reqs, batch=2, max_len=8,
                           device="cpu")
    assert sorted(r.rid for r in done) == list(range(5))
    assert len(stats.prefill_s) == 3 and stats.steps == 3 * 2
    m = SV.summary(done, stats, seconds=1.0)
    assert m["requests"] == 5 and m["tokens"] == 15 and m["steps"] == 6
    assert m["tok_per_s"] == 15.0
    assert 0 < m["ttft_p50_s"] <= m["latency_p50_s"] <= m["latency_p99_s"]
    assert all(r.t_first <= r.t_done for r in done)


def test_server_refuses_what_the_reference_refuses(monkeypatch):
    cfg, params, _ = setup("musicgen-medium")
    with pytest.raises(ValueError, match="token prompts"):
        SV.serve(cfg, params, requests(cfg, 2, 4, 2), 2, 8, device="cpu")
    cfg, params, _ = setup("gemma2-2b")
    mixed = requests(cfg, 2, 4, 2) + requests(cfg, 1, 5, 2)
    with pytest.raises(ValueError, match="first's length"):
        SV.serve(cfg, params, mixed, 2, 8, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SV.serve(cfg, params, requests(cfg, 2, 4, 2), 2, 8)


def test_main_serves_on_the_cpu_when_asked(capsys):
    SV.main(["--arch", "gemma2-2b", "--requests", "3", "--batch", "2",
             "--prompt-len", "4", "--max-new", "3", "--max-len", "8",
             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out and "on cpu" in out
    assert "TTFT p50=" in out and "decode step" in out
    with pytest.raises(SystemExit, match="token prompts"):
        SV.main(["--arch", "internvl2-76b", "--device", "cpu"])


def test_reduced_flag_keeps_its_default_and_turns_off():
    assert SV.parse_args([]).reduced is True
    assert SV.parse_args(["--no-reduced"]).reduced is False
    assert SV.parse_args(["--reduced"]).reduced is True
