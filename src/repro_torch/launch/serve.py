"""The server: a continuous-batching decode loop, the counterpart of
``src/repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --requests 16 --max-new 32 [--no-reduced]

A minimal production-shaped server core: a request queue, a fixed decode
batch with slot recycling (a finished sequence's slot is refilled from the
queue on the next step), greedy sampling, and per-request latency stats.
Weights are random, drawn from ``--seed`` on the device in f32, as the
reference's ``main`` draws them.

``--reduced`` keeps the reference's default (a tiny same-family config),
but unlike the reference's ``store_true`` flag with ``default=True`` it can
be turned off: ``--no-reduced`` serves the full-width configuration.

The loop keeps the reference's behaviour: slots share one ``DecodeState``
whose ``length`` is global, so every request has the prompt length of the
first, and a refill re-prefills the whole batch (empty slots get a zero
prompt).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_config, reduced
from ..device import resolve_device
from ..models import model as MDL
from ..serve.decode import make_serve_step, sample_greedy


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    t_enqueue: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None


@dataclass
class ServeStats:
    """What one ``serve`` call did: decode steps, and the host seconds of
    each batch prefill and each decode step (each ends when its tokens
    reach the host, which waits for the device)."""
    steps: int = 0
    prefill_s: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)


def serve(cfg, params, requests: Sequence[Request], batch: int,
          max_len: int, device=None) -> Tuple[List[Request], ServeStats]:
    """Serve ``requests`` (in order) with a decode batch of ``batch`` slots
    and caches of ``max_len`` tokens.  Returns the finished requests, in
    the order they finished, and the loop's stats.  ``params`` must live on
    ``device`` (the card unless the caller names another)."""
    if cfg.embed_inputs:
        raise ValueError("the server takes token prompts; pick a "
                         "token-input arch (frontend-stub archs take "
                         "embeddings through models.model directly)")
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"not on {dev}")
    queue = list(requests)
    if not queue:
        return [], ServeStats()
    prompt_len = len(queue[0].prompt)
    if any(len(r.prompt) != prompt_len for r in queue):
        raise ValueError("every prompt must have the first's length: the "
                         "slots share one cache length")
    serve_step = make_serve_step(cfg)
    stats = ServeStats()
    done: List[Request] = []
    slots: List[Optional[Request]] = [None] * batch
    state = None
    cur_tok = None
    while queue or any(s is not None for s in slots):
        # (re)fill empty slots -> batch prefill
        if any(s is None for s in slots) and queue:
            h0 = time.perf_counter()
            for i in range(batch):
                if slots[i] is None and queue:
                    slots[i] = queue.pop(0)
            prompts = np.stack([
                s.prompt if s is not None else
                np.zeros(prompt_len, np.int32) for s in slots])
            state = MDL.init_decode_state(params, cfg, batch, max_len,
                                          dtype=torch.float32)
            logits, state = MDL.prefill(
                params, torch.from_numpy(prompts).long().to(dev), cfg, state)
            cur_tok = sample_greedy(logits[:, -1])
            tok = cur_tok.cpu().numpy()
            now = time.perf_counter()
            stats.prefill_s.append(now - h0)
            for i, s in enumerate(slots):
                if s is not None and s.t_first is None:
                    s.t_first = now
                    s.out.append(int(tok[i]))
        h0 = time.perf_counter()
        cur_tok, _, state = serve_step(params, cur_tok, state)
        tok = cur_tok.cpu().numpy()
        now = time.perf_counter()
        stats.steps += 1
        stats.step_s.append(now - h0)
        for i, s in enumerate(slots):
            if s is None:
                continue
            s.out.append(int(tok[i]))
            if len(s.out) >= s.max_new:
                s.t_done = now
                done.append(s)
                slots[i] = None
    return done, stats


def summary(done: Sequence[Request], stats: ServeStats,
            seconds: float) -> dict:
    """Tokens, tok/s, TTFT and latency percentiles (s), and the mean
    prefill and decode step (ms) of one ``serve`` call."""
    toks = sum(len(r.out) for r in done)
    lat = [r.t_done - r.t_enqueue for r in done]
    ttft = [r.t_first - r.t_enqueue for r in done]
    return {
        "requests": len(done), "tokens": toks, "seconds": seconds,
        "tok_per_s": toks / max(seconds, 1e-9), "steps": stats.steps,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "prefill_ms": 1e3 * float(np.mean(stats.prefill_s)),
        "step_ms": 1e3 * float(np.mean(stats.step_s)),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the host")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.embed_inputs:
        raise SystemExit("the server takes token prompts; pick a "
                         "token-input arch")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = MDL.init_params(gen, cfg, dtype=torch.float32, device=dev)

    rng = np.random.RandomState(args.seed)
    queue = [Request(i, rng.randint(0, cfg.vocab,
                                    size=args.prompt_len).astype(np.int32),
                     args.max_new, t_enqueue=time.perf_counter())
             for i in range(args.requests)]
    t0 = time.perf_counter()
    done, stats = serve(cfg, params, queue, args.batch, args.max_len, dev)
    m = summary(done, stats, time.perf_counter() - t0)
    print(f"served {m['requests']} requests, {m['tokens']} tokens in "
          f"{m['seconds']:.2f}s ({m['tok_per_s']:.1f} tok/s, "
          f"{m['steps']} decode steps) on {dev}")
    print(f"TTFT p50={m['ttft_p50_s']:.3f}s "
          f"latency p50={m['latency_p50_s']:.3f}s "
          f"p99={m['latency_p99_s']:.3f}s; prefill {m['prefill_ms']:.2f} ms, "
          f"decode step {m['step_ms']:.2f} ms")


if __name__ == "__main__":
    main()
