"""End-to-end training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --steps 200 --batch 8 --seq 512 [--reduced] [--compress] \\
        [--ckpt-dir DIR] [--device cpu]

The reference's flags and defaults.  ``--reduced`` trains the tiny
same-family config in f32; without it the full-width config trains in
bf16 (f32 AdamW moments), as in the reference.  The default arch,
granite-8b, does not fit one H100 at full width (bf16 weights and grads
plus f32 moments ~99 GB); gemma2-2b does.  The launcher wires together:
data pipeline (``SyntheticLM``) -> train step (autograd, remat on) ->
DiSketch gradient compression (``--compress``: width D // 64, depth 4, 2
subepochs, 5% recovered a step) -> checkpoint/restart (``--ckpt-dir``:
restores the newest committed step, saves every ``--ckpt-every`` steps
and at the end) -> metrics log.  As in the reference's ``main``,
``TrainingSupervisor`` does not drive it.

Weights are random, drawn from ``--seed`` by a ``torch.Generator`` on the
device.  Frontend-stub archs (``cfg.embed_inputs``) take (B, S, D) input
embeddings drawn each step from a ``torch.Generator`` seeded by (seed,
step), where the reference draws from ``jax.random``: the values are the
port's own.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import torch

from ..ckpt.checkpoint import latest_step, restore_checkpoint, \
    save_checkpoint
from ..configs import get_config, reduced
from ..data.pipeline import SyntheticLM
from ..device import resolve_device
from ..models import model as MDL
from ..train.compress import DisketchCompressor
from ..train.optimizer import cosine_schedule, wsd_schedule
from ..train.train_step import TrainState, init_train_state, \
    make_train_step
from ..tree import leaves, tree_map


def make_compressor(d_total: int) -> DisketchCompressor:
    """The reference launcher's compressor for ``d_total`` parameters."""
    return DisketchCompressor(width=max(d_total // 64, 1 << 10), depth=4,
                              n_sub=2, k_frac=0.05)


class _Timed:
    """A compressor whose ``apply`` is timed: CUDA events on the card
    (read after the step), the host clock on the CPU."""

    def __init__(self, comp: DisketchCompressor, dev: torch.device):
        self.comp, self.dev, self._t = comp, dev, None

    def init(self, params):
        return self.comp.init(params)

    def apply(self, grads, state, step):
        if self.dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            out = self.comp.apply(grads, state, step)
            end.record()
            self._t = (start, end)
        else:
            h0 = time.perf_counter()
            out = self.comp.apply(grads, state, step)
            self._t = 1e3 * (time.perf_counter() - h0)
        return out

    def ms(self) -> float:
        if isinstance(self._t, tuple):
            self._t[1].synchronize()
            return self._t[0].elapsed_time(self._t[1])
        return self._t


def _batch(data: SyntheticLM, cfg, step: int, seed: int, dtype,
           dev: torch.device) -> dict:
    b = data.batch(step)
    tokens = torch.from_numpy(b["tokens"]).to(dev).long()
    if cfg.embed_inputs:
        gen = torch.Generator(device=dev).manual_seed((seed << 32) + step)
        tokens = torch.randn(tokens.shape + (cfg.d_model,), generator=gen,
                             device=dev).to(dtype)
    return {"tokens": tokens,
            "labels": torch.from_numpy(b["labels"]).to(dev).long()}


def train(cfg, *, steps: int = 100, batch: int = 8, seq: int = 512,
          lr: float = 3e-4, schedule: str = "cosine", compress: bool = False,
          ckpt_dir: str = "", ckpt_every: int = 50, log_every: int = 10,
          seed: int = 0, dtype=torch.bfloat16, until: Optional[int] = None, device=None,
          log=print) -> Tuple[TrainState, List[dict]]:
    """Train ``cfg`` from random weights for ``steps`` steps of a
    ``steps``-step LR schedule (``until``: stop after that step instead,
    as a job killed there would, without the end's checkpoint: the last
    one is the ``ckpt_every`` cadence's).  Returns the final state and one
    record a step run: loss, aux loss, grad norm, lr, ms (CUDA events on
    the card), tokens/s, and on the card the peak device memory; with
    ``compress``, the compressor's ms, k, the coordinates it kept and
    those of them whose estimate is the threshold."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = MDL.init_params(gen, cfg, dtype=dtype, device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    log(f"arch={cfg.name} params={n_params} family={cfg.family} "
        f"dtype={dtype} device={dev}")

    if schedule == "wsd":
        sched = wsd_schedule(lr, steps // 10, int(steps * 0.7), steps // 5)
    else:
        sched = cosine_schedule(lr, steps // 10, steps)

    compressor = k = None
    if compress:
        comp = make_compressor(n_params)
        k = comp.k_of(n_params)
        compressor = _Timed(comp, dev)
        log(f"compressor: D={n_params} width={comp.width} "
            f"ratio~{n_params / (comp.width * 4):.0f}x k={k}")

    step_fn = make_train_step(cfg, sched, compressor=compressor)
    state = init_train_state(params, compressor)
    del params

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        # restore onto the device without holding two states at once
        like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), state)
        state = None
        state, start, _ = restore_checkpoint(ckpt_dir, like, device=dev)
        log(f"restored checkpoint at step {start}")

    data = SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    stop = steps if until is None else min(until, steps)
    history: List[dict] = []
    t0 = time.time()
    for step in range(start, stop):
        b = _batch(data, cfg, step, seed, dtype, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, metrics = step_fn(state, b)
            ev[1].record()
            ev[1].synchronize()
            ms = ev[0].elapsed_time(ev[1])
        else:
            h0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            ms = 1e3 * (time.perf_counter() - h0)
        rec = {"step": step + 1, **{name: float(v) for name, v in
                                    metrics.items()},
               "ms": ms, "tokens_per_s": batch * seq / (ms / 1e3)}
        if dev.type == "cuda":
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        if compressor is not None:
            rec["compress_ms"], rec["k"] = compressor.ms(), k
            rec["kept"], rec["tied"] = (int(c) for c in compressor.comp.kept)
        history.append(rec)
        if (step + 1) % log_every == 0 or step == start:
            log(f"step {step + 1:5d} loss={rec['loss']:.4f} "
                f"gnorm={rec['grad_norm']:.3f} lr={rec['lr']:.2e} "
                f"({(time.time() - t0) / (step - start + 1):.2f}s/step)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, state)
            log(f"checkpointed step {step + 1}")
    if ckpt_dir and until is None and latest_step(ckpt_dir) != steps:
        save_checkpoint(ckpt_dir, steps, state)
    log(f"done: {stop} steps in {time.time() - t0:.1f}s")
    return state, history


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (f32)")
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd"])
    ap.add_argument("--compress", action="store_true",
                    help="DiSketch gradient compression")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the host")
    return ap.parse_args(argv)


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    _, history = train(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        schedule=args.schedule, compress=args.compress,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=args.log_every, seed=args.seed,
        dtype=torch.float32 if args.reduced else torch.bfloat16,
        device=args.device)
    return history


if __name__ == "__main__":
    main()
