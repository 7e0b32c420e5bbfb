"""Time the unsharded decode step of full-width gemma2-2b on the card for
several source trees, each in a process of its own, so that two versions
of the port are compared within one run on one card.

    python scripts/decode_step_ab.py --trees OLD . . OLD

Each tree is a checkout of this repo (its ``src/`` is imported).  A tree
draws f32 weights from ``torch.Generator`` seed 0 on the card and, in
each of ``--rounds`` rounds, prefills a batch of 4 x 32 tokens, takes 8
greedy decode steps to warm up and then ``--steps`` more, each timed on
the host clock up to the copy of its tokens back to the host, as the
server (``launch/serve.py``) times a step, and up to the return of the
step's last launch (``issue_ms``: a decode step reads nothing back
before it, so this is the host's part).  Prints one JSON line per tree
(medians over every timed step) and, last, the card's name and power
limit.  Needs one CUDA card.  The host clock of a one-card machine moves
with other load on its shared cores: compare trees within one run, in
an order such as A B B A A B B A.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH, PROMPT, MAX_LEN, WARMUP = 4, 32, 128, 8


def _child(tree: str, steps: int, rounds: int) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as PM

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script times the "
                           "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("gemma2-2b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = PM.init_params(gen, cfg, dtype=torch.float32, device=dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device=dev,
                           generator=gen)
    ms, issue_ms, prefill_ms, out = [], [], [], []
    with torch.no_grad():
        for _ in range(rounds):
            state = PM.init_decode_state(params, cfg, BATCH, MAX_LEN,
                                         dtype=torch.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = PM.prefill(params, prompt, cfg, state)
            tok = torch.argmax(logits[:, -1], dim=-1)
            tok.tolist()
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
            toks = []
            for i in range(WARMUP + steps):
                t0 = time.perf_counter()
                logits, state = PM.decode_step(params, tok, cfg, state)
                tok = torch.argmax(logits, dim=-1)
                t1 = time.perf_counter()
                toks.append(tok.tolist())
                if i >= WARMUP:
                    ms.append(1e3 * (time.perf_counter() - t0))
                    issue_ms.append(1e3 * (t1 - t0))
            out = toks
    return {"tree": tree, "torch": torch.__version__, "steps": steps,
            "rounds": rounds, "batch": BATCH,
            "decode_ms_median": statistics.median(ms),
            "decode_ms_min": min(ms), "decode_ms_max": max(ms),
            "issue_ms_median": statistics.median(issue_ms),
            "prefill_ms_median": statistics.median(prefill_ms),
            "tokens": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.child, args.steps, args.rounds)),
              flush=True)
        return 0
    first = None
    for tree in args.trees:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", tree, "--steps", str(args.steps),
                            "--rounds", str(args.rounds)],
                           capture_output=True, text=True, timeout=600)
        if p.returncode != 0:
            sys.stderr.write(p.stdout + p.stderr)
            return p.returncode
        res = json.loads(p.stdout.strip().splitlines()[-1])
        tokens = res.pop("tokens")
        res["tokens_equal_first"] = first is None or tokens == first
        first = tokens if first is None else first
        print(json.dumps(res), flush=True)
        if not res["tokens_equal_first"]:
            print(f"{tree}: greedy tokens differ from {args.trees[0]}'s",
                  file=sys.stderr)
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
