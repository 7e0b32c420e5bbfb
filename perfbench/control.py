#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and the control's over a few.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 3 --seconds 5 [--out FILE]

For each seed it runs the cell as ``run.py`` does (the program's timed
path, a short window, the comparison with the plain reference) and, for
the first ``--control-seeds`` seeds, the control: the plain reference in
bfloat16 put in the program's place and judged by the same comparison.
A sound limit lies above every program reading and below every control
reading.  One JSON line per reading goes to standard output and to
``--out``.  Not part of a benchmark run.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell: str, seed: int, overrides=None) -> dict:
    """The control's numbers for one seed, at the cell's own size: the
    cell's loop compares the answers of the reference in bfloat16, put in
    the program's place, as it compares the program's."""
    from perfbench import harness

    h = harness.prepare(cell, seed, overrides)
    ctrl = h.reference.Reference(h.cfg, precision="bf16")
    numbers, _ = h.loop.compare(h, h.loop.control(h, ctrl), h.reference)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    for j, seed in enumerate(seeds):
        rows = []
        res = harness.run_cell(args.workload, seed, args.seconds, False)
        r = res["result"]
        rows.append({"side": "program", "correct": r["correct"],
                     "attempted": r["attempted"], "failed": r["failed"],
                     "numbers": {k: v["value"]
                                 for k, v in r["compared"].items()},
                     "metrics": {k: v["value"]
                                 for k, v in r["metrics"].items()}})
        if j < args.control_seeds:
            rows.append({"side": "control",
                         "numbers": control_numbers(args.workload, seed)})
        for row in rows:
            row.update(workload=args.workload, seed=seed)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
