#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the card(s) the cell asks
for.  It makes the cell's trace from the seed, builds and warms the
system, measures for ``--seconds``, checks what the timed path produced
against the plain reference in ``perfbench/reference/``, and prints one
JSON object as the last line of standard output: the end-to-end metrics
(``--trace 0``) or the per-layer ones read from spans, counters and a
``torch.profiler`` trace (``--trace 1``).  The numbers the check compared
close standard error, each beside its limit.

It exits non-zero and prints no result without CUDA, with fewer cards
than the cell asks for, without the program's sources beside it, or when
the process holds JAX or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _pin_caches() -> None:
    """Kernel caches at fixed paths inside the checkout: only a cell's
    first run there builds (the program's own nvcc cache is
    ``build/repro_torch/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        print("perfbench: --seed must be >= 0 and --seconds > 0",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: the program (src/repro_torch) is not in {ROOT}",
              file=sys.stderr)
        return 2
    _pin_caches()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import harness, registry

    chips = int(registry.workload(args.workload,
                                  registry.benchmark())["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", t_start=T_START,
        spans_dir=str(ROOT / "build" / "perfbench" / "spans"))
    for line in out["lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
