"""B1 dispatch: bytes uploaded a dispatched window (``fleet.upload``'s
``bytes`` count), in 10^6 bytes."""
from perfbench.program_spans import counted


def read(ctx):
    n = counted(ctx, "run_window", "bytes", name="fleet.upload")
    return None if n is None else n * 1e-6
