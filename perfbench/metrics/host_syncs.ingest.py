"""System and fleet dispatch: the host's reads of device data (``*.wait``
spans) a dispatched window."""
from perfbench.program_spans import waits


def read(ctx):
    return waits(ctx, "run_window")
