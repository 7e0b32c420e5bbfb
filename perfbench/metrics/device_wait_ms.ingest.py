"""System and fleet dispatch: the host waiting for the device (every
``*.wait`` span: the peak's scalar and each PEB read), ms a dispatched
window."""
from perfbench.program_spans import wait_ms


def read(ctx):
    return wait_ms(ctx, "run_window")
