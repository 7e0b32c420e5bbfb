"""System and fleet dispatch: ``fleet.mass_check`` (each fragment's |value|
mass against 2^24), ms a dispatched window (the program's spans)."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "run_window", "fleet.mass_check")
