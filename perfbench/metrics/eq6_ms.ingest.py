"""System and fleet dispatch: ``disketch.observe`` (Eq. 6 over the window's
PEBs), ms a dispatched window (the program's spans)."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "run_window", "disketch.observe")
