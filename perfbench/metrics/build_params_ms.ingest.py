"""System and fleet dispatch: ``fleet.build_params`` (the window's parameter
tables), ms a dispatched window (the program's spans)."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "run_window", "fleet.build_params")
