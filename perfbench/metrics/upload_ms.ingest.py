"""B1 dispatch: ``fleet.upload`` (the packed stream, the parameter table and
the block map to the device), ms a dispatched window (the program's
spans)."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "run_window", "fleet.upload")
