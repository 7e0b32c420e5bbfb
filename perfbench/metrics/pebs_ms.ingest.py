"""System and fleet dispatch: ``fleet.pebs`` (the PEBs of every row group
and epoch on the device, each read back), ms a dispatched window (the
program's spans)."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "run_window", "fleet.pebs")
