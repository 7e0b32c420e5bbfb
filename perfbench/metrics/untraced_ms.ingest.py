"""System and fleet dispatch: the time of ``disketch.run_window`` that no
step span under it covers, ms a dispatched window."""
from perfbench.program_spans import untraced_ms


def read(ctx):
    return untraced_ms(ctx, "run_window")
