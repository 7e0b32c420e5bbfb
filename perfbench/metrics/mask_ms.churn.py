"""Churn: ``fleet.mask`` (the dead switches' segments of each epoch's
packets set to value 0), ms a dispatched window (the program's spans)."""
from perfbench.churn_spans import step_ms


def read(ctx):
    return step_ms(ctx, "fleet.mask")
