"""Churn: ``fleet.parity`` (the XOR parity of every group and epoch, taken
on the device), ms a dispatched window (the program's spans)."""
from perfbench.churn_spans import step_ms


def read(ctx):
    return step_ms(ctx, "fleet.parity")
