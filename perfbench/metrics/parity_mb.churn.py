"""Churn: the parity a dispatched window holds on the device
(``fleet.parity``'s ``bytes``), in 10^6 bytes."""
from perfbench.churn_spans import counted


def read(ctx):
    n = counted(ctx, "fleet.parity", "bytes")
    return None if n is None else n * 1e-6
