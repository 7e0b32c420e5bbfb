"""Churn: packets masked a dispatched window (``fleet.mask``'s
``packets``): the dead switches' packets, which they keep forwarding."""
from perfbench.churn_spans import counted


def read(ctx):
    return counted(ctx, "fleet.mask", "packets")
