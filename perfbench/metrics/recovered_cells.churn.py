"""Churn: lost cells a ``fleet.recover`` call rebuilt from XOR parity
(its ``cells``)."""
from perfbench.churn_spans import recovered


def read(ctx):
    return recovered(ctx)
