"""Churn: lost cells zeroed a dispatched window (``fleet.lose``'s
``cells``): a victim's epochs before its death in the same window."""
from perfbench.churn_spans import counted


def read(ctx):
    return counted(ctx, "fleet.lose", "cells")
