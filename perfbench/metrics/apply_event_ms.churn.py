"""Churn: ``disketch.apply_event`` (the control plane taking a death or a
rejoin: the §6 re-equalization of the survivors, the rejoin at n = 1),
ms a dispatched window (the program's spans)."""
from perfbench.churn_spans import step_ms


def read(ctx):
    return step_ms(ctx, "disketch.apply_event")
