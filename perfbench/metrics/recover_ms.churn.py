"""Churn: ms of a ``fleet.recover`` call (lost cells rebuilt from XOR
parity after a pass's last window; the program's spans)."""
from perfbench.churn_spans import recover_ms


def read(ctx):
    return recover_ms(ctx)
