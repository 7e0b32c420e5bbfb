"""UnivMon query plane: the host waiting for the device (``*.wait`` spans:
each path group's estimate copy-out and the G-sum's scalar), ms a query."""
from perfbench.program_spans import wait_ms


def read(ctx):
    return wait_ms(ctx, "query_entropy")
