"""Flow query plane: the host waiting for the device (``*.wait`` spans: each
estimate copy-out), ms a query."""
from perfbench.program_spans import wait_ms


def read(ctx):
    return wait_ms(ctx, "query_flows")
