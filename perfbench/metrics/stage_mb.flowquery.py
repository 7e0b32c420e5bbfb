"""Flow query plane: bytes the engine uploads a query (``query.stage``'s
``bytes`` count), in 10^6 bytes."""
from perfbench.program_spans import counted


def read(ctx):
    n = counted(ctx, "query_flows", "bytes", name="query.stage")
    return None if n is None else n * 1e-6
