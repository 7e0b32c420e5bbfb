"""UnivMon query plane: the time of ``disketch.query_entropy`` that no step
span under it covers, ms a query."""
from perfbench.program_spans import untraced_ms


def read(ctx):
    return untraced_ms(ctx, "query_entropy")
