"""UnivMon query plane: ``query.gather`` (the all-levels gathers and merges
launched under the transfer guard), ms a query."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "query_entropy", "query.gather")
