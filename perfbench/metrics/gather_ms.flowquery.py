"""Flow query plane: ``query.gather`` (the gathers and merges launched under
the transfer guard), ms a query."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "query_flows", "query.gather")
