"""Flow query plane: ``query.path_groups`` (the flows grouped by path), ms a
query (the program's spans)."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "query_flows", "query.path_groups")
