"""Flow query plane: ``fleet.liveness`` (the row tables, the liveness
selections and the routing of epochs to windows), ms a query."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "query_flows", "fleet.liveness")
