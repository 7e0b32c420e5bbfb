"""Flow query plane: ``query.stage`` (the engine's host tables and uploads
before its transfer guard), ms a query."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "query_flows", "query.stage")
