"""UnivMon query plane: ``query.stage`` (the engine's host tables and uploads
before its transfer guard, each path group), ms a query."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "query_entropy", "query.stage")
