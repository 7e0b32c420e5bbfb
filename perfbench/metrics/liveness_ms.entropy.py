"""UnivMon query plane: ``fleet.liveness`` (each path group's fragment
selection, liveness and routing), ms a query."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "query_entropy", "fleet.liveness")
