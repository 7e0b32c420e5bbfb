"""UnivMon query plane: ``hash.level_of`` (each path group's keys' levels on
the host), ms a query."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "query_entropy", "hash.level_of")
