"""UnivMon query plane: ``query.gsum`` (the G-sum's uploads, its device
recursion and its scalar read), ms a query."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "query_entropy", "query.gsum")
