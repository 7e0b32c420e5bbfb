"""UnivMon query plane: path groups a query (the ``path_groups`` count of
``disketch.query_entropy``)."""
from perfbench.program_spans import counted


def read(ctx):
    return counted(ctx, "query_entropy", "path_groups",
                   name="disketch.query_entropy")
