"""UnivMon query plane: the (epoch, fragment, level, key) slots the
entropy's gathers read (the ``slots`` counts of ``query.gather``), in
10^6 a query.  None where no ``query.gather`` span carries the count: a
program that gathers every level row for every key."""
from perfbench.program_spans import calls, counted


def read(ctx):
    cs = calls(ctx, "query_entropy")
    if not cs or not any("slots" in (s.counts or {}) for c in cs
                         for s in c.spans if s.name == "query.gather"):
        return None
    return counted(ctx, "query_entropy", "slots", name="query.gather") * 1e-6
