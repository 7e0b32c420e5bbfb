"""B1 dispatch: packets whose UnivMon level the CSR scatter folded into
their ts on the card (the ``folded`` counts of ``fleet.pack_csr``) per
dispatched window: the window's events where the card folds, 0 where it
does not (Count Sketch).  None where no ``fleet.pack_csr`` span carries
the count: a program that folds every level on the host."""
from perfbench.program_spans import calls, counted


def read(ctx):
    cs = calls(ctx, "run_window")
    if not cs or not any("folded" in (s.counts or {}) for c in cs
                         for s in c.spans if s.name == "fleet.pack_csr"):
        return None
    return counted(ctx, "run_window", "folded", name="fleet.pack_csr")
