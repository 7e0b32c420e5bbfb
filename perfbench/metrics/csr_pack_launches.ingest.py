"""B1 dispatch: launches of the CSR scatter that builds B1's stream on the
card (the ``launches`` counts of ``fleet.pack_csr``) per dispatched window.
None where no ``fleet.pack_csr`` span carries the count: a program whose
packing has no such counter."""
from perfbench.program_spans import calls, counted


def read(ctx):
    cs = calls(ctx, "run_window")
    if not cs or not any("launches" in (s.counts or {}) for c in cs
                         for s in c.spans if s.name == "fleet.pack_csr"):
        return None
    return counted(ctx, "run_window", "launches", name="fleet.pack_csr")
