"""B1 dispatch: ``fleet.pack_csr`` (each row group's ``FleetPacket.select``
and ``pack_csr``), ms a dispatched window (the program's spans)."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "run_window", "fleet.pack_csr")
