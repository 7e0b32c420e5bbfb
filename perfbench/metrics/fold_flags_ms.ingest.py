"""B1 dispatch: ``fleet.fold_flags`` (the UnivMon level and §4.4 flag folded
into every packet's ts, ``fold_packet_flags``), ms a dispatched window
(the program's spans)."""
from perfbench.program_spans import step_ms


def read(ctx):
    return step_ms(ctx, "run_window", "fleet.fold_flags")
