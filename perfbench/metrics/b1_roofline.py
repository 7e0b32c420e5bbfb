"""Update kernel B1: the least bytes of the profiled passes' launches
(``perfbench/roofline.py::b1_bytes``) at the card's HBM bandwidth, over
the ``fleet_ragged_kernel`` device time the profiler recorded (%)."""
from perfbench import roofline


def read(ctx):
    prof, run = ctx.profile, ctx.run
    touched = ctx.found.get("counters_touched")
    if prof is None or not run.profiled_ops or touched is None:
        return None
    kernel_s = sum(s for name, s in prof["kernel_s"].items()
                   if roofline.B1_KERNEL in name)
    if kernel_s <= 0:
        return None
    nbytes = run.profiled_ops * roofline.b1_bytes(
        run.events_per_pass, run.param_rows_per_pass, touched)
    return roofline.roofline_pct(nbytes, kernel_s)
