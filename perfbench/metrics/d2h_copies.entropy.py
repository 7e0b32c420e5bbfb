"""Device-to-host copies (``torch.profiler``'s memcpy DtoH events) per
query in the profiled part of the window."""


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof["kernel_s"]:
        return None
    return ctx.per_profiled_op(float(prof["d2h"]))
