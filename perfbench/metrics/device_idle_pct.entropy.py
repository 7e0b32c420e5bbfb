"""The device: the share of the traced window in which no kernel, copy or
fill ran on it (``torch.profiler``), in percent."""


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof["window_s"] or not prof["kernel_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
