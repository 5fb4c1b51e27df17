"""device_idle_share.<mode>: the share (%) of the profiled stretch of
steps in which no operation ran on the device: 100 · (1 − busy / wall),
busy the union of the device operations' intervals."""


def read(ctx):
    t = ctx.trace
    if ctx.device.type != "cuda" or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
