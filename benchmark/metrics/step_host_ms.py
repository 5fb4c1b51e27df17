"""step_host_ms.<mode>: host milliseconds a call of the program's step
takes, the mean over every call of the traced run's window (the
benchmark's own span around each call: the batch's copy into the
captured step's buffers and the replay's launch)."""


def read(ctx):
    times = ctx.window.host_ms
    return sum(times) / len(times) if times else None
