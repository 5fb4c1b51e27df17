"""copy_gbps.<mode>: the batch copy's rate in GB/s: the program's counter
``captured.copy_bytes`` over its ``captured.copy`` device spans, over the
traced stretch (``harness/program_trace``)."""

from harness import program_trace as pt


def read(ctx):
    t = pt.get(ctx)
    return None if t is None else pt.copy_gbps(t)
