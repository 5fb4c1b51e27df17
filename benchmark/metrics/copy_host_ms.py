"""copy_host_ms.<mode>: host milliseconds a call of the program's step spends
copying the batch into the captured graph's buffers: the mean of the
program's ``captured.copy`` host spans over the traced stretch
(``harness/program_trace``)."""

from harness import program_trace as pt


def read(ctx):
    t = pt.get(ctx)
    return None if t is None else pt.copy_host_ms(t)
