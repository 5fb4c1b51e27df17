"""capture_s.<mode>: seconds the program spent capturing its step before the
reader ran: its one-off spans ``captured.warmup`` (the two eager runs)
and ``captured.capture`` of the set-up, and of any capture in the window
(``harness/program_trace``)."""

from harness import program_trace as pt


def read(ctx):
    t = pt.get(ctx)
    return None if t is None else pt.capture_s(t)
