"""mp_step_share.<mode>: the message rounds' share (%) of the step's device
time: the in-graph ``mp.forward`` and ``mp.backward`` spans over the
replays' device spans, summed over the traced stretch's sampled replays
(``harness/program_trace``)."""

from harness import program_trace as pt


def read(ctx):
    t = pt.get(ctx)
    return None if t is None else pt.mp_share(t, ctx.mode)
