"""bwd_device_ms.<mode>: device milliseconds of the train step's backward: the
median over the traced stretch's sampled replays of the in-graph span
``train_step.backward`` (``harness/program_trace``)."""

from harness import program_trace as pt


def read(ctx):
    t = pt.get(ctx)
    return None if t is None else pt.phase_ms(t, ctx.mode, "backward")
