"""copy_stall_share.<mode>: the share (%) of the traced stretch's wall time in
which the device was in the batch copy (the program's ``captured.copy``
device spans), or idle while the host was inside ``captured.copy`` (no
copy or replay device span running): what the copy costs the device
(``harness/program_trace``)."""

from harness import program_trace as pt


def read(ctx):
    t = pt.get(ctx)
    return None if t is None else pt.copy_stall_share(t)
