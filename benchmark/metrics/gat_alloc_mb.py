"""gat_alloc_mb.<mode>: the megabytes (1e6 bytes) the caching allocator
hands out during one GATv2 round's forward: the port's counter
``gat.alloc_bytes`` over ``gat.rounds``, both counted while the tracer is
on, over every part of the traced run (``harness/program_trace``: the
traced capture's two warm-ups and the capture itself; a replay runs no
Python).  It counts what the round makes whatever implements it, so a
round that keeps its edge-sized intermediates out of memory reads less.
Nothing where the program has no such counters."""

from harness import program_trace as pt


def read(ctx):
    t = pt.get(ctx)
    if t is None:
        return None
    total = {"gat.alloc_bytes": 0, "gat.rounds": 0}
    for part in ("setup", "capture", "stretch"):
        for k in total:
            total[k] += t[part]["counters"].get(k, 0)
    if total["gat.rounds"] <= 0:
        return None
    return total["gat.alloc_bytes"] / total["gat.rounds"] / 1e6
