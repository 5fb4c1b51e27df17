"""gat_step_share.<mode>: the GATv2 rounds' share (%) of the step's device
time: the in-graph ``gat.forward`` and ``gat.backward`` spans of the
port's ``models/gat.py`` over the replays' device spans, summed over the
traced stretch's sampled replays (``harness/program_trace``).  Nothing
where the program has no such spans (a model without the GATv2 neck, or
a program without them)."""

from harness import program_trace as pt


def read(ctx):
    t = pt.get(ctx)
    if t is None:
        return None
    replays = pt._replays(t["stretch"], f"{pt.STEP[ctx.mode]}.replay").values()
    whole = sum(pt._ns(e["replay"]) for e in replays)
    gat = sum(pt._ns(s) for e in replays for s in e["inner"] if s["name"].startswith("gat."))
    return 100.0 * gat / whole if whole > 0 and gat > 0 else None
