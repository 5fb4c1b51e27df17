"""step_mfu.<mode>: the window's model FLOPs over its time, as a share
(%) of the H100's float32 peak: every matrix product of each step over
its batch's live rows (``counts.model_flops``; the backward at twice the
forward for ``train``), summed over the window's steps, over the
window's seconds times 67 TFLOP/s."""


def read(ctx):
    if ctx.device.type != "cuda" or not ctx.window.index:
        return None
    c = ctx.counts
    per_batch = [c.model_flops(ctx.cfg, int(v["nodes"].sum()), int(v["edges"].sum()),
                               int(v["und"].sum()), int(v["clusters"].sum()),
                               train=ctx.mode == "train") for v in ctx.live]
    flops = sum(per_batch[b] for b in ctx.window.index)
    return 100.0 * flops / (ctx.window.elapsed * c.PEAK_F32_FLOPS)
