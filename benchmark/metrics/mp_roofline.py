"""mp_roofline.<mode>: the message round's share (%) of its roofline.

The round entry of the configuration (the fused round) is called on the
cell's own batches, one call a batch of the pool with its graphs, at the
configuration's widths, with activations and weights drawn from the
seed: the forward for ``eval``, forward and backward for ``train``.  The
calls are captured as one CUDA graph and timed by CUDA events over its
replays (the median of ``REPLAYS``).  The bound is the round's least
work on those inputs (``counts.round_work``: live nodes and edges only)
at the H100's peaks: the larger of operations over 67 TFLOP/s and bytes
over 3.35 TB/s, summed over the calls.  Nothing when the round has no
such entry or off the card."""

import math

import torch

REPLAYS = 10


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    train = ctx.mode == "train"
    entry = ctx.program.round_entry()
    if entry is None:
        return None
    run, make_layout = entry
    cfg, dev = ctx.cfg, ctx.device
    d = cfg["graph_convolution_stem_channels"][0]
    de = cfg["edge_feat_enc_stem_channels"][-1]
    h, d2 = cfg["msg_mlp_hidden_dim"], cfg["graph_convolution_stem_channels"][0]
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)

    def uniform(*shape, fan_in):
        t = (2 * torch.rand(*shape, generator=gen, device=dev) - 1) / math.sqrt(fan_in)
        return t.requires_grad_(train)

    w = [uniform(2 * d + de, h, fan_in=2 * d + de), uniform(h, fan_in=2 * d + de),
         uniform(h, d2, fan_in=h), uniform(d2, fan_in=h)]
    scal = [torch.full((1,), v, device=dev, requires_grad=train) for v in (1.0, 0.0, 1.0, 0.0)]
    calls, bound = [], 0.0
    for batch, live in zip(ctx.pool, ctx.live):
        g = batch["graph"]
        mask = torch.from_numpy(g["edge_mask"]).to(dev)
        b, n = g["node_mask"].shape
        e = mask.shape[-1]
        sentinel = torch.full_like(mask, n, dtype=torch.int32)
        s = torch.where(mask, torch.from_numpy(g["senders"]).to(dev), sentinel).int()
        r = torch.where(mask, torch.from_numpy(g["receivers"]).to(dev), sentinel).int()
        x = torch.randn(b, n, d, generator=gen, device=dev).requires_grad_(train)
        ef = (torch.randn(b, e, de, generator=gen, device=dev) * mask[..., None]).requires_grad_(train)
        g_out = torch.randn(b, n, d2, generator=gen, device=dev) if train else None
        layout = make_layout(s, r, n)
        calls.append((x, ef, s, r, *w, *scal, layout, g_out))
        flops, nbytes = ctx.counts.round_work(int(live["nodes"].sum()), int(live["edges"].sum()),
                                              d, de, h, d2, backward=train)
        bound += ctx.counts.least_seconds(flops, nbytes)[0]

    def body():
        for args in calls:
            run(*args)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            body()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    graph.replay()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(REPLAYS):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z) / 1e3)
    times.sort()
    measured = times[len(times) // 2]
    del graph, calls
    return 100.0 * bound / measured
