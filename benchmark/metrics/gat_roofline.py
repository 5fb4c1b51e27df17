"""gat_roofline.<mode>: the GATv2 round's share (%) of its roofline.

The attention entry of the configuration's adapter (``attn_entry``: one
``GATv2Conv`` at the configuration's widths) is called on the cell's own
batches, one call a batch of the pool with its graphs, on activations
drawn from the seed: the forward for ``eval``, forward and backward for
``train``.  The calls are captured as one CUDA graph and timed by CUDA
events over its replays (the median of ``REPLAYS``), as ``mp_roofline``
times the fused round.  The bound is the round's least work on those
inputs (``counts_gat.gat_work``: live nodes and edges only) at the
H100's peaks, the larger of operations over 67 TFLOP/s and bytes over
3.35 TB/s, summed over the calls.  It reads the same work whatever
implements the round.  Nothing where the adapter has no attention entry
or off the card."""

import torch

REPLAYS = 10


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    entry = getattr(ctx.program, "attn_entry", None)
    work = getattr(ctx.counts, "gat_work", None)
    if entry is None or work is None:
        return None
    run = entry()
    train = ctx.mode == "train"
    cfg, dev = ctx.cfg, ctx.device
    d = cfg["graph_convolution_stem_channels"][0]
    de = cfg["edge_feat_enc_stem_channels"][-1]
    heads = cfg["num_heads_gat"]
    c = cfg["hidden_node_channels_gat"] // heads
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    calls, bound = [], 0.0
    for batch, live in zip(ctx.pool, ctx.live):
        g = batch["graph"]
        node_mask = torch.from_numpy(g["node_mask"]).to(dev)
        edge_mask = torch.from_numpy(g["edge_mask"]).to(dev)
        s = torch.from_numpy(g["senders"]).to(dev)
        r = torch.from_numpy(g["receivers"]).to(dev)
        b, n = node_mask.shape
        e = edge_mask.shape[-1]
        x = torch.randn(b, n, d, generator=gen, device=dev).requires_grad_(train)
        ef = (torch.randn(b, e, de, generator=gen, device=dev)
              * edge_mask[..., None]).requires_grad_(train)
        g_out = torch.randn(b, n, heads * c, generator=gen, device=dev) if train else None
        calls.append((x, ef, s, r, node_mask, edge_mask, g_out))
        flops, nbytes = work(int(live["nodes"].sum()), int(live["edges"].sum()),
                             d, de, heads, c, backward=train)
        bound += ctx.counts.least_seconds(flops, nbytes)[0]

    def body():
        with torch.set_grad_enabled(train):
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
