"""One rank of the collectives check, for tests/test_torch_parallel.py.

    python tests/torch_collectives_child.py STORE WORLD RANK OUT

Joins a gloo group of WORLD ranks on the CPU (a FileStore at STORE), runs
each collective of ``parallel/collectives.py`` over the world on a [2, 3]
tensor that depends on the rank, backprops a cotangent of 1 + rank, and
saves each one's output and input gradient (pmax: its backward's error) to
OUT.  Then, over the world (G = WORLD) and over the pairs of ranks
(G = 2), ``ppermute`` (i -> i + 1), ``all_gather`` and tiled
``all_gather`` on random [3, 5] rows with random cotangents, once through
each route (native, and staged by forcing ``collectives._staged``): each
output, input gradient and ``collectives.counts()`` advance of the forward
and of the backward.  Imports torch and the port only, never JAX.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from graph_neural_network_for_radar_perception_torch.parallel import (  # noqa: E402
    collectives as P,
)
from graph_neural_network_for_radar_perception_torch.parallel.distributed import (  # noqa: E402
    init_distributed,
)


def main(store, world, rank, out_path):
    torch.set_num_threads(1)
    init_distributed(num_processes=world, process_id=rank, device="cpu", store=store,
                     timeout_s=120)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    perm = [(i, i + 1) for i in range(world - 1)]  # rank 0 receives nothing
    cases = {
        "psum": lambda t: P.psum(t, None),
        "ppermute": lambda t: P.ppermute(t, perm, None),
        "all_gather": lambda t: P.all_gather(t, None),
        "all_gather_tiled": lambda t: P.all_gather(t, None, tiled=True),
        "pmax": lambda t: P.pmax(t, None),
    }
    out = {}
    for name, fn in cases.items():
        t = x.clone().requires_grad_(True)
        y = fn(t)
        try:
            y.backward(torch.full_like(y, 1.0 + rank))
            grad = t.grad.numpy()
        except NotImplementedError as e:
            grad = str(e)
        out[name] = (y.detach().numpy(), grad)

    pairs = [dist.new_group([i, i + 1]) for i in range(0, world, 2)]
    staged = P._staged
    routes = {}
    for g, group in ((world, None), (2, pairs[rank // 2])):
        chain = [(i, i + 1) for i in range(g - 1)]
        ops = {"ppermute": lambda t: P.ppermute(t, chain, group),
               "all_gather": lambda t: P.all_gather(t, group),
               "all_gather_tiled": lambda t: P.all_gather(t, group, tiled=True)}
        for name, fn in ops.items():
            for route in ("native", "staged"):
                P._staged = lambda *_: route == "staged"  # noqa: E731
                rng = np.random.default_rng(100 * g + rank)
                t = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
                t.requires_grad_(True)
                c0 = P.counts()
                y = fn(t)
                c1 = P.counts()
                y.backward(torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32)))
                c2 = P.counts()
                routes[g, name, route] = (y.detach().numpy(), t.grad.numpy(),
                                          [b - a for a, b in zip(c0, c1)],
                                          [b - a for a, b in zip(c1, c2)])
    P._staged = staged
    out["routes"] = routes
    torch.save(out, out_path)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
