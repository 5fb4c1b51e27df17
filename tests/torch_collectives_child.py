"""One rank of the collectives check, for tests/test_torch_parallel.py.

    python tests/torch_collectives_child.py STORE WORLD RANK OUT

Joins a gloo group of WORLD ranks on the CPU (a FileStore at STORE), runs
each collective of ``parallel/collectives.py`` over the world on a [2, 3]
tensor that depends on the rank, backprops a cotangent of 1 + rank, and
saves each one's output and input gradient (pmax: its backward's error) to
OUT.  Imports torch and the port only, never JAX.
"""

import os
import sys

import torch

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
    torch.save(out, out_path)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
