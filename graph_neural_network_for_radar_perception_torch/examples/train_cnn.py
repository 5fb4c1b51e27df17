"""Train the BEV-grid CNN detector (script_train_model_cnn.ipynb analog).

The port of the JAX package's ``examples/train_cnn.py``: the grid samples
are built on the device (``data/grid``) and the CNN runs cuDNN's
convolutions on the card, with TF32 off (f32 results, as the JAX
package's); no hand-written kernel is on this path.

Run: python -m graph_neural_network_for_radar_perception_torch.examples.train_cnn --iters 200
"""

import argparse

import numpy as np
import torch

from ..config.config import GNNConfig
from ..data.grid import GridSpec
from ..data.pipeline import preprocess_frame_hybrid
from ..data.synthetic import make_synthetic_frame
from ..models import cnn as CNN


def main(argv=None):
    """Returns each step's metrics (floats)."""
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--grid", type=int, default=64,
                   help="cells per side (reference uses 200)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        # f32 convolutions on the card; the flag is cuDNN's alone (on a
        # CPU-only build, setting it corrupted the heap in conv backward)
        torch.backends.cudnn.allow_tf32 = False

    cfg = GNNConfig()
    g = args.grid
    spec = GridSpec(
        min_x=0, max_x=100, min_y=-50, max_y=50,
        dx=100 / g, dy=100 / g,
    )
    ccfg = CNN.CNNConfig()
    rng = np.random.default_rng(0)

    def batch():
        items = []
        while len(items) < args.batch_size:
            data = make_synthetic_frame(rng, num_objects=6, window_size=5)
            _, gs = preprocess_frame_hybrid(data, cfg, spec, max_meas=1024,
                                            device=args.device)
            items.append(gs)
        return tuple(
            np.stack([it[k] for it in items])
            for k in ("image", "vr", "rcs", "label_grid", "offset_grid")
        )

    init, step, _ = CNN.make_grid_train_step(ccfg)
    # The JAX example initialises from one batch, which is drawn here too,
    # so that both take the same frames.
    batch()
    state = init(torch.Generator().manual_seed(0), device=args.device)
    history = []
    for it in range(args.iters):
        state, m = step(state, *batch())
        m = {k: float(v) for k, v in m.items()}
        history.append(m)
        if (it + 1) % max(args.iters // 10, 1) == 0:
            print(
                f"iter {it + 1}: total {m['loss_total']:.4f} "
                f"cls {m['loss_cls']:.4f} "
                f"reg {m['loss_reg']:.4f}"
            )
    return history


if __name__ == "__main__":
    main()
