"""Train the flagship radar GNN (script_train_model_gnn.ipynb analog).

The port of the JAX package's ``examples/train_gnn.py``: RadarScenes if
--data-root points at a real dataset (read with ``h5py``), otherwise the
synthetic scene generator; every step runs the fused message-pass kernels,
forward and backward, on the card.  Checkpoints go to ``<out>/ckpt`` (the
port's ``CheckpointManager``), ``--resume`` continues from the latest.
``--model`` picks the model family: ``gnn`` (the flagship ``RadarGNN``,
the default), ``v1`` (``RadarGNNv1``, the shared node head) or ``v2``
(``RadarGNNv2``, the GATv2 neck at ``hidden_node_channels_gat`` over
``num_heads_gat`` heads, plain PyTorch).

Run: python -m graph_neural_network_for_radar_perception_torch.examples.train_gnn --iters 2000
"""

import argparse
import os

import torch

from ..config.config import GNNConfig
from ..data.prefetch import device_prefetch
from ..models.gat import RadarGNNv2
from ..models.gnn import RadarGNN, RadarGNNv1
from ..train.steps import create_train_state
from ..train.trainer import TrainHooks, train
from ..utils.checkpoint import CheckpointManager
from ..utils.metrics_writer import MetricsWriter


MODELS = {"gnn": RadarGNN, "v1": RadarGNNv1, "v2": RadarGNNv2}


def main(argv=None):
    """Returns the final TrainState."""
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", default=None,
                   help="RadarScenes root (contains <dataset_dir>)")
    p.add_argument("--config", default=None, help="reference-format YAML")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--out", default=os.path.join("runs", "torch", "gnn"))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", choices=sorted(MODELS), default="gnn",
                   help="model family: the flagship, v1's shared node head or v2's GATv2 neck")
    args = p.parse_args(argv)

    cfg = (
        GNNConfig.from_yaml(args.config) if args.config else GNNConfig()
    )
    if args.batch_size:
        cfg.batch_size = args.batch_size
    iters = args.iters or cfg.max_train_iter

    if args.data_root:
        from ..data.radarscenes import (
            RadarScenesDataset, SequenceCache, build_metadata,
            train_val_test_split,
        )

        train_seqs, val_seqs, _ = train_val_test_split(
            args.data_root, cfg.dataset_dir
        )
        cache = SequenceCache(args.data_root, cfg.dataset_dir)
        tmd = build_metadata(cache, train_seqs, cfg.temporal_window_size)
        vmd = build_metadata(cache, val_seqs, cfg.temporal_window_size)
        train_ds = RadarScenesDataset(
            cfg, args.data_root, tmd, augment=cfg.dataset_augmentation
        )
        val_ds = RadarScenesDataset(cfg, args.data_root, vmd)
        train_iter = train_ds.batches(cfg.batch_size)
        val_iter = lambda: val_ds.batches(cfg.batch_size)
    else:
        from ..data.pipeline import SyntheticRadarDataset

        print("No --data-root: training on synthetic frames")
        cfg.max_nodes, cfg.max_clusters = 512, 256
        train_iter = SyntheticRadarDataset(cfg, seed=cfg.seed).batches(
            cfg.batch_size
        )
        val_iter = lambda: SyntheticRadarDataset(cfg, seed=999).batches(
            cfg.batch_size
        )

    ckpt = CheckpointManager(os.path.join(args.out, "ckpt"))
    state = create_train_state(cfg, torch.Generator().manual_seed(cfg.seed),
                               device=args.device, model_cls=MODELS[args.model])
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(template=state)
        start = state.step
        print(f"resumed from step {start}")

    writer = MetricsWriter(os.path.join(args.out, "logs"))
    hooks = TrainHooks(
        log_period=100,
        val_period=1000,
        checkpoint=ckpt,
        writer=writer,
    )
    state = train(
        cfg,
        device_prefetch(train_iter, device=args.device),
        val_batches=val_iter,
        hooks=hooks,
        state=state,
        max_iters=iters,
        starting_iter=start,
    )
    writer.close()
    return state


if __name__ == "__main__":
    main()
