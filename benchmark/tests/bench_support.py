"""Shared settings of the benchmark's CPU tests: the import paths of a run
and a configuration and mix small enough for the CPU."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(node_feat_enc_stem_channels=[32, 16], edge_feat_enc_stem_channels=[32, 16],
            graph_convolution_stem_channels=[16, 16], msg_mlp_hidden_dim=32,
            link_pred_stem_channels=[16, 16], node_pred_stem_channels=[16, 16],
            max_nodes=64, max_clusters=32, temporal_window_size=3)
TINY_MIX = dict(pool=3, batch=2, objects=[2, 4], profile_steps=2)
SEED = 2**31 + 1234
