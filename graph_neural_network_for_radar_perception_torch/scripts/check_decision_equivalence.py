"""Deployment equivalence: the card's inference path (the fused
message-pass kernel, cuBLAS, DBSCAN on the card) must produce the SAME
decisions as the CPU's plain path on real detector outputs: per-node
classes, DBSCAN cluster partitions and per-cluster object classes.

The port of root ``scripts/check_tpu_decision_equivalence.py``: runs
``FrameDetector`` with the committed fixture-trained weights
(``runs/fixture_artifact/weights.msgpack``, read without JAX by
``utils/checkpoint.load_params_msgpack``) over 12 mini-RadarScenes windows
(``data/mini_radarscenes``, made in memory) once on ``--device`` and once
on the CPU, in one process, and diffs the decision records.  Cluster ids
are compared as partitions (membership signatures), not raw ids.

Run: python -m graph_neural_network_for_radar_perception_torch.scripts.check_decision_equivalence
"""

from __future__ import annotations

import argparse
import json
import os

from ..config.config import GNNConfig
from ..data.mini_radarscenes import MemorySequenceCache, make_sequence
from ..data.pipeline import preprocess_frame
from ..infer.pipeline import FrameDetector
from ..utils.checkpoint import load_params_msgpack
from ..utils.convert import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARTIFACT = os.path.join(REPO, "runs", "fixture_artifact")
N_FRAMES = 12


def run_device(device) -> list:
    """The decision record of each of the 12 windows on ``device`` (None
    where preprocessing keeps no frame)."""
    with open(os.path.join(ARTIFACT, "config.json")) as f:
        saved = json.load(f)
    cfg = GNNConfig(
        max_nodes=int(saved["max_nodes"]),
        max_clusters=int(saved["max_clusters"]),
        temporal_window_size=int(saved["temporal_window_size"]),
    )
    weights = state_dict_from_flax(
        load_params_msgpack(os.path.join(ARTIFACT, "weights.msgpack")))
    det = FrameDetector(cfg, weights, eps=1.4, use_object_head=True, device=device)

    cache = MemorySequenceCache({"sequence_9": make_sequence(
        seed=777, n_scenes=N_FRAMES + 6, n_objects=4, seq_name="sequence_9")})
    records = []
    for w in cache.windows("sequence_9", 5)[:N_FRAMES]:
        fr = preprocess_frame(cache.extract_window("sequence_9", w), cfg)
        if fr is None:
            records.append(None)
            continue
        d = det.detect_frame_arrays(fr)
        # Partition signature: for each cluster, the sorted node-index
        # tuple + its object class — invariant to cluster id relabeling.
        clusters = {}
        for node, cid in enumerate(d.node2cluster.tolist()):
            clusters.setdefault(cid, []).append(node)
        sig = sorted(
            (tuple(v), int(d.cluster_class[k])) for k, v in clusters.items()
        )
        records.append({
            "node_class": d.node_class.tolist(),
            "partition": [[list(m), c] for m, c in sig],
        })
    return records


def compare(a: list, b: list, what: str) -> int:
    """The number of frames compared; raises at the first decision of
    records ``a`` that differs from ``b``'s."""
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} frames against {len(b)}")
    n_cmp = 0
    for i, (x, y) in enumerate(zip(a, b)):
        if (x is None) != (y is None):
            raise AssertionError(f"{what}: frame {i}: presence differs")
        if x is None:
            continue
        if x["node_class"] != y["node_class"]:
            raise AssertionError(f"{what}: frame {i}: node classes differ")
        if x["partition"] != y["partition"]:
            raise AssertionError(
                f"{what}: frame {i}: cluster partition / object classes differ")
        n_cmp += 1
    return n_cmp


def main(argv=None):
    """Returns the number of frames compared."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="the device whose decisions are held to the CPU's")
    args = p.parse_args(argv)
    records = run_device(args.device)
    n_cmp = compare(records, run_device("cpu"), f"{args.device} vs cpu")
    print(f"OK: {n_cmp} frames — {args.device} decisions (node classes, DBSCAN "
          f"partitions, object classes) identical to the CPU path")
    return n_cmp


if __name__ == "__main__":
    main()
