"""Frame-level detection pipeline: preprocess → model → decode → proposals.

The JAX package's ``infer/pipeline.py`` (the reference's
modules/inference/output.py:26-363): one deploy forward per padded frame
(DBSCAN on the device; on the card one CUDA graph, replayed), decoded to
numpy detections with per-cluster statistics, object classes from the
object head or by segmentation-majority vote (output.py:112-121), and the
FALSE class filtered from the final detections (output.py:123-128).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config.config import GNNConfig
from ..core.graph import RadarGraph, resolve_device
from ..data.labels import ID_FALSE
from ..data.pipeline import FrameArrays, pad_frame, preprocess_frame
from ..models.gnn import RadarGNN
from ..train.steps import CapturedGraphs, shape_key
from .proposals import compute_proposals


@dataclasses.dataclass
class FrameDetections:
    """Decoded per-frame outputs (unpadded numpy)."""

    node_class: np.ndarray        # [n] predicted class ids
    node_score: np.ndarray        # [n] softmax score of the argmax class
    centers: np.ndarray           # [n, 2] decoded cluster centers
    link_class: np.ndarray        # [eu] predicted link labels
    node2cluster: np.ndarray      # [n] DBSCAN cluster id
    num_clusters: int
    cluster_mu: np.ndarray        # [C, 2]
    cluster_sigma: np.ndarray     # [C, 2, 2]
    cluster_size: np.ndarray      # [C]
    cluster_class: np.ndarray     # [C] chosen object class per cluster
    xy: np.ndarray                # [n, 2] measurement positions
    gt: Optional[FrameArrays] = None

    def detections(self, filter_false: bool = True) -> Dict[str, np.ndarray]:
        """Final object list; drops class FALSE like output.py:123-128."""
        keep = np.ones(self.num_clusters, dtype=bool)
        if filter_false:
            keep &= self.cluster_class[: self.num_clusters] != ID_FALSE
        idx = np.flatnonzero(keep)
        return {
            "mu": self.cluster_mu[idx],
            "sigma": self.cluster_sigma[idx],
            "size": self.cluster_size[idx],
            "obj_class": self.cluster_class[idx],
            "cluster_ids": idx,
        }


class FrameDetector:
    """Deploy-mode detector over padded frames.

    ``state_dict`` holds the weights of a ``RadarGNN(cfg)`` (see
    ``utils.convert.state_dict_from_flax`` for weights trained by the JAX
    package).  The model runs on the card unless ``device="cpu"`` is
    passed.

    On the card ``RadarGNN.deploy`` and the softmax run as one CUDA graph
    per (frame shapes, eps, from_links, mp_impl) — the JAX package jits
    them into one program (``_run``): each frame's padded arrays are copied
    into the graph's static ``RadarGraph`` buffers and the graph replayed
    (``train/steps.CapturedGraphs``: two warm-up runs, the second under
    sync debug "error", then the capture; a failed capture raises).  The
    decode and ``compute_proposals`` run after it, as JAX runs them
    outside its jit.  On the CPU the forward runs eagerly."""

    def __init__(
        self,
        cfg: GNNConfig,
        state_dict: Mapping[str, torch.Tensor],
        *,
        eps: float = 1.4,
        from_links: bool = False,
        use_object_head: bool = True,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.eps = eps
        self.from_links = from_links
        self.use_object_head = use_object_head
        model = RadarGNN(cfg)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.captured = CapturedGraphs()

    def _run(self, graph: RadarGraph):
        """(DeployOutputs, node class probabilities, graph) of one padded
        graph on the detector's device."""
        with torch.no_grad():
            out = self.model.deploy(graph, eps=self.eps, from_links=self.from_links)
            return out, torch.softmax(out.node_cls, dim=-1), graph

    def forward(self, graph_np: RadarGraph):
        """(DeployOutputs, node class probabilities, graph) of a padded
        numpy graph (``pad_frame``'s): on the card its arrays copied into
        the captured graph's buffers and one replay, whose outputs the next
        replay overwrites; on the CPU the eager forward."""
        if self.device.type == "cpu":
            return self._run(RadarGraph.from_numpy(graph_np, self.device))
        leaves = [getattr(graph_np, f) for f in RadarGraph.__dataclass_fields__]
        key = (shape_key(leaves), self.eps, self.from_links, self.cfg.mp_impl)
        return self.captured.run(key, leaves, lambda inputs: self._run(RadarGraph(*inputs)),
                                 self.device, keep=self.model, label="detect.replay")

    def detect_frame_arrays(self, fr: FrameArrays) -> FrameDetections:
        graph_np, _ = pad_frame(fr, self.cfg)
        # On the card: the graph's outputs, overwritten by the next replay,
        # are read below before it.
        out, node_prob, graph = self.forward(graph_np)

        n = min(fr.n, self.cfg.max_nodes)  # pad_frame truncates oversize
        node_prob = node_prob[:n].cpu().numpy()
        node_cls = node_prob.argmax(-1)
        node_cls_padded = np.pad(node_cls, (0, self.cfg.max_nodes - n))
        props = compute_proposals(
            graph.other_feat[:, :2],
            torch.from_numpy(node_cls_padded).to(self.device),
            out.node2cluster,
            graph.node_mask,
            self.cfg.max_nodes,
            self.cfg.num_classes,
        )
        if self.use_object_head:
            cluster_class = out.obj_cls.argmax(-1).cpu().numpy()
        else:  # segmentation-majority (output.py:112-121)
            cluster_class = props.label.cpu().numpy()

        n_und = min(fr.und_senders.shape[0], self.cfg.max_und_edges)
        return FrameDetections(
            node_class=node_cls.astype(np.int32),
            node_score=node_prob.max(-1),
            centers=out.centers[:n].cpu().numpy(),
            link_class=out.edge_cls.argmax(-1)[:n_und].cpu().numpy(),
            node2cluster=out.node2cluster[:n].cpu().numpy(),
            num_clusters=int(out.num_clusters),
            cluster_mu=props.mu.cpu().numpy(),
            cluster_sigma=props.sigma.cpu().numpy(),
            cluster_size=props.size.cpu().numpy(),
            cluster_class=cluster_class.astype(np.int32),
            xy=fr.other_feat[:n, :2],
            gt=fr,
        )

    def detect(self, data_dict: dict) -> Optional[FrameDetections]:
        """Full pipeline from a raw windowed data_dict."""
        fr = preprocess_frame(data_dict, self.cfg)
        if fr is None:
            return None
        return self.detect_frame_arrays(fr)
