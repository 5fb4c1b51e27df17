"""The system under test for the GATv2 family: the port's ``RadarGNNv2``
(``models/gat.py``), reached only through here and ``harness/program.py``.

As ``harness/program.py``'s adapter, with the train state built as a
``RadarGNNv2``; the model has no fused message round (``round_entry`` is
None), and ``attn_entry`` gives one of its GATv2 convolutions for the
metric ``gat_roofline``.
"""

from __future__ import annotations

import torch

from graph_neural_network_for_radar_perception_torch.models.blocks import init_parameters
from graph_neural_network_for_radar_perception_torch.models.gat import GATv2Conv, RadarGNNv2
from graph_neural_network_for_radar_perception_torch.train import steps

from harness import program
from harness.program import as_batch  # noqa: F401  (part of the adapter's interface)


class Program(program.Program):
    """The port's ``RadarGNNv2`` at one configuration on one device."""

    def train_state(self, weights):
        """A fresh ``RadarGNNv2`` train state (model and optimiser) holding
        ``weights``."""
        state = steps.create_train_state(self.pcfg, torch.Generator().manual_seed(0),
                                         device=self.device, model_cls=RadarGNNv2)
        own = dict(state.model.named_parameters())
        if {k: tuple(v.shape) for k, v in own.items()} != {
                k: tuple(v.shape) for k, v in weights.items()}:
            raise RuntimeError("the port's parameters differ from the reference's list")
        with torch.no_grad():
            for name, p in own.items():
                p.copy_(weights[name])
        return state

    def round_entry(self):
        return None

    def attn_entry(self):
        """``run(x, ef, senders, receivers, node_mask, edge_mask, g_out=None)``:
        one ``GATv2Conv`` of the configuration's widths (its weights drawn
        as the port initialises them, from a fixed seed) over a batch (x
        [B, N, D], ef [B, E, De], the rest [B, ...]); with ``g_out`` the
        gradients of the aggregate for that cotangent with respect to x,
        ef and every weight of the conv."""
        cfg = self.pcfg
        heads = cfg.num_heads_gat
        conv = GATv2Conv(cfg.graph_convolution_stem_channels[0],
                         cfg.edge_feat_enc_stem_channels[-1],
                         cfg.hidden_node_channels_gat // heads, heads)
        init_parameters(conv, torch.Generator().manual_seed(0))
        conv = conv.to(self.device)
        weights = list(conv.parameters())

        def run(x, ef, senders, receivers, node_mask, edge_mask, g_out=None):
            out = conv(x, ef, senders, receivers, node_mask, edge_mask)
            if g_out is None:
                return out
            return torch.autograd.grad(out, [x, ef, *weights], g_out)

        return run
