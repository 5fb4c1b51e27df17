"""The system under test: the PyTorch port, reached only through here.

Builds the port's configuration from a cell's configuration file, its
train state with the benchmark's weights, its captured train and eval
steps and its message-round entry, and reads back what the comparison
needs (the parameters and the momentum by name).  The default adapter of
a configuration (``harness/cell.resolve_modules``); only it and another
family's adapter, ``harness/program_<family>.py``, import the port.
"""

from __future__ import annotations

from typing import Dict

import torch

from graph_neural_network_for_radar_perception_torch.config.config import GNNConfig
from graph_neural_network_for_radar_perception_torch.core.graph import (
    GraphBatch, GraphLabels, RadarGraph)
from graph_neural_network_for_radar_perception_torch.ops import fused_mp
from graph_neural_network_for_radar_perception_torch.train import steps

# configuration keys of the benchmark that are arguments of the step, not
# fields of the port's GNNConfig
_STEP_KEYS = ("mp_bf16",)


def port_config(cfg: dict) -> GNNConfig:
    fields = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in cfg.items() if k not in _STEP_KEYS}
    return GNNConfig(**fields)


def as_batch(batch: dict) -> GraphBatch:
    """The benchmark's batch as the port's container of numpy arrays."""
    return GraphBatch(RadarGraph(**batch["graph"]), GraphLabels(**batch["labels"]))


class Program:
    """The port at one configuration on one device."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.pcfg = port_config(cfg)
        self.device = torch.device(device)

    def train_state(self, weights: Dict[str, torch.Tensor]):
        """A fresh train state (model and optimiser) holding ``weights``."""
        state = steps.create_train_state(self.pcfg, torch.Generator().manual_seed(0),
                                         device=self.device)
        own = dict(state.model.named_parameters())
        if {k: tuple(v.shape) for k, v in own.items()} != {
                k: tuple(v.shape) for k, v in weights.items()}:
            raise RuntimeError("the port's parameters differ from the reference's list")
        with torch.no_grad():
            for name, p in own.items():
                p.copy_(weights[name])
        return state

    def train_step(self):
        return steps.make_train_step(self.pcfg, mp_impl=self.pcfg.mp_impl,
                                     mp_bf16=bool(self.cfg.get("mp_bf16", False)))

    def eval_step(self):
        return steps.make_eval_step(self.pcfg)

    @staticmethod
    def params(state) -> Dict[str, torch.Tensor]:
        return {k: p.detach().clone() for k, p in state.model.named_parameters()}

    @staticmethod
    def momentum(state) -> Dict[str, torch.Tensor]:
        opt_state = state.optimizer.state
        return {k: opt_state[p]["momentum_buffer"].detach().clone()
                for k, p in state.model.named_parameters()}

    def round_entry(self):
        """(run, layout): ``run(x, ef, senders, receivers, w1, b1, w2, b2,
        g1, be1, g2, be2, layout, g_out=None)`` is one fused message round
        over a batch (with ``g_out``, its gradients for that cotangent of
        the aggregate), ``layout(senders, receivers, n)`` the index
        preparation its kernels walk; None where the configuration's round
        is not the fused one."""
        if self.pcfg.mp_impl not in (None, "onehot"):
            return None
        bf16 = bool(self.cfg.get("mp_bf16", False))

        def run(x, ef, s, r, w1, b1, w2, b2, g1, be1, g2, be2, layout, g_out=None):
            agg = fused_mp.fused_message_pass(x, ef, s, r, w1, b1, w2, b2, g1, be1,
                                              g2, be2, 0.01, bf16=bf16, layout=layout)
            if g_out is None:
                return agg
            return torch.autograd.grad(agg, [x, ef, w1, b1, w2, b2, g1, be1, g2, be2],
                                       g_out)

        return run, fused_mp.fused_layout
