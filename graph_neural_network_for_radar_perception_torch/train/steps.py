"""Train/eval steps and optimiser construction.

The JAX package's ``train/steps.py``: the model runs over the B graphs of a
batch (written out as a loop where JAX vmaps the one-graph model), the
per-graph loss sums are added before dividing, and the SGD (momentum 0.9,
coupled weight decay, MultiStep LR ×0.1 at 50 %/80 %) or AdamW update
follows.  A batch with a non-finite loss or gradient is skipped whole: the
parameters, the optimiser's moments, the gradient-accumulation buffer and
the schedule's count stay as they were (reference training.py:40-45).

The port updates the parameters and optimiser state in place
(``torch.optim``); a step returns the same ``TrainState`` object it was
given.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config.config import GNNConfig
from ..core.graph import GraphBatch, resolve_device
from ..models.gnn import RadarGNN
from .loss import graph_loss_sums, reduce_loss_sums, tree_sum


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimiser (its state), the number of
    steps taken, and the number of optimiser updates applied, which drives
    the LR schedule (skipped batches and accumulation micro-steps apply
    none).  ``acc_grads``/``mini_step`` hold gradient accumulation's running
    mean (``optax.MultiSteps``) when ``cfg.grad_accumulation_steps > 1``."""

    model: RadarGNN
    optimizer: torch.optim.Optimizer
    step: int = 0
    updates: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None
    mini_step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def lr_schedule(cfg: GNNConfig) -> Callable[[int], float]:
    """MultiStepLR(γ=0.1 @50%/80%) as optax's piecewise-constant schedule
    (set_param_for_training_gnn.py:50-56): the rate for update number
    ``count`` (from 0) is scaled once per milestone ≤ count, in float32."""
    boundaries = dict.fromkeys(cfg.lr_milestones, np.float32(cfg.lr_gamma))

    def schedule(count: int) -> float:
        v = np.float32(cfg.learning_rate)
        for threshold, scale in sorted(boundaries.items()):
            if count >= threshold:
                v = np.float32(scale * v)
        return float(v)

    return schedule


def make_optimizer(cfg: GNNConfig, params) -> torch.optim.Optimizer:
    """torch.optim.SGD(momentum, coupled weight decay: wd is added to the raw
    gradient before the momentum buffer, whose first value is the gradient)
    — optax's chain(add_decayed_weights, sgd) — or AdamW with optax.adamw's
    defaults (set_param_for_training_gnn.py:46-56).  The learning rate is set
    from ``lr_schedule`` before every update (``make_train_step``)."""
    lr = lr_schedule(cfg)(0)
    if cfg.optim == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum, dampening=0,
                           nesterov=False, weight_decay=cfg.weight_decay)


def create_train_state(cfg: GNNConfig,
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> TrainState:
    """A fresh model from ``generator`` (default: seeded with ``cfg.seed``)
    on ``device`` — the card unless ``device="cpu"`` — and its optimiser."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model = RadarGNN(cfg, generator=generator).to(device)
    return TrainState(model, make_optimizer(cfg, model.parameters()))


def batch_on(batch: GraphBatch, device) -> GraphBatch:
    """A batch of numpy arrays (``stack_batch``) or tensors, on ``device``."""
    if isinstance(batch.graph.node_feat, np.ndarray):
        return GraphBatch.from_numpy(batch, device)
    return batch.to(device)


def make_loss_fn(cfg: GNNConfig, mp_impl: Optional[str] = None,
                 mp_bf16: bool = False) -> Callable:
    """(model, batch) → (total loss, metrics) over the B graphs of a batch:
    one model call per graph, per-graph LossSums added, then divided.  The
    per-graph loop keeps layer/group norm statistics per graph, as the JAX
    package's vmap does.  ``mp_impl`` ("onehot" | "csr") overrides
    ``cfg.mp_impl`` for the message rounds, as the JAX signature's does;
    ``mp_bf16`` runs them with bf16 operands (f32 accumulation and
    backward), as the JAX package's fast path does."""

    def loss_fn(model: RadarGNN, batch: GraphBatch):
        sums = []
        for b in range(batch.batch_size):
            graph, labels = batch.graph.at(b), batch.labels.at(b)
            out = model(graph, labels.node2cluster, cfg.max_clusters,
                        labels.cluster_mask, mp_impl=mp_impl, mp_bf16=mp_bf16)
            sums.append(graph_loss_sums(out, graph, labels, cfg))
        return reduce_loss_sums(tree_sum(sums), cfg)

    return loss_fn


def _apply_update(state: TrainState, grads: List[torch.Tensor],
                  cfg: GNNConfig, schedule: Callable[[int], float]) -> None:
    """Apply (or, between accumulation boundaries, accumulate) one finite
    gradient, as optax.MultiSteps(tx, k) does."""
    k = cfg.grad_accumulation_steps
    params = list(state.model.parameters())
    if k > 1:
        if state.acc_grads is None:
            state.acc_grads = [torch.zeros_like(p) for p in params]
        n = state.mini_step
        for acc, g in zip(state.acc_grads, grads):
            acc.add_((g - acc) / (n + 1))  # optax's running mean
        state.mini_step = (n + 1) % k
        if state.mini_step:
            return
        grads = [acc.clone() for acc in state.acc_grads]
        for acc in state.acc_grads:
            acc.zero_()
    for p, g in zip(params, grads):
        p.grad = g
    for group in state.optimizer.param_groups:
        group["lr"] = schedule(state.updates)
    state.optimizer.step()
    state.updates += 1


def make_train_step(cfg: GNNConfig, mp_impl: Optional[str] = None,
                    mp_bf16: bool = False) -> Callable:
    """(state, batch) → (state, metrics); single device.  The batch may hold
    numpy arrays or tensors; it is moved to the model's device.  metrics are
    0-d tensors on that device, ``skipped`` = 1.0 for a skipped batch (a
    non-finite loss or gradient, such as the CSR round's NaN guard gives).
    ``mp_impl`` and ``mp_bf16`` as in ``make_loss_fn``.  The step's
    three parts are profiler ranges: ``train_step.forward`` (batch to
    device, loss), ``train_step.backward`` and ``train_step.update``
    (finiteness check, optimiser)."""
    loss_fn = make_loss_fn(cfg, mp_impl, mp_bf16)
    schedule = lr_schedule(cfg)

    def train_step(state: TrainState, batch: GraphBatch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model
        with record_function("train_step.forward"):
            batch = batch_on(batch, state.device)
            model.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(model, batch)
        with record_function("train_step.backward"):
            loss.backward()
        with record_function("train_step.update"):
            # A parameter the loss does not reach gets a zero gradient, so
            # that weight decay and momentum still apply to it, as in optax.
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in model.parameters()]
            # torch.optim updates in place, so finiteness is decided before
            # the update: one device→host sync per step, accepted here.
            finite = torch.cat([loss.detach().reshape(1)]
                               + [g.reshape(-1) for g in grads]).isfinite().all()
            ok = bool(finite)
            if ok:
                _apply_update(state, grads, cfg, schedule)
            model.zero_grad(set_to_none=True)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["skipped"] = loss.new_tensor(0.0 if ok else 1.0)
        return state, metrics

    return train_step


def make_train_scan(cfg: GNNConfig, length: int,
                    mp_impl: Optional[str] = None,
                    mp_bf16: bool = False) -> Callable:
    """(state, batches) → (state, last step's metrics): ``length`` train
    steps in sequence, with ``make_train_step``'s results.  ``batches`` is
    one batch reused every step, or batches stacked on a leading [length]
    axis (node_feat of rank 4).  Capturing the steps as one CUDA graph is
    later work (ROADMAP.md)."""
    step = make_train_step(cfg, mp_impl, mp_bf16)

    def run(state: TrainState, batches: GraphBatch):
        stacked = batches.graph.node_feat.ndim == 4
        metrics = None
        for i in range(length):
            state, metrics = step(state, batches.at(i) if stacked else batches)
        return state, metrics

    return run


def make_eval_step(cfg: GNNConfig) -> Callable:
    """(model, batch) → metrics, without gradients."""
    loss_fn = make_loss_fn(cfg)

    def eval_step(model: RadarGNN, batch: GraphBatch
                  ) -> Dict[str, torch.Tensor]:
        device = next(model.parameters()).device
        with torch.no_grad():
            _, metrics = loss_fn(model, batch_on(batch, device))
        return metrics

    return eval_step
