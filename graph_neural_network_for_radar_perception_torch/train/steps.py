"""Train/eval steps and optimiser construction.

The JAX package's ``train/steps.py``, whose step is one compiled program:
the model runs over the B graphs of a batch in one call
(``batched_forward``: a leading graph axis where the JAX package vmaps the
one-graph model, so each message round is one launch of its kernels for
the whole batch), the per-graph loss sums are added in graph order before
dividing, and the update — optax's chain(add_decayed_weights, sgd)
(momentum 0.9, coupled weight decay, MultiStep LR ×0.1 at 50 %/80 %) or
adamw, with optax.MultiSteps gradient accumulation — runs as tensor ops on
the device: the learning rate is a 0-d tensor computed from the count of
applied updates, and a batch with a non-finite loss or gradient is skipped
without a branch (``all_finite``, ``apply_if``): the parameters, the
optimiser's moments, the accumulation buffer and the counts stay as they
were (reference training.py:40-45).  ``apply_update`` is that update for
every train step of the port.

On a CUDA device ``make_train_step`` captures the step as one CUDA graph
per state and batch shape (``core/capture.CapturedStep``, the counterpart
of ``jax.jit``) and replays it: one host launch a step, no device→host
sync inside.  ``make_train_scan`` replays it once per batch, as
``lax.scan`` repeats its body; ``make_eval_step`` captures the eval step
per model and batch shape.  On the CPU the same code runs eagerly.

The port updates in place: the optimiser keeps the parameters in one flat
buffer (each parameter a view of it) with its moments and the accumulation
buffer in flat buffers beside it, and the counts in one device tensor; a
step returns the same ``TrainState`` object it was given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.config import GNNConfig
from ..core.capture import CapturedGraphs, CapturedStep, shape_key
from ..core.graph import GraphBatch, RadarGraph, resolve_device
from ..models.gnn import RadarGNN
from ..utils.profiling import TRACER
from .loss import LossSums, graph_loss_sums, reduce_loss_sums, tree_sum


class Optimizer:
    """optax's chain(add_decayed_weights(wd), sgd(lr, momentum)) or
    adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
    (set_param_for_training_gnn.py:46-56) as tensor ops over one flat
    buffer of the parameters, in optax's order of operations.

    The parameters become views of ``flat`` (re-made, with their values,
    if one of them was moved or replaced since); the moments are flat
    buffers, zero at first as optax's init makes them.  ``propose`` gives
    the updated parameters and moments for a flat gradient, a 0-d learning
    rate and the 0-d count of earlier updates (Adam's bias correction)
    without writing anything; ``commit`` writes them where a 0-d predicate
    holds.  For torch.optim's callers: ``state[p]`` holds p's moments as
    views (SGD "momentum_buffer", AdamW "exp_avg" and "exp_avg_sq"),
    ``state_dict``/``load_state_dict`` have torch.optim's form, and
    ``step()`` applies each parameter's ``.grad`` at
    ``param_groups[0]["lr"]``."""

    def __init__(self, params, kind: str, lr: float, weight_decay: float,
                 momentum: float = 0.9, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("the optimiser keeps float32 parameters")
        self.kind = kind
        if kind == "sgd":
            group = dict(lr=lr, weight_decay=weight_decay, momentum=momentum)
        else:
            group = dict(lr=lr, weight_decay=weight_decay, betas=betas, eps=eps)
        self.param_groups = [dict(params=self.params, **group)]
        sizes = [p.numel() for p in self.params]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        self.flat: Optional[torch.Tensor] = None
        self.bind()
        names = ("momentum_buffer",) if kind == "sgd" else ("exp_avg", "exp_avg_sq")
        self.moments = {k: torch.zeros_like(self.flat) for k in names}
        self._count = torch.zeros((), dtype=torch.int64, device=self.flat.device)

    def _views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        return [buf[o:o + p.numel()].view_as(p)
                for p, o in zip(self.params, self.offsets)]

    def bind(self) -> torch.Tensor:
        """Make every parameter a view of ``flat`` (again, with its current
        values, if any was moved or replaced); returns ``flat``."""
        flat = self.flat
        if flat is not None and all(
                p.device == flat.device
                and p.data_ptr() == flat.data_ptr() + 4 * o
                for p, o in zip(self.params, self.offsets)):
            return flat
        with torch.no_grad():
            self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        for p, v in zip(self.params, self._views(self.flat)):
            p.data = v
        for k, m in getattr(self, "moments", {}).items():
            self.moments[k] = m.to(self.flat.device)
        if hasattr(self, "_count"):
            self._count = self._count.to(self.flat.device)
        return self.flat

    @property
    def state(self) -> Dict[torch.Tensor, Dict[str, torch.Tensor]]:
        views = {k: self._views(m) for k, m in self.moments.items()}
        return {p: {k: v[i] for k, v in views.items()}
                for i, p in enumerate(self.params)}

    def propose(self, g: torch.Tensor, lr: torch.Tensor, count: torch.Tensor):
        """(updated flat parameters, updated moments) for the flat gradient
        ``g`` at rate ``lr``; ``count`` updates were applied before."""
        hp = self.param_groups[0]
        p, wd = self.flat, hp["weight_decay"]
        if self.kind == "sgd":  # add_decayed_weights, then trace, then -lr
            buf = (g + wd * p) + hp["momentum"] * self.moments["momentum_buffer"]
            return p + (-lr) * buf, {"momentum_buffer": buf}
        (b1, b2), eps = hp["betas"], hp["eps"]
        mu = (1 - b1) * g + b1 * self.moments["exp_avg"]
        nu = (1 - b2) * (g * g) + b2 * self.moments["exp_avg_sq"]
        t = (count + 1).to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=p.device)
        mu_hat = mu / (1 - (one * b1) ** t)
        nu_hat = nu / (1 - (one * b2) ** t)
        u = mu_hat / (torch.sqrt(nu_hat) + eps) + wd * p
        return p + (-lr) * u, {"exp_avg": mu, "exp_avg_sq": nu}

    def commit(self, take: torch.Tensor, params: torch.Tensor,
               moments: Dict[str, torch.Tensor]) -> None:
        """Write the proposed parameters and moments where ``take`` (0-d
        bool) holds; elsewhere everything keeps its bits."""
        olds = [self.flat, *self.moments.values()]
        news = apply_if(take, [params, *(moments[k] for k in self.moments)], olds)
        for old, new in zip(olds, news):
            old.copy_(new)

    def step(self) -> None:
        """torch.optim's step: each parameter's ``.grad`` (zero where None)
        at ``param_groups[0]["lr"]``."""
        flat = self.bind()
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in self.params])
        lr = torch.tensor(self.param_groups[0]["lr"], dtype=torch.float32, device=flat.device)
        with torch.no_grad():
            self.commit(torch.ones((), dtype=torch.bool, device=flat.device),
                        *self.propose(g, lr, self._count))
        self._count += 1

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """torch.optim's form: per-parameter moments (copies), the groups'
        hyper-parameters with the parameters as indices."""
        views = {k: self._views(m) for k, m in self.moments.items()}
        group = {k: v for k, v in self.param_groups[0].items() if k != "params"}
        return {"state": {i: {k: v[i].clone() for k, v in views.items()}
                          for i in range(len(self.params))},
                "param_groups": [dict(group, params=list(range(len(self.params))))]}

    def load_state_dict(self, saved: dict) -> None:
        """Copies a ``state_dict``'s moments in place (torch.optim's
        AdamW "step" entries are the TrainState's ``updates`` here)."""
        views = {k: self._views(m) for k, m in self.moments.items()}
        with torch.no_grad():
            for i, st in saved["state"].items():
                for k, v in views.items():
                    if k in st:
                        v[int(i)].copy_(st[k])


@dataclasses.dataclass(eq=False)
class TrainState:
    """The model (its parameters), the optimiser (its state) and the counts:
    steps taken, optimiser updates applied (they drive the LR schedule;
    skipped batches and accumulation micro-steps apply none) and gradient
    accumulation's micro-step, all in one int64 device tensor
    (``counters``), read as ints (``step``, ``updates``, ``mini_step``: a
    host sync each) and set in place.  ``acc_grads`` holds gradient
    accumulation's running mean (``optax.MultiSteps``) when
    ``cfg.grad_accumulation_steps > 1``: views of the flat ``acc``."""

    model: RadarGNN
    optimizer: Any
    step: int = 0
    updates: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None
    mini_step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes: parameters, moments, counts and the
        accumulation buffer (``make_train_step``'s states)."""
        opt = self.optimizer
        return ([opt.bind(), *opt.moments.values(), self.counters]
                + ([] if self.acc is None else [self.acc]))


def _count_property(i: int) -> property:
    """Count i of ``TrainState.counters`` as an int (a host sync to read)."""

    def get(self) -> int:
        return int(self.counters[i])

    def put(self, v) -> None:
        if "counters" not in self.__dict__:
            self.counters = torch.zeros(3, dtype=torch.int64, device=self.device)
        self.counters[i].fill_(int(v))

    return property(get, put)


def _get_acc(self) -> Optional[List[torch.Tensor]]:
    acc = self.__dict__.get("acc")
    return None if acc is None else self.optimizer._views(acc)


def _set_acc(self, grads) -> None:
    acc = self.__dict__.get("acc")
    if grads is None:
        self.acc = None
        return
    flat = torch.cat([g.reshape(-1) for g in grads]).to(self.device)
    if acc is None or acc.shape != flat.shape:
        self.acc = flat.clone()
    else:
        acc.copy_(flat)


TrainState.step, TrainState.updates, TrainState.mini_step = map(_count_property, range(3))
TrainState.acc_grads = property(_get_acc, _set_acc)


def lr_schedule(cfg: GNNConfig) -> Callable:
    """MultiStepLR(γ=0.1 @50%/80%) as optax's piecewise-constant schedule
    (set_param_for_training_gnn.py:50-56): the rate for update number
    ``count`` (from 0) is scaled once per milestone ≤ count, in float32.
    ``count`` an int gives a float; a tensor (the device count of applied
    updates) gives a 0-d float32 tensor on its device, with no host sync."""
    milestones = sorted(set(cfg.lr_milestones))
    gamma = np.float32(cfg.lr_gamma)

    def schedule(count):
        if torch.is_tensor(count):
            v = torch.full((), cfg.learning_rate, dtype=torch.float32,
                           device=count.device)
            for threshold in milestones:
                v = torch.where(count >= threshold, v * float(gamma), v)
            return v
        v = np.float32(cfg.learning_rate)
        for threshold in milestones:
            if count >= threshold:
                v = np.float32(gamma * v)
        return float(v)

    return schedule


def make_optimizer(cfg: GNNConfig, params) -> Optimizer:
    """The ``Optimizer`` of ``cfg.optim``: SGD (momentum, coupled weight
    decay: wd is added to the raw gradient before the momentum buffer, whose
    first value is the gradient) — optax's chain(add_decayed_weights, sgd) —
    or AdamW with optax.adamw's defaults (set_param_for_training_gnn.py:
    46-56).  The learning rate comes from ``lr_schedule`` at every update
    (``apply_update``); ``param_groups[0]["lr"]`` is the first one."""
    lr = lr_schedule(cfg)(0)
    if cfg.optim == "adamw":
        return Optimizer(params, "adamw", lr, cfg.weight_decay)
    return Optimizer(params, "sgd", lr, cfg.weight_decay, momentum=cfg.momentum)


def create_train_state(cfg: GNNConfig,
                       generator: Optional[torch.Generator] = None,
                       device="cuda", model_cls: type = RadarGNN) -> TrainState:
    """A fresh ``model_cls(cfg)`` (``RadarGNN``, or a variant such as
    ``RadarGNNv1`` or ``models/gat.RadarGNNv2``) from ``generator``
    (default: seeded with ``cfg.seed``) on ``device`` — the card unless
    ``device="cpu"`` — and its optimiser."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model = model_cls(cfg, generator=generator).to(device)
    return TrainState(model, make_optimizer(cfg, model.parameters()))


def batch_on(batch: GraphBatch, device) -> GraphBatch:
    """A batch of numpy arrays (``stack_batch``) or tensors, on ``device``."""
    if isinstance(batch.graph.node_feat, np.ndarray):
        return GraphBatch.from_numpy(batch, device)
    return batch.to(device)


def batched_forward(model: RadarGNN, cfg: GNNConfig,
                    mp_impl: Optional[str] = None,
                    mp_bf16: bool = False, graph_group=None) -> Callable:
    """fn(graph batch, node2cluster [B, N], cluster_mask [B, C]) → GNNOutputs
    with a leading graph axis: ONE model call for the B graphs (the JAX
    package vmaps the one-graph model).  Layer/group norm statistics stay
    per graph; each message round is one kernel launch for all of them.
    ``mp_impl``/``mp_bf16`` as in ``make_loss_fn``; with a ``graph_group``
    the edge fields are this rank's shard (``parallel/sharded.py``) and
    each round combines the batch's partial aggregates in one collective."""

    def forward(graph: RadarGraph, node2cluster, cluster_mask):
        return model(graph, node2cluster, cfg.max_clusters, cluster_mask,
                     mp_impl=mp_impl, mp_bf16=mp_bf16, graph_group=graph_group)

    return forward


def batched_deploy(model: RadarGNN, cfg: GNNConfig, eps: Optional[float] = None,
                   from_links: bool = False,
                   mp_impl: Optional[str] = None) -> Callable:
    """fn(graph batch) → DeployOutputs with a leading graph axis: ONE
    ``RadarGNN.deploy`` call for the B graphs (the JAX package vmaps the
    one-graph deploy), DBSCAN included; each message round one kernel
    launch for all of them.  ``eps`` defaults to ``cfg.clustering_eps``."""
    eps = cfg.clustering_eps if eps is None else eps

    def deploy(graph: RadarGraph):
        return model.deploy(graph, eps=eps, from_links=from_links, mp_impl=mp_impl)

    return deploy


def make_loss_fn(cfg: GNNConfig, mp_impl: Optional[str] = None,
                 mp_bf16: bool = False) -> Callable:
    """(model, batch) → (total loss, metrics) over the B graphs of a batch:
    one model call (``batched_forward``), the per-graph LossSums added in
    graph order (``tree_sum``), then divided (JAX ``make_loss_fn``).
    ``mp_impl`` ("onehot" | "csr") overrides ``cfg.mp_impl`` for the
    message rounds, as the JAX signature's does; ``mp_bf16`` runs them with
    bf16 operands (f32 accumulation and backward), as the JAX package's fast
    path does."""

    def loss_fn(model: RadarGNN, batch: GraphBatch):
        labels = batch.labels
        out = batched_forward(model, cfg, mp_impl, mp_bf16)(
            batch.graph, labels.node2cluster, labels.cluster_mask)
        return reduce_loss_sums(tree_sum(graph_loss_sums(out, batch.graph, labels, cfg)), cfg)

    return loss_fn


def per_graph_loss_sums(model: RadarGNN, batch: GraphBatch, cfg: GNNConfig,
                        **model_kwargs) -> List[LossSums]:
    """One model call per graph of the batch (``model_kwargs`` passed on)
    and its ``graph_loss_sums``, in batch order: the reference's per-graph
    loop, the yardstick of the batched step (``chip_smoke.py``'s [train],
    tests/test_torch_batched_step.py)."""
    sums = []
    for b in range(batch.batch_size):
        graph, labels = batch.graph.at(b), batch.labels.at(b)
        out = model(graph, labels.node2cluster, cfg.max_clusters,
                    labels.cluster_mask, **model_kwargs)
        sums.append(graph_loss_sums(out, graph, labels, cfg))
    return sums


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor: every element of every tensor is finite (no host
    sync)."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def apply_if(ok: torch.Tensor, new: Sequence[torch.Tensor],
             old: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise select between two lists of tensors on a 0-d predicate:
    ``new`` where ``ok``, else ``old`` (the branchless NaN-batch skip)."""
    return [torch.where(ok, n, o) for n, o in zip(new, old)]


def apply_update(state: TrainState, loss: torch.Tensor,
                 grads: Sequence[Optional[torch.Tensor]], cfg: Optional[GNNConfig] = None,
                 frozen: Sequence[Optional[torch.Tensor]] = (),
                 reduce: Optional[Callable[[torch.Tensor], Any]] = None) -> torch.Tensor:
    """The update after the loss, one route for every train step of the
    port (the default and grid steps, finetuning, the classifier and the
    grid CNN), with no branch and no host sync.

    ``grads`` holds one gradient a parameter of the optimiser, None where
    the loss does not reach one: that parameter gets a zero gradient, so
    that weight decay and momentum still apply to it, as in optax.
    ``reduce``, if given, runs in place on the flat gradient first (the
    grid steps' all-reduce).  The update applies only where the loss, the
    flat gradient and the gradients in ``frozen`` are all finite
    (``all_finite``): ``frozen`` is checked and never applied, as optax's
    ``set_to_zero`` zeroes finetuning's frozen trunk after ``all_finite``
    saw the whole tree.  With ``cfg`` the rate is ``lr_schedule(cfg)`` on
    the count of applied updates and ``cfg.grad_accumulation_steps``
    gradients make one update (optax.MultiSteps' running mean); without it
    the rate is the optimiser's constant ``param_groups[0]["lr"]`` and
    every step updates.  Every write is a select on the check
    (``Optimizer.commit``), so a skipped batch leaves the parameters, the
    moments, the accumulation buffer and the update count as they were.
    Counts the step and, if taken, the update.  Returns ok, a 0-d bool
    device tensor."""
    opt = state.optimizer
    opt.bind()
    with torch.no_grad():
        grad = torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                          for g, p in zip(grads, opt.params)])
        if reduce is not None:
            reduce(grad)
        checked = [loss.detach(), grad]
        rest = [g.reshape(-1) for g in frozen if g is not None]
        if rest:
            checked.append(torch.cat(rest))
        ok = all_finite(checked)
        counts = state.counters
        take = ok
        k = 1 if cfg is None else cfg.grad_accumulation_steps
        if k > 1:
            if state.acc is None:
                state.acc = torch.zeros_like(opt.flat)
            n = counts[2]
            acc = state.acc + (grad - state.acc) / (n + 1)  # optax's running mean
            emit = n == k - 1
            state.acc.copy_(torch.where(ok, torch.where(emit, 0.0, acc), state.acc))
            counts[2].copy_(torch.where(ok, (n + 1) % k, n))
            grad, take = acc, ok & emit
        count = counts[1]
        lr = (torch.full((), opt.param_groups[0]["lr"], dtype=torch.float32, device=grad.device)
              if cfg is None else lr_schedule(cfg)(count))
        opt.commit(take, *opt.propose(grad, lr, count))
        count.add_(take.to(count.dtype))
        counts[0].add_(1)
    return ok


def step_metrics(metrics: Dict[str, torch.Tensor], ok: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A train step's metrics, detached, and ``skipped``: 1.0 where the
    update was skipped (``ok``, ``apply_update``'s check, false)."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["skipped"] = (~ok).to(torch.float32)
    return metrics


def _train_body(state: TrainState, batch: GraphBatch, loss_fn: Callable,
                cfg: GNNConfig) -> Dict[str, torch.Tensor]:
    """One step on tensors on the state's device: loss, gradients, the
    branchless update.  Captured while ``TRACER`` is on, its three parts
    are device spans in the graph: ``train_step.forward``,
    ``train_step.backward``, ``train_step.update``."""
    with TRACER.graph_span("train_step.forward"):
        loss, metrics = loss_fn(state.model, batch)
    with TRACER.graph_span("train_step.backward"):
        grads = torch.autograd.grad(loss, state.optimizer.params, allow_unused=True)
    with TRACER.graph_span("train_step.update"):
        ok = apply_update(state, loss, grads, cfg)
    return step_metrics(metrics, ok)


def make_train_step(cfg: GNNConfig, mp_impl: Optional[str] = None,
                    mp_bf16: bool = False) -> Callable:
    """(state, batch) → (state, metrics); single device.  The batch may hold
    numpy arrays or tensors.  metrics are 0-d tensors on the state's
    device, ``skipped`` = 1.0 for a skipped batch (a non-finite loss or
    gradient, such as the CSR round's NaN guard gives).  ``mp_impl`` and
    ``mp_bf16`` as in ``make_loss_fn``.

    On the CPU the step runs eagerly.  On a CUDA device it is captured once
    per state and batch shape (``CapturedStep``, ``train_step.captured``)
    and replayed: one host launch a step, the tracer's span
    ``train_step.replay`` around it."""
    loss_fn = make_loss_fn(cfg, mp_impl, mp_bf16)

    def body(state: TrainState, batch: GraphBatch) -> Dict[str, torch.Tensor]:
        return _train_body(state, batch, loss_fn, cfg)

    captured = CapturedStep(body)

    def train_step(state: TrainState, batch: GraphBatch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if cfg.grad_accumulation_steps > 1 and state.acc is None:
            state.acc = torch.zeros_like(state.optimizer.bind())
        if state.device.type == "cpu":
            return state, body(state, batch_on(batch, state.device))
        return state, captured(state, batch)

    train_step.captured = captured
    return train_step


def make_train_scan(cfg: GNNConfig, length: int,
                    mp_impl: Optional[str] = None,
                    mp_bf16: bool = False) -> Callable:
    """(state, batches) → (state, last step's metrics): train steps in
    sequence, with ``make_train_step``'s results, as the JAX package's
    ``lax.scan``: on the card each is a replay of the one captured step.
    ``batches`` is either one batch reused for ``length`` steps, or batches
    stacked on a leading axis (node_feat of rank 4): then one step per
    entry of that axis, whatever ``length`` is."""
    step = make_train_step(cfg, mp_impl, mp_bf16)

    def run(state: TrainState, batches: GraphBatch):
        stacked = batches.graph.node_feat.ndim == 4
        metrics = None
        if stacked:
            for i in range(batches.graph.node_feat.shape[0]):
                state, metrics = step(state, batches.at(i))
        else:
            for _ in range(length):
                state, metrics = step(state, batches)
        return state, metrics

    run.step = step
    return run


def make_eval_step(cfg: GNNConfig) -> Callable:
    """(model, batch) → metrics, without gradients: the loss's metrics over
    the batch (JAX ``make_eval_step``).  On the CPU it runs eagerly.  On a
    CUDA device it is captured once per model, binding of the model's
    parameters (their ``data_ptr``s) and batch shape (``CapturedGraphs``,
    ``eval_step.captured``; nothing to restore) and replayed: one host
    launch a batch.  A replay reads the parameters where they are, so it
    sees the updates a train step makes in place.  The metrics are cloned
    at once, before another replay overwrites them.  ``eval_step.body`` is
    the eager body (``body(model, batch)`` on tensors on the model's
    device)."""
    loss_fn = make_loss_fn(cfg)
    captured = CapturedGraphs()

    def body(model: RadarGNN, batch: GraphBatch) -> Dict[str, torch.Tensor]:
        with torch.no_grad(), TRACER.graph_span("eval_step.forward"):
            return loss_fn(model, batch)[1]

    def eval_step(model: RadarGNN, batch: GraphBatch
                  ) -> Dict[str, torch.Tensor]:
        device = next(model.parameters()).device
        if device.type == "cpu":
            return body(model, batch_on(batch, device))
        leaves = GraphBatch.leaves(batch)
        binding = tuple(p.data_ptr() for p in model.parameters())
        outputs = captured.run(
            (id(model), binding, shape_key(leaves)), leaves,
            lambda inputs: body(model, GraphBatch.from_leaves(inputs)), device,
            keep=model, label="eval_step.replay")
        return {k: v.clone() for k, v in outputs.items()}

    eval_step.captured = captured
    eval_step.body = body
    return eval_step
