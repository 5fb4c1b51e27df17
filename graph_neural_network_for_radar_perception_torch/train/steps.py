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
were (reference training.py:40-45).

On a CUDA device ``make_train_step`` captures the step as one CUDA graph
per state and batch shape (the counterpart of ``jax.jit``) and replays it:
one host launch a step, no device→host sync inside.  ``make_train_scan``
replays it once per batch, as ``lax.scan`` repeats its body;
``make_eval_step`` captures the eval step per model and batch shape.  On
the CPU the same code runs eagerly.

The port updates in place: the optimiser keeps the parameters in one flat
buffer (each parameter a view of it) with its moments and the accumulation
buffer in flat buffers beside it, and the counts in one device tensor; a
step returns the same ``TrainState`` object it was given.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.config import GNNConfig
from ..core.graph import GraphBatch, GraphLabels, RadarGraph, resolve_device
from ..models.gnn import RadarGNN
from ..ops import csr_mp as C
from ..ops import fused_mp as FM
from ..parallel import collectives as P
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
    (``_apply_update``); ``param_groups[0]["lr"]`` is the first one."""
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


def _apply_update(state: TrainState, grad, cfg: GNNConfig,
                  ok: Optional[torch.Tensor] = None) -> None:
    """Apply (or, between accumulation boundaries, accumulate) one gradient
    — flat, or one a parameter — as optax.MultiSteps(tx, k) does, if ``ok``
    (0-d bool; default: always), with no branch and no host sync: every
    write is a select on ``ok``, so a skipped batch leaves the parameters,
    the moments, the accumulation buffer and the counts as they were."""
    opt = state.optimizer
    opt.bind()
    if not torch.is_tensor(grad):
        grad = torch.cat([g.reshape(-1) for g in grad])
    counts = state.counters
    if ok is None:
        ok = torch.ones((), dtype=torch.bool, device=counts.device)
    take = ok
    k = cfg.grad_accumulation_steps
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
    opt.commit(take, *opt.propose(grad, lr_schedule(cfg)(count), count))
    count.add_(take.to(count.dtype))


def update_if_finite(state: TrainState, loss: torch.Tensor,
                     frozen: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The JAX finetuning, classifier and grid-CNN steps' update after the
    loss: the gradient of ``loss`` with respect to the optimiser's
    parameters (zero where none reaches one) and, for the finiteness check
    only, with respect to ``frozen`` (optax's ``set_to_zero`` zeroes their
    update after ``all_finite`` saw the whole tree); then optax's update
    at the constant rate ``param_groups[0]["lr"]`` where the loss and every
    gradient are finite, else nothing changes (``all_finite``,
    ``Optimizer.commit``): no branch, no host sync.  Counts the step and,
    if taken, the update.  Returns ok, a 0-d bool device tensor."""
    opt = state.optimizer
    opt.bind()
    params = opt.params
    grads = torch.autograd.grad(loss, [*params, *frozen], allow_unused=True)
    with torch.no_grad():
        grad = torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                          for g, p in zip(grads, params)])
        checked = [loss.detach(), grad]
        rest = [g.reshape(-1) for g in grads[len(params):] if g is not None]
        if rest:
            checked.append(torch.cat(rest))
        ok = all_finite(checked)
        lr = torch.full((), opt.param_groups[0]["lr"], dtype=torch.float32,
                        device=grad.device)
        count = state.counters[1]
        opt.commit(ok, *opt.propose(grad, lr, count))
        count.add_(ok.to(count.dtype))
        state.counters[0].add_(1)
    return ok


def _train_body(state: TrainState, batch: GraphBatch, loss_fn: Callable,
                cfg: GNNConfig) -> Dict[str, torch.Tensor]:
    """One step on tensors on the state's device: loss, gradients, the
    branchless update.  Captured while ``TRACER`` is on, its three parts
    are device spans in the graph: ``train_step.forward``,
    ``train_step.backward``, ``train_step.update``."""
    opt = state.optimizer
    with TRACER.graph_span("train_step.forward"):
        loss, metrics = loss_fn(state.model, batch)
    with TRACER.graph_span("train_step.backward"):
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    with TRACER.graph_span("train_step.update"), torch.no_grad():
        # A parameter the loss does not reach gets a zero gradient, so
        # that weight decay and momentum still apply to it, as in optax.
        grad = torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                          for g, p in zip(grads, opt.params)])
        ok = all_finite([loss.detach(), grad])
        _apply_update(state, grad, cfg, ok)
        state.counters[0].add_(1)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["skipped"] = (~ok).to(torch.float32)
    return metrics


# ------------------------------------------------------------ CUDA graphs
_POOLS: Dict[torch.device, tuple] = {}


def _pool(device: torch.device):
    """The one CUDA-graph memory pool of this process's captured graphs on
    ``device`` (every train step, each bucket's included, every detector's
    deploy, the eval steps and the finetuning, classifier and grid-CNN
    steps): they replay one at a time, so they share it.  A pool whose
    graphs are all gone cannot take another capture, so a graph of one
    allocation holds it for the process."""
    if device not in _POOLS:
        keeper = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(keeper):
            torch.zeros(1, device=device)
        _POOLS[device] = (keeper.pool(), keeper)
    return _POOLS[device][0]


def launch_counters() -> List[Tuple[object, str]]:
    """The message rounds' launch counters, as (function, attribute)."""
    return [(FM.fused_message_pass, "launches"),
            (FM.fused_message_pass, "launches_bf16"),
            (FM.fused_message_pass_backward, "launches"),
            (C.fused_message_pass_csr, "launches"),
            (C.fused_message_pass_csr, "launches_bf16"),
            (C.fused_message_pass_csr_backward, "launches")]


def _read_counters() -> List[int]:
    """The launch counters, then the collectives' calls and bytes
    (``parallel/collectives.counts``)."""
    return [getattr(f, a) for f, a in launch_counters()] + P.counts()


def _add_counters(deltas: Sequence[int]) -> None:
    n = len(launch_counters())
    for (f, a), d in zip(launch_counters(), deltas[:n]):
        setattr(f, a, getattr(f, a) + d)
    P.add_counts(deltas[n:])


TRACER.watch("launches", lambda: {f"{f.__name__}.{a}": getattr(f, a)
                                  for f, a in launch_counters()})
TRACER.watch("collectives", lambda: {k: (dict(v) if isinstance(v, dict) else v)
                                     for k, v in P.STATS.items()})


def _batch_leaves(batch) -> list:
    """The arrays of a batch (numpy or tensors), graph fields then labels'."""
    return ([getattr(batch.graph, f) for f in RadarGraph.__dataclass_fields__]
            + [getattr(batch.labels, f) for f in GraphLabels.__dataclass_fields__])


def _static_batch(inputs: list) -> GraphBatch:
    """The batch whose fields are ``inputs``, in ``_batch_leaves`` order."""
    names = list(RadarGraph.__dataclass_fields__)
    return GraphBatch(
        RadarGraph(**dict(zip(names, inputs[:len(names)]))),
        GraphLabels(**dict(zip(GraphLabels.__dataclass_fields__, inputs[len(names):]))))


STAGING_ALIGN = 256  # bytes: each staged leaf starts at a multiple of this


def _on_card(a) -> bool:
    """Whether a leaf is already device memory (copied on the device, never staged)."""
    return bool(getattr(a, "is_cuda", False))


def _leaf_dtype(a) -> torch.dtype:
    return a.dtype if torch.is_tensor(a) else torch.from_numpy(np.empty(0, a.dtype)).dtype


def _staging_layout(leaves) -> Tuple[List[Optional[int]], int]:
    """One flat layout of the leaves that are host memory (numpy arrays,
    CPU tensors, pinned or not): each one's byte offset, a multiple of
    ``STAGING_ALIGN``, or None for a leaf on a card; and the layout's size
    in bytes."""
    offsets, end = [], 0
    for a in leaves:
        if _on_card(a):
            offsets.append(None)
        else:
            offsets.append(end)
            end += -(-a.nbytes // STAGING_ALIGN) * STAGING_ALIGN
    return offsets, end


def _leaf_views(flat: torch.Tensor, leaves, offsets) -> list:
    """Each laid-out leaf's view of the flat byte buffer ``flat``, at its
    offset, dtype and shape; None for a leaf off the layout."""
    return [None if off is None else
            flat[off:off + a.nbytes].view(_leaf_dtype(a)).view(tuple(a.shape))
            for a, off in zip(leaves, offsets)]


def _as_tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))


class _Staging:
    """A captured graph's static inputs and the way a batch reaches them.

    The leaves that were host memory at capture (``_staging_layout``) are
    views of one flat device buffer; a leaf on a card has a buffer of its
    own.  Two pinned host buffers of the same layout serve in turn, each
    guarded by an event recorded after its copy to the card.  ``copy``
    writes the host leaves into the turn's pinned buffer on the host (a
    numpy array by ``np.copyto`` on the calling thread: torch's CPU copy of
    a large array wakes its thread pool, whose threads then compete with
    the host's waits for the card) and copies it to the card in one
    asynchronous DMA on the current stream, then copies the other leaves
    on the device: stream order alone keeps the DMA behind the previous
    replay and ahead of the next, and the caller's arrays are read in full
    before it returns.  ``wait`` blocks until the turn's pinned buffer is
    free, the one host wait of a copy."""

    def __init__(self, leaves, device: torch.device):
        self.offsets, nbytes = _staging_layout(leaves)
        self.flat = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.inputs = [torch.empty(tuple(a.shape), dtype=_leaf_dtype(a), device=device)
                       if v is None else v
                       for a, v in zip(leaves, _leaf_views(self.flat, leaves, self.offsets))]
        self.pinned = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=device.type == "cuda")
                       for _ in range(2 if nbytes else 0)]
        self.host = [_leaf_views(h, leaves, self.offsets) for h in self.pinned]
        self.host_np = [[v.numpy() if isinstance(a, np.ndarray) and v is not None else None
                         for v, a in zip(views, leaves)] for views in self.host]
        self.done = [torch.cuda.Event() for _ in self.pinned]
        self.turn = 0

    def wait(self) -> bool:
        """Wait until the turn's pinned buffer has left for the card;
        whether that took a wait."""
        if not self.done or self.done[self.turn].query():
            return False
        self.done[self.turn].synchronize()
        return True

    def copy(self, leaves) -> int:
        """Copy ``leaves`` into the inputs; returns the bytes staged."""
        staged, rest = 0, []
        for i, a in enumerate(leaves):
            if self.offsets[i] is None or _on_card(a):
                rest.append((self.inputs[i], a))
                continue
            dst, dst_np = self.host[self.turn][i], self.host_np[self.turn][i]
            if dst_np is not None and isinstance(a, np.ndarray):
                np.copyto(dst_np, a, casting="unsafe")
            else:
                dst.copy_(_as_tensor(a))
            staged += dst.nbytes
        if staged:
            self.flat.copy_(self.pinned[self.turn], non_blocking=True)
            self.done[self.turn].record()
            self.turn ^= 1
        for buf, a in rest:
            buf.copy_(_as_tensor(a))
        return staged


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    staging: _Staging           # the static input buffers and how a batch reaches them
    outputs: Any
    launches: List[int]         # each counter's advance per replay (_read_counters)
    keep: Any                   # kept alive: the graph reads or writes it
    marks: list                 # its device spans (TRACER.marking), empty untraced


class CapturedGraphs:
    """``body(inputs)`` on a CUDA device, where ``inputs`` is a list of
    static device buffers, captured as one CUDA graph per key and replayed
    (the counterpart of ``jax.jit``): ``run`` copies the arrays it is given
    into the key's buffers, replays its graph and returns the graph's
    outputs, which the next replay of that graph overwrites.  The arrays in
    host memory go through pinned staging in one asynchronous DMA
    (``_Staging``), so ``run`` returns without waiting for the card: it
    waits only when both of the key's pinned buffers are still on their
    way, and the caller may reuse its arrays at once.

    Capture: on a side stream the body runs once eagerly (libraries,
    constants and other first-use work) and once more under
    ``torch.cuda.set_sync_debug_mode("error")`` — a device→host sync there
    raises — then the tensors in ``restore`` get back their values from
    before the two, and the body is captured into the process's one graph
    pool (``_pool``: the process's captured graphs replay one at a time,
    so they share it).  A capture that fails raises, with ``restore``'s
    tensors given back their values: nothing falls back to eager work on
    the card.

    The launch counters of the message rounds, and the collectives' calls
    and bytes (``parallel/collectives.STATS``), advance by what a replay
    launches: the capture itself launches nothing, so its advance is taken
    back and added at every replay.  ``warmups`` counts the eager runs
    (``WARMUP_RUNS`` a capture), ``replays`` the graph launches.

    Tracing (``utils/profiling.TRACER``): the warm-ups and the capture are
    always spans (``captured.warmup``, ``captured.capture``).  While the
    tracer is on, the copy of the arrays is a host and device span
    (``captured.copy``: on the host the staging and the enqueue, on the
    device the DMA; counters ``captured.copy_bytes``,
    ``captured.pageable_bytes``, the bytes the caller gave in memory that
    is not pinned, ``captured.staged_bytes``, the bytes that went through
    the pinned staging, and ``captured.staging_waits``, the waits for a
    pinned buffer, made before the span) and the replay one (``label``)
    that shares its call; a graph captured then holds the body's device
    spans (``TRACER.graph_span``), read after its replays.  Whether the
    tracer was on is part of the key: a graph with those spans is never
    replayed untraced, nor the reverse."""

    WARMUP_RUNS = 2
    _every: "weakref.WeakSet[CapturedGraphs]" = weakref.WeakSet()

    def __init__(self):
        self.graphs: Dict[tuple, _Captured] = {}
        self.warmups = 0
        self.replays = 0
        CapturedGraphs._every.add(self)

    def run(self, key: tuple, leaves: Sequence, body: Callable[[list], Any],
            device: torch.device, restore: Sequence[torch.Tensor] = (),
            keep: Any = None, label: str = "captured.replay") -> Any:
        """Replay the graph of ``key`` on ``leaves`` (numpy arrays or
        tensors), capturing ``body`` first if the key is new; ``keep`` is
        held as long as the graph (what it reads or writes)."""
        key = (key, TRACER.enabled)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(leaves, body, device, restore, keep)
            call = None
        else:
            waited = entry.staging.wait()
            with TRACER.span("captured.copy", device) as copy:
                staged = entry.staging.copy(leaves)
            call = copy.call
            if TRACER.enabled:
                TRACER.count("captured.staged_bytes", staged)
                TRACER.count("captured.staging_waits", int(waited))
                TRACER.count("captured.copy_bytes", sum(b.nbytes for b in entry.staging.inputs))
                TRACER.count("captured.pageable_bytes", sum(
                    b.nbytes for b, a in zip(entry.staging.inputs, leaves)
                    if not (torch.is_tensor(a) and (a.is_cuda or a.is_pinned()))))
        with TRACER.span(label, device, call=call, marks=entry.marks):
            entry.graph.replay()
        _add_counters(entry.launches)
        self.replays += 1
        if TRACER.enabled:
            TRACER.count("captured.traced_replays")
        return entry.outputs

    def _capture(self, leaves, body, device, restore, keep) -> _Captured:
        staging = _Staging(leaves, device)
        staging.copy(leaves)
        inputs = staging.inputs
        saved = [t.clone() for t in restore]
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                with TRACER.once("captured.warmup"):
                    body(inputs)  # first use
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with TRACER.once("captured.warmup"):
                        body(inputs)  # as it will be captured
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        finally:  # a failed capture leaves no trace of its warm-ups either
            current.wait_stream(side)
            for t, v in zip(restore, saved):
                t.copy_(v)
        self.warmups += self.WARMUP_RUNS
        graph = torch.cuda.CUDAGraph()
        before = _read_counters()
        with (TRACER.once("captured.capture"), TRACER.marking() as marks,
              torch.cuda.graph(graph, pool=_pool(device))):
            outputs = body(inputs)
        launches = [a - b for a, b in zip(_read_counters(), before)]
        _add_counters([-d for d in launches])  # the capture launched nothing
        return _Captured(graph, staging, outputs, launches, keep, marks)


TRACER.watch("captured_graphs", lambda: {
    "replays": sum(c.replays for c in CapturedGraphs._every),
    "warmups": sum(c.warmups for c in CapturedGraphs._every)})


def shape_key(leaves) -> tuple:
    """The shapes and dtypes of ``leaves``: part of a capture's key."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in leaves)


class CapturedStep(CapturedGraphs):
    """``body(state, batch)`` on a CUDA device, captured as one CUDA graph
    per state and batch shape (and per binding of the state's tensors) and
    replayed (``CapturedGraphs``): the batch is copied into the graph's
    static input buffers, the graph replayed, and its metrics cloned
    before the next replay can overwrite them.  The warm-up runs write the
    state; it is restored before the capture.  ``leaves(batch)`` gives a
    batch's arrays and ``rebuild(inputs)`` the batch of static buffers
    (default: a ``GraphBatch``'s fields)."""

    def __init__(self, body: Callable, leaves: Callable = None, rebuild: Callable = None):
        super().__init__()
        self.body = body
        self.leaves = leaves or _batch_leaves
        self.rebuild = rebuild or _static_batch

    def __call__(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        leaves = self.leaves(batch)
        binding = tuple(t.data_ptr() for t in state.tensors())
        outputs = self.run(
            (id(state), binding, shape_key(leaves)), leaves,
            lambda inputs: self.body(state, self.rebuild(inputs)), state.device,
            restore=state.tensors(), keep=state, label="train_step.replay")
        return {k: v.clone() for k, v in outputs.items()}


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
        leaves = _batch_leaves(batch)
        binding = tuple(p.data_ptr() for p in model.parameters())
        outputs = captured.run(
            (id(model), binding, shape_key(leaves)), leaves,
            lambda inputs: body(model, _static_batch(inputs)), device,
            keep=model, label="eval_step.replay")
        return {k: v.clone() for k, v in outputs.items()}

    eval_step.captured = captured
    eval_step.body = body
    return eval_step
