"""Helpers of the entry-point tests (tests/test_torch_examples_*.py): run a
root example or script of the JAX package and its port in one process on
the same seeds, with the JAX run's weights carried into the port's.

Both run at the widths of ``tiny_test_config`` (their capacities as the
entry point sets them): each side's ``GNNConfig`` is replaced by a factory
that overrides the widths.  Weights: every initialisation of the JAX run
(``create_train_state``, ``init_params``, a classifier's or CNN's ``init``)
is recorded in call order; the port run's initialisations take them in the
same order, converted by ``utils/convert``.  Steps: every train step the
JAX run makes (``make_train_step`` and its kin) records its metrics.
Nothing of either package is changed: the patches are monkeypatch's, undone
after each test."""

from __future__ import annotations

import importlib.util
import pathlib
import sys

import jax
import numpy as np

from graph_neural_network_for_radar_perception_torch.config import config as PC
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    classifier_state_dict_from_flax,
    cnn_state_dict_from_flax,
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC

REPO = pathlib.Path(__file__).resolve().parents[1]

# tiny_test_config's widths (its capacities stay the entry point's own).
WIDTHS = dict(
    node_feat_enc_stem_channels=(32, 16),
    edge_feat_enc_stem_channels=(32, 16),
    graph_convolution_stem_channels=(16, 16),
    msg_mlp_hidden_dim=32,
    link_pred_stem_channels=(16, 16),
    node_pred_stem_channels=(16, 16),
)
# Losses after each of <= 3 train steps (tests/test_torch_classifier.py).
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def narrow(config_cls):
    """A stand-in for ``GNNConfig`` that builds it at WIDTHS."""

    def make(**kw):
        return config_cls(**{**kw, **WIDTHS})

    make.from_yaml = config_cls.from_yaml
    return make


def load_root(kind: str, name: str):
    """The root ``examples/<name>.py`` or ``scripts/<name>.py`` of the JAX
    package, imported as a module of its own."""
    path = REPO / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(monkeypatch, module, argv):
    """``module.main()`` with ``argv`` as its command line."""
    monkeypatch.setattr(sys, "argv", [module.__name__] + list(argv))
    return module.main()


def host(tree):
    """Copies on the host: a view of a JAX buffer changes when a later step
    donates it."""
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


class Carry:
    """The JAX run's initial weights (in call order) and step metrics."""

    def __init__(self):
        self.inits = []      # (kind, numpy params)
        self.metrics = []    # one dict of floats per JAX train step
        self.taken = 0

    # -- the JAX side ---------------------------------------------------
    def _record_step(self, step):
        def wrapped(state, *args):
            state, m = step(state, *args)
            self.metrics.append({k: float(v) for k, v in m.items()})
            return state, m

        if hasattr(step, "place_batch"):
            wrapped.place_batch = step.place_batch
        return wrapped

    def _record_init(self, kind, fn, params_of):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.inits.append((kind, host(params_of(out))))
            return out

        return wrapped

    def patch_jax(self, monkeypatch):
        """Record every initialisation and train step of the JAX package."""
        from graph_neural_network_for_radar_perception_tpu.models import classifier as JCL
        from graph_neural_network_for_radar_perception_tpu.models import cnn as JCNN
        from graph_neural_network_for_radar_perception_tpu.train import finetune as JFT
        from graph_neural_network_for_radar_perception_tpu.train import steps as JS
        from graph_neural_network_for_radar_perception_tpu.train import trainer as JT

        monkeypatch.setattr(JC, "GNNConfig", narrow(JC.GNNConfig))
        make_state = self._record_init("gnn", JS.create_train_state, lambda s: s.params)
        for mod in (JS, JT):
            monkeypatch.setattr(mod, "create_train_state", make_state)
        monkeypatch.setattr(JS, "init_params",
                            self._record_init("gnn", JS.init_params, lambda p: p))
        make_step = JS.make_train_step

        def make_train_step(*a, **k):
            return self._record_step(make_step(*a, **k))

        for mod in (JS, JT):
            monkeypatch.setattr(mod, "make_train_step", make_train_step)

        make_ft = JFT.make_finetune_step

        def make_finetune_step(cfg):
            build, loss_fn = make_ft(cfg)

            def recorded_build(params):
                step, tx = build(params)
                return self._record_step(step), tx

            return recorded_build, loss_fn

        monkeypatch.setattr(JFT, "make_finetune_step", make_finetune_step)

        for mod, attr, kind in ((JCL, "make_classifier_train_step", "classifier"),
                                (JCNN, "make_grid_train_step", "cnn")):
            def make(ccfg, _orig=getattr(mod, attr), _kind=kind):
                model, init, step, loss_fn = _orig(ccfg)
                return (model, self._record_init(_kind, init, lambda s: s.params),
                        self._record_step(step), loss_fn)

            monkeypatch.setattr(mod, attr, make)

    # -- the port side --------------------------------------------------
    def next_init(self, kind):
        got, params = self.inits[self.taken]
        assert got == kind, f"init {self.taken}: JAX made {got}, the port {kind}"
        self.taken += 1
        return params

    def patch_port(self, monkeypatch, example=None):
        """Give each initialisation of the port the JAX run's weights, in
        order; ``example``'s own ``GNNConfig`` is narrowed as the JAX one,
        and its ``RadarGNN`` / ``create_train_state`` carry weights too."""
        from graph_neural_network_for_radar_perception_torch.models import classifier as TCL
        from graph_neural_network_for_radar_perception_torch.models import cnn as TCNN
        from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
        from graph_neural_network_for_radar_perception_torch.train import steps as TS
        from graph_neural_network_for_radar_perception_torch.train import trainer as TT

        make_state = TS.create_train_state

        def create_train_state(cfg, generator=None, device="cuda", model_cls=RadarGNN):
            state = make_state(cfg, generator, device=device, model_cls=model_cls)
            state.model.load_state_dict(state_dict_from_flax(self.next_init("gnn")))
            return state

        def radar_gnn(cfg, generator=None):
            model = RadarGNN(cfg, generator=generator)
            model.load_state_dict(state_dict_from_flax(self.next_init("gnn")))
            return model

        for mod in (TS, TT):
            monkeypatch.setattr(mod, "create_train_state", create_train_state)
        if example is not None:
            for attr, value in (("GNNConfig", narrow(PC.GNNConfig)),
                                ("create_train_state", create_train_state),
                                ("RadarGNN", radar_gnn)):
                if hasattr(example, attr):
                    monkeypatch.setattr(example, attr, value)

        for mod, attr, kind, convert in (
                (TCL, "make_classifier_train_step", "classifier",
                 classifier_state_dict_from_flax),
                (TCNN, "make_grid_train_step", "cnn", None)):
            def make(ccfg, _orig=getattr(mod, attr), _kind=kind, _convert=convert):
                init, step, loss_fn = _orig(ccfg)

                def carried_init(generator=None, device="cuda"):
                    state = init(generator, device=device)
                    params = self.next_init(_kind)
                    sd = (_convert(params) if _convert is not None
                          else cnn_state_dict_from_flax(params, ccfg))
                    state.model.load_state_dict(sd)
                    return state

                return carried_init, step, loss_fn

            monkeypatch.setattr(mod, attr, make)

    def port_steps(self, monkeypatch):
        """A list that collects the metrics of every train step the port's
        ``make_train_step`` makes from here on."""
        from graph_neural_network_for_radar_perception_torch.train import steps as TS
        from graph_neural_network_for_radar_perception_torch.train import trainer as TT

        log = []
        make_step = TS.make_train_step

        def make_train_step(*a, **k):
            step = make_step(*a, **k)

            def wrapped(state, batch):
                state, m = step(state, batch)
                log.append({k: float(v) for k, v in m.items()})
                return state, m

            return wrapped

        for mod in (TS, TT):
            monkeypatch.setattr(mod, "make_train_step", make_train_step)
        return log


def assert_msgpack_like_jax(port_path, jax_path):
    """The flax msgpack file the port wrote (``port_path``) read by the JAX
    package's ``load_params_msgpack`` with the JAX run's file
    (``jax_path``) as its template: the same keys in the same order at
    every level, the same shapes and dtypes, and values within STEP_TOL
    (the two runs trained alike, each on its own backend)."""
    from flax import serialization

    from graph_neural_network_for_radar_perception_tpu.utils.checkpoint import (
        load_params_msgpack,
    )

    with open(jax_path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = load_params_msgpack(want, str(port_path))
    with open(port_path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    paths = jax.tree_util.tree_flatten_with_path(raw)[0]
    assert [p for p, _ in paths] == [p for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]

    def keys(tree):
        return [(k, keys(v)) for k, v in tree.items()] if isinstance(tree, dict) else None

    assert keys(raw) == keys(want)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_allclose(g, w, **STEP_TOL, err_msg=str(path))


def assert_steps_close(got, want, keys=None, what=""):
    """Per-step metrics of the port (``got``) against JAX's at STEP_TOL."""
    assert len(got) == len(want) and want, (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys or w:
            np.testing.assert_allclose(g[k], w[k], **STEP_TOL,
                                       err_msg=f"{what} step {i} {k}")
