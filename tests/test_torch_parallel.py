"""The port's data-parallel and edge-sharded train steps (``parallel/``)
against the JAX package's mesh steps.

The port's grid is four real gloo processes of the port's worker on the
CPU (``parallel/worker.launch_spec``, no JAX in them), started once for
every mode while this process runs the JAX steps on ``make_mesh`` of the same
shape over the virtual CPU devices, from the same converted weights and
the same numpy batch.  Held: metrics (rtol 2e-3, atol 1e-5) and params
after each step (rtol 2e-4, atol 1e-6) against JAX, as the JAX package's
tests/test_parallel.py holds its mesh steps; the port's single-process
``make_train_step`` within tests/test_torch_train.py's STEP_TOL; every
rank's params equal bit for bit; every step eager on the CPU.  The
collectives' child (tests/torch_collectives_child.py) also runs each
ppermute and all_gather through both routes, native and staged, at G = 2
and G = 4: equal bit for bit, each route's bytes in ``collectives.STATS``."""

import concurrent.futures
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config.config import (
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.core.graph import (
    GraphBatch,
)
from graph_neural_network_for_radar_perception_torch.parallel import mesh as PM
from graph_neural_network_for_radar_perception_torch.parallel.worker import run_processes
from graph_neural_network_for_radar_perception_torch.train import steps as S
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    SyntheticRadarDataset,
)
from graph_neural_network_for_radar_perception_tpu.parallel import mesh as JM
from graph_neural_network_for_radar_perception_tpu.parallel import sharded as JS
from graph_neural_network_for_radar_perception_tpu.train import steps as T
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)
from torch_port_fixtures import in_background, port_batch, start_grid

JAX_METRIC_TOL = dict(rtol=2e-3, atol=1e-5)   # tests/test_parallel.py
JAX_PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)         # tests/test_torch_train.py
WORLD = 4
# Edge-sharded modes whose forward's all-reduces are counted, and the psums
# a message round makes for the rank's whole batch: the partial aggregates,
# for "mean" also the edge counts.
CALL_MODES = {"edge": 1, "edge-mean": 2}

# name: (kind, (n_data, n_graph), steps, cfg overrides, mp_impl)
MODES = {
    "dp": ("dp", (4, 1), 1, {}, None),
    "edge": ("edge", (2, 2), 2, {}, None),
    "edge-csr": ("edge", (2, 2), 2, {}, "csr"),
    "edge-mean": ("edge", (2, 2), 1, {"aggregation": "mean"}, None),
}


def _params(js):
    return {k: v.numpy() for k, v in
            state_dict_from_flax(jax.tree.map(np.asarray, js.params)).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mode: the port grid's ranks' results, JAX's mesh step's
    (metrics, params) per step and the port single process's; the
    collectives' results per rank; the error of a max-aggregation step."""
    tmp = tmp_path_factory.mktemp("grid")
    jcfg = JC.tiny_test_config(batch_size=4)
    batch = next(SyntheticRadarDataset(jcfg, seed=5, num_objects=2).batches(4))
    tbatch = port_batch(batch)
    js0 = T.create_train_state(jcfg, jax.random.key(0))
    weights = state_dict_from_flax(jax.tree.map(np.asarray, js0.params))
    modes = [{"name": name, "n_graph": shape[1], "steps": steps, "weights": weights,
              "cfg": tiny_test_config(batch_size=4, **over, **({"mp_impl": mp_impl} if mp_impl
                                                              else {})),
              "batch": tbatch}
             for name, (kind, shape, steps, over, mp_impl) in MODES.items()]
    max_mode = dict(modes[1], name="max", cfg=tiny_test_config(batch_size=4, aggregation="max"))
    poisoned = dataclasses.replace(tbatch, graph=dataclasses.replace(
        tbatch.graph, node_feat=tbatch.graph.node_feat.copy()))
    poisoned.graph.node_feat[0, 0, 0] = np.nan  # in one graph of rank 0's rows
    modes += [dict(max_mode, loss_only=True), dict(modes[0], name="nan", steps=1, batch=poisoned)]
    # One forward of the edge-sharded loss a mode: its all-reduce calls.
    modes += [dict(m, name=m["name"] + "-calls", loss_only=True) for m in modes
              if m["name"] in CALL_MODES]
    grid = start_grid(modes, WORLD)
    # The max round's step on a 1 x 2 grid: its backward must fail the run.
    max_step = start_grid([dict(max_mode, steps=1)], 2)
    child = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_collectives_child.py")
    collectives = in_background(run_processes, [
        [sys.executable, child, str(tmp / "store"), str(WORLD), str(r), str(tmp / f"c{r}.pt")]
        for r in range(WORLD)], timeout=120.0, env=dict(os.environ, OMP_NUM_THREADS="1"))

    jbatch = jax.tree.map(jnp.asarray, batch)

    def jax_steps(kind, shape, steps, over):
        """JAX's mesh step from the same weights: (metrics, params) per
        step.  The state starts replicated on the mesh, as the step leaves
        it, so that the second step reuses the first's compilation."""
        jc = JC.tiny_test_config(batch_size=4, **over)
        mesh = JM.make_mesh(*shape)
        if kind == "dp":
            jstep, jb = JS.make_dp_train_step(jc, mesh), jbatch
        else:
            jstep = JS.make_edge_sharded_train_step(jc, mesh)
            jb = jstep.place_batch(jbatch)
        js, out = jax.device_put(js0, NamedSharding(mesh, P())), []
        for _ in range(steps):
            js, jm = jstep(js, jb)
            out.append(({k: float(v) for k, v in jm.items()}, _params(js)))
        return out

    def jax_max():
        jc = JC.tiny_test_config(batch_size=4, aggregation="max")
        mesh = JM.make_mesh(2, 2)
        loss = JS._edge_sharded_loss(jc, mesh)
        jb = JS.make_edge_sharded_train_step(jc, mesh).place_batch(jbatch)
        _, jm = jax.jit(loss)(js0.params, jb)
        try:
            jax.jit(jax.value_and_grad(loss, has_aux=True))(js0.params, jb)
            err = None
        except NotImplementedError as e:
            err = str(e)
        return {"jax": {k: float(v) for k, v in jm.items()}, "error": err}

    # JAX's compilations (~10 s each) run side by side, beside the grid.
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        jax_runs = {(kind, shape, steps, tuple(over.items())): pool.submit(
                        jax_steps, kind, shape, steps, over)
                    for kind, shape, steps, over, _ in MODES.values()}
        jmax = pool.submit(jax_max)
        out = {}
        for name, (kind, shape, steps, over, mp_impl) in MODES.items():
            cfg = tiny_test_config(batch_size=4, **over)
            st = S.create_train_state(cfg, device="cpu")
            st.model.load_state_dict(weights)
            pstep = S.make_train_step(cfg, mp_impl=mp_impl)
            single = []
            for _ in range(steps):
                st, pm = pstep(st, batch)
                single.append(({k: float(v) for k, v in pm.items()},
                               {k: v.numpy().copy() for k, v in st.model.state_dict().items()}))
            out[name] = {"single": single}
        for name, (kind, shape, steps, over, _) in MODES.items():
            out[name]["jax"] = jax_runs[kind, shape, steps, tuple(over.items())].result()
        out["max"] = jmax.result()
    ranks = grid.result()
    for name in out:
        out[name]["ranks"] = [r[name] for r in ranks]
    collectives.result()
    out["collectives"] = [torch.load(tmp / f"c{r}.pt", weights_only=False)
                          for r in range(WORLD)]
    out["nan"] = {"ranks": [r["nan"] for r in ranks], "weights": weights}
    for name in CALL_MODES:
        out[name]["calls"] = [r[name + "-calls"]["all_reduces"] for r in ranks]
    with pytest.raises(RuntimeError) as err:
        max_step.result()
    out["max"]["step_error"] = str(err.value)
    return out


def _close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("mode", list(MODES))
def test_grid_matches_jax_mesh_step(runs, mode):
    r = runs[mode]
    for i, (jm, jp) in enumerate(r["jax"]):
        rec = r["ranks"][0]["records"][i]
        _close(rec["metrics"], jm, JAX_METRIC_TOL, f"{mode} step {i}")
        _close(rec["params"], jp, JAX_PARAM_TOL, f"{mode} step {i}")


@pytest.mark.parametrize("mode", list(MODES))
def test_grid_matches_single_process_step(runs, mode):
    r = runs[mode]
    for i, (pm, pp) in enumerate(r["single"]):
        rec = r["ranks"][0]["records"][i]
        _close(rec["metrics"], pm, STEP_TOL, f"{mode} step {i}")
        _close(rec["params"], pp, STEP_TOL, f"{mode} step {i}")
        assert rec["metrics"]["skipped"] == 0.0


@pytest.mark.parametrize("mode", list(MODES))
def test_ranks_hold_identical_params(runs, mode):
    ranks = [r["records"] for r in runs[mode]["ranks"]]
    for i in range(len(ranks[0])):
        for r in ranks[1:]:
            assert r[i]["metrics"] == ranks[0][i]["metrics"]
            for k, v in ranks[0][i]["params"].items():
                assert np.array_equal(r[i]["params"][k], v), (mode, i, k)


@pytest.mark.parametrize("mode", list(CALL_MODES))
def test_round_psums_are_one_a_round_for_the_batch(runs, mode):
    """The edge-sharded forward runs ONE model call for a rank's 2 graphs:
    each message round all-reduces the batch's [B, N, D] partial once (and,
    for "mean", its counts once), then one all-reduce of the LossSums
    (``collectives.STATS``; one a round a graph before)."""
    rounds = len(tiny_test_config().graph_convolution_stem_channels)
    assert runs[mode]["calls"] == [rounds * CALL_MODES[mode] + 1] * WORLD


def test_max_forward_matches_jax_and_backward_raises(runs):
    """Edge-sharded max aggregation: the forward's metrics equal JAX's (a
    max all-reduce of per-shard maxima that fill 0 where a shard has no
    edge of a node, as JAX's), and the backward raises JAX's error."""
    r = runs["max"]
    assert "pmax" in r["error"]
    for rank in r["ranks"]:
        _close(rank["metrics"], r["jax"], JAX_METRIC_TOL, "max")
    assert "NotImplementedError: Differentiation rule for 'pmax' not implemented" \
        in r["step_error"]


def test_nan_on_one_rank_skips_every_rank(runs):
    """A NaN in one graph of rank 0's rows: the NaN skip decides from the
    all-reduced loss and gradients, so every rank skips the step and keeps
    its params bit for bit."""
    for r in runs["nan"]["ranks"]:
        assert r["records"][0]["metrics"]["skipped"] == 1.0
        for k, v in runs["nan"]["weights"].items():
            assert np.array_equal(r["records"][0]["params"][k], v.numpy()), k


def test_csr_edge_shards_keep_the_contract():
    """A contiguous 1/G of destination-sorted edges stays sorted and inside
    its tiles' windows: the CSR guard counts no violation on any shard of
    the test batch (the CSR round's dst are the senders)."""
    from graph_neural_network_for_radar_perception_torch.ops import csr_mp as C

    cfg = tiny_test_config(batch_size=4, mp_impl="csr")
    batch = next(SyntheticRadarDataset(JC.tiny_test_config(batch_size=4), seed=5,
                                       num_objects=2).batches(4))
    for shards in (2, 4):
        for g in range(shards):
            cut = PM.edge_shard(batch, shards, g)
            for b in range(4):
                m = torch.from_numpy(cut.graph.edge_mask[b])
                dst = torch.where(m, torch.from_numpy(cut.graph.senders[b]), cfg.max_nodes)
                assert int(C.order_violations(dst, cfg.max_nodes)) == 0
                assert int(C.window_span_violations(
                    dst, cfg.max_nodes, cfg.csr_edge_tile, cfg.csr_window)) == 0


@pytest.mark.parametrize("name", ["psum", "ppermute", "all_gather",
                                  "all_gather_tiled", "pmax"])
def test_collectives_forward_and_backward(runs, name):
    """Rank r holds x_r = arange(6).reshape(2, 3) + 10 r and backprops a
    cotangent of 1 + r: each op's output and its transpose (JAX's rule)."""
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(WORLD)]
    ct = [np.float32(1 + r) for r in range(WORLD)]
    for r, (y, grad) in enumerate(c[name] for c in runs["collectives"]):
        if name == "psum":
            want_y, want_g = sum(x), np.full((2, 3), sum(ct))
        elif name == "ppermute":  # i -> i + 1, no wrap
            want_y = x[r - 1] if r else np.zeros((2, 3))
            want_g = np.full((2, 3), ct[r + 1] if r + 1 < WORLD else 0.0)
        elif name == "pmax":
            want_y, want_g = x[-1], "Differentiation rule for 'pmax' not implemented"
        else:
            want_y = np.stack(x)
            want_y = want_y.reshape(-1, 3) if name.endswith("tiled") else want_y
            want_g = np.full((2, 3), sum(ct))
        np.testing.assert_array_equal(y, want_y)
        if name == "pmax":
            assert grad == want_g
        else:
            np.testing.assert_array_equal(grad, want_g)


ROUTE_OPS = ("ppermute", "all_gather", "all_gather_tiled")


@pytest.mark.parametrize("g, name", [(g, n) for g in (2, WORLD) for n in ROUTE_OPS],
                         ids=lambda v: f"G{v}" if isinstance(v, int) else v)
def test_native_route_equals_staged_route(runs, g, name):
    """``ppermute`` (i -> i + 1), ``all_gather`` and tiled ``all_gather``
    over the world (G = 4) and over pairs of ranks (G = 2) on random rows
    with random cotangents: the native route (``batch_isend_irecv``,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``) gives the staged
    all-reduce route's output and input gradient bit for bit on every
    rank."""
    for r, c in enumerate(runs["collectives"]):
        native, staged = c["routes"][g, name, "native"], c["routes"][g, name, "staged"]
        for what, a, b in (("output", native[0], staged[0]), ("gradient", native[1], staged[1])):
            assert a.dtype == b.dtype and np.array_equal(a, b), (r, what)


def _kinds(delta):
    """A ``collectives.counts()`` advance by kind: {kind: (calls, bytes)}
    of the kinds called."""
    from graph_neural_network_for_radar_perception_torch.parallel import collectives as PC

    assert delta[0] == sum(delta[1::2])
    return {k: (delta[1 + 2 * i], delta[2 + 2 * i]) for i, k in enumerate(PC.KINDS)
            if delta[1 + 2 * i]}


@pytest.mark.parametrize("g", [2, WORLD], ids=["G2", "G4"])
def test_stats_count_what_each_route_hands_over(runs, g):
    """``collectives.STATS`` by kind: a native ppermute hands over the
    rows it sends (x.nbytes from a rank that sends, 0 from the last of the
    chain), the staged one G x x.nbytes; a native all_gather its own rows,
    the staged one G x; the backward of either all_gather is a
    reduce-scatter of the [G, ...] cotangent."""
    rows = 3 * 5 * 4  # the [3, 5] f32 rows
    for r, c in enumerate(runs["collectives"]):
        me = r % g
        want = {
            ("ppermute", "native"): ({"ppermute": (1, rows * (me < g - 1))},
                                     {"ppermute": (1, rows * (me > 0))}),
            ("ppermute", "staged"): ({"ppermute": (1, g * rows)}, {"ppermute": (1, g * rows)}),
            ("all_gather", "native"): ({"all_gather": (1, rows)},
                                       {"reduce_scatter": (1, g * rows)}),
            ("all_gather", "staged"): ({"all_gather": (1, g * rows)},
                                       {"reduce_scatter": (1, g * rows)}),
        }
        for (name, route), (fwd, bwd) in want.items():
            for op in (name, name + "_tiled") if name == "all_gather" else (name,):
                got = c["routes"][g, op, route]
                assert (_kinds(got[2]), _kinds(got[3])) == (fwd, bwd), (r, op, route)


@pytest.mark.parametrize("mode", list(MODES))
def test_grid_step_on_the_cpu_runs_eagerly(runs, mode):
    """On the CPU the grid step is not captured: every step is eager, with
    no warm-up runs, its host launches not counted and the host ms in its
    collectives recorded."""
    for rank in runs[mode]["ranks"]:
        for rec in rank["records"]:
            assert rec["captured"] is False and rec["warmups"] == 0
            assert rec["host_launches"] is None and rec["all_reduce_ms"] >= 0.0
        assert rank["replays"] == 0 and rank["backend"] == "gloo"


def test_edge_fields_are_jaxs():
    """The fields cut along E are those JAX's specs put on ('data', 'graph')."""
    specs = JM.edge_sharded_batch_specs(None)
    for part, fields in (("graph", PM.GRAPH_EDGE_FIELDS), ("labels", PM.LABEL_EDGE_FIELDS)):
        jpart = getattr(specs, part)
        want = {f.name for f in dataclasses.fields(jpart)
                if getattr(jpart, f.name) == P("data", "graph")}
        assert set(fields) == want, part


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_edge_shards_tile_the_batch(shards):
    """Concatenating the G edge shards gives the batch back; every
    node-indexed field stays whole; a G that does not divide E raises."""
    cfg = tiny_test_config()
    batch = next(SyntheticRadarDataset(JC.tiny_test_config(), seed=3,
                                       num_objects=2).batches(2))
    cuts = [PM.edge_shard(batch, shards, g) for g in range(shards)]
    for part in ("graph", "labels"):
        for f in dataclasses.fields(getattr(batch, part)):
            name, full = f.name, getattr(getattr(batch, part), f.name)
            got = [getattr(getattr(c, part), name) for c in cuts]
            if name in PM.GRAPH_EDGE_FIELDS + PM.LABEL_EDGE_FIELDS:
                np.testing.assert_array_equal(np.concatenate(got, axis=1), full)
                assert got[0].shape[1] * shards == full.shape[1]
            else:
                for g in got:
                    assert g is full
    assert cfg.max_edges % 3
    with pytest.raises(ValueError, match="edge capacity"):
        PM.edge_shard(batch, 3, 0)
    assert isinstance(cuts[0], GraphBatch)


@pytest.mark.parametrize("rows, edges", [("all", False), ("data", False), ("data", True)])
def test_prefetch_places_this_ranks_share(rows, edges):
    """``device_prefetch(sharding=)`` hands out rank (1, 1) of a 2 × 2
    grid's share of each batch: rows 2-3 of 4 over 'data' (row 3 over every
    rank), and with edges the second half of every edge-indexed field."""
    from graph_neural_network_for_radar_perception_torch.data.prefetch import (
        device_prefetch,
    )

    mesh = PM.ProcessMesh(2, 2, 3, torch.device("cpu"))
    sharding = PM.BatchSharding(mesh, rows=rows, edges=edges)
    gen = SyntheticRadarDataset(JC.tiny_test_config(), seed=4, num_objects=2).batches(4)
    batches = [next(gen) for _ in range(3)]
    got = list(device_prefetch(iter(batches), device="cpu", sharding=sharding))
    assert len(got) == 3
    sl = slice(3, 4) if rows == "all" else slice(2, 4)
    for full, share in zip(batches, got):
        for part in ("graph", "labels"):
            for f in dataclasses.fields(getattr(full, part)):
                want = getattr(getattr(full, part), f.name)[sl]
                if edges and f.name in PM.GRAPH_EDGE_FIELDS + PM.LABEL_EDGE_FIELDS:
                    want = want[:, want.shape[1] // 2:]
                t = getattr(getattr(share, part), f.name)
                assert isinstance(t, torch.Tensor)
                np.testing.assert_array_equal(t.numpy(), want)
