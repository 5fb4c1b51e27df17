"""The port's owner-computes halo step (``parallel/halo.py``) against the
JAX package's: the host layout bit for bit (shards, halo widths, edge
capacities and the same ``ValueError`` on an unsorted frame), and the
train step on a grid of four gloo processes of the port's worker
(``parallel/worker.launch_spec``)
against JAX's ``make_halo_train_step`` on a mesh of the same shape, at
G = 2 and G = 4, for 2 steps, from the same converted weights and the same
spatially-sorted numpy batch; also against the port's single-process step
(tests/test_torch_train.py's STEP_TOL), every rank's params equal bit for
bit."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from graph_neural_network_for_radar_perception_torch.config.config import (
    GNNConfig,
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.parallel import halo as TH
from graph_neural_network_for_radar_perception_torch.train import steps as S
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
    SyntheticRadarDataset,
    pad_frame,
    stack_batch,
)
from graph_neural_network_for_radar_perception_tpu.parallel import halo as JH
from graph_neural_network_for_radar_perception_tpu.parallel.mesh import make_mesh
from graph_neural_network_for_radar_perception_tpu.train import steps as T
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)
from torch_port_fixtures import port_batch, start_grid

JAX_METRIC_TOL = dict(rtol=2e-3, atol=1e-5)   # tests/test_halo.py
JAX_PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)         # tests/test_torch_train.py
SHAPES = {"G2": (2, 2), "G4": (1, 4)}         # (n_data, n_graph), 4 ranks
STEPS = 2


def _sorted_batch(seed, size=4):
    jcfg = JC.tiny_test_config(batch_size=size)
    ds = SyntheticRadarDataset(jcfg, seed=seed, num_objects=2)
    return stack_batch([pad_frame(JH.spatial_sort_frame(ds.sample_frame()), jcfg)
                        for _ in range(size)])


def _graph(batch, b):
    return jax.tree.map(lambda x: np.asarray(x)[b], batch.graph)


def _params(js):
    return {k: v.numpy() for k, v in
            state_dict_from_flax(jax.tree.map(np.asarray, js.params)).items()}


# ------------------------------------------------------------- host layout
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("seed", [11, 12])
def test_layout_matches_jax_bit_for_bit(seed, n_shards):
    batch = _sorted_batch(seed)
    cfg = tiny_test_config(batch_size=4)
    tbatch = port_batch(batch)
    halo = TH.halo_width(tbatch, n_shards)
    need = max(JH.required_halo(_graph(batch, b), n_shards) for b in range(4))
    assert halo == 8 * max(1, -(-need // 8))
    for b in range(4):
        g = _graph(batch, b)
        assert TH.required_halo(g, n_shards) == JH.required_halo(g, n_shards)
        got, want = TH.build_halo_shards(g, n_shards, halo), JH.build_halo_shards(g, n_shards, halo)
        for f in dataclasses.fields(TH.HaloShards):
            a, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
            assert a.dtype == w.dtype and np.array_equal(a, w), f.name
    got = TH.make_halo_batch(tbatch, cfg, n_shards, halo)
    want = JH.make_halo_batch(batch, JC.tiny_test_config(batch_size=4), n_shards, halo)
    for f in dataclasses.fields(TH.HaloShards):
        assert np.array_equal(getattr(got, f.name), np.asarray(getattr(want, f.name))), f.name


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_edge_cap_matches_jax(n_shards):
    for over in ({}, {"max_nodes": 256}, {"k_number_nearest_points": 16}):
        assert (TH.halo_edge_cap(tiny_test_config(**over), n_shards)
                == JH.halo_edge_cap(JC.tiny_test_config(**over), n_shards))
    assert TH.halo_edge_cap(GNNConfig(), n_shards) == JH.halo_edge_cap(JC.GNNConfig(), n_shards)


def test_unsorted_frame_raises_as_jax():
    """An unsorted frame's sources lie outside a narrow halo: both raise the
    same ValueError; so does an owner over its edge capacity."""
    jcfg = JC.tiny_test_config()
    ds = SyntheticRadarDataset(jcfg, seed=9, num_objects=2)
    g, _ = pad_frame(ds.sample_frame(), jcfg)
    g = jax.tree.map(np.asarray, g)
    assert JH.required_halo(g, 4) > 8
    for args in ((g, 4, 8), (g, 2, JH.required_halo(g, 2), 8)):
        with pytest.raises(ValueError) as want:
            JH.build_halo_shards(*args)
        with pytest.raises(ValueError) as got:
            TH.build_halo_shards(*args)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------- the step
@pytest.fixture(scope="module")
def runs():
    batch = _sorted_batch(11)
    jcfg, cfg = JC.tiny_test_config(batch_size=4), tiny_test_config(batch_size=4)
    js0 = T.create_train_state(jcfg, jax.random.key(0))
    weights = state_dict_from_flax(jax.tree.map(np.asarray, js0.params))
    tbatch = port_batch(batch)
    halos = {name: TH.halo_width(tbatch, shape[1]) for name, shape in SHAPES.items()}
    modes = [{"name": name, "partition": "halo", "n_graph": shape[1], "steps": STEPS,
              "cfg": cfg, "weights": weights, "batch": tbatch}
             for name, shape in SHAPES.items()]
    grid = start_grid(modes + [dict(m, name=m["name"] + "-calls", loss_only=True)
                               for m in modes], world=4)

    def jax_steps(shape, halo):
        mesh = make_mesh(*shape)
        step = JH.make_halo_train_step(jcfg, mesh, halo)
        b, s = step.place(jax.tree.map(jnp.asarray, batch),
                          JH.make_halo_batch(batch, jcfg, shape[1], halo))
        js, out = jax.device_put(js0, NamedSharding(mesh, P())), []
        for _ in range(STEPS):
            js, jm = step(js, b, s)
            out.append(({k: float(v) for k, v in jm.items()}, _params(js)))
        return out

    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        jax_runs = {name: pool.submit(jax_steps, shape, halos[name])
                    for name, shape in SHAPES.items()}
        st = S.create_train_state(cfg, device="cpu")
        st.model.load_state_dict(weights)
        pstep, single = S.make_train_step(cfg), []
        for _ in range(STEPS):
            st, pm = pstep(st, batch)
            single.append(({k: float(v) for k, v in pm.items()},
                           {k: v.numpy().copy() for k, v in st.model.state_dict().items()}))
        jax_out = {name: f.result() for name, f in jax_runs.items()}
    ranks = grid.result()
    return {name: {"jax": jax_out[name], "single": single, "halo": halos[name],
                   "ranks": [r[name] for r in ranks],
                   "calls": [r[name + "-calls"]["all_reduces"] for r in ranks],
                   "kinds": [r[name + "-calls"]["collectives"] for r in ranks]}
            for name in SHAPES}


def _close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_halo_grid_matches_jax(runs, shape):
    r = runs[shape]
    for i, (jm, jp) in enumerate(r["jax"]):
        rec = r["ranks"][0]["records"][i]
        _close(rec["metrics"], jm, JAX_METRIC_TOL, f"{shape} step {i}")
        _close(rec["params"], jp, JAX_PARAM_TOL, f"{shape} step {i}")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_halo_grid_matches_single_process_step(runs, shape):
    r = runs[shape]
    for i, (pm, pp) in enumerate(r["single"]):
        rec = r["ranks"][0]["records"][i]
        _close(rec["metrics"], pm, STEP_TOL, f"{shape} step {i}")
        _close(rec["params"], pp, STEP_TOL, f"{shape} step {i}")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_halo_ranks_hold_identical_params(runs, shape):
    ranks = [r["records"] for r in runs[shape]["ranks"]]
    for i in range(STEPS):
        for r in ranks[1:]:
            assert r[i]["metrics"] == ranks[0][i]["metrics"]
            for k, v in ranks[0][i]["params"].items():
                assert np.array_equal(r[i]["params"][k], v), (shape, i, k)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_halo_collectives_are_one_set_a_round_for_the_batch(runs, shape):
    """The halo forward takes a rank's graphs as one batch: each round's
    exchange is two ppermutes a hop for the batch, then one all_gather of
    the [B, N, D] embeddings and one all-reduce of the LossSums
    (``collectives.STATS``' calls over all kinds)."""
    cfg = tiny_test_config()
    g = SHAPES[shape][1]
    hops = -(-runs[shape]["halo"] // (cfg.max_nodes // g))
    rounds = len(cfg.graph_convolution_stem_channels)
    assert runs[shape]["calls"] == [rounds * 2 * hops + 2] * 4


@pytest.mark.parametrize("shape", list(SHAPES))
def test_halo_collectives_hand_over_the_rank_rows_once(runs, shape):
    """The native route under gloo on the CPU (``collectives.STATS`` by
    kind, one halo forward): each ppermute hands over the rank's
    [B_local, N/G, D] f32 rows once where the rank sends (the staged
    all-reduce handed over G times as many from every rank), the
    all_gather the same rows once, the LossSums' all-reduce its 11 f32
    sums; no reduce-scatter runs forward."""
    from graph_neural_network_for_radar_perception_torch.train.loss import LossSums

    cfg = tiny_test_config()
    n_data, g = SHAPES[shape]
    nl = cfg.max_nodes // g
    hops = -(-runs[shape]["halo"] // nl)
    widths = (cfg.node_feat_enc_stem_channels[-1],) + cfg.graph_convolution_stem_channels[:-1]
    rows = [(4 // n_data) * nl * w * 4 for w in widths]  # a round's input rows, bytes
    for r, kinds in enumerate(runs[shape]["kinds"]):
        me = r % g
        sends = sum((me < g - hop) + (me >= hop) for hop in range(1, hops + 1))
        assert kinds["ppermute"] == {"calls": len(widths) * 2 * hops,
                                     "bytes": sends * sum(rows)}, r
        last = (4 // n_data) * nl * cfg.graph_convolution_stem_channels[-1] * 4
        assert kinds["all_gather"] == {"calls": 1, "bytes": last}, r
        assert kinds["all_reduce"] == {"calls": 1, "bytes": len(LossSums._fields) * 4}, r
        assert kinds["reduce_scatter"] == {"calls": 0, "bytes": 0}, r


@pytest.mark.parametrize("shape", list(SHAPES))
def test_halo_step_on_the_cpu_runs_eagerly(runs, shape):
    """On the CPU the halo step is not captured: every step eager, the host
    ms in its collectives recorded."""
    for rank in runs[shape]["ranks"]:
        for rec in rank["records"]:
            assert rec["captured"] is False and rec["warmups"] == 0
            assert rec["host_launches"] is None and rec["all_reduce_ms"] >= 0.0
        assert rank["replays"] == 0 and rank["backend"] == "gloo"


def test_halo_step_refuses_other_rounds():
    """The halo round computes channel norm, leaky ReLU and sums only."""
    from graph_neural_network_for_radar_perception_torch.parallel.mesh import ProcessMesh

    mesh = ProcessMesh(1, 2, 0, torch.device("cpu"), graph_group=object())
    with pytest.raises(ValueError, match="channel normalisation"):
        TH.make_halo_train_step(tiny_test_config(aggregation="mean"), mesh, 8)
    with pytest.raises(ValueError, match="graph axis"):
        TH.make_halo_train_step(tiny_test_config(), ProcessMesh(2, 1, 0, torch.device("cpu")), 8)
