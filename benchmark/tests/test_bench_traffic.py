"""The frozen generator: the same pool for the same seed, the same graph
sizes for every seed, each slot within its capacities."""

import json

import numpy as np

from bench_support import BENCH_DIR, SEED, TINY, TINY_MIX
from harness import traffic


def _cfg(name="radar_gnn_knn"):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())["gnn_config"]
    return dict(cfg, **TINY)


def _mix():
    return dict(json.loads((BENCH_DIR / "mixes" / "train.json").read_text()), **TINY_MIX)


def test_same_seed_same_pool():
    a, sa = traffic.make_pool(_cfg(), _mix(), SEED)
    b, sb = traffic.make_pool(_cfg(), _mix(), SEED)
    assert sa == sb
    for x, y in zip(a, b):
        for part in ("graph", "labels"):
            for k in x[part]:
                np.testing.assert_array_equal(x[part][k], y[part][k])


def test_every_seed_same_sizes_other_values():
    a, _ = traffic.make_pool(_cfg(), _mix(), SEED)
    b, _ = traffic.make_pool(_cfg(), _mix(), SEED + 1)
    sizes = lambda pool: sorted(tuple(int(v.sum()) for v in traffic.live_counts(p).values())  # noqa: E731
                                for p in pool)
    assert sizes(a) == sizes(b)
    assert not all(np.array_equal(x["graph"]["node_feat"], y["graph"]["node_feat"])
                   for x, y in zip(a, b))


def test_slots_within_capacity_and_prefix_masks():
    cfg = _cfg("radar_gnn_ball")
    pool, stats = traffic.make_pool(cfg, _mix(), SEED)
    n_cap, e_cap, eu_cap, c_cap = traffic.capacities(cfg)
    assert stats["slots"] == _mix()["pool"] * _mix()["batch"]
    for batch in pool:
        g, lab = batch["graph"], batch["labels"]
        assert g["node_feat"].shape[1:] == (n_cap, 6) and g["edge_feat"].shape[1:] == (e_cap, 7)
        assert g["und_senders"].shape[1] == eu_cap and lab["cluster_mask"].shape[1] == c_cap
        for mask in (g["node_mask"], g["edge_mask"], g["und_mask"], lab["cluster_mask"]):
            n = mask.sum(-1)
            assert all(mask[i, :n[i]].all() for i in range(mask.shape[0]))
        n = g["node_mask"].sum(-1)
        e = g["edge_mask"].sum(-1)
        for i in range(len(n)):
            assert (g["senders"][i, :e[i]] < n[i]).all()
            assert (g["receivers"][i, :e[i]] < n[i]).all()
            assert (lab["node2cluster"][i, :n[i]] <= c_cap).all()


def test_knn_graph_is_symmetric_and_holds_each_nearest():
    rng = np.random.default_rng(3)
    px, py = rng.uniform(0, 10, 40).astype(np.float32), rng.uniform(0, 10, 40).astype(np.float32)
    s, r, us, ur, _ = traffic._adjacency(px, py, 25.0, 5, union_ball=False)
    pairs = set(zip(s.tolist(), r.tolist()))
    assert all((b, a) in pairs for a, b in pairs)
    assert all(a < b for a, b in zip(us.tolist(), ur.tolist()))
    assert len(us) * 2 == len(s)
    d2 = (px[:, None] - px[None]) ** 2 + (py[:, None] - py[None]) ** 2
    for i in range(40):
        nearest = np.argsort(d2[i])[1:6]
        assert all((i, int(j)) in pairs for j in nearest)
