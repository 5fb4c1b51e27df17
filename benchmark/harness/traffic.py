"""The benchmark's batches: synthetic radar frames, graphs, packing.

A frozen copy of the port's synthetic-frame generator
(``data/synthetic.make_synthetic_frame``, the same draws in the same
order) and of its batch-building arithmetic (``data/pipeline``:
``preprocess_frame`` with the numpy graph builder of
``data/features.adjacency_info``, ``pad_frame``, ``merge_frames`` and the
first-fit packing of ``SyntheticRadarDataset.packed_batches``), in numpy
only, so that later changes to the program cannot change the traffic.
The kNN selection takes each row's k + 1 nearest by ``argpartition``; the
edge set equals the full stable sort's except on exact distance ties.

A batch is a dict of two dicts of numpy arrays, ``graph`` and ``labels``,
each field with a leading slot axis, named as the program's ``RadarGraph``
and ``GraphLabels`` fields.  ``make_pool`` draws a mix's pool of batches
from a seed: the same seed gives the same arrays, and every seed the same
graph sizes (``FrameSource``), in another order and with other values.
"""

from __future__ import annotations

import numpy as np

GRAPH_FIELDS = ("node_feat", "edge_feat", "senders", "receivers", "node_mask",
                "edge_mask", "und_senders", "und_receivers", "und_mask",
                "other_feat")
LABEL_FIELDS = ("node_class", "node_offsets", "edge_class", "node2cluster",
                "cluster_class", "cluster_mask")

# RadarScenes raw label ids and the 12 → 8 class map (reference labels.py).
OLD_IDS = {"CAR": 0, "LARGE_VEHICLE": 1, "TRUCK": 2, "BUS": 3, "TRAIN": 4,
           "BICYCLE": 5, "MOTORIZED_TWO_WHEELER": 6, "PEDESTRIAN": 7,
           "PEDESTRIAN_GROUP": 8, "ANIMAL": 9, "OTHER": 10, "STATIC": 11}
OLD_TO_NEW = np.array([0, 4, 4, 4, 4, 3, 3, 1, 2, 5, 5, 7], dtype=np.int32)
ID_FALSE, ID_STATIC = 6, 7

_CLASS_SPECS = {
    "CAR": dict(size=(4.5, 1.9), pts=(4, 14), speed=(3, 15)),
    "PEDESTRIAN": dict(size=(0.6, 0.6), pts=(1, 4), speed=(0.5, 2.0)),
    "PEDESTRIAN_GROUP": dict(size=(2.5, 2.5), pts=(4, 12), speed=(0.5, 2.0)),
    "BICYCLE": dict(size=(1.8, 0.6), pts=(2, 6), speed=(2, 8)),
    "TRUCK": dict(size=(9.0, 2.5), pts=(8, 24), speed=(3, 12)),
}


def make_frame(rng: np.random.Generator, num_objects: int, window_size: int,
               clutter_per_frame: float = 3.0, static_per_frame: int = 40,
               roi=(0.0, 100.0, -50.0, 50.0), frame_dt_us: float = 60_000.0) -> dict:
    """One windowed radar frame in the reference's data_dict schema:
    dynamic objects in linear motion, static background and clutter."""
    min_x, max_x, min_y, max_y = roi
    class_names = list(_CLASS_SPECS)
    cols = {k: [] for k in ("px", "py", "vx", "vy", "vr", "rcs", "ts", "sensor",
                            "stat", "label")}
    trackid = []

    def emit(x, y, velx, vely, tid, lab, stationary, t_us):
        n = x.shape[0]
        cols["px"].append(x)
        cols["py"].append(y)
        cols["vx"].append(velx)
        cols["vy"].append(vely)
        r = np.sqrt(x ** 2 + y ** 2) + 1e-6
        cols["vr"].append((velx * x + vely * y) / r + rng.normal(0, 0.05, n))
        cols["rcs"].append(rng.normal(-5.0, 8.0, n))
        cols["ts"].append(np.full(n, t_us))
        trackid.extend([tid] * n)
        cols["sensor"].append(np.full(n, rng.integers(1, 5), dtype=np.int32))
        cols["stat"].append(np.full(n, stationary, dtype=bool))
        cols["label"].append(np.full(n, lab, dtype=np.int32))

    for obj in range(num_objects):
        cname = class_names[rng.integers(len(class_names))]
        spec = _CLASS_SPECS[cname]
        cx = rng.uniform(min_x + 10, max_x - 10)
        cy = rng.uniform(min_y + 10, max_y - 10)
        speed = rng.uniform(*spec["speed"])
        heading = rng.uniform(-np.pi, np.pi)
        ovx, ovy = speed * np.cos(heading), speed * np.sin(heading)
        tid = f"trk_{obj}".encode()
        sx, sy = spec["size"]
        for w in range(window_size):
            t_rel = (w - (window_size - 1)) * frame_dt_us * 1e-6
            n = int(rng.integers(*spec["pts"]))
            if n == 0:
                continue
            x = cx + ovx * t_rel + rng.uniform(-sx / 2, sx / 2, n)
            y = cy + ovy * t_rel + rng.uniform(-sy / 2, sy / 2, n)
            emit(x, y, np.full(n, ovx) + rng.normal(0, 0.1, n),
                 np.full(n, ovy) + rng.normal(0, 0.1, n),
                 tid, OLD_IDS[cname], False, w * frame_dt_us)
    for w in range(window_size):
        n = static_per_frame
        x = rng.uniform(min_x, max_x, n)
        y = rng.uniform(min_y, max_y, n)
        emit(x, y, rng.normal(0, 0.02, n), rng.normal(0, 0.02, n),
             b"", OLD_IDS["STATIC"], True, w * frame_dt_us)
    for w in range(window_size):
        n = int(rng.poisson(clutter_per_frame))
        if n == 0:
            continue
        x = rng.uniform(min_x, max_x, n)
        y = rng.uniform(min_y, max_y, n)
        emit(x, y, rng.normal(0, 2.0, n), rng.normal(0, 2.0, n),
             b"", OLD_IDS["STATIC"], False, w * frame_dt_us)
    cat = np.concatenate
    return {
        "meas_px": cat(cols["px"]).astype(np.float32),
        "meas_py": cat(cols["py"]).astype(np.float32),
        "meas_vx": cat(cols["vx"]).astype(np.float32),
        "meas_vy": cat(cols["vy"]).astype(np.float32),
        "meas_vr": cat(cols["vr"]).astype(np.float32),
        "meas_rcs": cat(cols["rcs"]).astype(np.float32),
        "meas_timestamp": cat(cols["ts"]).astype(np.float64),
        "meas_trackid": np.array(trackid, dtype="S16"),
        "meas_sensorid": cat(cols["sensor"]),
        "stationary_meas_flag": cat(cols["stat"]),
        "meas_label_id": cat(cols["label"]),
    }


def _adjacency(px, py, eps_sq: float, k: int, union_ball: bool):
    """(directed senders, receivers in row-major order of the symmetric
    adjacency, upper-triangle pairs, ball-query degree): the reference's
    compute_adjacency_information[_v2] (graph_features.py:58-114)."""
    dx = px[:, None] - px[None, :]
    dy = py[:, None] - py[None, :]
    d2 = dx * dx + dy * dy
    n = d2.shape[0]
    ball = d2 <= eps_sq
    np.fill_diagonal(ball, False)
    kk = n if k >= n else k + 1
    nearest = (np.argpartition(d2, kk - 1, axis=-1)[:, :kk] if kk < n
               else np.tile(np.arange(n), (n, 1)))
    adj = np.zeros((n, n), dtype=bool)
    adj[np.repeat(np.arange(n), kk), nearest.ravel()] = True
    adj |= adj.T
    if union_ball:
        adj |= ball
    np.fill_diagonal(adj, False)
    s, r = np.nonzero(adj)
    upper = s < r  # row-major, as the upper triangle's nonzeros
    return s, r, s[upper], r[upper], ball.sum(-1)


def preprocess(data: dict, cfg: dict, flip: bool):
    """data_dict → ragged arrays of one frame, or None with fewer than two
    moving points (reference datagen_gnn.py:82-141)."""
    data = dict(data)
    if flip:
        data["meas_py"] = -data["meas_py"]
        data["meas_vy"] = -data["meas_vy"]
    tid = data["meas_trackid"]
    tracked = tid != b""
    # node classes and offsets to the track's mean (compute_node_labels.py)
    cls = np.zeros(tid.shape[0], dtype=np.float32)
    cls[tracked] = OLD_TO_NEW[data["meas_label_id"]][tracked]
    cls[~tracked & ~data["stationary_meas_flag"]] = ID_FALSE
    cls[~tracked & data["stationary_meas_flag"]] = ID_STATIC
    offx = np.zeros(tid.shape[0], dtype=np.float32)
    offy = np.zeros(tid.shape[0], dtype=np.float32)
    if tracked.any():
        uniq, inv = np.unique(tid[tracked], return_inverse=True)
        cnt = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        mx = np.bincount(inv, weights=data["meas_px"][tracked], minlength=len(uniq)) / cnt
        my = np.bincount(inv, weights=data["meas_py"][tracked], minlength=len(uniq)) / cnt
        offx[tracked] = (mx[inv] - data["meas_px"][tracked]).astype(np.float32)
        offy[tracked] = (my[inv] - data["meas_py"][tracked]).astype(np.float32)
    px, py = data["meas_px"], data["meas_py"]
    keep = ((px >= cfg["min_x"]) & (px < cfg["max_x"]) & (py >= cfg["min_y"])
            & (py < cfg["max_y"]) & (cls != ID_STATIC))
    data = {k: v[keep] for k, v in data.items()}
    cls, offx, offy = cls[keep], offx[keep], offy[keep]
    n = data["meas_px"].shape[0]
    if n <= 1:
        return None
    px, py = data["meas_px"], data["meas_py"]
    s, r, us, ur, degree = _adjacency(px, py, cfg["ball_query_eps_square"],
                                      cfg["k_number_nearest_points"],
                                      cfg["union_ball"])
    # edge features (graph_features.py:147-164, the double /10 of dl kept)
    dx = (px[s] - px[r]) / 10.0
    dy = (py[s] - py[r]) / 10.0
    dvx = data["meas_vx"][s] - data["meas_vx"][r]
    dvy = data["meas_vy"][s] - data["meas_vy"][r]
    dt = (data["meas_timestamp"][s] - data["meas_timestamp"][r]) * 1e-6
    edge_feat = np.stack([dx, dy, np.sqrt(dx ** 2 + dy ** 2) / 10.0, dvx, dvy,
                          np.sqrt(dvx ** 2 + dvy ** 2), dt], axis=-1).astype(np.float32)
    # node features (graph_features.py:117-144) with region confidences
    ts = data["meas_timestamp"]
    t_norm = ts - ts.min() if ts.max() == ts.min() else (ts - ts.min()) / (ts.max() - ts.min())
    rng_ = np.sqrt(px ** 2 + py ** 2)
    th = np.abs(np.arctan2(py, px))
    max_r = np.sqrt(cfg["max_x"] ** 2 + cfg["max_y"] ** 2)
    node_feat = np.stack([data["meas_vr"], data["meas_rcs"], t_norm, degree / 10.0,
                          (rng_ - max_r) / (0.0 - max_r),
                          (th - np.pi * 0.5) / (0.0 - np.pi * 0.5)],
                         axis=-1).astype(np.float32)
    other_feat = np.stack([px, py, data["meas_vx"], data["meas_vy"]],
                          axis=-1).astype(np.float32)
    tid = data["meas_trackid"]
    edge_class = ((tid[us] == tid[ur]) & (tid[us] != b"")).astype(np.int32)
    node_class = cls.astype(np.int32)
    # clusters: one per track id (np.unique order), then one per untracked
    # node in node order (datagen_gnn.py:15-45)
    tracked = tid != b""
    node2cluster = np.full(n, -1, dtype=np.int32)
    uniq, first, inv = np.unique(tid[tracked], return_index=True, return_inverse=True)
    node2cluster[tracked] = inv
    untracked = np.nonzero(~tracked)[0]
    node2cluster[untracked] = len(uniq) + np.arange(untracked.shape[0])
    cluster_class = np.concatenate([node_class[tracked][first],
                                    node_class[untracked]]).astype(np.int32)
    return dict(node_feat=node_feat, edge_feat=edge_feat, senders=s.astype(np.int32),
                receivers=r.astype(np.int32), und_senders=us.astype(np.int32),
                und_receivers=ur.astype(np.int32), other_feat=other_feat,
                node_class=node_class, node_offsets=np.stack([offx, offy], -1),
                edge_class=edge_class, node2cluster=node2cluster,
                cluster_class=cluster_class)


def capacities(cfg: dict):
    """(nodes, directed edges, undirected edges, clusters) of one slot."""
    e = int(cfg["edge_capacity_factor"] * cfg["k_number_nearest_points"]
            * cfg["max_nodes"])
    return cfg["max_nodes"], e, e // 2, cfg["max_clusters"]


def _size(fr):
    return (fr["node_feat"].shape[0], fr["senders"].shape[0],
            fr["und_senders"].shape[0], fr["cluster_class"].shape[0])


def _fits(acc, fr, caps) -> bool:
    return all(a + b <= c for a, b, c in zip(acc, _size(fr), caps))


def merge(frames) -> dict:
    """Several ragged frames as one block-diagonal frame (graph packing)."""
    if len(frames) == 1:
        return frames[0]
    n_off = np.cumsum([0] + [f["node_feat"].shape[0] for f in frames[:-1]])
    c_off = np.cumsum([0] + [f["cluster_class"].shape[0] for f in frames[:-1]])
    out = {}
    for k in frames[0]:
        parts = [f[k] for f in frames]
        if k in ("senders", "receivers", "und_senders", "und_receivers"):
            parts = [p + o for p, o in zip(parts, n_off)]
        elif k == "node2cluster":
            parts = [p + o for p, o in zip(parts, c_off)]
        out[k] = np.concatenate(parts).astype(parts[0].dtype)
    return out


def _pad(x, size, fill=0):
    out = np.full((size,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x[:size]
    return out


def pad(fr: dict, cfg: dict):
    """Ragged frame → (graph, labels) dicts at the slot's capacities,
    truncated node-first as the program's ``pad_frame``; also whether
    anything was cut."""
    n_cap, e_cap, eu_cap, c_cap = capacities(cfg)
    n = min(fr["node_feat"].shape[0], n_cap)
    ekeep = (fr["senders"] < n) & (fr["receivers"] < n)
    s, r = fr["senders"][ekeep][:e_cap], fr["receivers"][ekeep][:e_cap]
    ef = fr["edge_feat"][ekeep][:e_cap]
    ukeep = (fr["und_senders"] < n) & (fr["und_receivers"] < n)
    us, ur = fr["und_senders"][ukeep][:eu_cap], fr["und_receivers"][ukeep][:eu_cap]
    ec = fr["edge_class"][ukeep][:eu_cap]
    cut = (n < fr["node_feat"].shape[0] or s.shape[0] < fr["senders"].shape[0]
           or us.shape[0] < fr["und_senders"].shape[0])
    n2c = fr["node2cluster"][:n].copy()
    n2c[n2c >= c_cap] = c_cap
    mask = lambda m, cap: np.arange(cap) < m  # noqa: E731
    graph = dict(
        node_feat=_pad(fr["node_feat"], n_cap), edge_feat=_pad(ef, e_cap),
        senders=_pad(s, e_cap), receivers=_pad(r, e_cap),
        node_mask=mask(n, n_cap), edge_mask=mask(s.shape[0], e_cap),
        und_senders=_pad(us, eu_cap), und_receivers=_pad(ur, eu_cap),
        und_mask=mask(us.shape[0], eu_cap), other_feat=_pad(fr["other_feat"], n_cap))
    labels = dict(
        node_class=_pad(fr["node_class"][:n], n_cap),
        node_offsets=_pad(fr["node_offsets"][:n], n_cap).astype(np.float32),
        edge_class=_pad(ec, eu_cap), node2cluster=_pad(n2c, n_cap, fill=c_cap),
        cluster_class=_pad(fr["cluster_class"][:c_cap], c_cap),
        cluster_mask=mask(min(fr["cluster_class"].shape[0], c_cap), c_cap))
    return graph, labels, cut


class FrameSource:
    """Frames of a mix: the scenes (objects, their tracks and points) from
    the mix's fixed ``frames_seed``, so that every run has the same sizes;
    from the run's generator the flip augmentation (probability 1/2, a
    mirror image: the same graph sizes) and the radar's per-point noise
    (RCS, radial-velocity noise), so that every seed has its own values."""

    def __init__(self, cfg: dict, mix: dict, rng: np.random.Generator):
        self.cfg, self.mix, self.rng = cfg, mix, rng
        self.scenes = np.random.default_rng(mix["frames_seed"])

    def __call__(self) -> dict:
        lo, hi = self.mix["objects"]
        while True:
            n_obj = int(self.scenes.integers(lo, hi + 1))
            data = make_frame(self.scenes, n_obj, self.cfg["temporal_window_size"])
            n = data["meas_px"].shape[0]
            data["meas_rcs"] = self.rng.normal(-5.0, 8.0, n).astype(np.float32)
            data["meas_vr"] = (data["meas_vr"] + self.rng.normal(0, 0.05, n)).astype(np.float32)
            flip = self.mix["flip"] and self.rng.random() >= 0.5
            fr = preprocess(data, self.cfg, flip)
            if fr is not None:
                return fr


def make_pool(cfg: dict, mix: dict, seed: int):
    """The mix's pool: ``mix["pool"]`` batches of ``mix["batch"]`` slots,
    frames packed first-fit with ``mix["lookahead"]`` misses a slot
    (``SyntheticRadarDataset.packed_batches``), in an order drawn from the
    seed.  Returns (batches, stats): stats counts frames, slots and frames
    or slots cut to the capacities."""
    rng = np.random.default_rng(seed)
    draw = FrameSource(cfg, mix, rng)
    caps = capacities(cfg)
    look = mix["lookahead"]
    stats = dict(frames=0, frames_cut=0, slots=0, slots_cut=0)
    pending: list = []
    pool = []
    for _ in range(mix["pool"]):
        slots = []
        for _ in range(mix["batch"]):
            slot, acc = [], (0, 0, 0, 0)
            i = 0
            while i < len(pending):
                if not slot or _fits(acc, pending[i], caps):
                    fr = pending.pop(i)
                    slot.append(fr)
                    acc = tuple(a + b for a, b in zip(acc, _size(fr)))
                else:
                    i += 1
            misses = 0
            while misses < look and len(pending) < 4 * look:
                fr = draw()
                stats["frames"] += 1
                stats["frames_cut"] += int(any(a > c for a, c in zip(_size(fr), caps)))
                if not slot or _fits(acc, fr, caps):
                    slot.append(fr)
                    acc = tuple(a + b for a, b in zip(acc, _size(fr)))
                else:
                    pending.append(fr)
                    misses += 1
            graph, labels, cut = pad(merge(slot), cfg)
            stats["slots"] += 1
            stats["slots_cut"] += int(cut)
            slots.append((graph, labels))
        pool.append({
            "graph": {k: np.stack([g[k] for g, _ in slots]) for k in GRAPH_FIELDS},
            "labels": {k: np.stack([lab[k] for _, lab in slots]) for k in LABEL_FIELDS},
        })
    return [pool[i] for i in rng.permutation(len(pool))], stats


def live_counts(batch: dict) -> dict:
    """Live nodes, directed edges, undirected edges and clusters of each
    slot of a batch, as int arrays [B]."""
    g, lab = batch["graph"], batch["labels"]
    return dict(nodes=g["node_mask"].sum(-1), edges=g["edge_mask"].sum(-1),
                und=g["und_mask"].sum(-1), clusters=lab["cluster_mask"].sum(-1))
