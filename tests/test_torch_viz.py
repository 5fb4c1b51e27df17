"""The port's viz modules against the JAX package's: every function that
tests/test_viz.py renders, drawn for one detection by both packages (the
same frame and weights, the detections' decisions equal), has the same
plotted data in each artist — scatter offsets and colours, line segments,
arrows, annotations, images, limits and titles — with the covariance
ellipses compared as point sets (an eigenvector of the other sign traces
the same ellipse from another start: ROADMAP.md C7).  The GIF and PNGs are
written, and the viewers draw the same scenes."""

import os

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from PIL import Image  # noqa: E402

from graph_neural_network_for_radar_perception_torch.config.config import (  # noqa: E402
    tiny_test_config,
)
from graph_neural_network_for_radar_perception_torch.data import synthetic as PSYN  # noqa: E402
from graph_neural_network_for_radar_perception_torch.data.pipeline import (  # noqa: E402
    SyntheticRadarDataset,
)
from graph_neural_network_for_radar_perception_torch.infer.pipeline import (  # noqa: E402
    FrameDetector,
)
from graph_neural_network_for_radar_perception_torch.utils.convert import (  # noqa: E402
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_torch.viz import plots as P  # noqa: E402
from graph_neural_network_for_radar_perception_torch.viz import viewer as PV  # noqa: E402
from graph_neural_network_for_radar_perception_tpu.config import config as JC  # noqa: E402
from graph_neural_network_for_radar_perception_tpu.data import pipeline as JPIPE  # noqa: E402
from graph_neural_network_for_radar_perception_tpu.data import synthetic as JSYN  # noqa: E402
from graph_neural_network_for_radar_perception_tpu.infer import pipeline as JINF  # noqa: E402
from graph_neural_network_for_radar_perception_tpu.train.steps import init_params  # noqa: E402
from graph_neural_network_for_radar_perception_tpu.viz import plots as J  # noqa: E402
from graph_neural_network_for_radar_perception_tpu.viz import viewer as JV  # noqa: E402
from torch_port_fixtures import one_torch_thread  # noqa: F401,E402  (autouse)

# Plotted coordinates are the detections' float32 values, the ellipses
# f32 eigen-decompositions by two LAPACK builds.
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def dets():
    """One detection per package (tests/test_viz.py's frame and weights),
    its decisions equal."""
    params = init_params(JC.tiny_test_config(), jax.random.key(0))
    jdet = JINF.FrameDetector(JC.tiny_test_config(), params).detect_frame_arrays(
        JPIPE.SyntheticRadarDataset(JC.tiny_test_config(), seed=8, num_objects=2).sample_frame())
    cfg = tiny_test_config()
    det = FrameDetector(cfg, state_dict_from_flax(jax.tree.map(np.asarray, params)),
                        device="cpu").detect_frame_arrays(
        SyntheticRadarDataset(cfg, seed=8, num_objects=2).sample_frame())
    assert det.num_clusters == jdet.num_clusters > 0
    for field in ("node_class", "node2cluster", "link_class", "cluster_class"):
        np.testing.assert_array_equal(getattr(det, field), np.asarray(getattr(jdet, field)))
    return det, jdet


def _point_set_close(a, b, what):
    """Two closed curves as point sets: every point of each within TOL of
    a point of the other."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    scale = TOL["atol"] + TOL["rtol"] * np.abs(b).max()
    assert d.min(1).max() <= scale and d.min(0).max() <= scale, what


def _describe(fig):
    """Every artist's plotted data in a figure, axes by axes."""
    out = []
    for ax in fig.axes:
        entry = {"title": ax.get_title(), "xlabel": ax.get_xlabel(),
                 "ylabel": ax.get_ylabel(), "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
                 "collections": [], "lines": [], "texts": [], "images": []}
        for c in ax.collections:
            rec = {"type": type(c).__name__, "offsets": np.asarray(c.get_offsets()),
                   "facecolors": np.asarray(c.get_facecolors()),
                   "edgecolors": np.asarray(c.get_edgecolors()),
                   "array": None if c.get_array() is None else np.asarray(c.get_array())}
            if hasattr(c, "get_segments"):
                rec["segments"] = [np.asarray(s) for s in c.get_segments()]
            if type(c).__name__ == "Quiver":
                rec["uv"] = np.stack([np.asarray(c.U), np.asarray(c.V)])
                rec["xy"] = np.stack([np.asarray(c.X), np.asarray(c.Y)])
            entry["collections"].append(rec)
        for ln in ax.lines:
            entry["lines"].append({"xy": np.asarray(ln.get_xydata()),
                                   "color": matplotlib.colors.to_rgba(ln.get_color())})
        for t in ax.texts:
            entry["texts"].append((t.get_text(), tuple(np.round(t.get_position(), 4))))
        legend = ax.get_legend()
        entry["legend"] = [t.get_text() for t in legend.get_texts()] if legend else None
        for im in ax.images:
            entry["images"].append(np.asarray(im.get_array()))
        out.append(entry)
    return out


def _assert_same_drawing(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        at = f"{what} axes {i}"
        for k in ("title", "xlabel", "ylabel", "texts", "legend"):
            assert g[k] == w[k], f"{at} {k}"
        np.testing.assert_allclose(g["xlim"], w["xlim"], **TOL, err_msg=at)
        np.testing.assert_allclose(g["ylim"], w["ylim"], **TOL, err_msg=at)
        assert len(g["collections"]) == len(w["collections"]), at
        for gc, wc in zip(g["collections"], w["collections"]):
            assert gc.keys() == wc.keys() and gc["type"] == wc["type"], at
            for k, v in wc.items():
                if k == "type":
                    continue
                if v is None:
                    assert gc[k] is None, f"{at} {k}"
                elif k == "segments":
                    assert len(gc[k]) == len(v), f"{at} segments"
                    for s, t in zip(gc[k], v):
                        np.testing.assert_allclose(s, t, **TOL, err_msg=f"{at} segment")
                else:
                    np.testing.assert_allclose(gc[k], v, **TOL, err_msg=f"{at} {k}")
        assert len(g["lines"]) == len(w["lines"]), at
        for gl, wl in zip(g["lines"], w["lines"]):
            assert gl["color"] == wl["color"], at
            _point_set_close(gl["xy"], wl["xy"], f"{at} line")
        assert len(g["images"]) == len(w["images"]), at
        for gi, wi in zip(g["images"], w["images"]):
            np.testing.assert_array_equal(gi, wi, err_msg=at)


def _arrays(det):
    px, py = det.xy[:, 0], det.xy[:, 1]
    n = px.shape[0]
    return px, py, n, det.gt


# Each case: (name, call(V, det) -> figure or axes), the calls of
# tests/test_viz.py.
CASES = {
    "plot_measurements": lambda V, d: V.plot_measurements(*_arrays(d)[:2]),
    "plot_range_rates": lambda V, d: V.plot_range_rates(
        *_arrays(d)[:2], d.gt.other_feat[:d.xy.shape[0], 2], d.gt.other_feat[:d.xy.shape[0], 3]),
    "plot_graph": lambda V, d: V.plot_graph(*_arrays(d)[:2], d.gt.senders, d.gt.receivers),
    "plot_edge_labels": lambda V, d: V.plot_edge_labels(
        *_arrays(d)[:2], d.gt.und_senders, d.gt.und_receivers, d.gt.edge_class),
    "plot_node_classes": lambda V, d: V.plot_node_classes(*_arrays(d)[:2], d.node_class),
    "plot_offsets": lambda V, d: V.plot_offsets(*_arrays(d)[:2], d.centers - d.xy),
    "plot_clusters": lambda V, d: V.plot_clusters(
        *_arrays(d)[:2], d.node2cluster, d.num_clusters, cluster_mu=d.cluster_mu,
        cluster_sigma=d.cluster_sigma, cluster_class=d.cluster_class),
    "plot_all_outputs": lambda V, d: V.plot_all_outputs(d, figsize=(8, 8)),
    "compare_pred_gt": lambda V, d: V.compare_pred_gt(d, figsize=(8, 4)),
    "plot_track_centers": lambda V, d: V.plot_track_centers(
        *_arrays(d)[:2], *(d.xy + d.gt.node_offsets[:d.xy.shape[0]]).T),
    "plot_meas_and_gt_labels": lambda V, d: V.plot_meas_and_gt_labels(
        *_arrays(d)[:2], d.gt.node_class[:d.xy.shape[0]]),
    "plot_meas_cluster_centers": lambda V, d: V.plot_meas_cluster_centers(
        *_arrays(d)[:2], d.gt.node_offsets[:d.xy.shape[0]]),
    "plot_meas_and_gt_labels_cluster_centers":
        lambda V, d: V.plot_meas_and_gt_labels_cluster_centers(
            *_arrays(d)[:2], d.gt.node_class[:d.xy.shape[0]],
            d.gt.node_offsets[:d.xy.shape[0]]),
    "plot_pred_class": lambda V, d: V.plot_pred_class(d),
    "plot_pred_offsets": lambda V, d: V.plot_pred_offsets(d),
    "plot_pred_edge_class": lambda V, d: V.plot_pred_edge_class(d),
    "plot_clusters_measurements_and_object_class":
        lambda V, d: V.plot_clusters_measurements_and_object_class(d),
    "compare_pred_gt_class": lambda V, d: V.compare_pred_gt_class(d),
    "compare_pred_gt_offsets": lambda V, d: V.compare_pred_gt_offsets(d),
    "compare_pred_gt_offsets_meas": lambda V, d: V.compare_pred_gt_offsets_meas(d),
    "compare_pred_gt_edge_class": lambda V, d: V.compare_pred_gt_edge_class(d),
    "compare_pred_gt_offsets_edge_labels":
        lambda V, d: V.compare_pred_gt_offsets_edge_labels(d),
    "compare_pred_gt_clusters": lambda V, d: V.compare_pred_gt_clusters(d),
    "compare_pred_gt_object_classes": lambda V, d: V.compare_pred_gt_object_classes(d),
    "plot_channels": lambda V, d: V.plot_channels(
        np.random.default_rng(0).random((16, 16, 3))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plot_draws_what_jax_draws(dets, name):
    det, jdet = dets
    try:
        drawn = {}
        for side, V, d in (("port", P, det), ("jax", J, jdet)):
            plt.close("all")
            out = CASES[name](V, d)
            drawn[side] = _describe(getattr(out, "figure", out))
        assert any(a["collections"] or a["images"] for a in drawn["port"]), name
        _assert_same_drawing(drawn["port"], drawn["jax"], name)
    finally:
        plt.close("all")


def test_every_plot_function_is_covered():
    public = {n for n, f in vars(J).items() if callable(f) and not n.startswith("_")
              and getattr(f, "__module__", "") == J.__name__}
    assert public - set(CASES) == {"set_roi", "save_frames_as_gif", "compute_node_pairs",
                                   "save_compare_pred_gt_clusters"}
    assert {n for n in vars(P) if not n.startswith("_")} >= public


def test_node_pairs_gif_and_png_written(dets, tmp_path):
    det, jdet = dets
    px, py, _, fr = _arrays(det)
    segs = P.compute_node_pairs(px, py, fr.edge_class, fr.und_senders, fr.und_receivers)
    want = J.compute_node_pairs(jdet.xy[:, 0], jdet.xy[:, 1], jdet.gt.edge_class,
                                jdet.gt.und_senders, jdet.gt.und_receivers)
    assert segs.ndim == 3 and segs.shape[1:] == (2, 2)
    np.testing.assert_array_equal(segs, want)
    try:
        fig1 = P.plot_all_outputs(det, figsize=(8, 8))
        fig2 = P.compare_pred_gt(det, figsize=(8, 4))
        out = P.save_frames_as_gif([fig1, fig2], str(tmp_path / "out.gif"), fps=2)
        assert os.path.getsize(out) > 1000
        with Image.open(out) as gif:
            assert gif.n_frames == 2
        png = P.save_compare_pred_gt_clusters(det, str(tmp_path / "cmp.png"))
        assert os.path.getsize(png) > 1000
    finally:
        plt.close("all")


def _windows(module):
    rng = np.random.default_rng(0)
    return [module.make_synthetic_frame(rng, num_objects=2, window_size=3) for _ in range(4)]


def test_interactive_viewer_as_jax(tmp_path):
    """tests/test_viz.py's widget drive on both packages' viewers: the
    same state after each callback and the same drawing in each mode."""
    pw, jw = _windows(PSYN), _windows(JSYN)
    views = [PV.InteractiveSequenceViewer(pw), JV.InteractiveSequenceViewer(jw)]
    try:
        figs = []
        for v in views:
            fig, widgets = v.build_figure()
            assert set(widgets) == {"slider", "sensors", "mode"}
            widgets["slider"].set_val(2)
            figs.append(fig)
        assert views[0].idx == views[1].idx == 2
        for step in (lambda v: v.toggle_sensor(1), lambda v: v.set_mode("doppler"),
                     lambda v: v.set_mode("track"), lambda v: v.set_mode("label")):
            for v in views:
                step(v)
            assert views[0].sensors_on == views[1].sensors_on
            _assert_same_drawing(_describe(figs[0])[:1], _describe(figs[1])[:1], views[0].mode)
        assert int(views[0]._visible_mask(pw[2]).sum()) == int(views[1]._visible_mask(jw[2]).sum())
        out = views[0].export(str(tmp_path / "viewer.png"))
        assert os.path.getsize(out) > 1000
    finally:
        plt.close("all")


def test_sequence_viewer_exports_as_jax(tmp_path):
    """SequenceViewer over frames (default and doppler renders) writes the
    same PNGs and GIF as the JAX viewer's, each frame drawn alike."""
    pfr = [SyntheticRadarDataset(tiny_test_config(), seed=3).sample_frame() for _ in range(1)]
    pfr += [SyntheticRadarDataset(tiny_test_config(), seed=4).sample_frame()]
    jfr = [JPIPE.SyntheticRadarDataset(JC.tiny_test_config(), seed=s).sample_frame()
           for s in (3, 4)]
    try:
        for render in (None, "doppler"):
            drawn = []
            for V, frames in ((PV, pfr), (JV, jfr)):
                r = None if render is None else (lambda ax, fr, V=V: V.doppler_render(ax, fr))
                viewer = V.SequenceViewer(frames, render=r)
                fig, ax = plt.subplots()
                viewer.idx = 1
                viewer._draw(fig, ax)
                drawn.append(_describe(fig))
                plt.close(fig)
            _assert_same_drawing(drawn[0], drawn[1], f"render {render}")
        out = PV.SequenceViewer(pfr).export(str(tmp_path / "seq"), fps=2)
        assert sorted(os.listdir(tmp_path / "seq")) == [
            "frame_0000.png", "frame_0001.png", "sequence.gif"]
        assert out == str(tmp_path / "seq" / "sequence.gif")
    finally:
        plt.close("all")
