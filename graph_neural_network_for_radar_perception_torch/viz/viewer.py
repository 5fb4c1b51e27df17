"""Sequence viewer — the port's copy of the JAX package's ``viz/viewer.py``,
a matplotlib replacement for the reference's PySide6
GUI (dataset/radar_scenes/radar_scenes/viewer.py, 1059 LoC of Qt).

Headless-friendly: renders frame-by-frame panels (measurements coloured
by class/track/doppler, optional prediction overlay) and steps through a
sequence interactively (matplotlib key events) or exports the walk as
PNGs/GIF for remote use.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from ..data.labels import NEW_LABELS
from .plots import _CLASS_COLORS, plot_node_classes, set_roi


class SequenceViewer:
    """Step through frames; in notebooks/desktops use .show() for key
    navigation (←/→), headless use .export()."""

    def __init__(
        self,
        frames: List,
        render: Optional[Callable] = None,
        figsize=(9, 9),
        roi=None,
    ):
        self.frames = frames
        self.render = render or self._default_render
        self.figsize = figsize
        self.roi = roi or {}
        self.idx = 0

    def _default_render(self, ax, fr):
        px = fr.other_feat[:, 0]
        py = fr.other_feat[:, 1]
        plot_node_classes(px, py, fr.node_class, ax=ax, **self.roi)

    def _draw(self, fig, ax):
        ax.clear()
        self.render(ax, self.frames[self.idx])
        ax.set_title(f"frame {self.idx + 1}/{len(self.frames)}")
        fig.canvas.draw_idle()

    def show(self):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=self.figsize)

        def on_key(event):
            if event.key in ("right", "n"):
                self.idx = (self.idx + 1) % len(self.frames)
            elif event.key in ("left", "p"):
                self.idx = (self.idx - 1) % len(self.frames)
            else:
                return
            self._draw(fig, ax)

        fig.canvas.mpl_connect("key_press_event", on_key)
        self._draw(fig, ax)
        plt.show()
        return fig

    def export(self, out_dir: str, gif: bool = True, fps: int = 4):
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i in range(len(self.frames)):
            self.idx = i
            fig, ax = plt.subplots(figsize=self.figsize)
            self._draw(fig, ax)
            p = os.path.join(out_dir, f"frame_{i:04d}.png")
            fig.savefig(p, dpi=90)
            plt.close(fig)
            paths.append(p)
        if gif and paths:
            from .plots import save_frames_as_gif

            return save_frames_as_gif(
                paths, os.path.join(out_dir, "sequence.gif"), fps=fps
            )
        return paths


def doppler_render(ax, fr, roi=None):
    """Colour by range-rate (viewer 'doppler' display mode)."""
    px, py = fr.other_feat[:, 0], fr.other_feat[:, 1]
    sc = ax.scatter(
        px, py, c=fr.node_feat[:, 0], s=8, cmap="coolwarm", marker="."
    )
    set_roi(ax, **(roi or {}))
    return sc


class InteractiveSequenceViewer:
    """Interactive raw-sequence viewer with the essentials of the
    reference's Qt GUI (dataset/radar_scenes/radar_scenes/viewer.py:
    frame slider, per-sensor visibility toggles, display-mode switch) on
    plain matplotlib widgets — desktop sessions get a live window via
    .show(); headless/CI drive the same callbacks programmatically
    (tests/test_viz.py) or .export() the current state.

    `windows` is a list of reference-schema data_dicts (meas_px/meas_py/
    meas_sensorid/meas_label_id/meas_trackid/meas_vr …) — the same raw
    representation the reference viewer scrubs.
    """

    MODES = ("label", "doppler", "track")

    def __init__(self, windows: List[dict], figsize=(10, 8), roi=None):
        self.windows = windows
        self.figsize = figsize
        self.roi = roi or {}
        self.idx = 0
        self.mode = "label"
        self.sensors_on = {1: True, 2: True, 3: True, 4: True}
        self._fig = None
        self._ax = None

    # -- state mutations (wired to widgets, callable headless) ------------
    def set_frame(self, idx: int):
        self.idx = int(idx) % len(self.windows)
        self._redraw()

    def toggle_sensor(self, sensor_id: int):
        self.sensors_on[sensor_id] = not self.sensors_on[sensor_id]
        self._redraw()

    def set_mode(self, mode: str):
        assert mode in self.MODES, mode
        self.mode = mode
        self._redraw()

    # -- rendering --------------------------------------------------------
    def _visible_mask(self, data) -> np.ndarray:
        sid = np.asarray(data["meas_sensorid"])
        keep = np.zeros(sid.shape[0], dtype=bool)
        for s, on in self.sensors_on.items():
            if on:
                keep |= sid == s
        return keep

    def render(self, ax):
        data = self.windows[self.idx]
        keep = self._visible_mask(data)
        px = np.asarray(data["meas_px"])[keep]
        py = np.asarray(data["meas_py"])[keep]
        if self.mode == "doppler":
            ax.scatter(
                px, py, c=np.asarray(data["meas_vr"])[keep], s=10,
                cmap="coolwarm", marker=".",
            )
        elif self.mode == "track":
            tids = np.asarray(data["meas_trackid"])[keep]
            uniq = {t: i for i, t in enumerate(sorted(set(tids.tolist())))}
            ax.scatter(
                px, py, s=10, marker=".",
                c=[uniq[t] for t in tids.tolist()], cmap="tab20",
            )
        else:  # per-measurement class labels
            from ..data.labels import old_to_new_label_id_map

            lut = old_to_new_label_id_map()
            cls = lut[np.asarray(data["meas_label_id"])[keep]]
            for cid in np.unique(cls):
                sel = cls == cid
                ax.scatter(
                    px[sel], py[sel], s=10, marker=".",
                    c=_CLASS_COLORS.get(int(cid), "magenta"),
                    label=NEW_LABELS[int(cid)],
                )
            if cls.size:
                ax.legend(loc="upper right", fontsize=7)
        set_roi(ax, **self.roi)
        on = [s for s, v in self.sensors_on.items() if v]
        ax.set_title(
            f"frame {self.idx + 1}/{len(self.windows)}  "
            f"mode={self.mode}  sensors={on}"
        )

    def _redraw(self):
        if self._ax is None:
            return
        self._ax.clear()
        self.render(self._ax)
        self._fig.canvas.draw_idle()

    # -- interactive surface ----------------------------------------------
    def build_figure(self):
        """Create the figure + widgets; returns (fig, widgets dict).
        Separated from show() so headless tests can exercise the full
        widget wiring without a GUI event loop."""
        import matplotlib.pyplot as plt
        from matplotlib.widgets import CheckButtons, RadioButtons, Slider

        fig = plt.figure(figsize=self.figsize)
        ax = fig.add_axes([0.07, 0.22, 0.68, 0.72])
        self._fig, self._ax = fig, ax

        ax_slider = fig.add_axes([0.07, 0.08, 0.68, 0.04])
        slider = Slider(
            ax_slider, "frame", 0, len(self.windows) - 1,
            valinit=self.idx, valstep=1,
        )
        slider.on_changed(self.set_frame)

        ax_checks = fig.add_axes([0.79, 0.55, 0.18, 0.3])
        checks = CheckButtons(
            ax_checks, [f"radar_{s}" for s in (1, 2, 3, 4)],
            [self.sensors_on[s] for s in (1, 2, 3, 4)],
        )
        checks.on_clicked(
            lambda label: self.toggle_sensor(int(label.split("_")[1]))
        )

        ax_radio = fig.add_axes([0.79, 0.25, 0.18, 0.22])
        radio = RadioButtons(ax_radio, self.MODES)
        radio.on_clicked(self.set_mode)

        def on_key(event):
            if event.key in ("right", "n"):
                slider.set_val((self.idx + 1) % len(self.windows))
            elif event.key in ("left", "p"):
                slider.set_val((self.idx - 1) % len(self.windows))

        fig.canvas.mpl_connect("key_press_event", on_key)
        self._redraw()
        return fig, {"slider": slider, "sensors": checks, "mode": radio}

    def show(self):
        import matplotlib.pyplot as plt

        fig, _ = self.build_figure()
        plt.show()
        return fig

    def export(self, path: str):
        import matplotlib

        matplotlib.use("Agg", force=False)
        if self._fig is None:
            self.build_figure()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fig.savefig(path, dpi=90)
        return path
