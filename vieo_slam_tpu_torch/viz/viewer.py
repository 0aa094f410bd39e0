"""Visualization: map and frame drawers + a polling viewer.

Port of vieo_slam_tpu/viz/viewer.py (the reference's Pangolin/OpenCV GUI,
src/Viewer.cc, MapDrawer.cc, FrameDrawer.cc, as headless PNG snapshots at
a keyframe cadence).  The classes, signatures, poll cadence, file names
and the geometry drawn (which landmarks and keyframes, the frusta, the
trajectory centers) are the JAX package's.  The pixels come from a small
numpy rasterizer instead of matplotlib, written by `io/png.write_png`:

- MapDrawer: an orthographic view from matplotlib's default 3D angle
  (elevation 30 deg, azimuth -60 deg) scaled to the drawn extent, on an
  880 x 660 canvas (the JAX figure's 8 x 6 in at 110 dpi); landmarks as
  black dots, keyframe frusta as blue lines, the trajectory as a green
  polyline, the current camera in red.
- FrameDrawer: the image, with lime circles round tracked keypoints and
  deep-sky-blue circles round new ones, at the image's own size.

Text is not rasterized: the map title and the frame's state label, which
the JAX package draws as pixels, go into the PNG's tEXt chunk under
"Title".  All drawing is host-side numpy on map snapshots; nothing here
touches the device path, and nothing imports matplotlib.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.png import write_png

MAP_SIZE = (660, 880)                     # rows, columns
_ELEV, _AZIM = np.deg2rad(30.0), np.deg2rad(-60.0)
_BLACK = (0, 0, 0)
_BLUE = (0, 0, 255)
_GREEN = (0, 128, 0)
_RED = (255, 0, 0)
_LIME = (0, 255, 0)
_DEEPSKYBLUE = (0, 191, 255)


def _view_axes():
    """Screen right and up of matplotlib's default 3D view, in world
    coordinates (orthographic)."""
    right = np.array([-np.sin(_AZIM), np.cos(_AZIM), 0.0])
    up = np.array([-np.sin(_ELEV) * np.cos(_AZIM),
                   -np.sin(_ELEV) * np.sin(_AZIM), np.cos(_ELEV)])
    return np.stack([right, up], axis=1)           # [3, 2]


def _segments(img, a, b, color):
    """Draw pixel segments a[i] -> b[i] ([N, 2] x, y floats)."""
    if not len(a):
        return
    n = int(np.ceil(np.abs(b - a).max())) + 1
    s = np.linspace(0.0, 1.0, n)[:, None, None]
    p = np.rint(a[None] + s * (b - a)[None]).reshape(-1, 2).astype(int)
    _dots(img, p, color)


def _dots(img, p, color):
    """Set the pixels at integer x, y positions that lie on the canvas."""
    h, w = img.shape[:2]
    p = np.asarray(p, int).reshape(-1, 2)
    keep = (p[:, 0] >= 0) & (p[:, 0] < w) & (p[:, 1] >= 0) & (p[:, 1] < h)
    img[p[keep, 1], p[keep, 0]] = color


def _circles(img, centers, radius, color):
    """Circle outlines round each center ([N, 2] x, y)."""
    if not len(centers):
        return
    ang = np.linspace(0.0, 2 * np.pi, int(8 * radius) + 8, endpoint=False)
    ring = radius * np.stack([np.cos(ang), np.sin(ang)], -1)
    _dots(img, np.rint(centers[:, None] + ring[None]), color)


class MapDrawer:
    """3D map render: landmarks, keyframe frusta, trajectory
    (MapDrawer::DrawMapPoints, DrawKeyFrames, DrawCurrentCamera)."""

    def __init__(self, frustum_scale: float = 0.1):
        self.frustum_scale = frustum_scale

    def _frustum(self, Rcw, tcw, s):
        """Wireframe pyramid of one camera in world coords."""
        Rwc = Rcw.T
        twc = -Rwc @ tcw
        pts_c = np.array([[0, 0, 0], [-s, -0.75 * s, s], [s, -0.75 * s, s],
                          [s, 0.75 * s, s], [-s, 0.75 * s, s]], np.float32)
        pts_w = pts_c @ Rwc.T + twc
        edges = [(0, 1), (0, 2), (0, 3), (0, 4),
                 (1, 2), (2, 3), (3, 4), (4, 1)]
        return pts_w, edges

    def draw(self, map_state, path: str, *, trajectory=None,
             current_pose=None, title: str = ""):
        lm = np.asarray(map_state.lm_pw[map_state.lm_valid], np.float64)
        s = self.frustum_scale
        lines = []                     # (start [N, 3], end [N, 3], color)

        def frustum_lines(R, t, scale, color):
            pts, edges = self._frustum(np.asarray(R), np.asarray(t), scale)
            a, b = np.asarray(edges).T
            lines.append((pts[a], pts[b], color))

        for k in map_state.keyframe_ids():
            frustum_lines(map_state.kf_Rcw[k], map_state.kf_tcw[k], s, _BLUE)
        if trajectory is not None and len(trajectory):
            p = np.asarray([-(R.T @ t) for _, R, t, _ in trajectory])
            lines.append((p[:-1], p[1:], _GREEN))
        if current_pose is not None:
            frustum_lines(current_pose[0], current_pose[1], 1.5 * s, _RED)

        h, w = MAP_SIZE
        img = np.full((h, w, 3), 255, np.uint8)
        axes = _view_axes()
        drawn = [lm] + [x for a, b, _ in lines for x in (a, b)]
        allp = np.concatenate([np.reshape(x, (-1, 3)) for x in drawn]) @ axes
        if len(allp):
            lo, hi = allp.min(0), allp.max(0)
            scale = 0.9 * min(w / max(hi[0] - lo[0], 1e-9),
                              h / max(hi[1] - lo[1], 1e-9))
            mid = 0.5 * (lo + hi)

            def px(p):
                q = (np.reshape(p, (-1, 3)) @ axes - mid) * scale
                return np.stack([w / 2 + q[:, 0], h / 2 - q[:, 1]], -1)

            _dots(img, np.rint(px(lm)), _BLACK)
            for a, b, color in lines:
                _segments(img, px(a), px(b), color)
        return write_png(path, img, {"Title": title} if title else None)


class FrameDrawer:
    """Per-frame overlay: image + keypoints colored by tracking status
    (FrameDrawer::DrawFrame -- green = tracked map point, blue = new)."""

    def draw(self, path: str, image, uv, tracked_mask=None, *,
             state: str = "", n_tracked: int | None = None):
        image = np.asarray(image)
        img = np.clip(np.rint(image), 0, 255).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        img = np.ascontiguousarray(img[..., :3])
        uv = np.asarray(uv, np.float64).reshape(-1, 2)
        if tracked_mask is None:
            tracked_mask = np.zeros(len(uv), bool)
        t = np.asarray(tracked_mask, bool)
        _circles(img, uv[~t], 3.0, _DEEPSKYBLUE)
        _circles(img, uv[t], 3.0, _LIME)
        label = state
        if n_tracked is not None:
            label += f"  matches: {n_tracked}"
        return write_png(path, img, {"Title": label} if label else None)


class Viewer:
    """Polling viewer (Viewer::Run): snapshot the map every N keyframes
    into out_dir.  Attach with `viewer.poll(system)` after each tracked
    frame (the reference's 3 ms GUI poll collapsed to keyframe cadence)."""

    def __init__(self, out_dir: str, every_n_kf: int = 5,
                 map_drawer: MapDrawer | None = None):
        self.out_dir = out_dir
        self.every_n_kf = every_n_kf
        self.map_drawer = map_drawer or MapDrawer()
        self._last_drawn = -1
        os.makedirs(out_dir, exist_ok=True)

    def poll(self, system) -> str | None:
        n = system.map.n_keyframes()
        if n == 0 or n == self._last_drawn or n % self.every_n_kf:
            return None
        self._last_drawn = n
        path = os.path.join(self.out_dir, f"map_{n:05d}.png")
        tr = system.tracker
        return self.map_drawer.draw(
            system.map, path, trajectory=tr.trajectory,
            current_pose=(tr.Rcw, tr.tcw),
            title=f"{n} KFs / {int(np.sum(system.map.lm_valid))} points")
