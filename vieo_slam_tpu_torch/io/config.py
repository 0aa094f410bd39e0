"""Run configuration: the reference's OpenCV-YAML settings files.

Port of vieo_slam_tpu/io/config.py: camera intrinsics, distortion and
extrinsics (a second camera's `Camera2.*` and `Camera2.Trc`), `Camera.Tbc`,
IMU and encoder noise, ORB extractor parameters, local-window and GBA
settings, and the objects built from them (`build_system`,
`make_frame_builder`).

The JAX package reads these files with cv2.FileStorage.  The port has its
own reader (`read_opencv_yaml`, no OpenCV and no PyYAML) for the subset
the reference's files use: the `%YAML:1.0` header, `key: scalar` lines
(numbers, quoted or plain strings), `!!opencv-matrix` nodes with rows,
cols, dt and data, plain `[a, b, ...]` lists (inline or on the following
lines) and indented mappings; `#` starts a comment outside quotes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# !!opencv-matrix element types -> numpy
_DT = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
       "i": np.int32, "f": np.float32, "d": np.float64}


@dataclasses.dataclass
class SlamSettings:
    # camera
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    width: int = 752
    height: int = 480
    dist: tuple = (0.0, 0.0, 0.0, 0.0)
    model: str = "pinhole"          # pinhole | radtan | kb8
    bf: float = 47.9
    fps: float = 20.0
    th_depth_factor: float = 35.0   # ThDepth in baselines
    # second camera (stereo rig; identity Trc means rectified)
    cam2: dict | None = None
    # body-from-camera extrinsic
    Tbc: np.ndarray | None = None
    # IMU
    imu_sigma_g: float = 1.7e-4
    imu_sigma_a: float = 2e-3
    imu_sigma_bg: float = 1.9e-5
    imu_sigma_ba: float = 3e-3
    imu_freq_hz: float = 200.0
    # Encoder
    enc_scale: float = 1.0
    enc_rc: float = 0.28
    enc_sigma: float = 0.01
    Tbe: np.ndarray | None = None
    # ORB
    n_features: int = 1200
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    # backend
    local_window_size: int = 8
    gba_no_loop_closing: bool = False
    gba_final_iterations: int = 15
    imu_init_final_time: float = 15.0   # IMU.FinalTime (VI-init span)


# ---------------------------------------------------------------------------
# The OpenCV-YAML reader
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _scalar(text: str):
    """A number as float (FileStorage's real()), a string otherwise."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    try:
        return float(text)
    except ValueError:
        return text


def _flow_list(text: str) -> np.ndarray:
    inner = text.strip()[1:-1]
    return np.asarray([float(x) for x in inner.split(",") if x.strip()],
                      np.float64)


def _matrix(node: dict, key: str) -> np.ndarray:
    try:
        rows, cols = int(node["rows"]), int(node["cols"])
        data = np.asarray(node["data"], np.float64).reshape(-1)
        dtype = _DT[str(node["dt"])]
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed !!opencv-matrix node {key!r}") from e
    if data.size != rows * cols:
        raise ValueError(f"{key}: {data.size} values for a {rows}x{cols} "
                         "matrix")
    return data.astype(dtype).reshape(rows, cols)


def _parse_block(items, i: int, indent: int, path: str):
    """The mapping of the lines from items[i] on at this indentation.
    Returns (dict, index of the first line after it)."""
    out = {}
    n = len(items)
    while i < n and items[i][0] == indent:
        text = items[i][1]
        key, sep, rest = text.partition(":")
        if not sep:
            raise ValueError(f"{path}: expected 'key: value', got {text!r}")
        key, rest = key.strip(), rest.strip()
        tag = None
        if rest.startswith("!!"):
            tag, _, rest = rest.partition(" ")
            rest = rest.strip()
        i += 1
        if rest.startswith("["):
            while rest.count("[") > rest.count("]") and i < n:
                rest += " " + items[i][1]
                i += 1
            value = _flow_list(rest)
        elif rest:
            value = _scalar(rest)
        elif i < n and items[i][0] > indent:
            if items[i][1].startswith("["):
                flow = items[i][1]
                i += 1
                while flow.count("[") > flow.count("]") and i < n:
                    flow += " " + items[i][1]
                    i += 1
                value = _flow_list(flow)
            else:
                value, i = _parse_block(items, i, items[i][0], path)
        else:
            value = None
        if tag == "!!opencv-matrix":
            value = _matrix(value, key)
        out[key] = value
    if i < n and items[i][0] > indent:
        raise ValueError(f"{path}: unexpected indentation at "
                         f"{items[i][1]!r}")
    return out, i


def read_opencv_yaml(path: str) -> dict:
    """The top-level nodes of an OpenCV YAML file: numbers as float,
    strings as str, lists as float64 arrays, matrices as arrays of their
    element type, mappings as dicts."""
    with open(path) as f:
        lines = f.read().splitlines()
    items = []
    for line in lines:
        if line.startswith("%YAML") or line.strip() in ("---", "..."):
            continue
        body = _strip_comment(line).rstrip()
        if body.strip():
            items.append((len(body) - len(body.lstrip()), body.strip()))
    if not items:
        return {}
    out, i = _parse_block(items, 0, items[0][0], path)
    if i != len(items):
        raise ValueError(f"{path}: cannot parse {items[i][1]!r}")
    return out


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------


def load_settings(path: str) -> SlamSettings:
    """Parse a reference-format OpenCV YAML settings file."""
    nodes = read_opencv_yaml(path)
    s = SlamSettings()

    def g(key, default=None):
        v = nodes.get(key)
        return default if v is None else v

    s.fx = float(g("Camera.fx", s.fx))
    s.fy = float(g("Camera.fy", s.fy))
    s.cx = float(g("Camera.cx", s.cx))
    s.cy = float(g("Camera.cy", s.cy))
    s.width = int(g("Camera.width", s.width))
    s.height = int(g("Camera.height", s.height))
    s.bf = float(g("Camera.bf", s.bf))
    s.fps = float(g("Camera.fps", s.fps))
    s.th_depth_factor = float(g("ThDepth", s.th_depth_factor))

    cam_type = g("Camera.type")
    is_kb8 = isinstance(cam_type, str) and "KannalaBrandt" in cam_type
    k1 = g("Camera.k1")
    if k1 is not None:
        if is_kb8:      # KB8 stores k1..k4
            s.dist = (float(k1), float(g("Camera.k2", 0.0)),
                      float(g("Camera.k3", 0.0)), float(g("Camera.k4", 0.0)))
        else:
            s.dist = (float(k1), float(g("Camera.k2", 0.0)),
                      float(g("Camera.p1", 0.0)), float(g("Camera.p2", 0.0)))
            if any(abs(d) > 1e-12 for d in s.dist):
                s.model = "radtan"
    if is_kb8:
        s.model = "kb8"

    Tbc = g("Camera.Tbc")
    if Tbc is not None:
        s.Tbc = np.asarray(Tbc, np.float32).reshape(4, 4)

    fx2 = g("Camera2.fx")
    if fx2 is not None:
        if is_kb8:
            dist2 = (float(g("Camera2.k1", 0.0)), float(g("Camera2.k2", 0.0)),
                     float(g("Camera2.k3", 0.0)), float(g("Camera2.k4", 0.0)))
        else:
            dist2 = (float(g("Camera2.k1", 0.0)), float(g("Camera2.k2", 0.0)),
                     float(g("Camera2.p1", 0.0)), float(g("Camera2.p2", 0.0)))
        Trc = np.eye(4, dtype=np.float32)
        Trc_raw = g("Camera2.Trc")
        if Trc_raw is not None:     # a 3x4 (or 4x4) matrix
            rows = np.asarray(Trc_raw, np.float32).reshape(-1, 4)
            Trc[:rows.shape[0]] = rows
        s.cam2 = dict(fx=float(fx2), fy=float(g("Camera2.fy", fx2)),
                      cx=float(g("Camera2.cx", 0.0)),
                      cy=float(g("Camera2.cy", 0.0)), dist=dist2, Trc=Trc)

    sig = g("IMU.sigma")
    if sig is None:
        sig = g("IMU.SigmaI")
    if sig is not None:
        sig = np.asarray(sig).reshape(-1)   # [sigma_g, sigma_a, bg, ba]
        if sig.size >= 2:
            s.imu_sigma_g, s.imu_sigma_a = float(sig[0]), float(sig[1])
        if sig.size >= 4:
            s.imu_sigma_bg, s.imu_sigma_ba = float(sig[2]), float(sig[3])
    for key, attr in [("IMU.sigma_g", "imu_sigma_g"),
                      ("IMU.sigma_a", "imu_sigma_a"),
                      ("IMU.sigma_bg", "imu_sigma_bg"),
                      ("IMU.sigma_ba", "imu_sigma_ba"),
                      ("IMU.freq_hz", "imu_freq_hz"),
                      ("Encoder.scale", "enc_scale"),
                      ("Encoder.rc", "enc_rc")]:
        v = g(key)
        if v is not None:
            setattr(s, attr, float(v))
    Tbe = g("Camera.Tce")
    if Tbe is not None:
        s.Tbe = np.asarray(Tbe, np.float32).reshape(4, 4)

    s.n_features = int(g("ORBextractor.nFeatures", s.n_features))
    s.scale_factor = float(g("ORBextractor.scaleFactor", s.scale_factor))
    s.n_levels = int(g("ORBextractor.nLevels", s.n_levels))
    s.ini_th_fast = float(g("ORBextractor.iniThFAST", s.ini_th_fast))
    s.min_th_fast = float(g("ORBextractor.minThFAST", s.min_th_fast))

    lws = g("LocalMapping.LocalWindowSize")
    if lws is not None:
        s.local_window_size = int(lws)
    nlc = g("GBA.NoLoopClosing")
    if nlc is not None:
        s.gba_no_loop_closing = bool(int(nlc))
    fit = g("GBA.finalIterations")
    if fit is not None:
        s.gba_final_iterations = int(fit)
    ft = g("IMU.FinalTime")
    if ft is not None:
        s.imu_init_final_time = float(ft)
    return s


def build_system(settings: SlamSettings, sensor: str = "stereo",
                 device=None):
    """A System (with a LoopCloser unless GBA.NoLoopClosing) and its
    `frame_builder` from settings.  Runs on `device` (default: the GPU;
    raises when CUDA is missing)."""
    from ..backend.local_mapping import LocalMappingConfig
    from ..backend.loop_closing import LoopCloser, LoopClosingConfig
    from ..cameras import models as cm
    from ..frontend.tracking import TrackerConfig
    from ..map.map_state import MapConfig
    from ..system import SensorMode, System, SystemConfig
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    s = settings
    # Tracking and mapping run in an undistorted virtual pinhole frame;
    # distorted physical cameras live in the frame builder.
    cam = cm.make_pinhole(s.fx, s.fy, s.cx, s.cy, s.width, s.height)
    cfg = SystemConfig(
        sensor={"mono": SensorMode.MONOCULAR, "stereo": SensorMode.STEREO,
                "rgbd": SensorMode.RGBD}[sensor],
        map=MapConfig(max_kp=s.n_features, n_levels=s.n_levels,
                      scale_factor=s.scale_factor),
        tracker=TrackerConfig(th_depth=s.bf / s.fx * s.th_depth_factor),
        mapper=LocalMappingConfig(
            window_size=max(s.local_window_size, 4),
            close_depth=s.bf / s.fx * s.th_depth_factor))
    sys_ = System(cam, s.bf, cfg, device=dev)
    if not s.gba_no_loop_closing:
        sys_.loop_closer = LoopCloser(cam, s.bf, sys_.map,
                                      LoopClosingConfig(), device=dev)
    sys_.frame_builder = make_frame_builder(s, geom_cam=cam, device=dev)
    return sys_


def rig_cameras(s: SlamSettings) -> list:
    """The distorted cameras of the settings: Camera.* and, if present,
    Camera2.* with its Trc (camera-from-rig) extrinsic."""
    from ..cameras import models as cm

    make = {"radtan": cm.make_radtan, "kb8": cm.make_kb8}[s.model]
    cams = [make(s.fx, s.fy, s.cx, s.cy, list(s.dist), s.width, s.height)]
    if s.cam2 is not None:
        c2 = s.cam2
        Trc = np.asarray(c2["Trc"], np.float32)
        cams.append(make(c2["fx"], c2["fy"], c2["cx"], c2["cy"],
                         list(c2["dist"]), s.width, s.height,
                         Rcr=Trc[:3, :3], tcr=Trc[:3, 3]))
    return cams


def make_frame_builder(s: SlamSettings, geom_cam=None, device=None):
    """The image -> Frame function of these settings: rectified pinhole
    stereo (row search), a distorted two-camera rig (descriptor matching
    and DLT through Camera2.Trc) or distorted mono.  Stereo builders take
    (img_left, img_right, timestamp), the mono one (img, timestamp)."""
    from ..cameras import models as cm
    from ..frontend import frame as fr
    from ..ops import orb
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if geom_cam is None:
        geom_cam = cm.make_pinhole(s.fx, s.fy, s.cx, s.cy, s.width,
                                   s.height)
    ocfg = orb.OrbConfig(n_features=s.n_features,
                         scale_factor=s.scale_factor, n_levels=s.n_levels,
                         fast_threshold=s.ini_th_fast,
                         fast_min_threshold=s.min_th_fast)
    if s.model == "pinhole":
        return lambda l, r, t: fr.build_stereo_frame(
            l, r, ocfg, bf=s.bf, timestamp=t, device=dev)
    cams = rig_cameras(s)
    if len(cams) == 2:
        return lambda l, r, t: fr.build_multicam_frame(
            [l, r], cams, ocfg, geom_cam=geom_cam, virt_bf=s.bf,
            timestamp=t, device=dev)
    return lambda im, t: fr.build_undistorted_mono_frame(
        im, cams[0], ocfg, geom_cam=geom_cam, timestamp=t, device=dev)
