"""Carry state from the JAX package into the port.

The functions take the JAX package's objects as plain Python / numpy
values (anything `np.asarray` accepts), so this module imports nothing of
the JAX package.  With them a test can start both systems from the same
camera, configuration, map and frame and compare one step.  Descriptors
cross as int32 views of the uint32 words; the map keeps uint32.

The BRIEF pattern and the FAST circle are constants, not state: the port
regenerates them (ops/orb.py) and a test holds them equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .backend.loop_closing import LoopCloser, LoopClosingConfig
from .cameras import models as cm
from .frontend.frame import Frame, make_frame_from_features
from .io.odom_ring import OdomRing
from .loop.keyframe_db import KeyFrameDatabase
from .loop.vocabulary import Vocabulary
from .map.map_state import MapConfig, MapState
from .math.navstate import NavState
from .math.preintegration import ImuPreint
from .ops.orb import OrbConfig
from .solvers.initializer import MonoInitResult
from .io.config import SlamSettings
from .system import SensorMode, SystemConfig
from .vio.encoder_frontend import EncoderConfig, EncoderFrontend
from .vio.frontend import VioConfig, VioFrontend

_MAP_ARRAYS = (
    "kf_valid", "kf_Rcw", "kf_tcw", "kf_timestamp", "kf_frame_id", "kf_Rwb",
    "kf_pwb", "kf_vwb", "kf_bg", "kf_ba", "kf_uv", "kf_level", "kf_desc",
    "kf_ur", "kf_depth", "kf_kp_valid", "kf_lm_idx", "kf_prev", "kf_next",
    "lm_valid", "lm_pw", "lm_desc", "lm_normal", "lm_min_dist", "lm_max_dist",
    "lm_n_obs", "lm_visible", "lm_found", "lm_first_kf", "lm_ref_kf",
)


def camera_from_jax(jcam) -> cm.Camera:
    """The port's Camera (pinhole, radtan or KB8) from the JAX package's
    Camera (numpy leaves)."""
    kind = int(jcam.kind)
    if kind not in (cm.PINHOLE, cm.RADTAN, cm.KB8):
        raise ValueError(f"unknown camera kind {kind}")
    cam = cm.make_pinhole(
        float(np.asarray(jcam.fx)), float(np.asarray(jcam.fy)),
        float(np.asarray(jcam.cx)), float(np.asarray(jcam.cy)),
        jcam.width, jcam.height, Rcr=np.asarray(jcam.Rcr),
        tcr=np.asarray(jcam.tcr))
    return cam._replace(kind=kind,
                        dist=np.array(np.asarray(jcam.dist), np.float32))


def orb_config_from_jax(jcfg) -> OrbConfig:
    return OrbConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(OrbConfig)})


def map_from_jax(jmap) -> MapState:
    """A copy of the JAX package's MapState (keyframe poses, landmarks,
    descriptors, observations and counters)."""
    cfg = MapConfig(**{f.name: getattr(jmap.cfg, f.name)
                       for f in dataclasses.fields(MapConfig)})
    m = MapState(cfg)
    for name in _MAP_ARRAYS:
        setattr(m, name, np.array(getattr(jmap, name), copy=True))
    m.version = int(jmap.version)
    m.big_change_idx = int(jmap.big_change_idx)
    m._next_kf = int(jmap._next_kf)
    m._next_lm = int(jmap._next_lm)
    m._lm_free = list(jmap._lm_free)
    return m


def frame_from_jax(jframe, device=None) -> Frame:
    """A port Frame from the JAX package's Frame."""
    return make_frame_from_features(
        np.asarray(jframe.uv), np.asarray(jframe.level),
        np.asarray(jframe.angle), np.asarray(jframe.desc, np.uint32),
        np.asarray(jframe.valid), ur=np.asarray(jframe.ur),
        depth=np.asarray(jframe.depth),
        timestamp=float(np.asarray(jframe.timestamp)), device=device)


def system_config_from_jax(jcfg, tracker=None, mapper=None) -> SystemConfig:
    """The port's SystemConfig with the JAX SystemConfig's sensor mode, map
    sizes and async-mapping fields; tracker and mapper configurations are
    passed as the port's own (their JAX counterparts carry fields of
    slices not ported yet)."""
    cfg = SystemConfig(
        sensor=SensorMode[jcfg.sensor.name],
        map=MapConfig(**{f.name: getattr(jcfg.map, f.name)
                         for f in dataclasses.fields(MapConfig)}),
        async_mapping=bool(jcfg.async_mapping),
        kf_queue_depth=int(jcfg.kf_queue_depth))
    if tracker is not None:
        cfg.tracker = tracker
    if mapper is not None:
        cfg.mapper = mapper
    return cfg


def mono_init_result_from_jax(jres, device="cpu") -> MonoInitResult:
    """A port MonoInitResult from the JAX package's."""
    return MonoInitResult(*(torch.from_numpy(np.array(x)).to(device)
                            for x in jres))


def vocabulary_from_jax(jvoc) -> Vocabulary:
    """A copy of the JAX package's Vocabulary (tree and idf)."""
    return Vocabulary(k=int(jvoc.k), L=int(jvoc.L),
                      node_desc=np.array(jvoc.node_desc, np.uint32),
                      idf=np.array(jvoc.idf, np.float32))


def loop_closing_config_from_jax(jcfg) -> LoopClosingConfig:
    return LoopClosingConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(LoopClosingConfig)})


def loop_closer_from_jax(jlc, cam: cm.Camera, map_state: MapState,
                         device=None) -> LoopCloser:
    """The port's LoopCloser over `map_state` in the JAX closer's state:
    vocabulary, keyframe BoWs and database, consistency streaks, the last
    loop keyframe and the loop edges."""
    lc = LoopCloser(cam, jlc.bf, map_state,
                    loop_closing_config_from_jax(jlc.cfg),
                    vocabulary=None if jlc.voc is None
                    else vocabulary_from_jax(jlc.voc), device=device)
    lc.kf_bow = {int(k): np.array(v, np.float32)
                 for k, v in jlc.kf_bow.items()}
    if jlc.db is not None:
        lc.db = KeyFrameDatabase(1, 1)
        lc.db.bows = np.array(jlc.db.bows, np.float32)
        lc.db.present = np.array(jlc.db.present, bool)
    lc._pending = {int(k): int(v) for k, v in jlc._pending.items()}
    lc.last_loop_kf = int(jlc.last_loop_kf)
    lc.loop_edges = [(int(a), int(b), np.array(R, np.float32),
                      np.array(t, np.float32))
                     for a, b, R, t in jlc.loop_edges]
    lc.n_loops_closed = int(jlc.n_loops_closed)
    lc.total_fuse_count = int(jlc.total_fuse_count)
    return lc


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def navstate_from_jax(jns, device="cpu") -> NavState:
    """A port NavState (f32) from the JAX package's (same field order)."""
    return NavState(*(_f32(x, device) for x in jns))


def imu_preint_from_jax(jpre, device="cpu") -> ImuPreint:
    """A port ImuPreint (f32) from the JAX package's (same field order)."""
    return ImuPreint(*(_f32(x, device) for x in jpre))


def vio_config_from_jax(jcfg) -> VioConfig:
    return VioConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(VioConfig)})


def odom_ring_from_jax(jring) -> OdomRing:
    """A copy of the JAX package's odometry ring.  Its samples are read
    from the numpy fallback; the native ring keeps them in C++ and offers
    no way to read them back."""
    if getattr(jring, "native", False):
        raise NotImplementedError(
            "the native odometry ring cannot be read back; build the JAX "
            "ring with its numpy fallback")
    ring = OdomRing(jring.capacity)
    ring._t = np.array(jring._t, np.float64)
    ring._v = np.array(jring._v, np.float32)
    ring._n = int(jring._n)
    return ring


def vio_frontend_from_jax(jvio, system) -> VioFrontend:
    """The port's VioFrontend over `system` (a port System) in the JAX
    front end's state: gravity, biases, the last NavState and its prior,
    the keyframe times, the init flags and the odometry rings.  A
    backend the JAX front end had engaged is created again, without its
    init global BA."""
    vio = VioFrontend(system, Rcb=np.asarray(jvio.Rcb),
                      tcb=np.asarray(jvio.tcb),
                      cfg=vio_config_from_jax(jvio.cfg))
    dev = system.device
    vio.gw = np.array(jvio.gw, np.float32)
    vio.bg = np.array(jvio.bg, np.float32)
    vio.ba = np.array(jvio.ba, np.float32)
    vio.ns_last = None if jvio.ns_last is None \
        else navstate_from_jax(jvio.ns_last, dev)
    vio.prior_info = None if jvio.prior_info is None \
        else np.array(jvio.prior_info, np.float32)
    vio.last_t = jvio.last_t
    vio.kf_times = [(int(k), float(t)) for k, t in jvio.kf_times]
    vio.inited = bool(jvio.inited)
    vio.final_inited = bool(jvio.final_inited)
    vio.ring = odom_ring_from_jax(jvio.ring)
    if jvio.enc_ring is not None:
        vio.enc_ring = odom_ring_from_jax(jvio.enc_ring)
    if jvio.backend is not None:
        cfg = vio.cfg
        run_init_gba, cfg.run_init_gba = cfg.run_init_gba, False
        vio._attach_backend()
        cfg.run_init_gba = run_init_gba
        vio.backend.gravity = np.array(jvio.backend.gravity, np.float32)
    if jvio.sys.mapper.vio_active:
        system.mapper.vio_active = True
    return vio


def encoder_config_from_jax(jcfg) -> EncoderConfig:
    return EncoderConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(EncoderConfig)})


def encoder_frontend_from_jax(jveo, system) -> EncoderFrontend:
    """The port's EncoderFrontend over `system` (a port System) in the JAX
    front end's state: extrinsics, configuration, the last frame time and
    body pose, and the wheel samples of its ring (read from the JAX ring's
    numpy fallback, pushed in order into the port's native ring)."""
    veo = EncoderFrontend(system, Rcb=np.asarray(jveo.Rcb),
                          tcb=np.asarray(jveo.tcb),
                          cfg=encoder_config_from_jax(jveo.cfg))
    ring = odom_ring_from_jax(jveo.enc_ring)
    n = ring.size()
    idx = np.arange(ring._n - n, ring._n) % ring.capacity
    veo.enc_ring.push_bulk(ring._t[idx], ring._v[idx])
    veo.last_t = jveo.last_t
    veo._last_body = None if jveo._last_body is None else tuple(
        np.array(x, np.float32) for x in jveo._last_body)
    return veo


def slam_settings_from_jax(js) -> SlamSettings:
    """The port's SlamSettings with the JAX package's values."""
    kw = {f.name: getattr(js, f.name)
          for f in dataclasses.fields(SlamSettings)}
    for name in ("Tbc", "Tbe"):
        if kw[name] is not None:
            kw[name] = np.array(kw[name], np.float32)
    if kw["cam2"] is not None:
        kw["cam2"] = dict(kw["cam2"], Trc=np.array(kw["cam2"]["Trc"],
                                                   np.float32))
    return SlamSettings(**kw)
