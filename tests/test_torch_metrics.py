"""The port's observability (utils/metrics.py) against the JAX package's:
stage timers, counters and gauges, the leveled log and its file sinks,
the exit report (text equal character for character on equal stats), the
stage and counter names a System run records, the profiler trace and
System.shutdown(print_report=True).

Tolerances: the report text equal; counts of the frame, track and
keyframes entries equal over a 6-frame feature-level run (the JAX test's
test_system_wires_metrics), the port's names a superset of JAX's.
"""

import io
import json
import os
import time

import numpy as np
import pytest
import torch

from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend.frame import (
    make_frame_from_features as j_make_frame)
from vieo_slam_tpu.sim.world import (SyntheticWorld, WorldConfig,
                                     circle_trajectory, trajectory_to_tcw)
from vieo_slam_tpu.system import System as JSystem
from vieo_slam_tpu.system import SystemConfig as JSystemConfig
from vieo_slam_tpu.utils import metrics as jmetrics
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.frontend.frame import make_frame_from_features
from vieo_slam_tpu_torch.system import System, SystemConfig
from vieo_slam_tpu_torch.utils import metrics as tmetrics
from vieo_slam_tpu_torch.utils.metrics import (LOG_DEBUG, LOG_ERROR,
                                               Registry, metrics, trace)

torch.set_num_threads(1)


# -- the cases of tests/test_metrics.py, on the port ------------------------


def test_timer_accumulates():
    r = Registry()
    for _ in range(3):
        with r.timer("stage_a"):
            time.sleep(0.01)
    s = r.stages["stage_a"]
    assert s.count == 3
    assert 0.008 < s.mean < 0.2
    assert s.max >= s.mean >= 0
    rep = r.report()
    assert rep["stages_ms"]["stage_a"]["count"] == 3
    assert rep["stages_ms"]["stage_a"]["mean"] > 5


def test_counters_and_gauges():
    r = Registry()
    r.count("kf")
    r.count("kf", 4)
    r.set_gauge("landmarks", 123)
    assert r.report()["counters"] == {"kf": 5, "landmarks": 123}
    r.reset()
    assert r.report()["counters"] == {}


def test_log_levels_filter():
    sink = io.StringIO()
    r = Registry(level=LOG_ERROR, sink=sink)
    r.error("boom")
    r.debug("hidden")
    out = sink.getvalue()
    assert "boom" in out and "hidden" not in out
    sink2 = io.StringIO()
    r2 = Registry(level=LOG_DEBUG, sink=sink2)
    r2.debug("visible")
    assert "visible" in sink2.getvalue()


def test_file_sink(tmp_path):
    p = str(tmp_path / "track.log")
    r = Registry(level=LOG_ERROR)
    r.info("to file only", file=p)
    r.close()
    assert "to file only" in open(p).read()


def test_format_report_table():
    r = Registry()
    with r.timer("x"):
        pass
    r.count("events")
    txt = r.format_report()
    assert "x" in txt and "events" in txt and "mean ms" in txt


# -- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("env", [None, "error", "info", "DEBUG", "bogus"])
def test_log_level_from_env_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("VIEO_LOG", raising=False)
    else:
        monkeypatch.setenv("VIEO_LOG", env)
    assert Registry().level == jmetrics.Registry().level
    sinks = io.StringIO(), io.StringIO()
    for reg, sink in zip((Registry(sink=sinks[0]),
                          jmetrics.Registry(sink=sinks[1])), sinks):
        for name in ("error", "warn", "info", "debug"):
            getattr(reg, name)(f"{name} line")
    assert sinks[0].getvalue() == sinks[1].getvalue()


def test_disabled_registry_records_nothing():
    for reg in (Registry(), jmetrics.Registry()):
        reg.enabled = False
        with reg.timer("a"):
            pass
        reg.add_time("b", 0.5)
        reg.count("c")
        reg.set_gauge("d", 3)
        assert reg.report() == {"stages_ms": {}, "counters": {}}
        reg.enabled = True
        reg.add_time("b", 0.5)
        assert reg.report()["stages_ms"]["b"]["total"] == 500.0


def test_format_report_equals_jax():
    rng = np.random.RandomState(3)
    port, jax_ = Registry(), jmetrics.Registry()
    for name in ("track", "frame", "lm.local_ba", "a_very_long_stage_name"
                 "_beyond_the_column"):
        for dt in rng.rand(int(rng.randint(1, 6))) * 0.3:
            port.add_time(name, float(dt))
            jax_.add_time(name, float(dt))
    for name, v in (("keyframes", 7), ("state_OK", 120), ("map_landmarks",
                                                          123456789)):
        port.count(name, v)
        jax_.count(name, v)
    assert port.format_report() == jax_.format_report()
    assert port.report() == jax_.report()
    # equal _StageStat values put into both registries
    port.reset()
    jax_.reset()
    port.stages["x"] = tmetrics._StageStat(3, 0.123456, 0.1, 0.02)
    jax_.stages["x"] = jmetrics._StageStat(3, 0.123456, 0.1, 0.02)
    assert port.format_report() == jax_.format_report()
    assert "-- counters --" not in port.format_report()


def _feature_frames(n=6):
    """test_system_wires_metrics's world, path and observations."""
    cam = jcm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)
    bf = 400.0 * 0.2
    world = SyntheticWorld(WorldConfig(n_landmarks=4000, seed=5,
                                       extent=(6.0, 4.5, 3.0)))
    ts = np.arange(n) * 0.1
    Rwc, twc, _, _ = circle_trajectory(ts, radius=1.0, omega=0.25,
                                       look_outward=True)
    Rcw, tcw = trajectory_to_tcw(Rwc, twc)
    rng = np.random.RandomState(2)
    obs = [world.observe(Rcw[i], tcw[i], cam, bf=bf, n_kp=500,
                         pixel_noise=0.25, bit_flips=2, clutter=20, rng=rng,
                         max_depth=10.0) for i in range(n)]
    return bf, ts, obs


def test_system_stage_names_superset_of_jax(capsys):
    bf, ts, obs = _feature_frames()
    keys = ("uv", "level", "angle", "desc", "valid")
    jmetrics.metrics.reset()
    jsys = JSystem(jcm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480),
                   bf, JSystemConfig())
    for o, t in zip(obs, ts):
        jsys.track_frame(j_make_frame(*(o[k] for k in keys), ur=o["ur"],
                                      depth=o["depth"], timestamp=t))
    want = jsys.metrics_report()
    metrics.reset()
    tsys = System(tcm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480),
                  bf, SystemConfig(), device="cpu")
    for o, t in zip(obs, ts):
        tsys.track_frame(make_frame_from_features(
            *(o[k] for k in keys), ur=o["ur"], depth=o["depth"], timestamp=t,
            device="cpu"))
    got = tsys.metrics_report()
    assert set(want["stages_ms"]) <= set(got["stages_ms"])
    assert set(want["counters"]) <= set(got["counters"])
    for k in ("frame", "track"):
        assert got["stages_ms"][k]["count"] == want["stages_ms"][k][
            "count"] == 6
    assert got["counters"]["keyframes"] == want["counters"]["keyframes"]
    # the exit report: the same table from the stats it holds
    tsys.shutdown(print_report=True)
    out = capsys.readouterr().out
    assert out.strip() == metrics.format_report().strip()
    lines = out.splitlines()
    assert lines[0].split() == ["stage", "n", "mean", "ms", "max", "ms",
                                "total", "s"]
    assert any(line.split()[:2] == ["frame", "6"] for line in lines)
    assert "-- counters --" in lines


def test_shutdown_without_report_prints_nothing(capsys):
    cam = tcm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)
    System(cam, 80.0, SystemConfig(), device="cpu").shutdown()
    assert capsys.readouterr().out == ""


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "prof")
    with trace(log_dir, device="cpu") as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    assert prof is not None
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: trace() records it by default")
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace(str(tmp_path)):
            pass
