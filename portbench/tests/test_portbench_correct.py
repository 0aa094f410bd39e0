"""What decides `correct`, on the CPU at the tiny size: a sound run of the
program passes; the control (the references in the program's place, in
TF32) fails; and a run with the timed path broken underneath fails, for
each fault the cells can have: a step that returns its state unchanged,
half of the observations left out, an answer altered where it is
produced (a descriptor, a pose, a preintegrated delta)."""

import pytest
import torch

from portbench import check, run
from portbench.tests import tiny

# A window long enough on a loaded CPU for every sample to fall due.
ARGS = ["--workload", "tiny_euroc_stereo.map", "--seed", "2147483711",
        "--seconds", "40", "--trace", "0"]
VIO_ARGS = ["--workload", "tiny_euroc_stereo_vio.map", "--seed",
            "2147483713", "--seconds", "15", "--trace", "0"]


@pytest.fixture
def tree(tmp_path, monkeypatch):
    # Every sample at the window's first frame; a keyframe (and its local
    # BA) comes within 4 frames, so every sample is due by the fourth.
    monkeypatch.setattr(check, "SAMPLE_SPAN", 1)
    monkeypatch.setattr(check, "SAMPLE_FRAMES", 1)
    monkeypatch.setattr(check, "DUE_MARGIN", 3)
    # One torch thread a run: several runs share the CPU under xdist.
    monkeypatch.setattr(run, "THREADS", 1)
    return tiny.make_tree(tmp_path)


def _run(tree, control=None, args=ARGS):
    return run.run(args, device="cpu", root=tree, control=control,
                   log=lambda m: None)


@pytest.mark.parametrize("args", [ARGS, VIO_ARGS], ids=["stereo", "vio"])
def test_sound_run_is_correct(tree, args):
    res = _run(tree, args=args)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("args", [ARGS, VIO_ARGS], ids=["stereo", "vio"])
def test_control_is_not_correct(tree, args):
    res = _run(tree, control="tf32", args=args)
    assert any(c["value"] > c["limit"] for c in res["control"].values()), \
        res["control"]


def _pose_unchanged(monkeypatch):
    from vieo_slam_tpu_torch.frontend import tracking
    po = tracking.pose_optimization

    def fault(R, t, obs, *a, **k):
        res = po(R, t, obs, *a, **k)
        return res._replace(Rcw=R, tcw=t)
    monkeypatch.setattr(tracking, "pose_optimization", fault)


def _half_observations(monkeypatch):
    from vieo_slam_tpu_torch.frontend import tracking
    po = tracking.pose_optimization

    def fault(R, t, obs, *a, **k):
        keep = torch.arange(obs.valid.shape[0], device=obs.valid.device) % 2
        return po(R, t, obs._replace(valid=obs.valid & (keep == 0)), *a, **k)
    monkeypatch.setattr(tracking, "pose_optimization", fault)


def _descriptor_altered(monkeypatch):
    from vieo_slam_tpu_torch.frontend import frame as fr
    build = fr.build_stereo_frame

    def fault(*a, **k):
        f = build(*a, **k)
        return f._replace(desc=f.desc ^ 1)
    monkeypatch.setattr(fr, "build_stereo_frame", fault)


def _pose_altered(monkeypatch):
    from vieo_slam_tpu_torch.frontend import tracking
    po = tracking.pose_optimization

    def fault(R, t, obs, *a, **k):
        res = po(R, t, obs, *a, **k)
        return res._replace(tcw=res.tcw + 0.01)
    monkeypatch.setattr(tracking, "pose_optimization", fault)


FAULTS = {"pose_unchanged": _pose_unchanged,
          "half_observations": _half_observations,
          "descriptor_altered": _descriptor_altered,
          "pose_altered": _pose_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(tree, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = _run(tree)
    assert not res["correct"], res["checks"]


# The VIO cell's faults, from the window's first frame on: the warm-up has
# to reach the fused state first.
def _in_window(monkeypatch, target, name, make_fault):
    warmup = run._warmup

    def warmup_then_break(*a, **k):
        first = warmup(*a, **k)
        monkeypatch.setattr(target, name, make_fault(getattr(target, name)))
        return first
    monkeypatch.setattr(run, "_warmup", warmup_then_break)


def _preint_altered(monkeypatch):
    from vieo_slam_tpu_torch.vio import frontend

    def make(pre):
        def fault(*a, **k):
            res = pre(*a, **k)
            return res._replace(dp=res.dp + 0.01)
        return fault
    _in_window(monkeypatch, frontend, "preintegrate_imu", make)


VIO_FAULTS = {"preint_altered": _preint_altered}


@pytest.mark.parametrize("fault", sorted(VIO_FAULTS))
def test_broken_vio_path_is_not_correct(tree, monkeypatch, fault):
    VIO_FAULTS[fault](monkeypatch)
    res = _run(tree, args=VIO_ARGS)
    assert not res["correct"], res["checks"]
