"""Whether what the window produced is correct: the comparison with the
plain references (portbench/reference), its control, and beside them the
trajectory against the true poses.

During the window the checker keeps, for a sample of frames drawn from the
seed, what the timed path produced there: the Frame that
`build_stereo_frame` returned, the last motion-only pose optimization of the
tracker (`frontend.tracking.pose_optimization`) with its inputs and
result, and in a VIO cell the IMU preintegration (`VioFrontend._preint`).
It also logs the pose that each window frame returned (the tracker's, as
the VIO front end left it after its fused solve), and at the window's
close the map's keyframe poses.  It keeps references, or device copies
where the program reuses its buffers; nothing waits on the device.

Once the window has closed and the program is gone, the numbers compared:

- `frame_kp_mismatch`: the frame against reference/orb.py run on the
  cell's own uint8 images: the share of keypoints that one side gives and
  the other does not (level, pixel, descriptor, right u);
- `pose_gap`: the last pose optimization of each sampled frame (the one
  that gives its pose) against reference/pose.py, float64 Gauss-Newton
  iterations written from the optimization's definition, as many as the
  call asks for, on the
  inputs the program handed the step (its matches and map: this follows
  the program from its own state; the frame check covers the keypoints,
  the trajectory below reads the map);
- `preint_gap` (VIO): each sampled preintegration against
  reference/imu.py in float64 on the window of the cell's own IMU samples,
  at the program's bias estimates.

Each number is compared with its limit; the run is correct when none
exceeds it.  Beside them, not compared, the trajectory: the camera centres
of the window's frames, and of the map's keyframes as they stand at the
close, against the generator's true poses after the best rigid alignment
(`frame_ate_m`, `kf_ate_m`, RMSE in metres), which covers mapping, local
BA and the fused solve against something the program never computed; the
TF32 control does not separate from sound runs there (PERF.md).

The control (`control="tf32"`) puts each reference in the program's place
computed in TF32, the next precision below the configuration's float32
with TF32 off: the references in float32 with TF32 operands; the program
itself then runs under the same TF32 mode (portbench/run.py), for the
trajectory's readings.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cells

# Limits of the numbers compared, set from the readings in PERF.md (sound
# runs of the program over a dozen seeds and more, and the TF32 control).
LIMITS = {
    "frame_kp_mismatch": 0.04,
    "pose_gap": 0.04,
    "preint_gap": 5e-6,
}
SAMPLE_FRAMES = 5        # frames whose build and tracking are compared
SAMPLE_VIO = 2           # frames whose preintegration is compared
SAMPLE_SPAN = 30         # samples drawn from the first window frames,
                         # where the traffic names no `sample_span`
DUE_MARGIN = 10          # frames past the span by which every sample is due
POSE_FLOOR = 1e-3        # m: the least update a relative gap is taken over
MIN_POSES = 3            # the fewest poses an alignment is taken over
# Each number is the widest gap over its samples, except the pose's: the
# median over the sampled frames.  The tracker's two LM iterations in
# float32 land now and then up to a fifth of the update away from the
# same iterations in float64 (a damping candidate taken on a round-off
# difference), on sound runs as in the reference; every frame of a broken
# step reads high (PERF.md).
STAT = {"pose_gap": lambda v: float(np.median(v))}


# ---------------------------------------------------------------------------
# TF32: operands of matrix products rounded to 10 mantissa bits
# ---------------------------------------------------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (11 significant bits, to nearest), the operand
    rounding of the tensor cores' TF32 mode: Veltkamp's split at 2^13 + 1,
    plain arithmetic, so that it also runs under vmap and inside CUDA
    graphs."""
    if x.dtype != torch.float32:
        return x
    p = x * 8193.0
    return torch.where(torch.isfinite(p), (x - p) + p, x)


class TF32(torch.overrides.TorchFunctionMode):
    """Every matrix product and contraction with TF32 operands and f32
    accumulation, on any device."""

    OPS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
           torch.Tensor.__rmatmul__, torch.mm, torch.Tensor.mm, torch.bmm,
           torch.Tensor.bmm, torch.einsum, torch.tensordot}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            def r(a):
                if isinstance(a, torch.Tensor):
                    return tf32_round(a)
                if isinstance(a, (list, tuple)):
                    return type(a)(r(x) for x in a)
                return a
            args = tuple(r(a) for a in args)
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# Gaps
# ---------------------------------------------------------------------------


def _rotvec(R: torch.Tensor) -> torch.Tensor:
    from .generator import so3_log
    return so3_log(R.double())


def pose_gap(R_a, t_a, R_b, t_b, R_0, t_0) -> float:
    """|T_a - T_b| over the update |T_b - T_0| (at least POSE_FLOOR), with
    |T| = |t| + |log R| (radians as metres at 1 m)."""
    def dist(Ra, ta, Rb, tb):
        return float(torch.linalg.norm(ta.double() - tb.double())
                     + torch.linalg.norm(_rotvec(Ra.double() @ Rb.double().T)))
    return dist(R_a, t_a, R_b, t_b) / max(dist(R_b, t_b, R_0, t_0),
                                          POSE_FLOOR)


def state_gap(x_a: torch.Tensor, x_b: torch.Tensor,
              x_0: torch.Tensor) -> float:
    """|x_a - x_b| over |x_b - x_0| (at least POSE_FLOOR)."""
    x_a, x_b, x_0 = x_a.double(), x_b.double(), x_0.double()
    return float(torch.linalg.norm(x_a - x_b)) / max(
        float(torch.linalg.norm(x_b - x_0)), POSE_FLOOR)


def centres(Rcw: np.ndarray, tcw: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t [n, 3] of poses Rcw [n, 3, 3], tcw [n, 3]."""
    return -np.einsum("nji,nj->ni", np.asarray(Rcw, np.float64),
                      np.asarray(tcw, np.float64))


def ate_rmse(est: np.ndarray, true: np.ndarray) -> float:
    """RMSE of the centres est [n, 3] against true [n, 3] after the rigid
    motion that fits them best (Horn / Umeyama, no scale: stereo is
    metric)."""
    if len(est) < MIN_POSES:
        return float("inf")
    mu_e, mu_t = est.mean(0), true.mean(0)
    H = (est - mu_e).T @ (true - mu_t)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    err = true - (est - mu_e) @ R.T - mu_t
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def _clone(x):
    """Device copies of the tensors of a (nested) NamedTuple / tuple."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def frame_mismatch(prog: dict, ref: dict, scales) -> float:
    """Share of the keypoints, of the program's and the reference's
    together, that the other side does not give at the same level and
    pixel with the same descriptor and the same right-image u (within
    1e-3 px)."""
    def keyed(f):
        lv = f["level"].cpu().numpy()
        uv = f["uv"].cpu().numpy()
        grid = np.rint(uv / np.asarray(scales, np.float64)[lv][:, None])
        desc = f["desc"].cpu().numpy()
        ur = f["ur"].cpu().numpy()
        ok = f["valid"].cpu().numpy()
        return {(int(lv[j]), int(grid[j, 0]), int(grid[j, 1])):
                (desc[j].tobytes(), float(ur[j])) for j in np.nonzero(ok)[0]}
    p, r = keyed(prog), keyed(ref)
    if not p or not r:
        return 1.0
    same = 0
    for key, (d, ur) in p.items():
        got = r.get(key)
        if got is not None and got[0] == d and abs(got[1] - ur) <= 1e-3:
            same += 1
    return 1.0 - same / (len(p) + len(r) - same)


# ---------------------------------------------------------------------------
# The checker
# ---------------------------------------------------------------------------


class Checker:
    """Keeps samples of what the window produced; judges them after it."""

    def __init__(self, config: dict, seq, seed: int,
                 span: int | None = None):
        self.config = config
        self.seq = seq
        self.span = int(span or SAMPLE_SPAN)
        rng = np.random.RandomState(cells.seeds(seed, 4)[3])

        def draw(n):
            return set(rng.choice(self.span, min(n, self.span),
                                  replace=False).tolist())
        self.frame_at = draw(SAMPLE_FRAMES)
        self.vio_at = draw(SAMPLE_VIO)
        self.frames = []          # (frame index, program Frame)
        self.poses_opt = []       # (args, (rounds, iters), result): last
        self.preints = []         # (frame index, args, result)
        self.poses = []           # (frame index, Rcw, tcw) returned
        self.keyframes = None     # (timestamps, Rcw, tcw) at the close
        self._pose_on = self._vio_on = False
        self._last_opt = None
        self._i = None
        self.window_frames = 0

    # -- during the window -------------------------------------------------

    def install(self, sut):
        from vieo_slam_tpu_torch.frontend import tracking

        po = tracking.pose_optimization

        def pose_optimization(Rcw, tcw, obs, cam, bf=0.0, **kwargs):
            res = po(Rcw, tcw, obs, cam, bf, **kwargs)
            if self._pose_on:
                # The frame's last optimization gives its pose; the
                # earlier ones (the coarse stage) only start it.
                self._last_opt = (_clone((Rcw, tcw, obs)),
                                  (int(kwargs.get("rounds", 4)),
                                   int(kwargs.get("iters_per_round", 10))),
                                  _clone((res.Rcw, res.tcw)))
            return res

        tracking.pose_optimization = pose_optimization
        if sut.vio is not None:
            front = sut.vio
            preint0 = front._preint

            def preint(*args):
                res = preint0(*args)
                if self._vio_on:
                    self.preints.append((self._i, _clone(args), _clone(res)))
                return res

            front._preint = preint

    def begin(self, k: int, i: int):
        self._i = i
        self._pose_on = k in self.frame_at
        self._vio_on = k in self.vio_at

    def end(self, k: int, i: int, frame, pose, lost: bool):
        self.window_frames = k + 1
        if k in self.frame_at:
            self.frames.append((i, frame))
            if self._last_opt is not None:
                self.poses_opt.append(self._last_opt)
        self._last_opt = None
        if not lost:
            self.poses.append((i, pose[0].copy(), pose[1].copy()))
        self._pose_on = self._vio_on = False

    def close(self, system):
        """The map's keyframes as they stand when the window closes."""
        m = system.map
        ok = np.nonzero(m.kf_valid)[0]
        self.keyframes = (m.kf_timestamp[ok].copy(), m.kf_Rcw[ok].copy(),
                          m.kf_tcw[ok].copy())

    # -- after the window --------------------------------------------------

    def judge(self, dev, control: str | None = None, log=print) -> dict:
        """{name: (value, limit)} of the program against the references
        (control None), or of the references in TF32 in its place."""
        if control not in (None, "tf32"):
            raise ValueError(f"control {control!r}: only 'tf32'")
        readings = {"frame_kp_mismatch": self._frames(dev, control),
                    "pose_gap": self._poses(control)}
        if self.seq.imu is not None:
            readings["preint_gap"] = self._preints(control)
        # A window that passed every sample frame by a keyframe interval
        # and more has produced every sample: one missing never came.
        due = self.window_frames >= self.span + DUE_MARGIN
        out = {}
        for name, vals in readings.items():
            if vals is None:
                if not due:
                    continue
                vals = [float("inf")]
            log(f"check {name}: readings {[round(v, 9) for v in vals]}")
            out[name] = (STAT.get(name, max)(vals), LIMITS[name])
        return out

    def trajectory(self) -> dict:
        """The window's frames and the map's keyframes against the true
        poses: {"frame_ate_m", "kf_ate_m"}.  Read beside the comparison,
        not compared: a TF32 run of the program tracks as well as a sound
        one (PERF.md), so no limit separates the two."""
        return {"frame_ate_m": self._frame_ate(), "kf_ate_m": self._kf_ate()}

    def _ref(self, control, fn, *args):
        """fn(*args) as the reference wants it, and (for the control) in
        float32 with TF32 operands: (want, low)."""
        want = fn(*args)
        if control is None:
            return want, None
        with TF32():
            return want, fn(*args)

    def _frames(self, dev, control):
        from .reference import orb as rorb
        cfg, st = self.config["orb"], self.config["stereo"]
        bf = self.config["camera"]["bf"]
        scales = rorb.level_scales(cfg)
        vals = []
        for i, frame in self.frames:
            left, right = (x.to(dev) for x in self.seq.images[i])
            want, low = self._ref(control, rorb.frame, left, right, cfg, bf,
                                  st["min_depth"], st["max_depth"])
            got = low if control else {
                "uv": frame.uv, "level": frame.level, "desc": frame.desc,
                "ur": frame.ur, "valid": frame.valid}
            vals.append(frame_mismatch(got, want, scales))
        return vals or None

    def _cam(self):
        c = self.config["camera"]
        return (c["fx"], c["fy"], c["cx"], c["cy"]), float(c["bf"])

    def _poses(self, control):
        from .reference import pose as rpose
        if not self.poses_opt:
            return None
        cam, bf = self._cam()
        cpu = torch.device("cpu")
        vals = []
        for (R0, t0, obs), (rounds, iters), (R, t) in self.poses_opt:
            def solve(dtype):
                f = lambda x: x.to(cpu, dtype)  # noqa: E731
                return rpose.pose_optimization(
                    f(R0), f(t0), f(obs.pw), f(obs.uv), f(obs.ur),
                    f(obs.inv_sigma2), obs.valid.to(cpu), cam, bf,
                    rounds=rounds, iters=iters)
            want = solve(torch.float64)
            if control:
                with TF32():
                    R, t = solve(torch.float32)
            vals.append(pose_gap(R.cpu(), t.cpu(), *want, R0.cpu(),
                                 t0.cpu()))
        return vals

    def _preints(self, control):
        from .reference import imu as rimu
        if not self.preints:
            return None
        v = self.config["vio"]
        t_imu, gyro, acc = self.seq.imu
        vals = []
        for i, args, res in self.preints:
            bg, ba = args[3].cpu(), args[4].cpu()
            w = imu_window(t_imu, gyro, acc, self.seq.ts[i - 1],
                           self.seq.ts[i], v.get("window_cap", 64))

            def integrate(dtype):
                g, a, dt, mask = (torch.from_numpy(x) for x in w)
                return rimu.preintegrate(g.to(dtype), a.to(dtype),
                                         dt.to(dtype), mask, bg.to(dtype),
                                         ba.to(dtype))
            want = integrate(torch.float64)
            if control:
                with TF32():
                    got = integrate(torch.float32)
            else:
                got = (res.dR.cpu(), res.dv.cpu(), res.dp.cpu())
            x = torch.cat([_rotvec(got[0]).reshape(-1),
                           got[1].double().reshape(-1),
                           got[2].double().reshape(-1)])
            y = torch.cat([_rotvec(want[0]).reshape(-1),
                           want[1].reshape(-1), want[2].reshape(-1)])
            vals.append(state_gap(x, y, torch.zeros_like(y)))
        return vals

    def _frame_ate(self) -> float:
        if not self.poses:
            return float("inf")
        idx = np.asarray([i for i, _, _ in self.poses])
        est = centres(np.stack([R for _, R, _ in self.poses]),
                      np.stack([t for _, _, t in self.poses]))
        true = centres(self.seq.Rcw[idx], self.seq.tcw[idx])
        return ate_rmse(est, true)

    def _kf_ate(self) -> float:
        if self.keyframes is None:
            return float("inf")
        ts, R, t = self.keyframes
        fps = self.config["camera"]["fps"]
        idx = np.rint(np.asarray(ts) * fps).astype(np.int64)
        true = centres(self.seq.Rcw[idx], self.seq.tcw[idx])
        return ate_rmse(centres(R, t), true)


def imu_window(t, gyro, acc, t0: float, t1: float, cap: int):
    """The samples over (t0, t1] of a stream fed up to t1, each held until
    the next: (gyro [n, 3], acc [n, 3], dt [n], mask [n]) f32, trimmed to
    the samples used."""
    fed = int(np.searchsorted(t, t1, side="right"))
    t = t[:fed]
    i0 = max(int(np.searchsorted(t, t0, side="right")) - 1, 0)
    rows = []
    for j in range(i0, fed - 1):
        if t[j] >= t1:
            break
        a, b = max(t[j], t0), min(t[j + 1], t1)
        if b - a > 0:
            rows.append((j, b - a))
    rows = rows[:cap]
    if not rows:
        rows = [(max(fed - 1, 0), 0.0)]
    idx = np.asarray([j for j, _ in rows])
    dt = np.asarray([d for _, d in rows], np.float32)
    return (gyro[idx].astype(np.float32), acc[idx].astype(np.float32), dt,
            dt > 0)
