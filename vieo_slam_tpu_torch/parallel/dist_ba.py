"""Landmark-sharded distributed bundle adjustment.

Port of vieo_slam_tpu/parallel/dist_ba.py.  The landmark dimension [M]
of a BAProblem -- observations, V blocks, the pose-landmark coupling W --
is cut into contiguous shards, one for each entry of a `BAMesh`; each
shard reduces its landmarks into a partial Schur camera system (Hpp, the
pose-pair fill S, the reduced right-hand side).  The camera system
[6K, 6K] is small, so the partials are summed once and the damped dense
system is solved on the summed copy; the landmark back-substitution is
local to each shard.

A mesh runs its shards in one of two ways, through one method,
`BAMesh.reduce`:

- in-process: a list of devices, one shard each, the same card as often
  as the caller lists it (N shards on one GPU).  This is the counterpart
  of the JAX package's single-controller shard_map over the process's
  devices: the partials are moved to the first device and summed there
  in shard order, the system is solved once there and the step is copied
  back to each shard's device;
- across processes: a torch.distributed process group, each rank holding
  its own shards; one all_reduce(SUM) of the partials (NCCL on CUDA, gloo
  on the CPU), after which every rank solves redundantly, as every chip
  of the JAX program does.

A shard's terms are those of the single-device solver,
solvers/local_ba.py (_partial_schur, _solve_camera_system,
_back_substitute, lm_iterations): its pose-pair fill is chunked over
landmarks, as in the JAX package (unchunked, the [M, O, O, 6, 6] pair
tensor takes 302 MB a shard at M = 32768, O = 8).  The JAX package's
one-hot pair fill is a TPU workaround and has no counterpart here; every
by-keyframe reduction is an `index_add_` scatter.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..cameras import models as cm
from ..solvers.local_ba import (BAProblem, _back_substitute, _partial_schur,
                                _pose_step, _solve_camera_system,
                                _total_cost, lm_iterations)

# The landmark-major fields of a BAProblem: sharded.  The pose fields
# (Rcw, tcw, fixed) are replicated on every shard.
LANDMARK_FIELDS = ("pw", "lm_valid", "obs_kf", "obs_uv", "obs_ur",
                   "obs_inv_sigma2", "obs_valid")
# The fill of each landmark-major field for padded landmarks: no
# observation, invalid, mono.
_PAD_FILL = {"pw": 0, "lm_valid": False, "obs_kf": -1, "obs_uv": 0,
             "obs_ur": -1.0, "obs_inv_sigma2": 1.0, "obs_valid": False}


@dataclasses.dataclass(frozen=True)
class BAMesh:
    """The shards of a landmark-sharded BA.

    devices: this process's shards, one landmark slice each; a device may
    repeat (N shards on one card).  group: a torch.distributed process
    group whose every rank holds such a list, or None for an in-process
    mesh; rank r's shards follow rank r-1's."""

    devices: tuple
    group: object = None

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """The number of shards over all ranks."""
        n = len(self.devices)
        return n if self.group is None else n * dist.get_world_size(
            self.group)

    def local_rows(self, M: int) -> slice:
        """The landmarks [M] held by this process's shards."""
        m = M // self.size
        first = self.rank * len(self.devices)
        return slice(first * m, (first + len(self.devices)) * m)

    def reduce(self, parts: list) -> list:
        """The sum over every shard of its partials.  parts holds one list
        of tensors for each local shard, of one shape from shard to shard;
        they are summed on devices[0] in shard order and then, with a
        process group, all-reduced over the ranks (one collective), so
        that every rank gets the same sums, on its devices[0]."""
        flat = [torch.cat([t.reshape(-1) for t in p]).to(self.devices[0])
                for p in parts]
        total = flat[0]
        for f in flat[1:]:
            total = total + f
        if self.group is not None:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        out, o = [], 0
        for t in parts[0]:
            out.append(total[o:o + t.numel()].view(t.shape))
            o += t.numel()
        return out


def make_ba_mesh(devices=None, group=None) -> BAMesh:
    """A mesh over `devices` (default: every visible CUDA device of the
    process, as jax.devices() is the JAX package's default).  A CPU
    device is used only when the caller lists it; without a GPU and
    without a list this raises."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_ba_mesh: no CUDA device is visible; list the devices "
                "to shard over (a CPU mesh is made only when asked for)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_ba_mesh: a mesh needs at least one device")
    return BAMesh(devices, group)


def pad_landmarks(prob: BAProblem, multiple: int) -> BAProblem:
    """prob with M padded to a multiple of `multiple` by landmarks that
    have no observation."""
    M = prob.pw.shape[0]
    pad = -(-M // multiple) * multiple - M
    if not pad:
        return prob

    def padded(name):
        a = getattr(prob, name)
        fill = torch.full((pad,) + tuple(a.shape[1:]), _PAD_FILL[name],
                          dtype=a.dtype, device=a.device)
        return torch.cat([a, fill])

    return prob._replace(**{f: padded(f) for f in LANDMARK_FIELDS})


def _landmark_shards(x: torch.Tensor, mesh: BAMesh) -> list:
    """This process's shards of a landmark-major tensor, each on its
    device."""
    M = x.shape[0]
    if M % mesh.size:
        raise ValueError(f"{M} landmarks do not split into {mesh.size} "
                         f"even shards: pad M to a multiple (pad_landmarks)")
    local = x[mesh.local_rows(M)].chunk(len(mesh.devices))
    return [c.to(d) for c, d in zip(local, mesh.devices)]


def shard_problem(prob: BAProblem, mesh: BAMesh) -> list:
    """This process's shards of a BAProblem: the landmark-major fields cut
    into contiguous slices, the pose fields replicated, each shard on its
    mesh device."""
    cut = {f: _landmark_shards(getattr(prob, f), mesh)
           for f in LANDMARK_FIELDS}
    return [BAProblem(Rcw=prob.Rcw.to(d), tcw=prob.tcw.to(d),
                      fixed=prob.fixed.to(d),
                      **{f: cut[f][i] for f in LANDMARK_FIELDS})
            for i, d in enumerate(mesh.devices)]


def _on(x, dev):
    return torch.as_tensor(x, device=dev)


def _step(shards, actives, Rcw, tcw, pws, cam, bf, lam, mesh):
    """One damped distributed Schur step from poses (Rcw, tcw) on
    devices[0] and the shards' landmarks pws.  Returns the candidate
    [Rcw, tcw] on devices[0] followed by the candidate landmarks of each
    shard."""
    parts, terms = [], []
    for p, a, pw in zip(shards, actives, pws):
        d = pw.device
        part, term = _partial_schur(Rcw.to(d), tcw.to(d), pw, p, cam,
                                    _on(bf, d), a, lam.to(d))
        parts.append(part)
        terms.append(term)
    Hpp, S, rhs = mesh.reduce(parts)
    dx = _solve_camera_system(Hpp, S, rhs, ~shards[0].fixed.to(Hpp.device),
                              lam)
    return [*_pose_step(Rcw, tcw, dx)] + [
        _back_substitute(pw, p.lm_valid, dx.to(pw.device), term)
        for p, pw, term in zip(shards, pws, terms)]


def _cost(shards, actives, Rcw, tcw, pws, cam, bf, mesh):
    """The total robust cost over every shard (replicated on every
    rank)."""
    parts = [[_total_cost(Rcw.to(pw.device), tcw.to(pw.device), pw, p, cam,
                          _on(bf, pw.device), a)]
             for p, a, pw in zip(shards, actives, pws)]
    return mesh.reduce(parts)[0]


def distributed_ba_step(prob: BAProblem, cam: cm.Camera, bf, active, lam,
                        mesh: BAMesh):
    """One damped distributed Schur step (landmark-sharded).

    prob and active [M, O] are whole; M must split evenly over the mesh.
    Returns (Rcw', tcw', pw') on mesh.devices[0]: pw' holds the landmarks
    of this process's shards (all of them for an in-process mesh)."""
    shards = shard_problem(prob, mesh)
    dev = mesh.devices[0]
    Rcw, tcw, *pws = _step(shards, _landmark_shards(active, mesh),
                           prob.Rcw.to(dev), prob.tcw.to(dev),
                           [p.pw for p in shards], cam, bf,
                           _on(lam, dev).to(prob.tcw.dtype), mesh)
    return Rcw, tcw, torch.cat([pw.to(dev) for pw in pws])


def distributed_ba(prob: BAProblem, cam: cm.Camera, bf, mesh: BAMesh, *,
                   iters: int):
    """Distributed Levenberg-Marquardt BA with true accept/reject.

    Each iteration sums the shards' camera systems once (in _step) and the
    shards' robust costs once, and accepts or rejects the step on the
    total cost (local_ba.lm_iterations, the single-device solver's LM)
    over every observation of prob (no chi2 reclassification), from the
    single-device solver's initial damping, 1e-4.  Returns
    (Rcw, tcw, pw) as distributed_ba_step does."""
    shards = shard_problem(prob, mesh)
    actives = [p.obs_valid for p in shards]
    dev, dtype = mesh.devices[0], prob.tcw.dtype

    def cost_of(s):
        return _cost(shards, actives, s[0], s[1], s[2:], cam, bf,
                     mesh).to(dtype)

    state = [prob.Rcw.to(dev), prob.tcw.to(dev)] + [p.pw for p in shards]
    (Rcw, tcw, *pws), _ = lm_iterations(
        state, cost_of(state),
        lambda s, lam: _step(shards, actives, s[0], s[1], s[2:], cam, bf,
                             lam, mesh),
        cost_of, iters, torch.tensor(1e-4, dtype=dtype, device=dev))
    return Rcw, tcw, torch.cat([pw.to(dev) for pw in pws])
