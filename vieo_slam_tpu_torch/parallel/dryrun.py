"""One multi-device pipeline step, checked against one device.

Port of the JAX package's `__graft_entry__.dryrun_multichip`: the
shardings of the multi-device pipeline on small shapes -- data-parallel
ORB extraction (one frame a mesh entry), per-camera projection matching
against a replicated landmark set, and one landmark-sharded distributed
BA step.  Where the JAX function checks only that its outputs are
finite, this one runs every part on a single device too and returns the
largest difference of each part, with the devices its shards ran on.  It
never moves work to another device than those it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import matching
from ..ops.orb import OrbConfig, extract_orb, extract_orb_batch
from ..solvers.local_ba import _ba_iteration
from .dist_ba import distributed_ba_step, make_ba_mesh
from .synthetic import mini_world


def _max_diff(a: list, b: list) -> float:
    """The largest absolute difference between paired tensors (integers
    compared exactly, in float64)."""
    return max(float((x.double() - y.to(x.device).double()).abs().max())
               if x.numel() else 0.0 for x, y in zip(a, b))


def dryrun_multichip(devices) -> dict:
    """Run the three parts over a mesh of `devices` (one shard each; a
    device may repeat) and on devices[0] alone.

    Returns {part: {"max_abs_diff": x, "devices": [device of each
    shard]}} for "extraction" (every field of the features: a batched
    extract_orb_batch of all frames on one device against one extract_orb
    a shard), "matching" (search_by_projection's indices and distances;
    "matched": the landmarks matched over all shards) and "ba_step"
    (distributed_ba_step against the single-device
    solvers.local_ba._ba_iteration: the largest difference of the poses'
    R and t and, under "pw_max_abs_diff", of the landmarks)."""
    mesh = make_ba_mesh(devices)
    n, dev0 = len(mesh.devices), mesh.devices[0]

    # data-parallel extraction: one small frame a shard
    cfg = OrbConfig(n_features=64, n_levels=2, cell_size=16)
    rng = np.random.RandomState(1)
    imgs = rng.rand(n, 64, 96).astype(np.float32) * 255
    sharded = [extract_orb(imgs[i], cfg, device=d)
               for i, d in enumerate(mesh.devices)]
    single = extract_orb_batch(imgs, cfg, device=dev0)
    out = {"extraction": {
        "max_abs_diff": max(_max_diff(list(f), [x[i] for x in single])
                            for i, f in enumerate(sharded)),
        "devices": [str(f.uv.device) for f in sharded]}}

    # per-camera matching: each shard's keypoints against a replicated
    # landmark set (the JAX function's sizes)
    n_lm = 32
    lm_desc = rng.randint(0, 2 ** 32, (n_lm, 8), np.uint64).astype(
        np.uint32).view(np.int32)
    lm_uv = rng.rand(n_lm, 2).astype(np.float32) * [96, 64]

    def match(f, d):
        return matching.search_by_projection(
            torch.as_tensor(lm_uv, device=d),
            torch.zeros(n_lm, dtype=torch.int32, device=d),
            torch.as_tensor(lm_desc, device=d),
            torch.ones(n_lm, dtype=torch.bool, device=d),
            f.uv, torch.zeros(f.uv.shape[0], dtype=torch.int32, device=d),
            f.desc, f.valid, radius=24.0, level_scales=cfg.level_scales,
            max_dist=256, level_tolerance=8)

    got = [match(f, d) for f, d in zip(sharded, mesh.devices)]
    want = [match(type(single)(*(x[i] for x in single)), dev0)
            for i in range(n)]
    out["matching"] = {
        "max_abs_diff": max(_max_diff(list(g), list(w))
                            for g, w in zip(got, want)),
        "matched": sum(int((g[0] >= 0).sum()) for g in got),
        "devices": [str(g[0].device) for g in got]}

    # one landmark-sharded distributed BA step
    cam, bf, prob = mini_world(n_kf=4, n_lm=16 * n, n_obs=3, device=dev0)
    lam = torch.tensor(1e-3, device=dev0)
    R2, t2, p2 = distributed_ba_step(prob, cam, bf, prob.obs_valid, lam,
                                     mesh)
    R1, t1, p1 = _ba_iteration(prob.Rcw, prob.tcw, prob.pw, prob, cam,
                               torch.tensor(bf, device=dev0),
                               prob.obs_valid, lam)
    out["ba_step"] = {"max_abs_diff": _max_diff([R2, t2], [R1, t1]),
                      "pw_max_abs_diff": _max_diff([p2], [p1]),
                      "devices": [str(d) for d in mesh.devices]}
    return out
