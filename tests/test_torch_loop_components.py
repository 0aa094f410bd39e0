"""The port's place-recognition components against the JAX package on the
same seeded inputs: Sim3 lie functions, the vocabulary and keyframe
database, Horn alignment and Sim3 RANSAC, the two-sided Sim3 refinement,
the pose graph with landmark correction, and both PnP cores.

Tolerances: lie functions 1e-6; vocabulary training bit for bit (the
same numpy), the descent's word ids exact and BoW vectors 1e-6; database
scores 1e-6 (the L1 sums reduce in another order) and the candidates
exact; solvers 1e-4 on poses, scales and landmarks, with identical inlier
sets.  The RANSAC cores are handed the indices the JAX package draws
(under the suite's x64 its Sim3 draw takes f64 logits); the port's own
draw, keyed (`utils.prng`, held against `jax.random` in
test_torch_prng.py), is checked here for its distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.loop import keyframe_db as jdb
from vieo_slam_tpu.loop import vocabulary as jvoc
from vieo_slam_tpu.math import lie as jlie
from vieo_slam_tpu.solvers import pnp_solver as jpnp
from vieo_slam_tpu.solvers import pose_graph as jpg
from vieo_slam_tpu.solvers import sim3_solver as jsim3
from vieo_slam_tpu_torch import convert
from vieo_slam_tpu_torch.cameras import models as tcm
from vieo_slam_tpu_torch.loop import keyframe_db as tdb
from vieo_slam_tpu_torch.loop import vocabulary as tvoc
from vieo_slam_tpu_torch.math import lie as tlie
from vieo_slam_tpu_torch.solvers import pnp_solver as tpnp
from vieo_slam_tpu_torch.solvers import pose_graph as tpg
from vieo_slam_tpu_torch.solvers import sim3_solver as tsim3
from vieo_slam_tpu_torch.utils import prng

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray
CAM_ARGS = (400.0, 400.0, 320.0, 240.0, 640, 480)


def f32(x):
    return np.asarray(x, np.float32)


def random_sim3(rng, n, scale=True):
    xi = rng.randn(n, 7).astype(np.float32) * [0.5, 0.5, 0.5, 0.6, 0.6, 0.6,
                                               0.3 if scale else 0.0]
    R, t, s = jlie.sim3_exp(J(f32(xi)))
    return f32(R), f32(t), f32(s)


def categorical_draws(valid, key, n_hyp, size):
    """The JAX solvers' draw: categorical over -1e9-masked logits."""
    logits = jnp.where(J(valid), 0.0, -1e9)
    return np.asarray(jax.random.categorical(key, logits,
                                             shape=(n_hyp, size)))


# ---------------------------------------------------------------------------
# Sim3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mag", [1.0, 1e-4, 0.0])
def test_sim3_functions(mag):
    rng = np.random.RandomState(0)
    xi = f32(rng.randn(16, 7) * mag)
    xi[0, 6] = 0.0                      # sigma exactly 0
    xi[1, 3:6] = 0.0                    # rotation exactly 0
    R, t, s = (T(np.asarray(a)) for a in tlie.sim3_exp(T(xi)))
    Rj, tj, sj = jlie.sim3_exp(J(xi))
    for a, b in ((R, Rj), (t, tj), (s, sj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(tlie.sim3_log(R, t, s).numpy(),
                               np.asarray(jlie.sim3_log(Rj, tj, sj)),
                               atol=1e-6)
    R2, t2, s2 = random_sim3(rng, 16)
    a = (R, t, s)
    b = (T(R2.copy()), T(t2.copy()), T(s2.copy()))
    ja = (Rj, tj, sj)
    jb = (J(R2), J(t2), J(s2))
    for x, y in zip(tlie.sim3_compose(*a, *b), jlie.sim3_compose(*ja, *jb)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
    for x, y in zip(tlie.sim3_inverse(*b), jlie.sim3_inverse(*jb)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
    p = f32(rng.randn(16, 3))
    np.testing.assert_allclose(tlie.sim3_apply(*b, T(p)).numpy(),
                               np.asarray(jlie.sim3_apply(*jb, J(p))),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Vocabulary and database
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vocab():
    rng = np.random.RandomState(1)
    base = rng.randint(0, 2 ** 32, (60, 8), np.uint64).astype(np.uint32)
    # clustered descriptors: bases with a few bits flipped
    desc = np.repeat(base, 30, axis=0)
    flips = rng.randint(0, 32, desc.shape).astype(np.uint32)
    desc = desc ^ (np.uint32(1) << flips) * (rng.rand(*desc.shape) < 0.3)
    desc = desc.astype(np.uint32)
    jv = jvoc.train_vocabulary(desc, k=4, L=3, seed=0)
    tv = tvoc.train_vocabulary(desc, k=4, L=3, seed=0)
    return jv, tv, desc, base


def test_train_vocabulary_exact(vocab):
    jv, tv, _, _ = vocab
    np.testing.assert_array_equal(tv.node_desc, jv.node_desc)
    np.testing.assert_array_equal(tv.idf, jv.idf)
    cv = convert.vocabulary_from_jax(jv)
    np.testing.assert_array_equal(cv.node_desc, tv.node_desc)


def test_transform(vocab):
    jv, tv, desc, _ = vocab
    rng = np.random.RandomState(2)
    q = desc[rng.choice(len(desc), 300)]
    valid = rng.rand(300) > 0.2
    bow_j, word_j = jvoc.transform(jv, J(q), J(valid))
    bow_t, word_t = tvoc.transform(tv, T(q.view(np.int32)), T(valid))
    np.testing.assert_array_equal(word_t.numpy(), np.asarray(word_j))
    np.testing.assert_allclose(bow_t.numpy(), np.asarray(bow_j), atol=1e-6)


def test_database_scores_and_candidates(vocab):
    jv, tv, desc, base = vocab
    rng = np.random.RandomState(3)

    def bow_of(place):
        """A keyframe at `place` sees bases 2*place .. 2*place+9."""
        q = np.repeat(base[2 * place:2 * place + 10], 6, axis=0)
        q = q ^ (np.uint32(1) << rng.randint(0, 32, q.shape).astype(
            np.uint32))
        return np.asarray(jvoc.transform(jv, J(q),
                                         J(np.ones(len(q), bool)))[0])

    jd = jdb.KeyFrameDatabase(jv.n_words, capacity=24)
    td = tdb.KeyFrameDatabase(tv.n_words, capacity=24)
    bows = [bow_of(k) for k in range(20)]
    for k, bow in enumerate(bows):
        if k != 7:
            jd.add(k, bow)
            td.add(k, bow)
    jd.erase(3)
    td.erase(3)
    np.testing.assert_allclose(td.scores(bows[12]), jd.scores(bows[12]),
                               atol=1e-6)
    np.testing.assert_allclose(
        tvoc.score_l1(T(bows[5]), T(np.stack(bows))).numpy(),
        np.asarray(jvoc.score_l1(J(bows[5]), J(np.stack(bows)))), atol=1e-6)
    covis = {k: np.asarray([x for x in (k - 1, k + 1, k - 2, k + 2)
                            if 0 <= x < 20], int) for k in range(20)}
    # keyframe 19 revisits place 5, keyframe 18 place 11
    for q, place in ((19, 5), (18, 11), (19, 2)):
        bow_q = bow_of(place)
        conn = np.asarray([q - 1, q - 2])
        want = jd.detect_loop_candidates(bow_q, q, conn, lambda c: covis[c])
        got = td.detect_loop_candidates(bow_q, q, conn, lambda c: covis[c])
        np.testing.assert_array_equal(got, want)
        assert place in want, (want, place)
        np.testing.assert_array_equal(td.detect_reloc_candidates(bow_q),
                                      jd.detect_reloc_candidates(bow_q))


# ---------------------------------------------------------------------------
# Horn, Sim3 RANSAC, Sim3 refinement
# ---------------------------------------------------------------------------


def sim3_pairs(seed, n=300, outliers=0.4, with_scale=True):
    rng = np.random.RandomState(seed)
    p_src = f32(rng.randn(n, 3) * [1.5, 1.0, 0.8] + [0, 0, 4.0])
    R, t, s = random_sim3(rng, 1, scale=with_scale)
    p_dst = f32(s[0] * p_src @ R[0].T + t[0] + rng.randn(n, 3) * 0.01)
    n_out = int(n * outliers)
    p_dst[:n_out] += f32(rng.randn(n_out, 3))
    valid = rng.rand(n) > 0.1
    return p_src, p_dst, valid


@pytest.mark.parametrize("with_scale", [True, False])
def test_horn_alignment(with_scale):
    p_src, p_dst, valid = sim3_pairs(4, outliers=0.0, with_scale=with_scale)
    w = f32(valid)
    want = jsim3.horn_alignment(J(p_src), J(p_dst), J(w),
                                with_scale=with_scale)
    got = tsim3.horn_alignment(T(p_src), T(p_dst), T(w),
                               with_scale=with_scale)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("with_scale", [True, False])
def test_sim3_ransac_from_jax_draws(with_scale):
    p_src, p_dst, valid = sim3_pairs(5, with_scale=with_scale)
    key = jax.random.PRNGKey(11)
    want = jsim3.sim3_ransac(J(p_src), J(p_dst), J(valid), key,
                             inlier_thresh=0.05, with_scale=with_scale)
    idx = categorical_draws(valid, key, 128, 3)
    got = tsim3.sim3_ransac_from_indices(
        T(p_src), T(p_dst), T(valid), T(idx).long(), inlier_thresh=0.05,
        with_scale=with_scale)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) > 100
    for a, b in ((got.R, want.R), (got.t, want.t), (got.s, want.s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_draws_are_uniform_over_valid_rows_with_replacement():
    valid = np.zeros(40, bool)
    valid[[1, 5, 6, 30]] = True
    idx = tpnp.draw_indices(T(valid), 2000, 3, prng.prng_key(3)).numpy()
    assert set(np.unique(idx)) == {1, 5, 6, 30}
    counts = np.bincount(idx.ravel(), minlength=40)[[1, 5, 6, 30]]
    assert counts.min() > 1300 and counts.max() < 1700
    # with replacement: repeated rows inside one sample occur
    assert (idx[:, 0] == idx[:, 1]).any()
    # the key alone decides the draw
    again = tpnp.draw_indices(T(valid), 2000, 3, prng.prng_key(3)).numpy()
    np.testing.assert_array_equal(again, idx)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3(fix_scale):
    rng = np.random.RandomState(6)
    n = 120
    R, t, s = random_sim3(rng, 1, scale=not fix_scale)
    R, t, s = R[0], t[0], s[0]
    p_k = f32(rng.randn(n, 3) * [1.5, 1.0, 0.5] + [0, 0, 4.0])
    p_c = f32(s * p_k @ R.T + t)
    fx, fy, cx, cy = CAM_ARGS[:4]

    def proj(p):
        return f32(np.stack([fx * p[:, 0] / p[:, 2] + cx,
                             fy * p[:, 1] / p[:, 2] + cy], -1))

    uv_c = proj(p_c) + f32(rng.randn(n, 2) * 0.5)
    uv_k = proj(p_k) + f32(rng.randn(n, 2) * 0.5)
    uv_c[:10] += 40.0                   # outliers
    isk = f32(1.2 ** (-2.0 * rng.randint(0, 4, n)))
    isc = f32(1.2 ** (-2.0 * rng.randint(0, 4, n)))
    valid = rng.rand(n) > 0.05
    dR, dt_, ds = random_sim3(np.random.RandomState(7), 1,
                              scale=not fix_scale)
    # perturb the start a little
    R0, t0, s0 = jlie.sim3_compose(
        *jlie.sim3_exp(J(f32([0.02, -0.01, 0.03, 0.01, -0.02, 0.015,
                              0.0 if fix_scale else 0.05]))),
        J(R), J(t), J(s))
    args = [R0, t0, s0, p_k, p_c, uv_k, uv_c, isk, isc, valid]
    want = jsim3.optimize_sim3(*(J(np.asarray(a)) for a in args),
                               jcm.make_pinhole(*CAM_ARGS),
                               fix_scale=fix_scale)
    got = tsim3.optimize_sim3(*(T(np.array(a)) for a in args),
                              tcm.make_pinhole(*CAM_ARGS),
                              fix_scale=fix_scale)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    for a, b in ((got.R, want.R), (got.t, want.t), (got.s, want.s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(got.R.numpy(), R, atol=5e-3)


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------


def pose_graph_problem(fix_scale, K=24):
    """A drifted chain around a loop with a loop edge to the truth."""
    rng = np.random.RandomState(8)
    ang = np.linspace(0, 2 * np.pi * (K - 1) / K, K)
    xi = np.zeros((K, 7), np.float32)
    xi[:, 4] = ang
    xi[:, 0] = 2.0 * np.cos(ang)
    xi[:, 2] = 2.0 * np.sin(ang)
    R, t, s = (f32(a) for a in jlie.sim3_exp(J(xi)))
    ei = np.arange(K - 1)
    ej = ei + 1
    eR, et, es = (f32(a) for a in jpg.make_edge_measurements(
        J(R), J(t), J(s), J(ei), J(ej)))
    # drift: perturb vertices progressively
    drift = f32(np.cumsum(rng.randn(K, 7) * 0.01, axis=0))
    if fix_scale:
        drift[:, 6] = 0.0
    Rd, td, sd = (f32(a) for a in jlie.sim3_compose(
        *jlie.sim3_exp(J(drift)), J(R), J(t), J(s)))
    # the loop edge (K-1 -> 0) measured on the truth, plus covisibility
    li, lj = np.asarray([K - 1, 5]), np.asarray([0, 8])
    lR, lt, ls = (f32(a) for a in jpg.make_edge_measurements(
        J(R), J(t), J(s), J(li), J(lj)))
    fields = dict(
        R=Rd, t=td, s=sd, fixed=np.arange(K) == 0,
        edge_i=np.concatenate([ei, li, [-1]]).astype(np.int32),
        edge_j=np.concatenate([ej, lj, [-1]]).astype(np.int32),
        edge_R=np.concatenate([eR, lR, np.eye(3, dtype=np.float32)[None]]),
        edge_t=np.concatenate([et, lt, np.zeros((1, 3), np.float32)]),
        edge_s=np.concatenate([es, ls, [1.0]]).astype(np.float32),
        edge_w=np.concatenate([np.ones(K - 1), [5.0, 2.0], [1.0]]).astype(
            np.float32))
    return fields, (R, t, s)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_pose_graph_and_correct_landmarks(fix_scale):
    fields, _ = pose_graph_problem(fix_scale)
    want = jpg.optimize_pose_graph(
        jpg.PoseGraphProblem(**{k: J(v) for k, v in fields.items()}),
        iters=20, fix_scale=fix_scale, backend="cpu")
    got = tpg.optimize_pose_graph(
        tpg.PoseGraphProblem(**{k: T(v) for k, v in fields.items()}),
        iters=20, fix_scale=fix_scale)
    for a, b in ((got.R, want.R), (got.t, want.t), (got.s, want.s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    moved = np.abs(np.asarray(want.t) - fields["t"]).max()
    assert moved > 1e-2, moved
    rng = np.random.RandomState(9)
    pw = f32(rng.randn(200, 3) * 2)
    ref = rng.randint(-1, len(fields["s"]), 200).astype(np.int32)
    old = (fields["R"], fields["t"], fields["s"])
    new = (np.asarray(want.R), np.asarray(want.t), np.asarray(want.s))
    pw_j = jpg.correct_landmarks(J(pw), J(ref), *(J(a) for a in old),
                                 *(J(a) for a in new))
    pw_t = tpg.correct_landmarks(T(pw), T(ref), *(T(a) for a in old),
                                 *(T(np.array(a)) for a in new))
    np.testing.assert_allclose(pw_t.numpy(), np.asarray(pw_j), atol=1e-4)


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------


def pnp_problem(seed, n=150, purity=0.5):
    rng = np.random.RandomState(seed)
    pw = f32(rng.randn(n, 3) * [2.0, 1.5, 1.0] + [0, 0, 5.0])
    R, t, _ = random_sim3(rng, 1, scale=False)
    R, t = R[0], t[0] * 0.3
    pc = pw @ R.T + t
    rays = f32(pc / pc[:, 2:])
    rays[:, :2] += f32(rng.randn(n, 2) * 0.5 / 400.0)
    n_out = int(n * (1 - purity))
    pw_obs = pw.copy()
    pw_obs[:n_out] = f32(rng.randn(n_out, 3) * [2.0, 1.5, 1.0] + [0, 0, 5.0])
    depth = f32(pc[:, 2] + rng.randn(n) * 0.05)
    p_cam = f32(rays * depth[:, None])
    valid = rng.rand(n) > 0.05
    valid3d = valid & (rng.rand(n) > 0.2)
    return rays, pw_obs, valid, p_cam, valid3d, (R, t)


def test_pnp_ransac_from_jax_draws():
    rays, pw, valid, _, _, (R, t) = pnp_problem(10, purity=0.7)
    key = jax.random.PRNGKey(5)
    want = jpnp.pnp_ransac(J(rays), J(pw), J(valid), key, n_hyp=512,
                           thresh=2.0 / 400.0, min_inliers=10)
    idx = categorical_draws(valid.astype(np.float32) > 0, key, 512, 6)
    # pnp_ransac's logits carry the rays' dtype
    idx = np.asarray(jax.random.categorical(
        key, jnp.where(J(valid), 0.0, -1e9).astype(jnp.float32),
        shape=(512, 6)))
    got = tpnp.pnp_ransac_from_indices(T(rays), T(pw), T(valid),
                                       T(idx).long(), thresh=2.0 / 400.0,
                                       min_inliers=10)
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    np.testing.assert_allclose(got.Rcw.numpy(), np.asarray(want.Rcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.tcw.numpy(), np.asarray(want.tcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.Rcw.numpy(), R, atol=1e-2)


def test_pnp_ransac_3d3d_from_jax_draws():
    rays, pw, valid, p_cam, valid3d, (R, t) = pnp_problem(12, purity=0.4)
    key = jax.random.PRNGKey(7)
    want = jpnp.pnp_ransac_3d3d(J(p_cam), J(rays), J(pw), J(valid3d),
                                J(valid), key, n_hyp=256,
                                thresh=3.0 / 400.0, min_inliers=10)
    idx = np.asarray(jax.random.categorical(
        key, jnp.where(J(valid3d), 0.0, -1e9).astype(jnp.float32),
        shape=(256, 3)))
    got = tpnp.pnp_ransac_3d3d_from_indices(
        T(p_cam), T(rays), T(pw), T(valid), T(idx).long(),
        thresh=3.0 / 400.0, min_inliers=10)
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    np.testing.assert_allclose(got.Rcw.numpy(), np.asarray(want.Rcw),
                               atol=1e-4)
    np.testing.assert_allclose(got.tcw.numpy(), np.asarray(want.tcw),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# Dynamic landmarks of the synthetic world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frac", [0.0, 0.02])
def test_dynamic_world_matches_jax(frac):
    from vieo_slam_tpu.sim import world as jworld
    from vieo_slam_tpu_torch.sim import world as tworld

    kw = dict(n_landmarks=2200, seed=4, extent=(6.0, 4.5, 3.0),
              dynamic_frac=frac)
    wj = jworld.SyntheticWorld(jworld.WorldConfig(**kw))
    wt = tworld.SyntheticWorld(tworld.WorldConfig(**kw))
    np.testing.assert_array_equal(wt.dynamic_ids, wj.dynamic_ids)
    assert len(wt.dynamic_ids) == round(frac * 2200)
    np.testing.assert_array_equal(wt.desc, wj.desc)
    ts = np.asarray([0.0, 1.7])
    Rwc, twc, _, _ = jworld.circle_trajectory(ts, radius=1.0, omega=0.35,
                                              look_outward=True)
    Rcw, tcw = jworld.trajectory_to_tcw(Rwc, twc)
    cam = (200.0, 200.0, 160.0, 120.0, 320, 240)
    for i, t in enumerate(ts):
        np.testing.assert_array_equal(wt.pw_at(t), wj.pw_at(t))
        want = wj.render_stereo(jcm.make_pinhole(*cam), Rcw[i], tcw[i], 0.2,
                                t=float(t))
        got = wt.render_stereo(tcm.make_pinhole(*cam), Rcw[i], tcw[i], 0.2,
                               t=float(t))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    if frac:
        assert not np.array_equal(wt.pw_at(1.7), wt.pw)
