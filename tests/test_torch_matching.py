"""The port's matchers (ops/matching.py; kernels B3 and B4 through their
plain versions on the CPU) against the JAX package on the same seeded
inputs.

Tolerance: none.  Every output is an integer (indices, Hamming distances)
or a copied coordinate, so the port must give identical values -- with
ties broken to the lowest index, rows without a candidate at 1 << 30 and
columns without a candidate at row 0, as the Pallas kernels and the XLA
branch do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.ops import matching as jm
from vieo_slam_tpu.ops import pallas_matching as jpm
from vieo_slam_tpu_torch.ops import cuda_matching as tk
from vieo_slam_tpu_torch.ops import matching as tm

# One intra-op thread: the suite runs several worker processes at once and
# the tensors here are small, so more threads only contend for the cores.
torch.set_num_threads(1)


def descriptors(rng, n, n_unique=None):
    """uint32 [n, 8] words; with n_unique < n, rows repeat (Hamming ties)."""
    base = rng.randint(0, 2 ** 32, (n_unique or n, 8), np.uint64)
    base = base.astype(np.uint32)
    if n_unique is None:
        return base
    return base[rng.randint(0, n_unique, n)]


def t32(desc_u32):
    return torch.from_numpy(np.ascontiguousarray(desc_u32).view(np.int32))


def assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def best2_case(seed, M, N):
    rng = np.random.RandomState(seed)
    a = descriptors(rng, M, n_unique=M // 3)
    b = np.concatenate([a[rng.randint(0, M, N // 2)],
                        descriptors(rng, N - N // 2)])
    b[rng.rand(*b.shape) < 0.02] ^= np.uint32(1 << 7)
    mask = rng.rand(M, N) < 0.3
    mask[: M // 10] = False                 # rows without a candidate
    mask[:, : N // 10] = False              # columns without a candidate
    return a, b, mask


@pytest.mark.parametrize("M,N", [(300, 200), (64, 257)])
def test_fused_best2_plain_matches_pallas(M, N):
    a, b, mask = best2_case(M + N, M, N)
    want = jpm.fused_best2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask),
                           interpret=True)
    got = tk.fused_best2(t32(a), t32(b), torch.from_numpy(mask))
    assert_same(got, want)
    xla = jm._best2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    assert_same(got, xla)
    dist = jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))
    assert_same(tm.masked_best2(torch.from_numpy(np.asarray(dist)),
                                torch.from_numpy(mask)),
                jm.masked_best2(dist, jnp.asarray(mask)))
    assert (got[1].numpy() == tk.INF).sum() >= M // 10


def test_hamming_matrix():
    rng = np.random.RandomState(0)
    a, b = descriptors(rng, 50), descriptors(rng, 70)
    np.testing.assert_array_equal(
        tm.hamming_matrix(t32(a), t32(b)).numpy(),
        np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))


def projection_case(seed, M, N):
    rng = np.random.RandomState(seed)
    kp_uv = (rng.rand(N, 2) * [640, 480]).astype(np.float32)
    kp_uv[: N // 4] = np.round(kp_uv[: N // 4])
    pick = rng.randint(0, N, M)
    proj_uv = kp_uv[pick] + rng.randn(M, 2).astype(np.float32) * 6
    # Integer offsets of exactly the radius put candidates on the window
    # boundary (du*du + dv*dv == r*r).
    proj_uv[: M // 8] = kp_uv[pick[: M // 8]] + np.float32(15.0) * np.array(
        [[0.6, 0.8]], np.float32)
    proj_uv = proj_uv.astype(np.float32)
    kp_desc = descriptors(rng, N, n_unique=N // 2)
    proj_desc = kp_desc[pick].copy()
    proj_desc[rng.rand(M, 8) < 0.05] ^= np.uint32(1 << 3)
    kp_level = rng.randint(0, 4, N).astype(np.int32)
    proj_level = np.clip(kp_level[pick] + rng.randint(-2, 3, M), 0, 3
                         ).astype(np.int32)
    kp_valid = rng.rand(N) > 0.1
    proj_valid = rng.rand(M) > 0.1
    return (proj_uv, proj_level, proj_desc, proj_valid,
            kp_uv, kp_level, kp_desc, kp_valid)


@pytest.mark.parametrize("M,N", [(300, 200), (530, 120)])
def test_fused_projection_best2_plain_matches_pallas(M, N):
    (puv, plv, pd, pv, kuv, klv, kd, kv) = projection_case(M * N, M, N)
    radius = (np.float32(15.0) * np.float32(1.2) ** plv).astype(np.float32)
    radius[:5] = -1.0                       # negative radius: masked row
    want = jpm.fused_projection_best2(
        jnp.asarray(pd), jnp.asarray(kd), jnp.asarray(puv),
        jnp.asarray(radius), jnp.asarray(plv), jnp.asarray(pv),
        jnp.asarray(kuv), jnp.asarray(klv), jnp.asarray(kv), 1.0,
        interpret=True)
    got = tk.fused_projection_best2(
        t32(pd), t32(kd), torch.from_numpy(puv), torch.from_numpy(radius),
        torch.from_numpy(plv), torch.from_numpy(pv), torch.from_numpy(kuv),
        torch.from_numpy(klv), torch.from_numpy(kv), 1.0)
    assert_same(got, want)
    assert (got[1].numpy() < tk.INF).sum() > M // 2


def crafted_projection_case():
    """12 rows x 10 columns with every special case of the contract."""
    rng = np.random.RandomState(42)
    N, M = 10, 12
    kuv = np.array([[50 + 40 * j, 60.0] for j in range(N)], np.float32)
    kuv[4] = kuv[3] + [1.0, 0.0]            # columns 3 and 4: one window
    kd = descriptors(rng, N)
    kd[4] = kd[3]                           # ... and one descriptor: a tie
    klv = np.zeros(N, np.int32)
    kv = np.ones(N, bool)
    kv[7] = False                           # invalid column
    kuv[9] = [5000.0, 5000.0]               # column no row comes near
    pick = np.array([0, 1, 2, 3, 3, 5, 6, 7, 8, 8, 1, 2])
    puv = kuv[pick] + np.float32(0.5)
    pd = kd[pick].copy()
    pd[10, 0] ^= np.uint32(0b111)           # row 10: a worse match of col 1
    plv = np.zeros(M, np.int32)
    pv = np.ones(M, bool)
    pv[11] = False                          # all-masked row (invalid)
    puv[5] = [-4000.0, 7.0]                 # all-masked row (no window)
    radius = np.full(M, 10.0, np.float32)
    return pd, kd, puv, radius, plv, pv, kuv, klv, kv


@pytest.mark.parametrize("form", ["native", "strided_uv", "float_levels"])
def test_fused_projection_best2_native_inputs(form):
    """Inputs as the wrapper takes them natively (f32 uv and radius, int32
    levels, bool flags), and the forms it converts itself: a strided uv is
    copied, float levels are cast."""
    pd, kd, puv, radius, plv, pv, kuv, klv, kv = crafted_projection_case()
    want = jpm.fused_projection_best2(
        jnp.asarray(pd), jnp.asarray(kd), jnp.asarray(puv),
        jnp.asarray(radius), jnp.asarray(plv), jnp.asarray(pv),
        jnp.asarray(kuv), jnp.asarray(klv), jnp.asarray(kv), 1.0,
        interpret=True)
    args = [t32(pd), t32(kd), torch.from_numpy(puv), torch.from_numpy(radius),
            torch.from_numpy(plv), torch.from_numpy(pv),
            torch.from_numpy(kuv), torch.from_numpy(klv),
            torch.from_numpy(kv)]
    assert args[4].dtype == torch.int32 and args[5].dtype == torch.bool
    if form == "strided_uv":
        args[2] = torch.from_numpy(np.repeat(puv, 2, axis=1))[:, ::2]
        args[6] = torch.from_numpy(np.repeat(kuv, 2, axis=1))[:, ::2]
        assert not args[2].is_contiguous()
    elif form == "float_levels":
        args[4], args[7] = args[4].float(), args[7].float()
    got = tk.fused_projection_best2(*args, 1.0)
    assert_same(got, want)
    idx, best, second, col = (g.numpy() for g in got)
    assert idx[3] == 3 and best[3] == 0 and second[3] == 0   # column tie
    assert col[3] == 3 and col[8] == 8                       # row ties
    assert col[1] == 1 and best[10] == 3 and idx[10] == 1
    assert col[7] == 0 and col[9] == 0                       # empty columns
    for row in (5, 11):                                      # masked rows
        assert (idx[row], best[row], second[row]) == (0, tk.INF, tk.INF)


def test_native_passes_tensors_through():
    """A tensor of the kernel's dtype and layout is not copied."""
    x = torch.zeros(5, 2)
    assert tk._native(x, torch.float32) is x
    assert tk._native(x[:, 0], torch.float32).is_contiguous()
    assert tk._native(x.double(), torch.float32).dtype == torch.float32


@pytest.mark.parametrize("ratio,level_tolerance", [(1.0, 1), (0.8, 0)])
def test_search_by_projection(ratio, level_tolerance):
    (puv, plv, pd, pv, kuv, klv, kd, kv) = projection_case(7, 400, 300)
    scales = (1.2 ** np.arange(4)).astype(np.float32)
    kw = dict(radius=15.0, level_scales=scales, ratio=ratio,
              level_tolerance=level_tolerance)
    want = jm.search_by_projection(
        jnp.asarray(puv), jnp.asarray(plv), jnp.asarray(pd), jnp.asarray(pv),
        jnp.asarray(kuv), jnp.asarray(klv), jnp.asarray(kd), jnp.asarray(kv),
        **kw)
    got = tm.search_by_projection(
        torch.from_numpy(puv), torch.from_numpy(plv), t32(pd),
        torch.from_numpy(pv), torch.from_numpy(kuv), torch.from_numpy(klv),
        t32(kd), torch.from_numpy(kv), **kw)
    assert_same(got, want)
    assert (got[0].numpy() >= 0).sum() > 50
    fuse_w = jm.fuse_candidates(
        jnp.asarray(puv), jnp.asarray(plv), jnp.asarray(pd), jnp.asarray(pv),
        jnp.asarray(kuv), jnp.asarray(klv), jnp.asarray(kd), jnp.asarray(kv),
        radius=3.0, level_scales=scales)
    fuse_g = tm.fuse_candidates(
        torch.from_numpy(puv), torch.from_numpy(plv), t32(pd),
        torch.from_numpy(pv), torch.from_numpy(kuv), torch.from_numpy(klv),
        t32(kd), torch.from_numpy(kv), radius=3.0, level_scales=scales)
    assert_same(fuse_g, fuse_w)


def test_search_stereo_rectified():
    rng = np.random.RandomState(11)
    N = 400
    uv_l = (rng.rand(N, 2) * [640, 480]).astype(np.float32)
    disp = (rng.rand(N) * 60 + 2).astype(np.float32)
    uv_r = np.stack([uv_l[:, 0] - disp, uv_l[:, 1] + rng.randn(N) * 0.7],
                    -1).astype(np.float32)
    perm = rng.permutation(N)
    uv_r = uv_r[perm]
    desc_l = descriptors(rng, N, n_unique=N // 2)
    desc_r = desc_l[perm].copy()
    desc_r[rng.rand(N, 8) < 0.1] ^= np.uint32(1 << 11)
    lv_l = rng.randint(0, 4, N).astype(np.int32)
    lv_r = np.clip(lv_l[perm] + rng.randint(-1, 2, N), 0, 3).astype(np.int32)
    v_l, v_r = rng.rand(N) > 0.05, rng.rand(N) > 0.05
    scales = (1.2 ** np.arange(4)).astype(np.float32)
    kw = dict(min_disp=80.0 / 15.0, max_disp=80.0 / 0.3, level_scales=scales)
    want = jm.search_stereo_rectified(
        jnp.asarray(uv_l), jnp.asarray(lv_l), jnp.asarray(desc_l),
        jnp.asarray(v_l), jnp.asarray(uv_r), jnp.asarray(lv_r),
        jnp.asarray(desc_r), jnp.asarray(v_r), **kw)
    got = tm.search_stereo_rectified(
        torch.from_numpy(uv_l), torch.from_numpy(lv_l), t32(desc_l),
        torch.from_numpy(v_l), torch.from_numpy(uv_r), torch.from_numpy(lv_r),
        t32(desc_r), torch.from_numpy(v_r), **kw)
    assert_same(got, want)
    assert (got[1].numpy() >= 0).sum() > N // 4


def test_match_descriptors():
    rng = np.random.RandomState(5)
    a = descriptors(rng, 250, n_unique=180)
    b = np.concatenate([a[rng.permutation(250)[:150]], descriptors(rng, 90)])
    b[rng.rand(*b.shape) < 0.03] ^= np.uint32(1 << 5)
    va, vb = rng.rand(250) > 0.1, rng.rand(240) > 0.1
    extra = rng.rand(250, 240) > 0.2
    for kw in (dict(), dict(max_dist=60, ratio=1.0, extra_mask=extra)):
        jkw = {k: (jnp.asarray(v) if k == "extra_mask" else v)
               for k, v in kw.items()}
        tkw = {k: (torch.from_numpy(v) if k == "extra_mask" else v)
               for k, v in kw.items()}
        want = jm.match_descriptors(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(va), jnp.asarray(vb), **jkw)
        got = tm.match_descriptors(t32(a), t32(b), torch.from_numpy(va),
                                   torch.from_numpy(vb), **tkw)
        assert_same(got, want)
        assert (got[0].numpy() >= 0).sum() > 50
