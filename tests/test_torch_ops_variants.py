"""The last ops variants of the port against the JAX package's:
ops/matching.mutual_filter and mutual_from_dist, and ops/orb's
cross-level keypoint selections (select_keypoints_batched and
select_keypoints_concat) with the ORB_BATCHED_SELECT switch.

Tolerances: equal.  The selections equal the per-level path in every bit
and JAX's variants in every field but one: JAX's variants also zero the
uv of picks that fail the border test (its per-level path keeps them, so
its docstrings' claim of identical results holds for the valid rows
only); there the port keeps the per-level path's uv.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vieo_slam_tpu.ops import matching as jmatching
from vieo_slam_tpu.ops import orb as jorb
from vieo_slam_tpu_torch.ops import matching as tmatching
from vieo_slam_tpu_torch.ops import orb as torb

torch.set_num_threads(1)


def _matches(seed, na, nb):
    """best_idx with many ties (few columns) and -1 rows; valid with
    invalid rows."""
    rng = np.random.RandomState(seed)
    best = rng.randint(-1, max(nb // 4, 1), na).astype(np.int32)
    valid = (rng.rand(na) < 0.8) & (best >= 0)
    return best, valid


@pytest.mark.parametrize("seed,na,nb", [(0, 64, 48), (1, 300, 40),
                                        (2, 17, 90), (3, 1, 1)])
def test_mutual_filter_matches_jax(seed, na, nb):
    best, valid = _matches(seed, na, nb)
    got = tmatching.mutual_filter(torch.from_numpy(best), na, nb,
                                  torch.from_numpy(valid))
    want = jmatching.mutual_filter(jnp.asarray(best), na, nb,
                                   jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one-to-one: no column kept twice
    cols = best[got.numpy()]
    assert len(cols) == len(set(cols.tolist()))


@pytest.mark.parametrize("seed,na,nb", [(0, 64, 48), (1, 120, 30),
                                        (2, 9, 70)])
def test_mutual_from_dist_matches_jax(seed, na, nb):
    rng = np.random.RandomState(seed)
    dist = rng.randint(0, 6, (na, nb)).astype(np.int32)     # many ties
    mask = rng.rand(na, nb) < 0.7
    mask[: na // 5] = False                                 # empty rows
    d = np.where(mask, dist, jmatching.INF)
    best = np.where(mask.any(1), d.argmin(1), -1).astype(np.int32)
    valid = (best >= 0) & (rng.rand(na) < 0.9)
    got = tmatching.mutual_from_dist(
        torch.from_numpy(dist), torch.from_numpy(mask),
        torch.from_numpy(best), torch.from_numpy(valid))
    want = jmatching.mutual_from_dist(
        jnp.asarray(dist), jnp.asarray(mask), jnp.asarray(best),
        jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the fused matcher's column argmin feeds the same filter
    assert got.dtype == torch.bool


def _score_maps(seed, h=150, w=190, n_levels=4):
    """Blended FAST-like score maps of a 4-level pyramid: mostly zero,
    small integer scores (ties), a few boosted (+1e4) winners."""
    rng = np.random.RandomState(seed)
    maps = []
    for lv in range(n_levels):
        s = 1.2 ** lv
        hh, ww = round(h / s), round(w / s)
        m = np.where(rng.rand(hh, ww) < 0.15,
                     rng.randint(1, 20, (hh, ww)), 0).astype(np.float32)
        m += np.where(rng.rand(hh, ww) < 0.01, 1e4, 0).astype(np.float32)
        maps.append(m)
    return maps


def _cfg(n_features=500, n_levels=4):
    return (torb.OrbConfig(n_features=n_features, n_levels=n_levels),
            jorb.OrbConfig(n_features=n_features, n_levels=n_levels))


@pytest.mark.parametrize("variant", ["batched", "concat"])
@pytest.mark.parametrize("seed,n_features", [(0, 500), (1, 3000)])
def test_selection_variants_match_per_level_and_jax(variant, seed,
                                                    n_features):
    maps = _score_maps(seed)
    tcfg, jcfg = _cfg(n_features)
    n_keeps = [int(n) for n in tcfg.features_per_level]
    scores = [torch.from_numpy(m) for m in maps]
    got = getattr(torb, f"select_keypoints_{variant}")(scores, n_keeps, tcfg)
    want = getattr(jorb, f"select_keypoints_{variant}")(
        [jnp.asarray(m) for m in maps], n_keeps, jcfg)
    for lv, (g, w, s) in enumerate(zip(got, want, scores)):
        # the per-level path in every bit, up to the shortfall padding
        # both get later
        per_level = torb.select_keypoints(s, n_keeps[lv], tcfg)
        n = per_level[0].shape[0]
        padded = [torb._pad_selection(*x, n_keeps[lv])
                  for x in (g, per_level)]
        for a, b in zip(*padded):
            assert torch.equal(a, b), lv
        for a, b in zip(g, per_level):
            assert torch.equal(a[:n], b), lv
        # JAX's variant: scores and validity equal, uv on the valid rows
        uv, score, valid = (x.numpy() for x in g)
        wuv, wscore, wvalid = (np.asarray(x) for x in w)
        np.testing.assert_array_equal(score, wscore)
        np.testing.assert_array_equal(valid, wvalid)
        np.testing.assert_array_equal(uv[valid], wuv[wvalid])
        assert (wuv[~wvalid] == 0).all()
    if n_features == 3000:       # some level ran short of candidates
        assert any(g[0].shape[0] < n for g, n in zip(got, n_keeps))


@pytest.mark.parametrize("mode", ["on", "concat"])
def test_extract_orb_batch_equal_under_every_selection(monkeypatch, mode):
    rng = np.random.RandomState(7)
    imgs = torch.from_numpy((rng.rand(2, 96, 128) * 255).astype(np.float32))
    cfg = torb.OrbConfig(n_features=400, n_levels=4)
    monkeypatch.setattr(torb, "BATCHED_SELECT_MODE", "off")
    want = torb.extract_orb_batch(imgs, cfg, device="cpu")
    monkeypatch.setattr(torb, "BATCHED_SELECT_MODE", mode)
    got = torb.extract_orb_batch(imgs, cfg, device="cpu")
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool((~want.valid).any())     # invalid rows are compared too
    # and one image through extract_orb
    one = torb.extract_orb(imgs[1], cfg, device="cpu")
    for f in want._fields:
        assert torch.equal(getattr(one, f), getattr(got, f)[1]), f


@pytest.mark.parametrize("value,ok", [("concat", True), ("ON", True),
                                      ("auto", True), ("cat", False)])
def test_batched_select_switch(monkeypatch, value, ok):
    monkeypatch.setenv("ORB_BATCHED_SELECT", value)
    if ok:
        assert torb._env_mode("ORB_BATCHED_SELECT", ("concat",)) == \
            jorb._env_mode("ORB_BATCHED_SELECT", ("concat",))
    else:
        with pytest.raises(ValueError, match="auto|on|off|concat"):
            torb._env_mode("ORB_BATCHED_SELECT", ("concat",))
    # the tail switches take no extra mode
    monkeypatch.setenv("ORB_TAIL_KERNEL", "concat")
    with pytest.raises(ValueError):
        torb._env_mode("ORB_TAIL_KERNEL")
