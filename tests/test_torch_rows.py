"""The port's evaluate_ntimes rows against the JAX package's: the keys of
a row's numbers, and the two-view initialization of the mono_loop row.

The mono_loop row's first two frames (noise seed 11) are built by both
packages and matched; the JAX package's `monocular_init` with its key for
frame 1 (`PRNGKey(1)`: the tracker keys the draw with its frame count)
accepts the pair.  Handed the same `jax.random.categorical` hypotheses,
the port's `monocular_init_from_indices` accepts it too, with as many
good points, and the port's own draw for the key of frame 1 gives those
very hypotheses and accepts the pair: the row initializes at the JAX
package's frame (ROADMAP.md §C item 6).

Tolerances: match counts equal; good-point counts within 2 (f32 DLT).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vieo_slam_tpu.cameras import models as jcm
from vieo_slam_tpu.frontend import frame as jframe
from vieo_slam_tpu.ops import matching as jmatching
from vieo_slam_tpu.ops import orb as jorb
from vieo_slam_tpu.solvers import initializer as jinit
from vieo_slam_tpu_torch.examples import evaluate_ntimes as ev
from vieo_slam_tpu_torch.frontend import frame as tframe
from vieo_slam_tpu_torch.ops import matching as tmatching
from vieo_slam_tpu_torch.solvers import initializer as tinit
from vieo_slam_tpu_torch.utils import prng

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_once_returns_jax_keys():
    got = ev.run_once("stereo_lem", 11, n_frames=6, device="cpu")
    ref = json.load(open(os.path.join(ROOT, "ACCURACY_r05.json")))
    want = [k[4:] for k in ref["scenarios"]["stereo_lem"]
            if k.startswith("avg_")]
    assert list(got) == want
    assert all(isinstance(v, float) for v in got.values())
    assert np.isfinite(got["rmse_fullBA"]) and got["rmse_fullBA"] < 0.02


def _pairs(f0, f1, idx):
    """The tracker's padded match arrays (uv1, uv2, valid)."""
    rows = np.nonzero(idx >= 0)[0]
    n = f0.shape[0]
    uv1 = np.zeros((n, 2), np.float32)
    uv2 = np.zeros((n, 2), np.float32)
    val = np.zeros(n, bool)
    uv1[:rows.size] = f0[rows]
    uv2[:rows.size] = f1[idx[rows]]
    val[:rows.size] = True
    return uv1, uv2, val


def test_mono_loop_init_is_decided_by_the_draw():
    # The JAX row runs with x64 off (the suite turns it on): its draws and
    # f32 arithmetic are those of x64 off.
    jax.config.update("jax_enable_x64", False)
    try:
        _mono_loop_init()
    finally:
        jax.config.update("jax_enable_x64", True)


def _mono_loop_init():
    row = ev.Row("mono_loop", 11, 2, "cpu")
    images = [row.prepare(i)[0] for i in range(2)]
    tf = [tframe.build_mono_frame(torch.from_numpy(im), row.sc.ocfg,
                                  timestamp=0.1 * i, device="cpu")
          for i, im in enumerate(images)]
    jcfg = jorb.OrbConfig(n_features=1000, n_levels=4)
    build = jax.jit(lambda im: jframe.build_mono_frame(im, jcfg))
    jf = [build(jnp.asarray(im)) for im in images]
    t_idx, _ = tmatching.match_descriptors(
        tf[0].desc, tf[1].desc, tf[0].valid, tf[1].valid, max_dist=60,
        ratio=0.8)
    j_idx, _ = jmatching.match_descriptors(
        jf[0].desc, jf[1].desc, jf[0].valid, jf[1].valid, max_dist=60,
        ratio=0.8)
    t_idx, j_idx = t_idx.numpy(), np.asarray(j_idx)
    assert (t_idx >= 0).sum() == (j_idx >= 0).sum() >= 100
    uv1, uv2, val = _pairs(tf[0].uv.numpy(), tf[1].uv.numpy(), t_idx)
    ju1, ju2, jval = _pairs(np.asarray(jf[0].uv), np.asarray(jf[1].uv),
                            j_idx)
    jcam = jcm.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480)
    key = jax.random.PRNGKey(1)
    want = jinit.monocular_init(jnp.asarray(ju1), jnp.asarray(ju2),
                                jnp.asarray(jval), jcam, key)
    hyp = np.asarray(jax.random.categorical(
        key, jnp.where(jnp.asarray(val), 0.0, -1e9), shape=(256, 8)))
    T = torch.from_numpy
    same_draw = tinit.monocular_init_from_indices(
        T(uv1), T(uv2), T(val), row.sc.cam, T(hyp.astype(np.int64)))
    np.testing.assert_array_equal(
        tinit.draw_hypotheses(T(val), prng.prng_key(1)).numpy(), hyp)
    own_draw = tinit.monocular_init(T(uv1), T(uv2), T(val), row.sc.cam,
                                    prng.prng_key(1))
    assert bool(want.ok) and bool(same_draw.ok) and bool(own_draw.ok)
    assert abs(int(same_draw.n_good) - int(want.n_good)) <= 2
    assert int(own_draw.n_good) == int(same_draw.n_good)


def test_row_parity_scales_the_jax_example():
    """scripts/row_parity.py runs the JAX example at another size by
    rewriting its camera and ORB lines in memory: the camera is the port's
    scenario() camera at that width, the ORB configuration the one asked
    for, and at the rows' own size the source is unchanged in effect."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "row_parity", os.path.join(ROOT, "scripts", "row_parity.py"))
    rp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rp)
    src = rp.jax_example_source(752, 1200, 8)
    assert rp.JAX_CAMERA not in src and rp.JAX_ORB not in src
    assert "OrbConfig(n_features=1200, n_levels=8)" in src
    ns = {}
    exec(src[src.index("    cam = cm.make_pinhole"):
             src.index("    bf = fx")].strip(),
         {"cm": jcm, "fx": 400.0}, ns)
    sc = ev.scenario("stereo_loop", 4, 752, 1200, 8)
    for a in ("fx", "fy", "cx", "cy", "width", "height"):
        assert float(np.asarray(getattr(ns["cam"], a))) \
            == float(getattr(sc.cam, a)), a
    assert sc.ocfg.n_features == 1200 and sc.ocfg.n_levels == 8
    own = rp.jax_example_source(640, None, 4)
    assert 'n_features=1000 if base == "mono" else 600, n_levels=4' in own
    assert "cm.make_pinhole(fx * 1.0, fx * 1.0, 320.0, 240.0, 640, 480)" \
        in own
