"""The card build of the extraction stages (csrc/xla_f32.cu) against their
CPU build (csrc/xla_f32_host.cc), bit for bit, at edge shapes: resize
passes at table and off-table shapes, one-pixel and one-column outputs;
the IC angle of no, one and many patches and of views into larger ones;
BRIEF with and without tap bounds; the blur at its smallest window and in
batches; atan2, sin and cos at special values; extract_orb_batch of a
stereo pair on both devices.  The CPU build is the one the CPU tests hold
to the JAX package and glibc (tests/test_torch_xla_exact.py).

These tests need an NVIDIA GPU and nvcc and skip elsewhere.  Run them on
the card with

    python -m pytest --noconftest tests/test_torch_xla_f32_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from vieo_slam_tpu_torch.ops import orb, xla_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the card build runs only on the card")
    return torch.device("cuda", 0)


def same_bits(card, cpu):
    """Equal bits; a NaN equals a NaN (the card's NaNs are canonical, the
    CPU's carry x86's sign and payload)."""
    a = card.cpu().contiguous().numpy()
    b = cpu.contiguous().numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    if not a.size:
        return
    differ = a.view(np.uint8).reshape(*a.shape, -1) \
        != b.view(np.uint8).reshape(*b.shape, -1)
    differ = differ.any(-1)
    if a.dtype.kind == "f":
        differ &= ~(np.isnan(a) & np.isnan(b))
    assert not differ.any(), (np.flatnonzero(differ)[:5], a[differ][:5],
                              b[differ][:5])


@pytest.mark.parametrize("shape,out", [((480, 752), (400, 627)),
                                       ((480, 640), (400, 533)),
                                       ((100, 150), (83, 125)),
                                       ((40, 41), (1, 34)),
                                       ((33, 300), (28, 1))])
def test_resize(dev, shape, out):
    img = torch.from_numpy(np.random.RandomState(sum(shape)).rand(*shape)
                           .astype(np.float32) * 255)
    same_bits(xla_f32.resize(img.to(dev), *out), xla_f32.resize(img, *out))


@pytest.mark.parametrize("n", [0, 1, 257, 2400])
def test_ic_angle(dev, n):
    big = torch.from_numpy(np.random.RandomState(n).rand(n, 53, 53)
                           .astype(np.float32) * 255)
    view = big[:, 11:42, 11:42]
    a_card, m_card = xla_f32.ic_angle(view.to(dev), moments=True)
    a_cpu, m_cpu = xla_f32.ic_angle(view, moments=True)
    same_bits(a_card, a_cpu)
    same_bits(m_card, m_cpu)


@pytest.mark.parametrize("n", [0, 1, 300])
def test_brief(dev, n):
    rng = np.random.RandomState(n)
    patches = torch.from_numpy(rng.rand(n, 47, 47).astype(np.float32) * 255)
    ang = torch.from_numpy((rng.rand(n) * 7 - 3.5).astype(np.float32))
    lo = rng.randint(0, 10, (n, 2))
    hi = 46 - rng.randint(0, 10, (n, 2))
    box = torch.from_numpy(np.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]],
                                    -1).astype(np.int32))
    for b in (None, box):
        same_bits(xla_f32.brief(patches.to(dev), ang.to(dev),
                                orb.BRIEF_PATTERN,
                                None if b is None else b.to(dev)),
                  xla_f32.brief(patches, ang, orb.BRIEF_PATTERN, b))


@pytest.mark.parametrize("shape", [(1, 7, 7), (3, 53, 53), (2, 70, 9)])
def test_blur7(dev, shape):
    x = torch.from_numpy(np.random.RandomState(7).rand(*shape)
                         .astype(np.float32) * 255)
    same_bits(xla_f32.blur7_valid(x.to(dev)), xla_f32.blur7_valid(x))
    same_bits(xla_f32.gaussian_blur7(x.to(dev)), xla_f32.gaussian_blur7(x))


def test_libm_special_values(dev):
    v = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e-45,
                  -1e-45, 1e-40, 1.2e-38, 3e38, -3e38, 0.7853982, 120.0,
                  119.99, 1e30, np.pi], np.float32)
    y = torch.from_numpy(np.repeat(v, len(v)))
    x = torch.from_numpy(np.tile(v, len(v)))
    same_bits(xla_f32.atan2(y.to(dev), x.to(dev)), xla_f32.atan2(y, x))
    for fn in (xla_f32.sin, xla_f32.cos):
        same_bits(fn(x.to(dev)), fn(x))


def test_extract_orb_batch(dev):
    rng = np.random.RandomState(3)
    pair = (rng.rand(2, 240, 320) * 200 + 20).astype(np.float32)
    pair[:, rng.randint(20, 220, 300), rng.randint(20, 300, 300)] = 255.0
    cfg = orb.OrbConfig(600, 8)
    card = orb.extract_orb_batch(torch.from_numpy(pair).to(dev), cfg)
    cpu = orb.extract_orb_batch(pair, cfg, device="cpu")
    for a, b in zip(card, cpu):
        same_bits(a, b)
