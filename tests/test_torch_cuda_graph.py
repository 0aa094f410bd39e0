"""utils.cuda_graph.GraphedCall, the CUDA-graph replay of the VIO solvers.

On the CPU it is the plain call and captures nothing; the layout keys of
the window BA's chain blocks (the call site with non-tensor arguments)
are hashable and tell the modes apart.  On the GPU (tests marked `cuda`,
skipped elsewhere; run with
`python -m pytest --noconftest tests/test_torch_cuda_graph.py -m cuda`)
each layout replays its own graph, equal to the plain call; a capture on
one thread succeeds while another thread allocates, copies from the host
and syncs its stream; and a background thread under no_capture() runs a
new layout plain until capture_pending() captures it on the caller's
thread, then replays it.  Tolerance: none (a replay runs the plain call's
kernels on the same inputs).
"""

import threading

import numpy as np
import pytest
import torch

from vieo_slam_tpu_torch.utils.cuda_graph import (GraphedCall,
                                                  capture_pending, layout,
                                                  no_capture)

torch.set_num_threads(1)


def poly(x, y, scale=2.0, *, shift=None):
    out = torch.sin(x) * scale + y @ y.T
    return out if shift is None else (out + shift, out.sum())


def test_cpu_tensors_take_the_plain_call():
    g = GraphedCall(poly)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 4).astype(np.float32))
    y = torch.from_numpy(rng.randn(4, 3).astype(np.float32))
    for kw in ({}, {"shift": torch.ones(4, 4)}):
        got = g(x, y, 3.0, **kw)
        want = poly(x, y, 3.0, **kw)
        for a, b in zip(*(torch.utils._pytree.tree_flatten(v)[0]
                          for v in (got, want))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert g.graphs == {}


def test_chain_block_layouts_are_keys():
    """The window BA through a chain_blocks_graph() on the CPU: the same
    result as without it, nothing captured, and the layouts of its calls
    hashable, one for each mode (cost only, linearized, robust)."""
    import test_torch_vio_components as comp
    from vieo_slam_tpu_torch import convert
    from vieo_slam_tpu_torch.solvers import vio_local_ba as tvlba

    prob, _, cam, cfg = comp.make_problem(seed=5, K=6, M=60, scale_map=0.8)
    prob = comp.port_problem(comp.f32_problem(prob))
    tcam, tcfg = convert.camera_from_jax(cam), comp.port_cfg(cfg)
    graph = tvlba.chain_blocks_graph()
    seen = []

    def spy(*args, **kwargs):
        flat, spec = torch.utils._pytree.tree_flatten((args, kwargs))
        seen.append(layout(flat, spec))
        return tvlba._chain_blocks(*args, **kwargs)

    graph.fn = spy
    kw = dict(stage_iters=(2, 2), opt_scale=True, opt_gdir=True,
              robust_chains=True)
    got = tvlba.vio_ba(prob, tcam, tcfg, graph=graph, **kw)
    want = tvlba.vio_ba(prob, tcam, tcfg, **kw)
    for a, b in zip(got.ns, want.ns):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert graph.graphs == {} and seen
    keys = {hash(k) for k in seen}
    # The cost-only and the linearizing calls at least.
    assert 2 <= len(keys) <= 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph is captured on the card")
    return torch.device("cuda", 0)


def _flat(v):
    return torch.utils._pytree.tree_flatten(v)[0]


@pytest.mark.cuda
def test_each_layout_replays_its_graph(dev):
    g = GraphedCall(poly)
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, scale in ((4, 2.0), (6, 2.0), (4, 3.0), (4, 2.0)):
        x = torch.randn(n, n, generator=gen, device=dev)
        y = torch.randn(n, 3, generator=gen, device=dev)
        got, want = g(x, y, scale), poly(x, y, scale)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = g(x, y, 2.0, shift=torch.ones(4, 4, device=dev))
    want = poly(x, y, 2.0, shift=torch.ones(4, 4, device=dev))
    for a, b in zip(_flat(got), _flat(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(g.graphs) == 4


@pytest.mark.cuda
def test_capture_while_another_thread_works(dev):
    """Graphs captured on one thread while another allocates,
    copies host memory to the card and reads results back, as the
    tracking thread does while the mapping worker captures the window
    BA's chain blocks."""
    stop, errors = threading.Event(), []

    def busy():
        rng = np.random.RandomState(1)
        while not stop.is_set():
            a = torch.from_numpy(rng.randn(257, 129).astype(np.float32))
            b = a.to(dev) @ a.to(dev).T
            float(b.sum().item())

    def capture():
        try:
            for n in range(8, 40):
                g = GraphedCall(poly)
                x = torch.randn(n, n, device=dev)
                y = torch.randn(n, 5, device=dev)
                got = g(x, y, 1.5)
                torch.testing.assert_close(got, poly(x, y, 1.5), rtol=0,
                                           atol=0)
        except Exception as e:      # re-raised on the main thread
            errors.append(e)

    t = threading.Thread(target=capture)
    other = threading.Thread(target=busy)
    other.start()
    t.start()
    t.join()
    stop.set()
    other.join()
    assert not errors, errors


@pytest.mark.cuda
def test_background_layouts_are_captured_by_the_caller(dev):
    g = GraphedCall(poly)
    x = torch.randn(9, 9, device=dev)
    y = torch.randn(9, 4, device=dev)
    got = {}

    def background(tag):
        with no_capture():
            got[tag] = g(x, y, 0.5)

    t = threading.Thread(target=background, args=("first",), name="bg")
    t.start()
    t.join()
    assert g.graphs == {}
    assert capture_pending() == 1 and capture_pending() == 0
    (c,) = g.graphs.values()
    assert c.thread == threading.current_thread().name
    t = threading.Thread(target=background, args=("second",), name="bg")
    t.start()
    t.join()
    assert c.replays["bg"] == 1
    for v in got.values():
        torch.testing.assert_close(v, poly(x, y, 0.5), rtol=0, atol=0)
