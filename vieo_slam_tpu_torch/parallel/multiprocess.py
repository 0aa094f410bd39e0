"""Distributed BA across processes over torch.distributed.

The BA half of the JAX package's scripts/multihost_bench.py (its
multi-host proxy): `run_distributed_ba` starts `n_ranks` processes, joins
them into one process group through a FileStore in a temporary directory
(no network), and each rank runs parallel.dist_ba.distributed_ba on its
landmark shard of one problem, with one all_reduce a reduction; rank 0's
replicated poses are returned.

The backend is gloo for ranks on the CPU and NCCL for ranks on GPUs, one
GPU a rank: NCCL refuses two ranks on one card, so a NCCL world with more
ranks than visible GPUs is refused here, and never run over gloo instead.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..solvers.local_ba import BAProblem
from .dist_ba import distributed_ba, make_ba_mesh


def _rank_main(rank, n_ranks, backend, root, arrays, cam, bf, stage_iters):
    """One rank: join the group, solve its shard, rank 0 writes the
    poses.  A failure is written to err_<rank>.txt for the launcher."""
    try:
        dev = torch.device("cuda", rank) if backend == "nccl" \
            else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(root, "store"), n_ranks)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=n_ranks)
        try:
            mesh = make_ba_mesh([dev], group=dist.group.WORLD)
            prob = BAProblem(**{k: torch.from_numpy(v)
                                for k, v in arrays.items()})
            rows = mesh.local_rows(prob.pw.shape[0])
            for it in stage_iters:
                Rcw, tcw, pw = distributed_ba(prob, cam, bf, mesh, iters=it)
                full = prob.pw.clone()
                full[rows] = pw.cpu()
                prob = prob._replace(Rcw=Rcw.cpu(), tcw=tcw.cpu(), pw=full)
            if rank == 0:
                np.savez(os.path.join(root, "poses.npz"),
                         Rcw=prob.Rcw.numpy(), tcw=prob.tcw.numpy())
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_distributed_ba(prob: BAProblem, cam, bf, n_ranks: int, *,
                       backend: str, stage_iters, timeout: float = 600.0):
    """Solve `prob` over a process group of `n_ranks` ranks, one
    distributed_ba call per entry of `stage_iters` (as the global BA's
    distributed branch); M must split evenly into n_ranks shards.

    backend: "gloo" (every rank on the CPU) or "nccl" (rank r on cuda:r).
    Returns rank 0's (Rcw [K,3,3], tcw [K,3]) as numpy.  Raises
    ValueError for a NCCL world larger than the visible GPUs, RuntimeError
    when a rank fails, TimeoutError when the ranks outlast `timeout`
    seconds (they are killed)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: expected 'gloo' or 'nccl'")
    if backend == "nccl":
        n_gpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_ranks > n_gpu:
            raise ValueError(
                f"a NCCL world takes one GPU a rank: {n_ranks} ranks, "
                f"{n_gpu} visible GPUs")
    arrays = {k: np.ascontiguousarray(getattr(prob, k).detach().cpu().numpy())
              for k in BAProblem._fields}
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dist_ba_") as root:
        procs = [ctx.Process(target=_rank_main, name=f"dist_ba_rank{r}",
                             args=(r, n_ranks, backend, root, arrays, cam,
                                   float(bf), tuple(stage_iters)))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            late = [p for p in procs if p.is_alive()]
            for p in late:
                p.kill()
                p.join()
        if late:
            raise TimeoutError(f"distributed BA: {len(late)} of {n_ranks} "
                               f"ranks still running after {timeout} s")
        errors = [open(os.path.join(root, f)).read()
                  for f in sorted(os.listdir(root)) if f.startswith("err_")]
        failed = [p.exitcode for p in procs if p.exitcode != 0]
        if errors or failed:
            raise RuntimeError(f"distributed BA: rank exit codes "
                               f"{[p.exitcode for p in procs]}\n"
                               + "\n".join(errors))
        with np.load(os.path.join(root, "poses.npz")) as out:
            return out["Rcw"], out["tcw"]


CLI_ITERS = 10     # LM iterations of each solve of the command line


def _sync(devices):
    for d in set(devices):
        torch.cuda.synchronize(d)


def main(argv=None):
    """python -m vieo_slam_tpu_torch.parallel.multiprocess --ranks N: the
    multi-host harness's problem (parallel.synthetic.scaling_problem: K 32,
    M 32768, O 8), CLI_ITERS LM iterations, solved on the GPUs by the
    single-device solver (solvers.local_ba), by the in-process mesh of N
    shards on cuda:0 and, with N GPUs visible, of one shard on each of
    cuda:0..N-1, and by N NCCL ranks, one GPU each.  Prints the ms per LM
    iteration of each in-process solve (host wall time after a warm-up,
    every device synchronized), the ranks' seconds with their process
    starts, and each solve's largest pose difference from the
    single-device solver's."""
    import argparse

    from ..solvers.local_ba import local_ba
    from .synthetic import scaling_problem

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--ranks", type=int, default=2)
    n = ap.parse_args(argv).ranks
    dev = torch.device("cuda", 0)
    cam, bf, prob = scaling_problem(device=dev)

    def sharded(devices):
        mesh = make_ba_mesh(devices)
        return devices, lambda: distributed_ba(prob, cam, bf, mesh,
                                               iters=CLI_ITERS)[:2]

    solves = {"single device (local_ba)": ([dev], lambda: local_ba(
        prob, cam, bf, stage_iters=(CLI_ITERS,))[:2]),
        f"{n} shards on cuda:0": sharded([dev] * n)}
    if torch.cuda.device_count() >= n:
        solves[f"{n} GPUs in-process"] = sharded(
            [torch.device("cuda", i) for i in range(n)])
    poses = {}
    for name, (devices, solve) in solves.items():
        solve()
        _sync(devices)
        t0 = time.perf_counter()
        R, t = solve()
        _sync(devices)
        ms = 1e3 * (time.perf_counter() - t0) / CLI_ITERS
        poses[name] = (R.cpu().numpy(), t.cpu().numpy())
        print(f"{name}: {ms:.3f} ms an LM iteration", flush=True)
    t0 = time.perf_counter()
    poses[f"{n} NCCL ranks"] = run_distributed_ba(
        prob, cam, bf, n, backend="nccl", stage_iters=(CLI_ITERS,))
    print(f"{n} NCCL ranks: {time.perf_counter() - t0:.1f} s with the "
          f"process starts", flush=True)
    R1, t1 = poses["single device (local_ba)"]
    for name, (R, t) in poses.items():
        print(f"{name}: poses against the single-device solver R "
              f"{np.abs(R - R1).max():.3g}, t {np.abs(t - t1).max():.3g}")


if __name__ == "__main__":
    main()
