"""Dense Levenberg-Marquardt core for small manifold problems.

Port of vieo_slam_tpu/solvers/lm.py.  `lax.scan` becomes a Python loop;
the accept/reject decisions stay tensor `where`s so a solve never waits
on the device.  Conventions: residual r, step dx minimizes ||r + J dx||^2,
b = -J^T W r, (H + lambda I) dx = b, x <- retract(x, dx).  An estimate x
is a tuple of tensors.
"""

from __future__ import annotations

from typing import Callable

import torch


def _pick(cond: torch.Tensor, a, b):
    return tuple(torch.where(cond, u, v) for u, v in zip(a, b))


def lm_solve(system_fn: Callable, cost_fn: Callable, retract_fn: Callable,
             x0, *, iters: int, init_lambda_factor: float = 1e-5,
             min_diag: float = 1e-10):
    """Run `iters` LM steps with Marquardt-Nielsen damping adaptation.

    Returns (x_final, final_cost, H at x_final)."""
    H0, _, c0 = system_fn(x0)
    dt = H0.dtype
    lam = init_lambda_factor * torch.clamp_min(torch.diagonal(H0).max(),
                                               min_diag)
    nu = torch.full((), 2.0, dtype=dt, device=H0.device)
    cost = c0.to(dt)
    x = tuple(x0)
    eye = torch.eye(H0.shape[0], dtype=dt, device=H0.device)
    for _ in range(iters):
        H, b, _ = system_fn(x)
        # solve_ex: no host-side singularity check (a device sync), so
        # that a CUDA graph can capture the loop; H + lam I is positive
        # definite for lam > 0.
        dx = torch.linalg.solve_ex(H + lam * eye, b)[0]
        x_new = tuple(a.to(ref.dtype) for a, ref in zip(retract_fn(x, dx), x))
        new_cost = cost_fn(x_new).to(dt)
        pred = 0.5 * torch.dot(dx, lam * dx + b)
        gain = (cost - new_cost) / torch.clamp_min(pred, 1e-30)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        lam_acc = lam * torch.clamp_min(1.0 - (2.0 * gain - 1.0) ** 3,
                                        1.0 / 3.0)
        x = _pick(accept, x_new, x)
        lam = torch.where(accept, lam_acc, lam * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        cost = torch.where(accept, new_cost, cost)
    H_f, _, _ = system_fn(x)
    return x, cost, H_f


def lm_solve_parallel(system_fn: Callable, cost_fn: Callable,
                      retract_fn: Callable, x0, *, iters: int,
                      n_lambda: int = 4, init_lambda_factor: float = 1e-5,
                      min_diag: float = 1e-10):
    """LM with `n_lambda` damping candidates per iteration (one decade
    apart): all candidate steps are solved and costed, the best one is
    taken.  Same contract as lm_solve."""
    H0, _, c0 = system_fn(x0)
    dt = H0.dtype
    dev = H0.device
    lam = init_lambda_factor * torch.clamp_min(torch.diagonal(H0).max(),
                                               min_diag)
    spread = 10.0 ** torch.arange(-1, n_lambda - 1, dtype=dt, device=dev)
    eye = torch.eye(H0.shape[0], dtype=dt, device=dev)
    x = tuple(x0)
    cost = c0.to(dt)
    for _ in range(iters):
        H, b, _ = system_fn(x)
        lams = lam * spread                                   # [K]
        A = H[None] + lams[:, None, None] * eye
        dxs = torch.linalg.solve_ex(
            A, b.expand(n_lambda, -1)[..., None])[0][..., 0]
        cands = [retract_fn(x, dxs[k]) for k in range(n_lambda)]
        costs = torch.stack([cost_fn(c) for c in cands]).to(dt)
        best = torch.argmin(costs)
        improved = (costs[best] < cost) & torch.isfinite(costs[best])
        stacked = [torch.stack([c[i] for c in cands]) for i in range(len(x))]
        x = _pick(improved, tuple(s[best].to(o.dtype)
                                  for s, o in zip(stacked, x)), x)
        lam = torch.where(improved, torch.clamp_min(lams[best] / 3.0, 1e-12),
                          lam * (10.0 ** (n_lambda - 1)))
        cost = torch.where(improved, costs[best], cost)
    H_f, _, _ = system_fn(x)
    return x, cost, H_f


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """Huber IRLS weight of the squared Mahalanobis residual."""
    safe = torch.clamp_min(chi2, 1e-30)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / safe))


def huber_cost(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """rho(chi2): chi2 inside the basin, 2 delta |r| - delta^2 outside."""
    delta2 = torch.as_tensor(delta2, dtype=chi2.dtype, device=chi2.device)
    r = torch.sqrt(torch.clamp_min(chi2, 1e-30))
    delta = torch.sqrt(delta2)
    return torch.where(chi2 <= delta2, chi2, 2.0 * delta * r - delta2)
