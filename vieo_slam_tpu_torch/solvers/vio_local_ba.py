"""VIO backend bundle adjustment: NavState windows with IMU/encoder chains.

Port of vieo_slam_tpu/solvers/vio_local_ba.py, one engine for the PRV
sliding-window local BA and the global / VI-init BA (optional scale and
gravity-direction extras, initial-bias prior):
  - State: one 15D tangent per keyframe in NavState.inc_pvr_bias order
    [dp, dv, dphi, dbg, dba], plus 3 global extras [dtheta_x, dtheta_y,
    dlog_s] for gravity direction and scale.
  - Vision: reprojection touches the [dp, dphi] slots; the landmark block
    is Schur-eliminated (per-keyframe sums and the pose-pair fill with
    `index_add_`, as in solvers/local_ba) in 6D and embedded into the
    dense [15K + 3] system, solved with torch.linalg.solve.  Landmarks are
    back-substituted each iteration.
  - Chains: whitened IMU (9D) + bias (6D) + encoder (6D) residuals per
    consecutive-keyframe pair; their Jacobians come from
    torch.func.vmap(torch.func.jacfwd(...)) over the chains.
  - Scale gauge: the visual frame is kept and the IMU residual sees
    p_metric = s * p_visual; the caller rescales the map by s afterwards.
  - Gravity: g(theta) = Rwi Exp([tx, ty, 0]) [0, 0, |g|] with Rwi chosen so
    theta = 0 reproduces the current estimate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from ..cameras import models as cm
from ..math import lie
from ..math.navstate import NavState
from ..math.preintegration import EncPreint, ImuPreint
from ..utils.cuda_graph import GraphedCall
from . import imu_factors
from .local_ba import _segment_sum, inv3x3
from .lm import huber_cost, huber_weight
from .motion_ba import CHI2_MONO, CHI2_STEREO
from .vio_ba import _chol_upper, _clamp_blocks, _solve

CHI2_IMU9 = 16.919    # chi2(0.05, 9)
CHI2_BIAS6 = 12.592   # chi2(0.05, 6)
CHI2_ENC6 = 12.592


class VioBAProblem(NamedTuple):
    """Fixed-capacity VIO BA problem.

    ns: NavState batched [K] (window keyframes first, then the fixed ring);
    fixed_pr / fixed_vb [K] bool: pose, resp. velocity + bias held.
    Vision block as in local_ba.BAProblem: pw [M, 3], lm_valid [M],
    obs_kf [M, O], obs_uv [M, O, 2], obs_ur [M, O], obs_inv_sigma2 [M, O],
    obs_valid [M, O].  Chains (local keyframe indices): chain_i, chain_j
    [C] int64, chain_valid [C] bool, chain_weight [C], imu_pre ImuPreint
    [C]; enc_pre EncPreint [C] with enc_valid [C].  Bias prior: unary on
    keyframe prior_idx (an int) with diagonal information prior_info6 [6]
    (zeros disable)."""

    ns: NavState
    fixed_pr: torch.Tensor
    fixed_vb: torch.Tensor
    pw: torch.Tensor
    lm_valid: torch.Tensor
    obs_kf: torch.Tensor
    obs_uv: torch.Tensor
    obs_ur: torch.Tensor
    obs_inv_sigma2: torch.Tensor
    obs_valid: torch.Tensor
    chain_i: torch.Tensor
    chain_j: torch.Tensor
    chain_valid: torch.Tensor
    chain_weight: torch.Tensor
    imu_pre: ImuPreint
    enc_pre: EncPreint
    enc_valid: torch.Tensor
    prior_idx: int
    prior_info6: torch.Tensor


class VioBAConfig(NamedTuple):
    Rcb: torch.Tensor
    tcb: torch.Tensor
    bf: torch.Tensor
    gravity: torch.Tensor        # current gravity estimate [3]
    sigma_bg_rw: float = 2e-4
    sigma_ba_rw: float = 2e-3
    Rbe: Optional[torch.Tensor] = None   # encoder extrinsic (body-from-enc)
    tbe: Optional[torch.Tensor] = None


class VioBAResult(NamedTuple):
    ns: NavState
    pw: torch.Tensor
    obs_inlier: torch.Tensor
    cost: torch.Tensor
    scale: torch.Tensor       # exp(dlog_s): 1 unless opt_scale
    gravity: torch.Tensor     # refined gravity (the input unless opt_gdir)


def _gravity_frame(gw: torch.Tensor):
    """Rwi with Rwi [0, 0, |g|] == gw."""
    gnorm = torch.linalg.norm(gw)
    eye = torch.eye(3, dtype=gw.dtype, device=gw.device)
    gI = eye[2]
    gdir = gw / torch.clamp_min(gnorm, 1e-9)
    v = torch.linalg.cross(gI, gdir)
    s = torch.linalg.norm(v)
    c = torch.dot(gI, gdir)
    vx = lie.hat(v)
    R = eye + vx + vx @ vx * ((1 - c) / torch.clamp_min(s * s, 1e-12))
    flip = eye - 2.0 * torch.diag(1.0 - eye[0])          # diag(1, -1, -1)
    R = torch.where(s < 1e-8, torch.where(c > 0, eye, flip), R)
    return R, gnorm


def _gravity_of(dg, gravity, Rwi, gnorm, opt_gdir: bool):
    if not opt_gdir:
        return gravity.to(dg.dtype)
    th = torch.cat([dg[:2], torch.zeros_like(dg[:1])])
    e3 = torch.eye(3, dtype=dg.dtype, device=dg.device)[2]
    return Rwi @ lie.so3_exp(th) @ e3 * gnorm


def _vision_terms(ns: NavState, pw, prob: VioBAProblem, cam, cfg):
    """Per-observation residual [M, O, 3] and Jacobians wrt the navstate
    [dp, dphi] tangent [M, O, 3, 6] and the landmark [M, O, 3, 3].
    pc = Rcb (Rwb^T (pw - pwb)) + tcb, so dpc/ddp = -Rcb and
    dpc/ddphi = Rcb hat(q) with q = Rwb^T (pw - pwb)."""
    kf = prob.obs_kf.clamp_min(0).long()
    Rwb = ns.R[kf]
    pwb = ns.p[kf]
    q = torch.einsum("moji,moj->moi", Rwb, pw[:, None, :] - pwb)
    Rcb = cfg.Rcb
    pc = torch.einsum("ij,moj->moi", Rcb, q) + cfg.tcb
    uv_hat, Jproj = cm.project_jacobian(cam, pc)
    z = pc[..., 2]
    depth_ok = z > 1e-3
    inv_z = 1.0 / torch.where(depth_ok, z, torch.ones_like(z))
    stereo = prob.obs_ur >= 0
    bf = cfg.bf
    r_uv = prob.obs_uv - uv_hat
    ur_hat = uv_hat[..., 0] - bf * inv_z
    r_ur = torch.where(stereo, prob.obs_ur - ur_hat, torch.zeros_like(ur_hat))
    r = torch.cat([r_uv, r_ur[..., None]], dim=-1)
    M, O = z.shape
    Jpc_pose = torch.cat([-Rcb.expand(M, O, 3, 3), Rcb @ lie.hat(q)], dim=-1)
    Juv_pose = Jproj @ Jpc_pose
    Jur_pose = Juv_pose[..., 0, :] + bf * (inv_z ** 2)[..., None] \
        * Jpc_pose[..., 2, :]
    Jur_pose = torch.where(stereo[..., None], Jur_pose,
                           torch.zeros_like(Jur_pose))
    Jp = -torch.cat([Juv_pose, Jur_pose[..., None, :]], dim=-2)
    Rcw = Rcb @ Rwb.transpose(-1, -2)
    Juv_lm = Jproj @ Rcw
    Jur_lm = Juv_lm[..., 0, :] + bf * (inv_z ** 2)[..., None] * Rcw[..., 2, :]
    Jur_lm = torch.where(stereo[..., None], Jur_lm, torch.zeros_like(Jur_lm))
    Jl = -torch.cat([Juv_lm, Jur_lm[..., None, :]], dim=-2)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    delta2 = torch.where(stereo, CHI2_STEREO, CHI2_MONO).to(chi2.dtype)
    return r, Jp, Jl, chi2, delta2, depth_ok


def _chain_residual(dxi, dxj, dg, ns_i: NavState, ns_j: NavState,
                    pre: ImuPreint, enc: EncPreint, L_imu, L_bias, L_enc,
                    enc_on, ext, opt_scale: bool, opt_gdir: bool,
                    use_enc: bool):
    """Whitened 21D chain residual [imu(9), bias(6), enc(6)] at tangent
    increments (dxi, dxj) and global extras dg = [tx, ty, dlog_s]; ext =
    (gravity, Rwi, |g|, Rbe, tbe)."""
    gravity, Rwi, gnorm, Rbe, tbe = ext
    ni = ns_i.inc_pvr_bias(dxi)
    nj = ns_j.inc_pvr_bias(dxj)
    gw = _gravity_of(dg, gravity, Rwi, gnorm, opt_gdir)
    if opt_scale:
        s = torch.exp(dg[2])
        ni = ni._replace(p=ni.p * s)
        nj = nj._replace(p=nj.p * s)
    parts = [L_imu @ imu_factors.imu_residual_prv(ni, nj, pre, gw),
             L_bias * imu_factors.bias_rw_residual(ni, nj)]
    if use_enc:
        r_enc = imu_factors.encoder_residual(ni, nj, enc, Rbe, tbe)
        parts.append(enc_on * (L_enc @ r_enc))
    else:
        parts.append(torch.zeros_like(dxi[:6]))
    return torch.cat(parts)


def _take(ns: NavState, idx) -> NavState:
    return NavState(*(x[idx] for x in ns))


def chain_blocks_graph() -> GraphedCall:
    """The chain blocks as a GraphedCall, for vio_ba's `graph`."""
    return GraphedCall(_chain_blocks)


def _chain_system(ns, dg0, prob: VioBAProblem, cfg, Rwi, gnorm, opt_scale,
                  opt_gdir, use_enc, *, irls=False, jacobian=True,
                  graph=None):
    """Per-chain GN blocks: H [C, 33, 33], b [C, 33] and the chains' cost;
    with jacobian=False the cost alone (no Jacobian is formed, as a
    compiled program drops an unused one).  `graph`, from
    chain_blocks_graph(), replays the blocks on a GPU from a CUDA graph
    for each chain count and mode."""
    args = (_take(ns, prob.chain_i), _take(ns, prob.chain_j), dg0,
            prob.imu_pre, prob.enc_pre, prob.enc_valid, prob.chain_weight,
            prob.chain_valid, (cfg.gravity, Rwi, gnorm, cfg.Rbe, cfg.tbe))
    static = dict(sigma_bg_rw=cfg.sigma_bg_rw, sigma_ba_rw=cfg.sigma_ba_rw,
                  opt_scale=opt_scale, opt_gdir=opt_gdir, use_enc=use_enc,
                  irls=irls, jacobian=jacobian)
    return (graph or _chain_blocks)(*args, **static)


def _chain_blocks(ns_i, ns_j, dg0, imu_pre, enc_pre, enc_valid,
                  chain_weight, chain_valid, ext, *, sigma_bg_rw, sigma_ba_rw,
                  opt_scale, opt_gdir, use_enc, irls, jacobian):
    """_chain_system on the chains' own states (ns_i, ns_j [C])."""
    dtype, dev = ns_i.p.dtype, ns_i.p.device
    info_imu = imu_factors.imu_info_prv(imu_pre)
    L_imu = _chol_upper(info_imu + 1e-12 * torch.eye(9, dtype=dtype,
                                                      device=dev))
    dt = torch.clamp_min(imu_pre.dt, 1e-6)
    ig = 1.0 / (sigma_bg_rw ** 2 * dt)
    ia = 1.0 / (sigma_ba_rw ** 2 * dt)
    L_bias = torch.sqrt(torch.cat([ig[:, None].expand(-1, 3),
                                   ia[:, None].expand(-1, 3)], dim=-1))
    C = ns_i.p.shape[0]
    if use_enc:
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        info_e = torch.linalg.inv_ex(enc_pre.cov + 1e-9 * eye6)[0]
        L_enc = _chol_upper(0.5 * (info_e + info_e.transpose(-1, -2))
                            + 1e-12 * eye6)
        enc_on = enc_valid.to(dtype)
    else:
        L_enc = torch.zeros((C, 6, 6), dtype=dtype, device=dev)
        enc_on = torch.zeros(C, dtype=dtype, device=dev)
    z15 = torch.zeros(15, dtype=dtype, device=dev)
    d0 = torch.cat([z15, z15, dg0])
    one = torch.ones((), dtype=dtype, device=dev)
    th = {k: torch.full((), v, dtype=dtype, device=dev) for k, v in
          (("imu", CHI2_IMU9), ("bias", CHI2_BIAS6), ("enc", CHI2_ENC6))}

    def block(nsi, nsj, pre, enc, Li, Lb, Le, eo, w_c):
        def f(d):
            return _chain_residual(d[:15], d[15:30], d[30:33], nsi, nsj, pre,
                                   enc, Li, Lb, Le, eo, ext, opt_scale,
                                   opt_gdir, use_enc)
        r = f(d0)
        chi = (torch.sum(r[:9] ** 2), torch.sum(r[9:15] ** 2),
               torch.sum(r[15:21] ** 2))
        # The backend adds its chain edges without robust kernels unless
        # asked: a Huber on heavily violated chains (a scale-off init GBA)
        # saturates the gradient and stalls convergence.
        if irls:
            ws = [huber_weight(c, th[k]) for c, k in
                  zip(chi, ("imu", "bias", "enc"))]
            cost = sum(huber_cost(c, th[k]) for c, k in
                       zip(chi, ("imu", "bias", "enc"))) * w_c
        else:
            ws = [one, one, one]
            cost = (chi[0] + chi[1] + chi[2]) * w_c
        if not jacobian:
            return cost
        J = jacfwd(f)(d0)                                   # [21, 33]
        sw = torch.sqrt(torch.cat([ws[0].expand(9), ws[1].expand(6),
                                   ws[2].expand(6)])) * torch.sqrt(w_c)
        rw = r * sw
        Jw = J * sw[:, None]
        return Jw.T @ Jw, -Jw.T @ rw, cost

    out = vmap(block)(ns_i, ns_j, imu_pre, enc_pre, L_imu, L_bias, L_enc,
                      enc_on, chain_weight.to(dtype))
    cv = chain_valid.to(dtype)
    if not jacobian:
        return torch.sum(out * cv)
    H, b, cost = out
    return H * cv[:, None, None], b * cv[:, None], torch.sum(cost * cv)


def _prior_terms(ns: NavState, prob: VioBAProblem):
    """Initial-bias prior residual (6D) on keyframe prior_idx."""
    i = prob.prior_idx
    return torch.cat([ns.bg[i] + ns.dbg[i], ns.ba[i] + ns.dba[i]])


def _vision_cost(ns, pw, prob, cam, cfg, active):
    _, _, _, chi2, delta2, depth_ok = _vision_terms(ns, pw, prob, cam, cfg)
    w_act = (active & prob.obs_valid).to(chi2.dtype)
    penalty = huber_cost(torch.full_like(chi2, 1e4), delta2)
    return torch.sum(huber_cost(chi2, delta2) * w_act * depth_ok) \
        + torch.sum(penalty * w_act * (~depth_ok))


def _total_cost(ns, pw, dg, prob, cam, cfg, active, Rwi, gnorm, opt_scale,
                opt_gdir, use_enc, robust, graph):
    c = _vision_cost(ns, pw, prob, cam, cfg, active)
    chain_cost = _chain_system(ns, dg, prob, cfg, Rwi, gnorm, opt_scale,
                               opt_gdir, use_enc, irls=robust,
                               jacobian=False, graph=graph)
    rp = _prior_terms(ns, prob)
    return c + chain_cost + torch.sum(rp * prob.prior_info6 * rp)


def _iteration(ns, pw, dg, prob: VioBAProblem, cam, cfg, active, lam, Rwi,
               gnorm, opt_scale, opt_gdir, use_enc, robust, graph):
    """One damped Schur step over the [15K + 3] system."""
    K = ns.p.shape[0]
    dtype, dev = ns.p.dtype, ns.p.device
    # The vision slots [dp, dphi] of the 15D tangent [dp, dv, dphi, ...].
    vi = torch.cat([torch.arange(0, 3, device=dev),
                    torch.arange(6, 9, device=dev)])

    # Vision: the 6D reduced camera system.
    r, Jp, Jl, chi2, delta2, depth_ok = _vision_terms(ns, pw, prob, cam, cfg)
    use = active & prob.obs_valid & depth_ok & (prob.obs_kf >= 0)
    w = huber_weight(chi2, delta2) * prob.obs_inv_sigma2 * use
    kf_i = prob.obs_kf.clamp_min(0).long()
    obs_free = (~prob.fixed_pr)[kf_i] & use
    wp = torch.where(obs_free, w, torch.zeros_like(w))
    kf_flat = kf_i.reshape(-1)
    Hpp = _segment_sum(torch.einsum("mori,mo,morj->moij", Jp, wp, Jp)
                       .reshape(-1, 6, 6), kf_flat, K)
    bp = _segment_sum(-torch.einsum("mori,mo,mor->moi", Jp, wp, r)
                      .reshape(-1, 6), kf_flat, K)
    V = torch.einsum("mori,mo,morj->mij", Jl, w, Jl)
    bl = -torch.einsum("mori,mo,mor->mi", Jl, w, r)
    lam_V = lam * torch.clamp_min(torch.diagonal(V, dim1=-2, dim2=-1), 1e-10)
    V_d = V + torch.diag_embed(lam_V)
    has_obs = torch.sum(w, dim=-1) > 0
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand_as(V_d)
    V_inv = inv3x3(torch.where(has_obs[:, None, None], V_d, eye3))
    Wc = torch.einsum("mori,mo,morj->moij", Jp, wp, Jl)
    Y = Wc @ V_inv[:, None]
    S_pairs = torch.einsum("moik,mpjk->mopij", Y, Wc)
    pair_idx = (kf_i[:, :, None] * K + kf_i[:, None, :]).reshape(-1)
    S6 = _segment_sum(S_pairs.reshape(-1, 6, 6), pair_idx, K * K).reshape(
        K, K, 6, 6)
    Yb = torch.einsum("moij,mj->moi", Y, bl)
    rhs6 = bp - _segment_sum(Yb.reshape(-1, 6), kf_flat, K)

    # Chains.
    Hc, bc, _ = _chain_system(ns, dg, prob, cfg, Rwi, gnorm, opt_scale,
                              opt_gdir, use_enc, irls=robust, graph=graph)

    # Assemble the [K, K, 15, 15] block system: the vision blocks
    # (Hpp - S6 on the [dp, dphi] slots), then the chain blocks.
    ii = torch.arange(K, device=dev)
    vis = -S6
    vis[ii, ii] += Hpp
    big = torch.zeros((K, K, 15, 15), dtype=dtype, device=dev)
    big[:, :, vi[:, None], vi[None, :]] = vis
    rhs = torch.zeros((K, 15), dtype=dtype, device=dev)
    rhs[:, vi] = rhs6
    ci, cj = prob.chain_i.long(), prob.chain_j.long()
    big_flat = big.reshape(K * K, 15, 15)
    for pidx, sr, sc in ((ci * K + ci, slice(0, 15), slice(0, 15)),
                         (ci * K + cj, slice(0, 15), slice(15, 30)),
                         (cj * K + ci, slice(15, 30), slice(0, 15)),
                         (cj * K + cj, slice(15, 30), slice(15, 30))):
        big_flat.index_add_(0, pidx, Hc[:, sr, sc])
    rhs.index_add_(0, ci, bc[:, 0:15])
    rhs.index_add_(0, cj, bc[:, 15:30])

    # Global extras coupling.
    Hgg = torch.sum(Hc[:, 30:33, 30:33], dim=0)
    Hkg = _segment_sum(Hc[:, 0:15, 30:33], ci, K) \
        + _segment_sum(Hc[:, 15:30, 30:33], cj, K)
    bg_extra = torch.sum(bc[:, 30:33], dim=0)

    # Bias prior (unary): information on slots 9:15 of prior_idx.
    pi = prob.prior_idx
    rp = _prior_terms(ns, prob)
    big[pi, pi, 9:15, 9:15] += torch.diag(prob.prior_info6)
    rhs[pi, 9:15] -= prob.prior_info6 * rp

    Hkg_flat = Hkg.reshape(15 * K, 3)
    A = torch.cat([
        torch.cat([big.permute(0, 2, 1, 3).reshape(15 * K, 15 * K),
                   Hkg_flat], dim=1),
        torch.cat([Hkg_flat.T, Hgg], dim=1)], dim=0)
    rhs_full = torch.cat([rhs.reshape(-1), bg_extra])

    # Damping and the free mask.
    A = A + torch.diag(lam * torch.clamp_min(torch.diagonal(A), 1e-8))
    fpr = (~prob.fixed_pr)[:, None]
    fvb = (~prob.fixed_vb)[:, None]
    m15 = torch.cat([fpr.expand(K, 3), fvb.expand(K, 3), fpr.expand(K, 3),
                     fvb.expand(K, 6)], dim=1).to(dtype)
    gmask = torch.cat([torch.full((2,), float(opt_gdir), dtype=dtype,
                                  device=dev),
                       torch.full((1,), float(opt_scale), dtype=dtype,
                                  device=dev)])
    fm = torch.cat([m15.reshape(-1), gmask])
    A = A * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    dx = _solve(A, rhs_full * fm)
    dx_kf = _clamp_blocks(dx[:15 * K].reshape(K, 15)) * m15
    dgx = dx[15 * K:] * gmask

    # Landmark back-substitution with the 6D vision slice.
    dx6 = dx_kf[:, vi]
    Wt_dx = torch.einsum("moij,moi->mj", Wc, dx6[kf_i])
    dl = torch.einsum("mij,mj->mi", V_inv, bl - Wt_dx)
    dl = torch.where((has_obs & prob.lm_valid)[:, None], dl,
                     torch.zeros_like(dl))
    return ns.inc_pvr_bias(dx_kf), pw + dl, dg + dgx


def vio_ba(prob: VioBAProblem, cam: cm.Camera, cfg: VioBAConfig, *,
           stage_iters: tuple = (5, 10), init_lambda: float = 1e-4,
           opt_scale: bool = False, opt_gdir: bool = False,
           use_enc: bool = False, robust_chains: bool = False,
           graph: Optional[GraphedCall] = None) -> VioBAResult:
    """Two-stage robust VIO BA (reprojection outliers reclassified between
    the stages).  `graph`: a chain_blocks_graph() the caller keeps across
    calls, which on a GPU captures the chain blocks (the `vmap` of
    `jacfwd` over the chains, most of a call's launches) once per chain
    count and mode and replays them."""
    dtype, dev = prob.ns.p.dtype, prob.ns.p.device
    Rwi, gnorm = _gravity_frame(cfg.gravity.to(dtype))
    args = (prob, cam, cfg)
    flags = (Rwi, gnorm, opt_scale, opt_gdir, use_enc, robust_chains, graph)

    def lm_stage(ns, pw, dg, active, n_iters):
        cost = _total_cost(ns, pw, dg, *args, active, *flags).to(dtype)
        lam = torch.full((), init_lambda, dtype=dtype, device=dev)
        for _ in range(n_iters):
            cand = _iteration(ns, pw, dg, *args, active, lam, *flags)
            new_cost = _total_cost(*cand, *args, active, *flags).to(dtype)
            accept = (new_cost < cost) & torch.isfinite(new_cost)
            ns = NavState(*(torch.where(accept, a, b)
                            for a, b in zip(cand[0], ns)))
            pw = torch.where(accept, cand[1], pw)
            dg = torch.where(accept, cand[2], dg)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost = torch.where(accept, new_cost, cost)
        return ns, pw, dg, cost

    ns, pw = prob.ns, prob.pw
    dg = torch.zeros(3, dtype=dtype, device=dev)
    active = torch.ones_like(prob.obs_valid)
    cost = torch.zeros((), dtype=dtype, device=dev)
    for n in stage_iters:
        ns, pw, dg, cost = lm_stage(ns, pw, dg, active, n)
        _, _, _, chi2, delta2, depth_ok = _vision_terms(ns, pw, prob, cam,
                                                        cfg)
        gated = (chi2 <= delta2) & depth_ok
        frac = torch.sum((gated & prob.obs_valid).float()) \
            / torch.clamp_min(torch.sum(prob.obs_valid.float()), 1.0)
        active = torch.where(frac > 0.2, gated, prob.obs_valid)
    gw_out = _gravity_of(dg, cfg.gravity, Rwi, gnorm, opt_gdir)
    scale = torch.exp(dg[2]) if opt_scale else torch.ones((), dtype=dtype,
                                                          device=dev)
    return VioBAResult(ns=ns, pw=pw, obs_inlier=active & prob.obs_valid,
                       cost=cost, scale=scale, gravity=gw_out)
