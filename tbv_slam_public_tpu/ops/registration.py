"""Sliding-window scan registration as batched Gauss-Newton / LM.

Re-design of n_scan_normal_reg (reference n_scan_normal.cpp:82-460):
Ceres autodiff + kd-tree association are replaced by

- masked brute-force top-1 association on distance matrices
  with the radius + cos(30 deg) normal gates and the coarse-to-fine doubled
  radius on the first iteration (n_scan_normal.cpp:213-261),
- residual-similarity weights (registration.cpp:67-75),
- closed-form 3-DoF Levenberg-Marquardt with Huber IRLS over (x, y, theta) of
  the single movable (source) scan — incremental mode with all target scans
  fixed (n_scan_normal.cpp:342-390),
- the reference's outer-loop convergence guards reproduced as masked early
  exit (n_scan_normal.cpp:125-152).

Everything is jittable and vmap-able; a batch of loop-candidate pairs is one
``vmap`` over this module (sharded across chips in
:mod:`tbv_slam_public_tpu.parallel`).

Cost convention matches Ceres: total cost = 0.5 * sum_i w_i * rho(|r_i|^2),
so scores are comparable with the reference's `summary_.final_cost`.
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se2
from ..core.config import RegistrationConfig
from ..core.types import Cells, RegistrationResult, pytree_dataclass

COST_P2L = 0
COST_P2D = 1
COST_P2P = 2

LOSS_NONE = 0
LOSS_HUBER = 1
LOSS_CAUCHY = 2
LOSS_SOFTLONE = 3
LOSS_TUKEY = 4
LOSS_COMBINED = 5

_COST_CODES = {"P2L": COST_P2L, "P2D": COST_P2D, "P2P": COST_P2P}
_LOSS_CODES = {"none": LOSS_NONE, "huber": LOSS_HUBER, "cauchy": LOSS_CAUCHY,
               "softlone": LOSS_SOFTLONE, "tukey": LOSS_TUKEY,
               "combined": LOSS_COMBINED}


def cost_code(name: str) -> int:
    return _COST_CODES[name.upper()]


def loss_code(name: str) -> int:
    return _LOSS_CODES[name.lower()]


@pytree_dataclass
class Associations:
    """Per (target-scan, source-cell) association, fixed during inner solves."""

    tgt_mean_w: jnp.ndarray  # [T, C, 2] world-frame target mean
    tgt_normal_w: jnp.ndarray  # [T, C, 2] world-frame target normal
    tgt_sqrtinfo: jnp.ndarray  # [T, C, 2, 2] P2D sqrt-information
    weight: jnp.ndarray  # [T, C] association (similarity) weight
    mask: jnp.ndarray  # [T, C] bool


def _pairwise_sqdist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Squared distances [N, M] between point sets [N,2] and [M,2].

    The cross term MUST run at full f32 matmul precision: reduced-precision
    matmuls (TF32 on the GPU, ~3 decimal digits) put O(10 m^2) errors on
    |a|~100 m coordinates, which breaks every radius gate downstream.
    """
    return (
        jnp.sum(a * a, axis=1)[:, None]
        + jnp.sum(b * b, axis=1)[None, :]
        - 2.0 * jnp.matmul(a, b.T, precision=jax.lax.Precision.HIGHEST)
    )


def _similarity(x, y):
    """2*min/(x+y) similarity (registration.h:96)."""
    return 2.0 * jnp.minimum(x, y) / jnp.maximum(x + y, 1e-12)


def _rho_and_weight(s: jnp.ndarray, loss: int, delta: float):
    """Robust loss rho(s) on squared residuals and IRLS weight rho'(s).

    All five reference options (losstype, registration.h:60; Ceres loss
    conventions): Huber (s <= d^2: rho=s else 2d*sqrt(s)-d^2), Cauchy,
    SoftLOne, Tukey, and Combined = ComposedLoss(Huber(1), Cauchy(1))
    i.e. rho(s) = huber(cauchy(s)) (registration.cpp:88-92).
    """
    if loss == LOSS_HUBER:
        sqrt_s = jnp.sqrt(jnp.maximum(s, 1e-20))
        rho = jnp.where(s <= delta * delta, s, 2.0 * delta * sqrt_s - delta * delta)
        w = jnp.where(s <= delta * delta, 1.0, delta / sqrt_s)
        return rho, w
    if loss == LOSS_CAUCHY:
        b = delta * delta
        rho = b * jnp.log1p(s / b)
        w = 1.0 / (1.0 + s / b)
        return rho, w
    if loss == LOSS_SOFTLONE:
        b = delta * delta
        t = jnp.sqrt(1.0 + s / b)
        rho = 2.0 * b * (t - 1.0)
        w = 1.0 / t
        return rho, w
    if loss == LOSS_TUKEY:
        b = delta * delta
        u = jnp.maximum(1.0 - s / b, 0.0)
        rho = (b / 3.0) * (1.0 - u ** 3)
        w = u * u
        return rho, w
    if loss == LOSS_COMBINED:
        # f(g(s)) with f = Huber(1), g = Cauchy(1); chain rule for the
        # IRLS weight: rho'(s) = f'(g(s)) * g'(s).
        g = jnp.log1p(s)
        gp = 1.0 / (1.0 + s)
        sqrt_g = jnp.sqrt(jnp.maximum(g, 1e-20))
        rho = jnp.where(g <= 1.0, g, 2.0 * sqrt_g - 1.0)
        fp = jnp.where(g <= 1.0, 1.0, 1.0 / sqrt_g)
        return rho, fp * gp
    return s, jnp.ones_like(s)


def _chol2x2_inv_sqrt(m: jnp.ndarray) -> jnp.ndarray:
    """Upper-triangular U with U^T U = M^{-1}, for batched 2x2 SPD M.

    Used for the P2D Mahalanobis whitening (n_scan_normal.cpp:288-297); the
    symmetric form r = U e gives r^T r = e^T M^{-1} e.
    """
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 1, 1]
    det = jnp.maximum(a * c - b * b, 1e-20)
    # M^{-1} = [[c, -b], [-b, a]] / det ; Cholesky of that, upper form.
    ia = c / det
    ib = -b / det
    ic = a / det
    u22 = jnp.sqrt(jnp.maximum(ic, 1e-20))
    u12 = ib / u22
    u11 = jnp.sqrt(jnp.maximum(ia - u12 * u12, 1e-20))
    z = jnp.zeros_like(u11)
    return jnp.stack(
        [jnp.stack([u11, u12], -1), jnp.stack([z, u22], -1)], axis=-2
    )


def associate(
    src: Cells,
    src_pose: jnp.ndarray,
    tgt_mean_w: jnp.ndarray,
    tgt_normal_w: jnp.ndarray,
    tgt_cov_w: jnp.ndarray,
    tgt_nsamples: jnp.ndarray,
    tgt_planarity: jnp.ndarray,
    tgt_valid: jnp.ndarray,
    radius,
    *,
    weight_option: int,
    cost: int,
    regularization: float,
    cov_scale: float,
    angle_gate_cos: float,
) -> Associations:
    """Top-1 NN association of source cells into each target scan.

    Reproduces AddScanPairCost's association pass (n_scan_normal.cpp:224-261):
    nearest target cell within ``radius``, accepted when the rotated source
    normal and target normal agree within 30 degrees; weights from the
    similarity of (Nsamples, normal direction, planarity).
    """
    src_mean_w = se2.apply(src_pose, src.mean)  # [C, 2]
    src_normal_w = se2.rotate(src_pose, src.normal)  # [C, 2]

    def per_target(t_mean, t_normal, t_cov, t_n, t_plan, t_valid):
        # Fused broadcast form (r4): XLA folds the [Cs, Ct] masked distance
        # expression straight into the argmin reduction — nothing the size
        # of the distance matrix is materialized in device memory (a matmul
        # form would write the [Cs, Ct] product out).
        d2 = jnp.sum((src_mean_w[:, None, :] - t_mean[None, :, :]) ** 2, -1)
        d2 = jnp.where(t_valid[None, :], d2, jnp.inf)
        nn = jnp.argmin(d2, axis=1)  # [Cs]

        # Winner attributes via ONE one-hot contraction instead of six
        # per-array row gathers (the candidate wave runs ~6 association
        # passes per pair).  Which form is faster on the GPU is unmeasured.
        # Exact: the one-hot row has a single 1.0, so every output element
        # is one f32 product at HIGHEST precision (TF32 would round it).
        ct = t_mean.shape[0]
        onehot = (jnp.arange(ct)[None, :] == nn[:, None]).astype(t_mean.dtype)
        cols = [t_mean, t_normal, t_n[:, None], t_plan[:, None],
                t_valid[:, None].astype(t_mean.dtype)]
        if cost == COST_P2D:
            cols.append(t_cov.reshape(ct, 4))
        packed = jnp.concatenate(cols, axis=-1)
        attrs = jnp.matmul(onehot, packed,
                           precision=jax.lax.Precision.HIGHEST)
        nn_mean = attrs[:, 0:2]
        nn_normal = attrs[:, 2:4]
        n_tgt = attrs[:, 4]
        plan_tgt = attrs[:, 5]
        nn_valid = attrs[:, 6] > 0.5
        nn_d2 = jnp.sum((src_mean_w - nn_mean) ** 2, -1)
        in_radius = (nn_d2 < radius * radius) & nn_valid

        dir_sim = jnp.maximum(jnp.sum(src_normal_w * nn_normal, axis=1), 0.0)
        ok = in_radius & (dir_sim > angle_gate_cos) & src.valid

        sim_n = _similarity(src.nsamples, n_tgt)
        sim_plan = _similarity(src.planarity, plan_tgt)
        if weight_option == 0:
            w = jnp.ones_like(dir_sim)
        elif weight_option == 1:
            w = sim_n
        elif weight_option == 2:
            w = dir_sim
        elif weight_option == 3:
            w = sim_plan
        else:  # Combined_weights (registration.cpp:73)
            w = sim_n + dir_sim + sim_plan

        if cost == COST_P2D:
            nn_cov = attrs[:, 7:11].reshape(-1, 2, 2)
            m = (regularization * jnp.eye(2) + nn_cov) * cov_scale
            sqrtinfo = _chol2x2_inv_sqrt(m)
        else:
            sqrtinfo = jnp.broadcast_to(jnp.eye(2, dtype=t_cov.dtype),
                                        (nn.shape[0], 2, 2))
        return nn_mean, nn_normal, sqrtinfo, jnp.where(ok, w, 0.0), ok

    tm, tn, ti, w, m = jax.vmap(per_target)(
        tgt_mean_w, tgt_normal_w, tgt_cov_w, tgt_nsamples, tgt_planarity, tgt_valid
    )
    return Associations(tgt_mean_w=tm, tgt_normal_w=tn, tgt_sqrtinfo=ti, weight=w, mask=m)


def _residual_terms(theta: jnp.ndarray, src: Cells, assoc: Associations, cost: int):
    """Per-association residual r, jacobian J (wrt x,y,theta) and sq-norm s."""
    c, s = jnp.cos(theta[2]), jnp.sin(theta[2])
    u = src.mean  # [C, 2] local
    ux, uy = u[..., 0], u[..., 1]
    wx = c * ux - s * uy + theta[0]
    wy = s * ux + c * uy + theta[1]
    # d(R u)/dtheta
    dx = -s * ux - c * uy
    dy = c * ux - s * uy

    e = jnp.stack([wx, wy], -1)[None, :, :] - assoc.tgt_mean_w  # [T, C, 2]
    if cost == COST_P2L:
        n = assoc.tgt_normal_w
        r = jnp.sum(n * e, axis=-1)[..., None]  # [T, C, 1]
        J = jnp.stack(
            [n[..., 0], n[..., 1], n[..., 0] * dx[None, :] + n[..., 1] * dy[None, :]],
            axis=-1,
        )[..., None, :]  # [T, C, 1, 3]
    else:
        T = assoc.tgt_mean_w.shape[0]
        ones = jnp.ones_like(dx)
        zeros = jnp.zeros_like(dx)
        Jp = jnp.stack(
            [
                jnp.stack([ones, zeros, dx], -1),
                jnp.stack([zeros, ones, dy], -1),
            ],
            axis=-2,
        )  # [C, 2, 3]
        Jp = jnp.broadcast_to(Jp[None], (T,) + Jp.shape)
        if cost == COST_P2D:
            r = jnp.einsum("tcij,tcj->tci", assoc.tgt_sqrtinfo, e)
            J = jnp.einsum("tcij,tcjk->tcik", assoc.tgt_sqrtinfo, Jp)
        else:  # P2P
            r = e
            J = Jp
    sq = jnp.sum(r * r, axis=-1)  # [T, C]
    return r, J, sq


def _cost_grad_hess(theta, src, assoc, *, cost: int, loss: int, delta: float,
                    prior=None):
    r, J, sq = _residual_terms(theta, src, assoc, cost)
    rho, w_irls = _rho_and_weight(sq, loss, delta)
    m = assoc.mask
    w_assoc = assoc.weight
    total_cost = 0.5 * jnp.sum(jnp.where(m, w_assoc * rho, 0.0))
    w = jnp.where(m, w_assoc * w_irls, 0.0)[..., None, None]  # [T, C, 1, 1]
    H = jnp.sum(w * jnp.einsum("tcri,tcrj->tcij", J, J), axis=(0, 1))
    g = jnp.sum((w[..., 0] * jnp.einsum("tcri,tcr->tci", J, r)), axis=(0, 1))
    if prior is not None:
        guess, sqrt_info, pw = prior
        pr = sqrt_info @ (theta - guess) * pw
        total_cost = total_cost + 0.5 * jnp.sum(pr * pr)
        Jp = sqrt_info * pw
        H = H + Jp.T @ Jp
        g = g + Jp.T @ pr
    return total_cost, g, H


def _cost_only(theta, src, assoc, *, cost, loss, delta, prior=None):
    _, _, sq = _residual_terms(theta, src, assoc, cost)
    rho, _ = _rho_and_weight(sq, loss, delta)
    c = 0.5 * jnp.sum(jnp.where(assoc.mask, assoc.weight * rho, 0.0))
    if prior is not None:
        guess, sqrt_info, pw = prior
        pr = sqrt_info @ (theta - guess) * pw
        c = c + 0.5 * jnp.sum(pr * pr)
    return c


def _solve3x3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 solve (adjugate / Cramer).

    The LM inner loop solves a damped SPD 3x3 per iteration; the generic
    batched LU kernel costs a separate (serializing) op dispatch each time —
    the adjugate form is ~30 fused elementwise ops that XLA folds into the
    surrounding iteration."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30,
                              jnp.where(det < 0, -1e-30, 1e-30), det)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return jnp.stack([x0, x1, x2], axis=-1)


def _lm_solve(theta0, src, assoc, *, cost, loss, delta, max_iter, init_lambda,
              prior=None):
    """Fixed-iteration Levenberg-Marquardt on 3 DoF with accept/reject damping.

    Mirrors Ceres' trust-region LM (options_.max_num_iterations = 20,
    n_scan_normal.cpp:9) closely enough for parity: diagonal damping, accept on
    cost decrease, track the last relative decrease for the outer-loop guard.

    ONE residual pass per iteration (r4): each candidate evaluation computes
    (cost, grad, Hessian) together; on accept they seed the next step, on
    reject the stored grad/Hessian of the incumbent are reused.  Identical
    iterate trajectory to the two-pass form (grad/H at the incumbent are the
    same values it was accepted with), at half the kernel count — the wave's
    wall-clock is sequential-small-kernel bound, not FLOP bound.
    """

    def body(_, state):
        theta, lam, cur_cost, g, H, rel_dec = state
        damp = lam * jnp.diag(jnp.diagonal(H)) + 1e-12 * jnp.eye(3)
        step = -_solve3x3(H + damp, g)
        cand = theta + step
        cand_cost, cand_g, cand_H = _cost_grad_hess(
            cand, src, assoc, cost=cost, loss=loss, delta=delta, prior=prior)
        accept = cand_cost < cur_cost
        theta = jnp.where(accept, cand, theta)
        g = jnp.where(accept, cand_g, g)
        H = jnp.where(accept, cand_H, H)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9),
                        jnp.minimum(lam * 4.0, 1e6))
        rel_dec = jnp.where(
            accept, (cur_cost - cand_cost) / jnp.maximum(cur_cost, 1e-20),
            rel_dec)
        cur_cost = jnp.where(accept, cand_cost, cur_cost)
        return theta, lam, cur_cost, g, H, rel_dec

    init_cost, g0, h0 = _cost_grad_hess(theta0, src, assoc, cost=cost,
                                        loss=loss, delta=delta, prior=prior)
    state = (theta0, jnp.asarray(init_lambda, theta0.dtype), init_cost,
             g0, h0, jnp.asarray(1.0, theta0.dtype))
    theta, _, final_cost, _, _, rel_dec = jax.lax.fori_loop(
        0, max_iter, body, state)
    return theta, final_cost, rel_dec


@partial(jax.jit, static_argnames=("cfg", "max_outer", "max_inner"))
def register_window(
    src: Cells,
    src_pose0: jnp.ndarray,
    tgt: Cells,  # stacked [T, C, ...]
    tgt_poses: jnp.ndarray,  # [T, 3]
    tgt_scan_mask: jnp.ndarray,  # [T] bool
    cfg: RegistrationConfig,
    guess: Optional[jnp.ndarray] = None,
    guess_sqrt_info: Optional[jnp.ndarray] = None,
    max_outer: Optional[int] = None,
    max_inner: Optional[int] = None,
) -> RegistrationResult:
    """Register the source scan against a window of fixed target scans.

    Equivalent of n_scan_normal_reg::Register in incremental mode
    (n_scan_normal.cpp:82-185): outer re-association loop (doubled radius on
    iteration 1) around an inner LM solve, with the reference's convergence
    guards (revert when the score regresses after min_itr, stop on relative
    improvement < score_tolerance).
    """
    cost = cost_code(cfg.cost)
    loss = loss_code(cfg.loss)
    delta = cfg.loss_limit
    n_outer = max_outer or cfg.max_outer_iterations
    n_inner = max_inner or cfg.max_inner_iterations
    angle_gate_cos = math.cos(math.radians(cfg.angle_gate_deg))

    # Targets are fixed: transform once.
    tmw = jax.vmap(se2.apply)(tgt_poses, tgt.mean)
    tnw = jax.vmap(se2.rotate)(tgt_poses, tgt.normal)
    rot = se2.rotmat(tgt_poses[:, 2])  # [T, 2, 2]
    tcw = jnp.einsum("tab,tcbd,ted->tcae", rot, tgt.cov, rot)
    tvalid = tgt.valid & tgt_scan_mask[:, None]

    prior = None
    if guess is not None:
        n_src = jnp.sqrt(jnp.maximum(jnp.sum(src.valid), 1.0))
        prior = (guess, guess_sqrt_info, n_src)

    def make_assoc(pose, radius):
        return associate(
            src, pose, tmw, tnw, tcw, tgt.nsamples, tgt.planarity, tvalid,
            radius,
            weight_option=cfg.weight_option, cost=cost,
            regularization=cfg.regularization, cov_scale=cfg.cov_scale,
            angle_gate_cos=angle_gate_cos,
        )

    def outer_body(itr, state):
        theta, prev_theta, prev_score, active, used, n_res = state
        radius = jnp.where(itr == 0, 2.0 * cfg.radius, cfg.radius)
        assoc = make_assoc(theta, radius)
        cnt = jnp.sum(assoc.mask)
        enough = cnt > 1
        new_theta, score, rel_dec = _lm_solve(
            theta, src, assoc, cost=cost, loss=loss, delta=delta,
            max_iter=n_inner, init_lambda=cfg.init_lambda, prior=prior,
        )

        # Convergence guards (n_scan_normal.cpp:134-152), active after min_itr.
        past_min = (itr + 1) > cfg.min_outer_iterations
        regressed = past_min & (prev_score < score)
        rel_improvement = (prev_score - score) / jnp.maximum(prev_score, 1e-20)
        converged = past_min & (
            (rel_improvement < cfg.score_tolerance)
            | (rel_dec < cfg.score_tolerance)
        )

        out_theta = jnp.where(active & enough,
                              jnp.where(regressed, prev_theta, new_theta), theta)
        out_score = jnp.where(active & enough,
                              jnp.where(regressed, prev_score, score), prev_score)
        next_active = active & enough & ~regressed & ~converged
        used = jnp.where(active, itr + 1, used)
        n_res = jnp.where(active & enough, cnt, n_res)
        return (out_theta, out_theta, out_score, next_active, used, n_res)

    big = jnp.asarray(jnp.finfo(src.mean.dtype).max / 4, src.mean.dtype)
    state = (
        src_pose0, src_pose0, big, jnp.asarray(True), jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    theta, _, score, _, used, n_res = jax.lax.fori_loop(0, n_outer, outer_body, state)

    success = n_res > 1
    # Default covariance (n_scan_normal.cpp:171-175).
    cov = jnp.diag(jnp.asarray([0.1 ** 2, 0.1 ** 2, 0.01 ** 2], theta.dtype))
    return RegistrationResult(
        pose=theta, score=score, num_residuals=n_res, iterations=used,
        success=success, cov=cov,
    )


def cell_rel_timestamps(mean: jnp.ndarray, ccw: bool) -> jnp.ndarray:
    """Relative in-sweep timestamp factor per cell in [-0.5, 0.5].

    GetRelTimeStamp (utils.h:28-32): derived from the azimuth angle of the
    cell's LOCAL position — the radar sweeps azimuths over one period, so a
    cell's bearing encodes when within the sweep it was observed.
    """
    a = jnp.arctan2(mean[..., 1], mean[..., 0])
    d = jnp.where(a > 1e-5, a, 2.0 * jnp.pi + a) / (2.0 * jnp.pi)
    return jnp.where(ccw, -(d - 0.5), d - 0.5)


def motion_correct_cells(src: Cells, vel: jnp.ndarray, ccw) -> Cells:
    """Per-cell velocity (distortion) correction for time-continuous
    registration: cell mean -> R(t_i * v_theta) mean + t_i * v_xy, normal
    rotated by the same per-cell rotation (P2PEfficientContinuousCost,
    n_scan_normal.h:363-404; Tcomp composition n_scan_normal.cpp:225-233).

    ``vel`` is the per-sweep motion (x, y, theta) — held constant during the
    solve (the reference never frees vel_parameters_)."""
    t = cell_rel_timestamps(src.mean, ccw)  # [C]
    ang = t * vel[2]
    c, s = jnp.cos(ang), jnp.sin(ang)
    mx, my = src.mean[..., 0], src.mean[..., 1]
    mean = jnp.stack([c * mx - s * my + t * vel[0],
                      s * mx + c * my + t * vel[1]], -1)
    nx, ny = src.normal[..., 0], src.normal[..., 1]
    normal = jnp.stack([c * nx - s * ny, s * nx + c * ny], -1)
    return src.replace(mean=mean, normal=normal)


@partial(jax.jit, static_argnames=("cfg", "ccw", "max_outer", "max_inner"))
def register_time_continuous(
    src: Cells,
    src_pose0: jnp.ndarray,
    tgt: Cells,
    tgt_poses: jnp.ndarray,
    tgt_scan_mask: jnp.ndarray,
    cfg: RegistrationConfig,
    vel: jnp.ndarray,  # [3] per-sweep velocity (Tvel of RegisterTimeContinuous)
    ccw: bool = False,
    guess: Optional[jnp.ndarray] = None,
    guess_sqrt_info: Optional[jnp.ndarray] = None,
    max_outer: Optional[int] = None,
    max_inner: Optional[int] = None,
) -> RegistrationResult:
    """Time-continuous P2P window registration (RegisterTimeContinuous,
    n_scan_normal.cpp:67-80).

    The reference threads a per-association-pass velocity correction through
    both association (Tsrctotar * Tcomp, n_scan_normal.cpp:225-233) and the
    P2P residual (P2PEfficientContinuousCost).  Because the velocity block is
    constant during the solve, correcting each source cell ONCE up front is
    algebraically identical: residual = tar_w - (pose o (R(t v_th) u + t v)).
    That makes the variant a pure pre-pass over the source cells followed by
    the standard (already batched) window registration with cost=P2P.
    """
    import dataclasses

    p2p_cfg = dataclasses.replace(cfg, cost="P2P")
    corrected = motion_correct_cells(src, vel, ccw)
    return register_window(
        corrected, src_pose0, tgt, tgt_poses, tgt_scan_mask, p2p_cfg,
        guess=guess, guess_sqrt_info=guess_sqrt_info,
        max_outer=max_outer, max_inner=max_inner)


def _quad_fit_pinv(xy_range: float, yaw_range: float, steps: int) -> tuple:
    """Static pseudo-inverse of the quadratic-fit design matrix over the
    3^3 sampling grid (approximateCovarianceBySampling,
    odometrykeyframefuser.cpp:324-342: monomials
    [x^2, y^2, t^2, xy, yt, tx, x, y, t, 1])."""
    xs = np.linspace(-xy_range / 2, xy_range / 2, steps)
    ts = np.linspace(-yaw_range / 2, yaw_range / 2, steps)
    rows = []
    offs = []
    for t in ts:
        for x in xs:
            for y in xs:
                rows.append([x * x, y * y, t * t, x * y, y * t, t * x,
                             x, y, t, 1.0])
                offs.append([x, y, t])
    a = np.asarray(rows, np.float64)
    return (np.linalg.pinv(a).astype(np.float32),
            np.asarray(offs, np.float32))


@partial(jax.jit, static_argnames=("cfg", "xy_range", "yaw_range", "steps",
                                   "reassociate"))
def sampled_covariance(
    src: Cells,
    theta_opt: jnp.ndarray,  # [3] optimized pose
    tgt: Cells,
    tgt_poses: jnp.ndarray,
    tgt_scan_mask: jnp.ndarray,
    cfg: RegistrationConfig,
    final_score: jnp.ndarray,
    n_res: jnp.ndarray,
    xy_range: float = 0.4,
    yaw_range: float = 0.0043625,
    steps: int = 3,
    cov_scaler: float = 4.0,
    reassociate: bool = False,
):
    """Grid-sampled covariance (C7): evaluate the registration cost on a
    steps^3 grid around the optimum, fit a quadratic by least squares, and
    invert its Hessian (approximateCovarianceBySampling,
    odometrykeyframefuser.cpp:261-380).

    All 27 cost evaluations run as ONE vmapped batch.  Returns (cov [3, 3],
    success) — success is False when the quadratic is not convex, matching
    the reference's rejection (odometrykeyframefuser.cpp:350-364).

    ``reassociate=False`` (default) associates ONCE at the optimum and
    evaluates all grid costs on that fixed correspondence set — the sample
    offsets (±0.2 m, ±0.0022 rad) are tiny against the 2 m association
    radius, so the correspondences are identical in practice, and the
    [S, C, C] distance-matrix blowup of per-sample association (the r3
    wave's dominant HBM traffic) disappears.  ``reassociate=True`` restores
    the literal per-sample GetCost pass (n_scan_normal.cpp:186-211).
    """
    pinv, offs = _quad_fit_pinv(xy_range, yaw_range, steps)
    pinv = jnp.asarray(pinv)
    poses = theta_opt[None, :] + jnp.asarray(offs)  # [S, 3]

    if reassociate:
        def one(p):
            c, _ = evaluate_cost(src, p, tgt, tgt_poses, tgt_scan_mask, cfg)
            return c
    else:
        cost = cost_code(cfg.cost)
        loss = loss_code(cfg.loss)
        angle_gate_cos = math.cos(math.radians(cfg.angle_gate_deg))
        tmw = jax.vmap(se2.apply)(tgt_poses, tgt.mean)
        tnw = jax.vmap(se2.rotate)(tgt_poses, tgt.normal)
        rot = se2.rotmat(tgt_poses[:, 2])
        tcw = jnp.einsum("tab,tcbd,ted->tcae", rot, tgt.cov, rot)
        tvalid = tgt.valid & tgt_scan_mask[:, None]
        assoc = associate(
            src, theta_opt, tmw, tnw, tcw, tgt.nsamples, tgt.planarity,
            tvalid, cfg.radius,
            weight_option=cfg.weight_option, cost=cost,
            regularization=cfg.regularization, cov_scale=cfg.cov_scale,
            angle_gate_cos=angle_gate_cos)

        def one(p):
            return _cost_only(p, src, assoc, cost=cost, loss=loss,
                              delta=cfg.loss_limit)

    costs = jax.vmap(one)(poses)  # [S]
    q = pinv @ costs  # [10]
    h = jnp.asarray([
        [2 * q[0], q[3], q[5]],
        [q[3], 2 * q[1], q[4]],
        [q[5], q[4], 2 * q[2]],
    ])
    eigs = jnp.linalg.eigvalsh(h)
    convex = jnp.all(eigs > 0)
    # Censi-style scaling: final_cost / (residual dim - parameters)
    resid_dim = jnp.where(cost_code(cfg.cost) == COST_P2L, 1, 2) * n_res
    denom = jnp.maximum(resid_dim - 3, 1).astype(final_score.dtype)
    score_scale = final_score / denom
    hinv = jnp.linalg.inv(h + (~convex) * jnp.eye(3))  # guarded inverse
    cov = 2.0 * hinv * score_scale * cov_scaler
    fallback = jnp.diag(jnp.asarray([0.1 ** 2, 0.1 ** 2, 0.01 ** 2],
                                    cov.dtype))
    return jnp.where(convex, cov, fallback), convex


@partial(jax.jit, static_argnames=("cfg",))
def evaluate_cost(
    src: Cells,
    src_pose: jnp.ndarray,
    tgt: Cells,
    tgt_poses: jnp.ndarray,
    tgt_scan_mask: jnp.ndarray,
    cfg: RegistrationConfig,
):
    """One association + cost evaluation pass without solving.

    Equivalent of n_scan_normal_reg::GetCost (n_scan_normal.cpp:186-211), used
    by the CFEAR alignment-quality feature (AlignmentQuality.cpp:330-354).
    Returns (total_cost, num_residuals).
    """
    cost = cost_code(cfg.cost)
    loss = loss_code(cfg.loss)
    angle_gate_cos = math.cos(math.radians(cfg.angle_gate_deg))

    tmw = jax.vmap(se2.apply)(tgt_poses, tgt.mean)
    tnw = jax.vmap(se2.rotate)(tgt_poses, tgt.normal)
    rot = se2.rotmat(tgt_poses[:, 2])
    tcw = jnp.einsum("tab,tcbd,ted->tcae", rot, tgt.cov, rot)
    tvalid = tgt.valid & tgt_scan_mask[:, None]

    assoc = associate(
        src, src_pose, tmw, tnw, tcw, tgt.nsamples, tgt.planarity, tvalid,
        cfg.radius,
        weight_option=cfg.weight_option, cost=cost,
        regularization=cfg.regularization, cov_scale=cfg.cov_scale,
        angle_gate_cos=angle_gate_cos,
    )
    total = _cost_only(src_pose, src, assoc, cost=cost, loss=loss,
                       delta=cfg.loss_limit)
    return total, jnp.sum(assoc.mask)


@partial(jax.jit, static_argnames=("cfg", "max_outer", "max_inner"))
def register_joint(
    scans: Cells,  # stacked [T, C, ...] — every scan in the window
    poses0: jnp.ndarray,  # [T, 3] initial poses
    scan_mask: jnp.ndarray,  # [T] bool — valid scans
    fixed: jnp.ndarray,  # [T] bool — scans whose pose stays constant
    cfg: RegistrationConfig,
    max_outer: Optional[int] = None,
    max_inner: Optional[int] = None,
) -> RegistrationResult:
    """many_to_many_refinement: joint refinement of ALL window scans
    (n_scan_normal.cpp:360-365 — every ordered pair (i, j), i != j, not both
    fixed, contributes costs).

    Batched decomposition: with the reference's efficient costs the target
    pose is baked into each residual at association time and only the SOURCE
    scan's 3 DoF are free (AddResidualBlock(parameters[scan_idx_src]),
    n_scan_normal.cpp:318-320) — so the per-association-pass joint Hessian is
    block-diagonal over scans, and one outer iteration = a vmap of T
    independent 3-DoF LM solves against all other scans at their
    last-iteration poses (Jacobi-style update, exactly the coupling the
    reference's rebuild-every-itr loop produces).  When no scan is fixed the
    first valid scan is gauge-fixed (n_scan_normal.cpp:370-371).
    """
    cost = cost_code(cfg.cost)
    loss = loss_code(cfg.loss)
    delta = cfg.loss_limit
    n_outer = max_outer or cfg.max_outer_iterations
    n_inner = max_inner or cfg.max_inner_iterations
    angle_gate_cos = math.cos(math.radians(cfg.angle_gate_deg))
    t_scans = scans.mean.shape[0]

    any_fixed = jnp.any(fixed & scan_mask)
    first_valid = jnp.argmax(scan_mask)
    gauge_fixed = jnp.where(
        any_fixed, fixed,
        jnp.arange(t_scans) == first_valid) & scan_mask

    def solve_scan(j, poses, radius):
        """One scan's 3-DoF solve against all others (targets baked)."""
        src = jax.tree.map(lambda x: x[j], scans)
        tmw = jax.vmap(se2.apply)(poses, scans.mean)
        tnw = jax.vmap(se2.rotate)(poses, scans.normal)
        rot = se2.rotmat(poses[:, 2])
        tcw = jnp.einsum("tab,tcbd,ted->tcae", rot, scans.cov, rot)
        tvalid = (scans.valid & scan_mask[:, None]
                  & (jnp.arange(t_scans) != j)[:, None])
        assoc = associate(
            src, poses[j], tmw, tnw, tcw, scans.nsamples, scans.planarity,
            tvalid, radius,
            weight_option=cfg.weight_option, cost=cost,
            regularization=cfg.regularization, cov_scale=cfg.cov_scale,
            angle_gate_cos=angle_gate_cos)
        theta, score, _ = _lm_solve(
            poses[j], src, assoc, cost=cost, loss=loss, delta=delta,
            max_iter=n_inner, init_lambda=cfg.init_lambda)
        return theta, score, jnp.sum(assoc.mask)

    def outer_body(itr, state):
        poses, _, _ = state
        radius = jnp.where(itr == 0, 2.0 * cfg.radius, cfg.radius)
        new_poses, scores, counts = jax.vmap(
            solve_scan, in_axes=(0, None, None))(
                jnp.arange(t_scans), poses, radius)
        movable = scan_mask & ~gauge_fixed
        poses = jnp.where(movable[:, None], new_poses, poses)
        return poses, jnp.sum(jnp.where(movable, scores, 0.0)), \
            jnp.sum(jnp.where(movable, counts, 0))

    poses, score, n_res = jax.lax.fori_loop(
        0, n_outer, outer_body,
        (poses0, jnp.asarray(0.0, poses0.dtype), jnp.asarray(0, jnp.int32)))
    cov = jnp.diag(jnp.asarray([0.1 ** 2, 0.1 ** 2, 0.01 ** 2], poses.dtype))
    return RegistrationResult(
        pose=poses, score=score, num_residuals=n_res,
        iterations=jnp.asarray(n_outer, jnp.int32), success=n_res > 1,
        cov=cov)


@partial(jax.jit, static_argnames=("cfg",))
def ceres_covariance(
    src: Cells,
    theta_opt: jnp.ndarray,  # [3] optimized pose
    tgt: Cells,
    tgt_poses: jnp.ndarray,
    tgt_scan_mask: jnp.ndarray,
    cfg: RegistrationConfig,
    final_score: jnp.ndarray,
    n_res: jnp.ndarray,
):
    """Ceres-covariance-style output (GetCovariance,
    n_scan_normal.cpp:390-431): covariance of the last (source) parameter
    block = the inverse Gauss-Newton Hessian at the optimum, scaled by
    30 * final_cost / (num_residuals_reduced - num_parameters_reduced)
    (Censi 2007-style score scaling).  Returns (cov [3,3], ok) — ok False
    when the Hessian is rank-deficient (Compute failure analogue).
    """
    cost = cost_code(cfg.cost)
    loss = loss_code(cfg.loss)
    angle_gate_cos = math.cos(math.radians(cfg.angle_gate_deg))

    tmw = jax.vmap(se2.apply)(tgt_poses, tgt.mean)
    tnw = jax.vmap(se2.rotate)(tgt_poses, tgt.normal)
    rot = se2.rotmat(tgt_poses[:, 2])
    tcw = jnp.einsum("tab,tcbd,ted->tcae", rot, tgt.cov, rot)
    tvalid = tgt.valid & tgt_scan_mask[:, None]
    assoc = associate(
        src, theta_opt, tmw, tnw, tcw, tgt.nsamples, tgt.planarity, tvalid,
        cfg.radius,
        weight_option=cfg.weight_option, cost=cost,
        regularization=cfg.regularization, cov_scale=cfg.cov_scale,
        angle_gate_cos=angle_gate_cos)
    _, _, H = _cost_grad_hess(theta_opt, src, assoc, cost=cost, loss=loss,
                              delta=cfg.loss_limit)
    eigs = jnp.linalg.eigvalsh(H)
    ok = eigs[0] > 1e-9
    resid_dim = jnp.where(cost == COST_P2L, 1, 2) * n_res
    denom = (resid_dim - 3).astype(final_score.dtype)
    ok = ok & (denom > 0)
    scale = 30.0 * final_score / jnp.maximum(denom, 1.0)
    hinv = jnp.linalg.inv(H + (~ok) * jnp.eye(3))
    cov = scale * hinv
    fallback = jnp.diag(jnp.asarray([0.1 ** 2, 0.1 ** 2, 0.01 ** 2],
                                    cov.dtype))
    return jnp.where(ok, cov, fallback), ok
