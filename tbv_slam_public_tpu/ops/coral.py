"""CorAl: entropy-based alignment quality for radar point clouds.

Re-design of CorAlRadarQuality (reference
AlignmentQuality.cpp:93-229): the per-point kd radius searches become masked
distance-matrix moments, computed in query-centered coordinates so f32 is
safe (neighborhood diameters are ~2 m while world coordinates reach hundreds
of meters).

Semantics reproduced:
- per point of each cloud: neighbors within ``radius`` in its OWN cloud and in
  the JOINT (src+ref) cloud; sample covariances with 1/(n-1) normalization
  (Covariance, AlignmentQuality.cpp:28-48; rejects n <= 2),
- validity requires >= 1 neighbor in the OTHER cloud (overlap_req_,
  AlignmentQuality.cpp:135-137) and both covariances computable,
- per-point differential entropies 0.5*log(2*pi*e*det + 1e-8)
  (ComputeEntropy, AlignmentQuality.cpp:75-92),
- outputs mean joint entropy, mean separate entropy and overlap fraction
  (quality vector, AlignmentQuality.cpp:187-202),
- optional KL-divergence mode (``mode="kl"``; ent_cfg == kl,
  ComputeKLDiv AlignmentQuality.cpp:49-73 dispatched at 139-166): src-cloud
  points score KL(sep||sep) — a constant -0.5 under the reference's k=3
  convention, reproduced verbatim — and ref-cloud points score
  KL((mu_sep, S_sep) || (mu_joint, S_joint)); the quality vector becomes
  {mean KL, 0, overlap}.
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.types import PointCloud


class CoralResult(NamedTuple):
    joint: jnp.ndarray  # [] mean joint entropy
    sep: jnp.ndarray  # [] mean separate entropy
    overlap: jnp.ndarray  # [] valid fraction of the merged cloud
    valid: jnp.ndarray  # [] bool — overlap >= 0.1


def _neighbor_moments(queries, qmask, points, pmask, radius):
    """Masked radius-neighborhood count/mean/second-moment for each query.

    Returns (count [Q], sum_rel [Q,2], sum_sq [Q,2,2]) where moments are of
    (p - q) in query-centered coordinates.  Every moment is an elementwise
    product summed over P (no matmul), which XLA fuses into one multi-output
    reduction without materializing the [Q, P] relative coordinates.
    """
    rx = points[None, :, 0] - queries[:, None, 0]  # [Q, P]
    ry = points[None, :, 1] - queries[:, None, 1]
    # d2 from the query-centered coordinates: exact in f32 regardless of
    # |coordinate| (the |q|^2+|p|^2-2qp matmul form loses the radius gate to
    # cancellation at range, and to TF32 rounding on the GPU).
    m = (rx * rx + ry * ry <= radius * radius) & pmask[None, :] & qmask[:, None]
    fm = m.astype(queries.dtype)
    mx = rx * fm
    my = ry * fm
    count = jnp.sum(fm, axis=1)
    sum_rel = jnp.stack([jnp.sum(mx, axis=1), jnp.sum(my, axis=1)], -1)
    sxx = jnp.sum(mx * rx, axis=1)
    sxy = jnp.sum(mx * ry, axis=1)
    syy = jnp.sum(my * ry, axis=1)
    sum_sq = jnp.stack([jnp.stack([sxx, sxy], -1),
                        jnp.stack([sxy, syy], -1)], axis=-2)
    return count, sum_rel, sum_sq


def _mean_cov_from_moments(n, s1, s2):
    """Sample mean and covariance (1/(n-1)) from query-centered moments."""
    mean = s1 / jnp.maximum(n, 1.0)[:, None]
    # sum of centered outer products = s2 - n * mean mean^T
    centered = s2 - n[:, None, None] * mean[:, :, None] * mean[:, None, :]
    cov = centered / jnp.maximum(n - 1.0, 1.0)[:, None, None]
    return mean, cov


def _entropy_from_moments(n, s1, s2, eps):
    """Differential entropy from query-centered moments."""
    _, cov = _mean_cov_from_moments(n, s1, s2)
    det = cov[:, 0, 0] * cov[:, 1, 1] - cov[:, 0, 1] * cov[:, 1, 0]
    ent = 0.5 * jnp.log(2.0 * math.pi * math.e * det + eps)
    return ent, det


def _kl_divergence_2d(u0, s0, u1, s1):
    """KL((u0, S0) || (u1, S1)) per query, with the reference's k=3 constant
    (ComputeKLDiv, AlignmentQuality.cpp:49-73 — kept verbatim for parity even
    though the distributions are 2-D): 0.5 * (tr(S1^-1 S0) + mahal - 3 +
    log(det S1 / det S0))."""
    det0 = s0[:, 0, 0] * s0[:, 1, 1] - s0[:, 0, 1] * s0[:, 1, 0]
    det1 = s1[:, 0, 0] * s1[:, 1, 1] - s1[:, 0, 1] * s1[:, 1, 0]
    # 2x2 inverse of S1
    inv_det1 = 1.0 / jnp.where(det1 == 0.0, 1.0, det1)
    s1i = jnp.stack([
        jnp.stack([s1[:, 1, 1], -s1[:, 0, 1]], -1),
        jnp.stack([-s1[:, 1, 0], s1[:, 0, 0]], -1),
    ], -2) * inv_det1[:, None, None]
    trace = jnp.einsum("qij,qji->q", s1i, s0)
    d = u1 - u0
    mahal = jnp.einsum("qi,qij,qj->q", d, s1i, d)
    score = 0.5 * (trace + mahal - 3.0 + jnp.log(det1 / det0))
    # the reference gates ONLY on the final score being finite
    # (score_problem, AlignmentQuality.cpp:67) — e.g. two identical
    # degenerate covariances still score -0.5 because log(d1/d0) = log 1
    finite = jnp.isfinite(score) & (det1 != 0.0)
    return jnp.where(finite, score, 0.0), finite


def _moments_dispatch(q_xy, q_mask, p_xy, p_mask, radius):
    """The Triton kernel where the program is lowered for a CUDA GPU, the
    plain XLA form everywhere else (CPU tests).  The choice is made per
    lowering platform, so a CPU computation inside a GPU process still gets
    the plain form."""
    from ..pallas import coral_moments

    return jax.lax.platform_dependent(
        q_xy, q_mask, p_xy, p_mask, radius,
        cuda=coral_moments.neighbor_moments, default=_neighbor_moments)


@partial(jax.jit, static_argnames=("mode",))
def _coral_impl(src_xy, src_mask, ref_xy, ref_mask, radius, eps,
                mode: str = "entropy"):
    # src-perspective: own = src, other = ref; then the mirror.
    # ``is_src`` only matters in KL mode, where the reference scores src
    # points KL(sep||sep) and ref points KL(sep||joint)
    # (AlignmentQuality.cpp:139-166).
    def side(q_xy, q_mask, own_xy, own_mask, oth_xy, oth_mask, is_src):
        n_own, s1_own, s2_own = _moments_dispatch(q_xy, q_mask, own_xy, own_mask, radius)
        n_oth, s1_oth, s2_oth = _moments_dispatch(q_xy, q_mask, oth_xy, oth_mask, radius)
        n_joint = n_own + n_oth
        s1_joint = s1_own + s1_oth
        s2_joint = s2_own + s2_oth
        ok = (
            q_mask
            & (n_oth >= 1)  # overlap requirement
            & (n_own > 2)  # Covariance() rejects <= 2 rows
            & (n_joint > 2)
        )
        if mode == "kl":
            u_sep, s_sep = _mean_cov_from_moments(n_own, s1_own, s2_own)
            if is_src:
                kl, fin = _kl_divergence_2d(u_sep, s_sep, u_sep, s_sep)
            else:
                u_j, s_j = _mean_cov_from_moments(n_joint, s1_joint, s2_joint)
                kl, fin = _kl_divergence_2d(u_sep, s_sep, u_j, s_j)
            # sep_res_ stays 0 in KL mode (ComputeKLDiv writes joint only)
            return jnp.zeros_like(kl), kl, ok & fin
        ent_sep, _ = _entropy_from_moments(n_own, s1_own, s2_own, eps)
        ent_joint, _ = _entropy_from_moments(n_joint, s1_joint, s2_joint, eps)
        return ent_sep, ent_joint, \
            ok & jnp.isfinite(ent_sep) & jnp.isfinite(ent_joint)

    es_s, ej_s, ok_s = side(src_xy, src_mask, src_xy, src_mask, ref_xy,
                            ref_mask, True)
    es_r, ej_r, ok_r = side(ref_xy, ref_mask, ref_xy, ref_mask, src_xy,
                            src_mask, False)

    ok = jnp.concatenate([ok_s, ok_r])
    sep = jnp.concatenate([es_s, es_r])
    joint = jnp.concatenate([ej_s, ej_r])
    count_valid = jnp.sum(ok)
    denom = jnp.maximum(count_valid.astype(src_xy.dtype), 1.0)
    sep_mean = jnp.sum(jnp.where(ok, sep, 0.0)) / denom
    joint_mean = jnp.sum(jnp.where(ok, joint, 0.0)) / denom
    merged = jnp.sum(src_mask) + jnp.sum(ref_mask)
    overlap = count_valid / jnp.maximum(merged, 1)
    return CoralResult(joint=joint_mean, sep=sep_mean, overlap=overlap,
                       valid=overlap >= 0.1)


def coral_quality(src: PointCloud, ref: PointCloud, radius: float = 1.0,
                  eps: float = 1e-8, mode: str = "entropy") -> CoralResult:
    """CorAl quality of two WORLD-FRAME peak clouds.

    Callers transform the clouds by their poses first (the reference wraps
    scans into PoseScan and calls GetCloudCopy(T), AlignmentQuality.cpp:104).
    ``mode``: "entropy" (default, ent_cfg=entropy) or "kl" (ent_cfg=kl).
    """
    return _coral_impl(src.xy, src.mask, ref.xy, ref.mask,
                       jnp.asarray(radius, src.xy.dtype),
                       jnp.asarray(eps, src.xy.dtype), mode=mode)


def compact_cloud(cloud: PointCloud, capacity: int) -> PointCloud:
    """Reduce a padded cloud to ``capacity`` slots, keeping the strongest
    returns (used to bound verification cost for large k-strongest settings)."""
    score = jnp.where(cloud.mask, cloud.intensity, -1.0)
    _, idx = jax.lax.top_k(score, capacity)
    return PointCloud(
        xy=cloud.xy[idx],
        intensity=cloud.intensity[idx],
        mask=cloud.mask[idx] & (score[idx] >= 0),
    )
