"""Radar ScanContext place recognition as dense batched tensor ops.

Re-design of SCManager/RSCManager (reference Scancontext.cpp,
RadarScancontext.cpp): the per-candidate loops, nanoflann kd-trees and
column-by-column cosine scans become

- descriptor build: one scatter-add binning of the point cloud into the
  40x120 (ring, sector) grid (MakeRadarCloudContext,
  RadarScancontext.cpp:59-131),
- retrieval: an L2 distance over the [N, 40(+1)] ring-key matrix + top-k
  (OdometryNNSearch / VanillaKDNNSearch, RadarScancontext.cpp:224-284),
- ScanContext distance: ALL 120 circular shifts evaluated at once as one
  [S, ring, sector] tensor contraction, then masked to the reference's
  +-search_ratio window around the sector-key argmin so results match the
  restricted search exactly (distanceBtnScanContext, Scancontext.cpp:157-189).

Descriptor databases are padded to a static capacity and grown in chunks on
the host, so retrieval jits once per capacity bucket.
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.config import ScanContextConfig
from ..core.types import PointCloud


@partial(jax.jit, static_argnames=("num_ring", "num_sector", "desc_function"))
def _descriptor_impl(xy, intensity, mask, *, num_ring: int, num_sector: int,
                     max_radius: float, desc_divider: float, no_point: float,
                     desc_function: str):
    r = jnp.sqrt(jnp.sum(xy * xy, axis=-1))
    ang = jnp.degrees(jnp.mod(jnp.arctan2(xy[..., 1], xy[..., 0]), 2 * jnp.pi))
    in_range = mask & (r <= max_radius)
    # ring = max(min(R, ceil(r/maxR*R)), 1) - 1  (RadarScancontext.cpp:88-89)
    ring = jnp.clip(jnp.ceil(r / max_radius * num_ring), 1, num_ring) - 1
    sector = jnp.clip(jnp.ceil(ang / 360.0 * num_sector), 1, num_sector) - 1
    if desc_function == "sum":
        # Matmul form: bin = (ring, sector) factorizes, so the scatter-add
        # becomes TWO one-hot contractions — desc = Ronehot^T diag(I) Sonehot
        # — instead of a segment_sum (which form is faster on the GPU is
        # unmeasured).  f32 accumulation forced: counts feed a `> 0` test.
        ring_oh = ((ring[:, None] == jnp.arange(num_ring)[None, :])
                   & in_range[:, None])
        sec_oh = (sector[:, None] == jnp.arange(num_sector)[None, :])
        ring_w = ring_oh.astype(intensity.dtype) * intensity[:, None]
        sec_f = sec_oh.astype(intensity.dtype)
        desc = jnp.einsum("pr,ps->rs", ring_w, sec_f,
                          precision=jax.lax.Precision.HIGHEST)
        counts = jnp.einsum("pr,ps->rs", ring_oh.astype(jnp.float32), sec_f,
                            precision=jax.lax.Precision.HIGHEST)
        desc = desc / desc_divider
        return jnp.where(counts > 0.5, desc, no_point)
    lin = (ring * num_sector + sector).astype(jnp.int32)
    lin = jnp.where(in_range, lin, num_ring * num_sector)  # spill bin
    nbins = num_ring * num_sector + 1
    desc = jax.ops.segment_max(
        jnp.where(in_range, intensity, -jnp.inf), lin, num_segments=nbins)
    desc = jnp.where(jnp.isfinite(desc), desc, 0.0)
    counts = jax.ops.segment_sum(in_range.astype(jnp.float32), lin,
                                 num_segments=nbins)
    desc = desc[:-1].reshape(num_ring, num_sector) / desc_divider
    counts = counts[:-1].reshape(num_ring, num_sector)
    desc = jnp.where(counts > 0, desc, no_point)
    return desc


def make_descriptor(cloud: PointCloud, cfg: ScanContextConfig) -> jnp.ndarray:
    """Point cloud -> [ring, sector] ScanContext descriptor."""
    return _descriptor_impl(
        cloud.xy, cloud.intensity, cloud.mask,
        num_ring=cfg.num_ring, num_sector=cfg.num_sector,
        max_radius=cfg.max_radius, desc_divider=cfg.desc_divider,
        no_point=cfg.no_point, desc_function=cfg.desc_function,
    )


def ring_key(desc: jnp.ndarray) -> jnp.ndarray:
    """Row-wise mean (rotation invariant key, Scancontext.cpp:239-252)."""
    return jnp.mean(desc, axis=-1)


def sector_key(desc: jnp.ndarray) -> jnp.ndarray:
    """Column-wise mean (Scancontext.cpp:255-268)."""
    return jnp.mean(desc, axis=-2)


def all_column_shifts(desc: jnp.ndarray) -> jnp.ndarray:
    """[shift, ring, sector] stack of all circular column shifts.

    shift s means: shifted[:, (c + s) mod S] = desc[:, c] (the reference's
    circshift moves columns right, Scancontext.cpp:80-98).
    """
    s = desc.shape[-1]
    cols = jnp.arange(s)
    src = jnp.mod(cols[None, :] - jnp.arange(s)[:, None], s)  # [shift, col]
    return jnp.transpose(desc[:, src], (1, 0, 2))  # [shift, ring, col]


def _dist_direct_batched(q: jnp.ndarray, cands_shifted: jnp.ndarray) -> jnp.ndarray:
    """distDirectSC for a query [R, S] against shifted candidates [..., R, S].

    1 - mean columnwise cosine similarity over columns where BOTH have
    non-zero norm (Scancontext.cpp:110-131).
    """
    qn = jnp.linalg.norm(q, axis=0)  # [S]
    cn = jnp.linalg.norm(cands_shifted, axis=-2)  # [..., S]
    dot = jnp.einsum("rs,...rs->...s", q, cands_shifted)
    eff = (qn[None, ...] > 0) & (cn > 0) if cands_shifted.ndim == 3 else \
        (qn > 0) & (cn > 0)
    sim = jnp.where(eff, dot / jnp.maximum(qn * cn, 1e-20), 0.0)
    num_eff = jnp.maximum(jnp.sum(eff, axis=-1), 1)
    return 1.0 - jnp.sum(sim, axis=-1) / num_eff


@partial(jax.jit, static_argnames=("search_ratio",))
def sc_distance(query: jnp.ndarray, candidate: jnp.ndarray,
                search_ratio: float = 0.1):
    """(min dist, argmin shift) between two descriptors.

    Reproduces distanceBtnScanContext (Scancontext.cpp:157-189): sector-key
    fast alignment picks a center shift; the column-wise cosine distance is
    evaluated on shifts within +-round(0.5*ratio*S) of it.

    Matmul form: the per-shift column dot products are all entries of ONE
    [S, S] Gram matrix G = query^T @ candidate gathered along circular
    diagonals — no [S, R, S] shifted-copy tensor is ever materialized, so
    this stays cheap under vmap over (queries x augments x candidates) in
    the batched offline wave.
    """
    s = query.shape[-1]
    vq = sector_key(query)
    vc = sector_key(candidate)
    cols = jnp.arange(s)
    # src column of the shifted candidate at (shift, col): (col - shift) % S
    src = jnp.mod(cols[None, :] - cols[:, None], s)  # [shift, col]

    # fastAlignUsingVkey: argmin_shift |vq - circshift(vc, shift)|
    vdiff2 = jnp.sum((vq[None, :] - vc[src]) ** 2, axis=-1)
    center = jnp.argmin(vdiff2)

    # distDirectSC over all shifts from the Gram matrix
    g = query.T @ candidate  # [S(cols_q), S(cols_c)]
    dot = g[cols[None, :], src]  # [shift, col] = sum_r q[r,col] c[r,col-s]
    qn = jnp.linalg.norm(query, axis=0)  # [S]
    cn = jnp.linalg.norm(candidate, axis=0)[src]  # [shift, col]
    eff = (qn[None, :] > 0) & (cn > 0)
    sim = jnp.where(eff, dot / jnp.maximum(qn[None, :] * cn, 1e-20), 0.0)
    num_eff = jnp.maximum(jnp.sum(eff, axis=-1), 1)
    dists = 1.0 - jnp.sum(sim, axis=-1) / num_eff  # [shift]

    radius = int(round(0.5 * search_ratio * s))
    circ = jnp.minimum(jnp.mod(cols - center, s), jnp.mod(center - cols, s))
    masked = jnp.where(circ <= radius, dists, jnp.inf)
    best = jnp.argmin(masked)
    return masked[best], best


class RetrievalResult(NamedTuple):
    dist: jnp.ndarray  # [K] combined score (sc + odom when coupled)
    dist_sc: jnp.ndarray  # [K]
    dist_odom: jnp.ndarray  # [K]
    index: jnp.ndarray  # [K] database ids
    shift: jnp.ndarray  # [K] argmin column shift
    valid: jnp.ndarray  # [K] bool


@partial(jax.jit, static_argnames=("num_candidates", "search_ratio",
                                   "odometry_coupled"))
def retrieve(
    query_desc: jnp.ndarray,  # [R, S]
    query_key: jnp.ndarray,  # [R]
    db_desc: jnp.ndarray,  # [N, R, S] padded
    db_key: jnp.ndarray,  # [N, R]
    db_mask: jnp.ndarray,  # [N] bool (true = searchable)
    odom_similarity: jnp.ndarray,  # [N] (zeros when not coupled)
    *,
    num_candidates: int,
    search_ratio: float,
    odometry_coupled: bool = True,
):
    """Ring-key NN retrieval + ScanContext distance for the top candidates.

    OdometryNNSearch (RadarScancontext.cpp:259-284): the search key is
    [ring_key, 10*odom_sim] with the query's last component 0; candidates are
    the ``num_candidates`` smallest L2 keys, then scored with the full
    ScanContext distance; combined score = sc_dist + odom_sim
    (RadarScancontext.cpp:310-325).
    """
    d2 = jnp.sum((db_key - query_key[None, :]) ** 2, axis=-1)
    if odometry_coupled:
        d2 = d2 + (10.0 * odom_similarity) ** 2
    d2 = jnp.where(db_mask, d2, jnp.inf)
    neg, idx = jax.lax.top_k(-d2, num_candidates)
    valid = jnp.isfinite(-neg)

    cands = db_desc[idx]  # [K, R, S]
    dist_fn = lambda c: sc_distance(query_desc, c, search_ratio=search_ratio)
    dist_sc, shift = jax.vmap(dist_fn)(cands)
    dist_odom = jnp.where(odometry_coupled, odom_similarity[idx], 0.0)
    total = jnp.where(valid, dist_sc + dist_odom, jnp.inf)
    return RetrievalResult(dist=total, dist_sc=dist_sc, dist_odom=dist_odom,
                           index=idx, shift=shift, valid=valid)


def shift_to_yaw(shift: jnp.ndarray, num_sector: int) -> jnp.ndarray:
    """Column shift -> yaw alignment in radians
    (PC_UNIT_SECTORANGLE, RadarScancontext.cpp:322)."""
    return shift.astype(jnp.float32) * (2.0 * jnp.pi / num_sector)


def odometry_similarity(positions: jnp.ndarray, mask: jnp.ndarray,
                        sigma: float) -> jnp.ndarray:
    """Per-past-pose odometry similarity of the NEWEST masked pose.

    ExcludeAndUpdateLikelihood (RadarScancontext.cpp:183-221): walking
    backwards from the current pose, accumulate traveled distance; rel_err =
    max(d_est - 5, 0)/d_travelled; similarity = 1 - exp(-rel_err^2/(2 sigma^2)).
    Padded slots get similarity 1 (worst).
    """
    n = positions.shape[0]
    count = jnp.sum(mask)
    cur = count - 1
    cur_pos = positions[jnp.maximum(cur, 0)]

    seg = jnp.linalg.norm(positions[1:] - positions[:-1], axis=-1)
    seg = jnp.concatenate([jnp.zeros(1), seg])  # seg[i] = |p_i - p_{i-1}|
    cum = jnp.cumsum(seg)  # distance from p_0 along the path
    trav = cum[jnp.maximum(cur, 0)] - cum  # distance traveled from i to cur

    d_est = jnp.linalg.norm(cur_pos[None, :] - positions, axis=-1)
    err = jnp.maximum(d_est - 5.0, 0.0)
    rel = err / jnp.maximum(trav, 1e-9)
    prob = jnp.exp(-rel * rel / (2.0 * sigma * sigma))
    sim = 1.0 - prob
    idx = jnp.arange(n)
    return jnp.where(mask & (idx < cur), sim, 1.0)


def num_exclude_recent(positions: jnp.ndarray, mask: jnp.ndarray,
                       distance: float) -> jnp.ndarray:
    """Dynamic recent-exclusion count from traveled distance
    (RadarScancontext.cpp:187-200)."""
    count = jnp.sum(mask)
    cur = jnp.maximum(count - 1, 0)
    seg = jnp.linalg.norm(positions[1:] - positions[:-1], axis=-1)
    seg = jnp.concatenate([jnp.zeros(1), seg])
    cum = jnp.cumsum(seg)
    trav = cum[cur] - cum  # [N] distance from i to current
    idx = jnp.arange(positions.shape[0])
    within = mask & (idx <= cur) & (trav < distance)
    return jnp.maximum(jnp.sum(within), jnp.where(count <= 2, 2, 0))
