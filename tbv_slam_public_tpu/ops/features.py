"""CFEAR oriented-surface-point features.

Re-design of MapPointNormal (reference pointnormal.cpp:7-297): the
voxel-grid downsample + kd-tree radius searches + per-cell Eigen eigensolves
become one batched pipeline over padded tensors:

1. voxel binning by ``floor(p / leaf)`` with scatter-add centroids
   (replaces pcl::VoxelGrid, pointnormal.cpp:276-281),
2. top-C occupied voxels -> fixed cell capacity,
3. masked all-pairs neighborhood stats (cell x point distance matrix;
   replaces kdt_input.radiusSearchT, pointnormal.cpp:287-292),
4. intensity-weighted mean + 2x2 weighted covariance per cell
   (cell::cell, pointnormal.cpp:7-35), computed in coordinates centered on the
   voxel centroid for f32 robustness,
5. closed-form symmetric 2x2 eigendecomposition -> surface normal, planarity,
   validity gates cond <= 1e4, det > 1e-5, lambda > 0
   (cell::ComputeNormal, pointnormal.cpp:37-63), normal oriented toward the
   sensor origin.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.config import FeatureConfig
from ..core.types import Cells, PointCloud


def eigh2x2(cov: jnp.ndarray):
    """Closed-form eigendecomposition of symmetric 2x2 matrices ``[..., 2, 2]``.

    Returns (lmin, lmax, vmin) with vmin the unit eigenvector of lmin.
    """
    a = cov[..., 0, 0]
    b = cov[..., 0, 1]
    c = cov[..., 1, 1]
    half_tr = 0.5 * (a + c)
    disc = jnp.sqrt(jnp.maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    lmin = half_tr - disc
    lmax = half_tr + disc
    # Eigenvector for lmin: rows of (cov - lmax I) span it; pick the better
    # conditioned of the two candidate expressions.
    v1 = jnp.stack([b, lmin - a], axis=-1)
    v2 = jnp.stack([lmin - c, b], axis=-1)
    n1 = jnp.sum(v1 * v1, axis=-1)
    n2 = jnp.sum(v2 * v2, axis=-1)
    v = jnp.where((n1 > n2)[..., None], v1, v2)
    # Degenerate (b ~ 0): axis-aligned eigenvectors.
    axis = jnp.where(
        (a <= c)[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0], cov.dtype), v.shape),
        jnp.broadcast_to(jnp.array([0.0, 1.0], cov.dtype), v.shape),
    )
    norm = jnp.sqrt(jnp.maximum(n1, n2))
    v = jnp.where((norm > 1e-20)[..., None], v / jnp.maximum(norm, 1e-20)[..., None], axis)
    return lmin, lmax, v


@partial(jax.jit, static_argnames=("cell_capacity", "grid_cells", "min_neighbors",
                                   "weight_intensity"))
def _compute_cells_impl(xy, intensity, mask, *, leaf: float, radius: float,
                        grid_extent: float, grid_cells: int, cell_capacity: int,
                        min_neighbors: int, weight_intensity: bool,
                        intensity_floor: float, max_cond: float, min_det: float,
                        origin_x: float, origin_y: float):
    p = xy.shape[0]
    fmask = mask.astype(xy.dtype)

    # --- 1. voxel binning -------------------------------------------------
    # Matmul form: the voxel id (i, j) factorizes, so the per-point
    # scatter-add (segment_sum) becomes three one-hot contractions
    # [G,P]x[P,G] over the row/column one-hots, with the point mask folded
    # into the row side (exact at HIGHEST; gather/scatter vs one-hot on the
    # GPU is unmeasured).
    ij = jnp.floor(xy / leaf).astype(jnp.int32) + grid_cells // 2
    ij = jnp.clip(ij, 0, grid_cells - 1)
    g = jnp.arange(grid_cells)
    oh_i = ((ij[:, 0:1] == g[None, :]) & mask[:, None]).astype(xy.dtype)
    oh_j = (ij[:, 1:2] == g[None, :]).astype(xy.dtype)  # [P, G]
    hi = jax.lax.Precision.HIGHEST
    counts = jnp.einsum("pg,ph->gh", oh_i, oh_j, precision=hi).reshape(-1)
    sums = jnp.stack([
        jnp.einsum("pg,ph->gh", oh_i * xy[:, 0:1], oh_j,
                   precision=hi).reshape(-1),
        jnp.einsum("pg,ph->gh", oh_i * xy[:, 1:2], oh_j,
                   precision=hi).reshape(-1),
    ], axis=-1)  # [G*G, 2]

    # --- 2. select top-C occupied voxels ---------------------------------
    occ_score = jnp.where(counts > 0, counts, -1.0)
    _, sel = jax.lax.top_k(occ_score, cell_capacity)
    sel_count = counts[sel]
    sel_occupied = sel_count > 0
    centroid = sums[sel] / jnp.maximum(sel_count, 1.0)[:, None]  # [C,2]

    # --- 3. masked neighborhood stats (centered on voxel centroid) -------
    # full-precision cross term: TF32 matmuls would corrupt the radius gate
    # at |p|~100 m (see registration._pairwise_sqdist)
    d2 = (
        jnp.sum(centroid * centroid, axis=1)[:, None]
        + jnp.sum(xy * xy, axis=1)[None, :]
        - 2.0 * jnp.matmul(centroid, xy.T,
                           precision=jax.lax.Precision.HIGHEST)
    )  # [C, P]
    nbr = (d2 <= radius * radius) & mask[None, :] & sel_occupied[:, None]
    nbr_count = jnp.sum(nbr, axis=1)

    if weight_intensity:
        w = jnp.maximum(intensity - intensity_floor, 0.0)
    else:
        w = jnp.ones_like(intensity)
    wm = jnp.where(nbr, w[None, :], 0.0)  # [C, P]
    w_sum = jnp.sum(wm, axis=1)
    w_norm = wm / jnp.maximum(w_sum, 1e-12)[:, None]

    # centered coordinates per cell (f32-safe: |q| <= radius + leaf)
    q = xy[None, :, :] - centroid[:, None, :]  # [C, P, 2]
    mu_local = jnp.einsum("cp,cpi->ci", w_norm, q)
    qq = jnp.einsum("cp,cpi,cpj->cij", w_norm, q, q)
    cov = qq - mu_local[:, :, None] * mu_local[:, None, :]
    cov = 0.5 * (cov + jnp.swapaxes(cov, -1, -2))  # enforce symmetry in f32
    mean = centroid + mu_local

    # --- 4. eigen-based normal + gates -----------------------------------
    lmin, lmax, normal = eigh2x2(cov)
    cond = jnp.abs(lmax / jnp.where(jnp.abs(lmin) > 1e-20, lmin, 1e-20))
    det = lmax * lmin
    cov_ok = (cond <= max_cond) & (det > min_det) & (lmin > 0) & (lmax > 0)
    planarity = jnp.log1p(cond / 2.0)  # reference `scale_`, used as weight feature

    # orient toward sensor origin (pointnormal.cpp:59-61)
    origin = jnp.array([origin_x, origin_y], xy.dtype)
    flip = jnp.sum(normal * (origin[None, :] - mean), axis=-1) < 0
    normal = jnp.where(flip[:, None], -normal, normal)

    valid = sel_occupied & (nbr_count >= min_neighbors) & cov_ok & (w_sum > 1e-9)
    avg_intensity = w_sum / jnp.maximum(nbr_count, 1)

    z = lambda x: jnp.where(valid.reshape(valid.shape + (1,) * (x.ndim - 1)), x, 0.0)
    return Cells(
        mean=z(mean),
        cov=z(cov),
        normal=z(normal),
        nsamples=jnp.where(valid, nbr_count.astype(xy.dtype), 0.0),
        planarity=z(planarity),
        avg_intensity=z(avg_intensity),
        valid=valid,
    )


def compute_cells(cloud: PointCloud, cfg: FeatureConfig,
                  origin=(0.0, 0.0)) -> Cells:
    """Point cloud -> CFEAR oriented-surface-point cells."""
    leaf = cfg.resolution / cfg.downsample_factor
    grid_cells = int(2 * cfg.grid_extent / leaf) + 2
    return _compute_cells_impl(
        cloud.xy, cloud.intensity, cloud.mask,
        leaf=leaf,
        radius=cfg.resolution,
        grid_extent=cfg.grid_extent,
        grid_cells=grid_cells,
        cell_capacity=cfg.cell_capacity,
        min_neighbors=cfg.min_neighbors,
        weight_intensity=cfg.weight_intensity,
        intensity_floor=cfg.intensity_floor,
        max_cond=cfg.max_cond,
        min_det=cfg.min_det,
        origin_x=float(origin[0]),
        origin_y=float(origin[1]),
    )


def transform_cells(cells: Cells, pose: jnp.ndarray) -> Cells:
    """Rigid transform of a feature set (cell::TransformCopy, pointnormal.h:66-77)."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    rot = jnp.stack([jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2)
    mean = cells.mean @ rot.T + pose[..., :2]
    normal = cells.normal @ rot.T
    cov = jnp.einsum("ab,cbd,ed->cae", rot, cells.cov, rot)
    return cells.replace(mean=mean, normal=normal, cov=cov)
