"""Core array-record types (pytrees).

Re-design of the reference's object types (reference:
cfear_radarodometry/include/cfear_radarodometry/types.h:26-315 and
pointnormal.h:45-243): a scan is a fixed-shape record of padded tensors with
validity masks, features are struct-of-arrays, and the pose graph is SoA.
Everything here is a pytree usable under jit/vmap/scan and across shard_map.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, TypeVar

import jax
import jax.numpy as jnp

T = TypeVar("T")


def pytree_dataclass(cls: type[T]) -> type[T]:
    """Frozen dataclass registered as a JAX pytree whose fields are all
    leaves, with ``replace(**changes)`` returning an updated copy."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class PointCloud:
    """Padded 2D point cloud with intensity.

    Replaces pcl::PointCloud<pcl::PointXYZI> (z unused by the planar
    pipeline).  ``mask`` marks real points; padded slots hold zeros.
    """

    xy: jnp.ndarray  # [P, 2] float32
    intensity: jnp.ndarray  # [P] float32
    mask: jnp.ndarray  # [P] bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask, axis=-1)


@pytree_dataclass
class Cells:
    """CFEAR oriented-surface-point feature set (SoA form of MapPointNormal).

    One row per grid cell (reference `cell`, pointnormal.h:45-105):
    intensity-weighted mean, 2x2 weighted covariance, oriented surface normal,
    sample count, planarity score and validity.
    """

    mean: jnp.ndarray  # [C, 2] float32 — weighted sample mean u_
    cov: jnp.ndarray  # [C, 2, 2] float32 — weighted covariance cov_
    normal: jnp.ndarray  # [C, 2] float32 — unit normal (smallest eigvec), oriented
    nsamples: jnp.ndarray  # [C] float32 — number of contributing points
    planarity: jnp.ndarray  # [C] float32 — log(1 + cond/2), reference `scale_`
    avg_intensity: jnp.ndarray  # [C] float32
    valid: jnp.ndarray  # [C] bool

    @property
    def capacity(self) -> int:
        return self.mean.shape[-2]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid, axis=-1)


@pytree_dataclass
class Scan:
    """One processed radar frame: filtered cloud, peaks cloud, features.

    Mirrors the payload of the reference RadarScan (types.h:100-196) minus the
    bookkeeping that lives in the host-side graph.
    """

    cloud: PointCloud  # k-strongest filtered cloud ("cloud_nopeaks_")
    peaks: PointCloud  # axial-NMS peaks cloud ("cloud_peaks_")
    cells: Cells  # CFEAR features ("cloud_normal_")


# Constraint type codes for the SoA pose graph (reference types.h:207-214).
ODOMETRY = 0
LOOP_APPEARANCE = 1
MINI_LOOP = 2
CANDIDATE = 3


@pytree_dataclass
class GraphEdges:
    """Padded SoA edge store for pose-graph optimization.

    Replaces vector<Constraint3d> (types.h:198-254).  ``meas`` is the relative
    pose t_be of node ``idx[:,1]`` ("end") expressed in the frame of node
    ``idx[:,0]`` ("begin").  ``sqrt_info`` holds per-edge full 3x3 whitening
    matrices for (x, y, theta) — diagonal under replace_cov_by_identity, a
    Cholesky factor of the measured information otherwise (construct via
    ops.posegraph.make_edges, which also accepts the diagonal [E, 3] form).
    """

    idx: jnp.ndarray  # [E, 2] int32 — (id_begin, id_end)
    meas: jnp.ndarray  # [E, 3] float32 — relative SE(2) measurement
    sqrt_info: jnp.ndarray  # [E, 3, 3] float32 — whitening (sqrt information)
    etype: jnp.ndarray  # [E] int32 — ODOMETRY / LOOP_APPEARANCE / ...
    mask: jnp.ndarray  # [E] bool

    @property
    def capacity(self) -> int:
        return self.idx.shape[-2]


@pytree_dataclass
class RegistrationResult:
    """Output of a window registration solve."""

    pose: jnp.ndarray  # [3] optimized source pose (world frame)
    score: jnp.ndarray  # [] final cost (Ceres convention: 0.5 * sum rho)
    num_residuals: jnp.ndarray  # [] int32
    iterations: jnp.ndarray  # [] int32 — outer (re-association) iterations used
    success: jnp.ndarray  # [] bool
    cov: jnp.ndarray  # [3, 3] covariance of (x, y, theta)


def make_point_cloud(capacity: int, dtype=jnp.float32) -> PointCloud:
    return PointCloud(
        xy=jnp.zeros((capacity, 2), dtype),
        intensity=jnp.zeros((capacity,), dtype),
        mask=jnp.zeros((capacity,), bool),
    )


def make_cells(capacity: int, dtype=jnp.float32) -> Cells:
    return Cells(
        mean=jnp.zeros((capacity, 2), dtype),
        cov=jnp.zeros((capacity, 2, 2), dtype),
        normal=jnp.zeros((capacity, 2), dtype),
        nsamples=jnp.zeros((capacity,), dtype),
        planarity=jnp.zeros((capacity,), dtype),
        avg_intensity=jnp.zeros((capacity,), dtype),
        valid=jnp.zeros((capacity,), bool),
    )
