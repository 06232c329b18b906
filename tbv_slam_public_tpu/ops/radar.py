"""Polar radar image filtering: k-strongest, axial non-max suppression, CA-CFAR.

Re-design of the reference's per-azimuth scalar loops
(radar_filters.cpp:209-307, cfar.cpp:12-84): the whole [A, R] polar image is
processed with one batched ``top_k`` + vectorized shift comparisons; no
per-row Python.  Semantics reproduced:

- k-strongest: per azimuth keep the k strongest range bins with intensity
  >= z_min (radar_filters.cpp:209-237).
- polar->Cartesian: theta = 2*pi*(a+1)/A, r = range_res*(bin + 0.5), and
  only bins with index > ceil(min_distance/range_res) become points
  (radar_filters.cpp:316-331).
- axial NMS peaks: per azimuth, score(r) = sum of raw intensities in a
  +-window box; a k-strongest bin is a peak iff its score is a local maximum
  against all +-window neighbors (radar_filters.cpp:238-298).
- CA-CFAR: cell-averaging threshold on squared intensities with guard cells,
  alpha = N * (FAR^(-1/N) - 1) (cfar.cpp:12-71).

Outputs are fixed-capacity [A*k] point sets with masks.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..core.config import RadarConfig
from ..core.types import PointCloud


def polar_to_xy(azimuth_idx: jnp.ndarray, range_idx: jnp.ndarray,
                num_azimuths: int, range_res: float) -> jnp.ndarray:
    """Reference bin->point mapping (radar_filters.cpp:316-331)."""
    theta = (azimuth_idx.astype(jnp.float32) + 1.0) / num_azimuths * (2.0 * jnp.pi)
    r = range_res * (range_idx.astype(jnp.float32) + 0.5)
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def _axial_nms_peak_mask(image: jnp.ndarray, window: int) -> jnp.ndarray:
    """Boolean [A, R] map of axial score local maxima.

    score[a, r] = sum_{|d|<=window} image[a, r+d]  (smoothed curve,
    radar_filters.cpp:249-263); peak iff for every i in 1..window:
    score[r-i] <= score[r] >= score[r+i] (ties allowed, :266-290), and the
    bin lies in the interior [window, R-window-1] (:246-247).
    """
    a, r = image.shape
    img = image.astype(jnp.int32)
    # box filter along range via cumulative sum
    padded = jnp.pad(img, ((0, 0), (window + 1, window)))
    csum = jnp.cumsum(padded, axis=1)
    score = csum[:, 2 * window + 1:] - csum[:, : r]  # [A, R] sum over [r-w, r+w]

    ok = jnp.ones((a, r), dtype=bool)
    for i in range(1, window + 1):
        prev = jnp.pad(score, ((0, 0), (i, 0)))[:, :r]
        nxt = jnp.pad(score, ((0, 0), (0, i)))[:, i:]
        ok = ok & (prev <= score) & (score >= nxt)
    rng = jnp.arange(r)
    interior = (rng >= window) & (rng < r - window)
    return ok & interior[None, :]


@partial(jax.jit, static_argnames=("num_azimuths", "num_range_bins", "k_strongest",
                                   "nms_window", "z_min", "range_res",
                                   "min_distance", "max_distance"))
def _kstrongest_impl(image: jnp.ndarray, *, num_azimuths: int, num_range_bins: int,
                     k_strongest: int, nms_window: int, z_min: float,
                     range_res: float, min_distance: float, max_distance: float):
    img = image.astype(jnp.float32)
    # Mask sub-threshold returns out before top-k (z_min gate,
    # radar_filters.cpp:216-218).
    gated = jnp.where(img >= z_min, img, -1.0)
    vals, idxs = jax.lax.top_k(gated, k_strongest)  # [A, k]

    a_idx = jnp.broadcast_to(jnp.arange(num_azimuths)[:, None], vals.shape)
    xy = polar_to_xy(a_idx, idxs, num_azimuths, range_res)

    min_range_bin = int(math.ceil(min_distance / range_res))
    max_range_bin = max_distance / range_res
    valid = (vals >= z_min) & (idxs > min_range_bin) & (idxs.astype(jnp.float32) <= max_range_bin)

    peak_map = _axial_nms_peak_mask(image, nms_window)
    peak_sel = jnp.take_along_axis(peak_map, idxs, axis=1)

    flat = lambda x: x.reshape((num_azimuths * k_strongest,) + x.shape[2:])
    cloud = PointCloud(xy=flat(xy), intensity=flat(vals), mask=flat(valid))
    peaks = PointCloud(xy=flat(xy), intensity=flat(vals), mask=flat(valid & peak_sel))
    return cloud, peaks


def kstrongest_filter(image: jnp.ndarray, cfg: RadarConfig):
    """Polar image [A, R] (uint8) -> (filtered cloud, peaks cloud).

    Both clouds have capacity A*k; the peaks cloud is the filtered cloud
    restricted to axial-NMS maxima, exactly like
    StructuredKStrongest::getPeaksFilteredPointCloud (radar_filters.cpp:299-307).
    """
    assert image.ndim == 2, "expected [A, R] polar image"
    return _kstrongest_impl(
        image,
        num_azimuths=image.shape[0],
        num_range_bins=image.shape[1],
        k_strongest=cfg.k_strongest,
        nms_window=cfg.nms_window,
        z_min=cfg.z_min,
        range_res=cfg.range_res,
        min_distance=cfg.min_distance,
        max_distance=cfg.max_distance,
    )


@partial(jax.jit, static_argnames=("guard_cells", "window_size", "k_strongest",
                                   "false_alarm_rate", "z_min", "range_res",
                                   "min_distance", "max_distance"))
def _cacfar_impl(image: jnp.ndarray, *, guard_cells: int, window_size: int,
                 false_alarm_rate: float, z_min: float, range_res: float,
                 min_distance: float, max_distance: float, k_strongest: int):
    a, r = image.shape
    img = image.astype(jnp.float32)
    sq = img * img
    n = 2 * window_size  # leading + trailing training cells
    alpha = n * (false_alarm_rate ** (-1.0 / n) - 1.0)

    padded = jnp.pad(sq, ((0, 0), (1, 0)))
    csum = jnp.cumsum(padded, axis=1)  # csum[:, i] = sum sq[:, :i]

    def windowsum(start, size):
        """Sum of sq[:, start:start+size] per row, clipped to valid bins."""
        lo = jnp.clip(start, 0, r)
        hi = jnp.clip(start + size, 0, r)
        return jnp.take_along_axis(csum, hi[None, :], axis=1) - \
            jnp.take_along_axis(csum, lo[None, :], axis=1)

    rng = jnp.arange(r)
    lead = windowsum(rng - guard_cells - window_size, jnp.int32(window_size))
    trail = windowsum(rng + guard_cells + 1, jnp.int32(window_size))
    noise = (lead + trail) / n
    detected = (sq > alpha * noise) & (img >= z_min)

    # Keep at most k detections per azimuth (strongest first) so output
    # capacity matches the k-strongest path.
    gated = jnp.where(detected, img, -1.0)
    vals, idxs = jax.lax.top_k(gated, k_strongest)
    a_idx = jnp.broadcast_to(jnp.arange(a)[:, None], vals.shape)
    xy = polar_to_xy(a_idx, idxs, a, range_res)
    min_range_bin = int(math.ceil(min_distance / range_res))
    valid = (vals > 0) & (idxs > min_range_bin) & \
        (idxs.astype(jnp.float32) <= max_distance / range_res)
    flat = lambda x: x.reshape((a * k_strongest,) + x.shape[2:])
    return PointCloud(xy=flat(xy), intensity=flat(vals), mask=flat(valid))


def cacfar_filter(image: jnp.ndarray, cfg: RadarConfig) -> PointCloud:
    """Cell-averaging CFAR detector (AzimuthCACFAR, cfar.cpp:19-84)."""
    return _cacfar_impl(
        image,
        guard_cells=cfg.cfar_guard_cells,
        window_size=max(cfg.cfar_window_size, 1),
        false_alarm_rate=cfg.cfar_false_alarm_rate,
        z_min=cfg.z_min,
        range_res=cfg.range_res,
        min_distance=cfg.min_distance,
        max_distance=cfg.max_distance,
        k_strongest=cfg.k_strongest,
    )


def motion_compensate(cloud: PointCloud, motion: jnp.ndarray, ccw: bool) -> PointCloud:
    """Per-point constant-velocity de-skew (utils.cpp:96-113).

    Each point's relative timestamp d in [-0.5, 0.5] derives from its azimuth
    angle (utils.h:28-32); the point is moved by the motion scaled by d.
    """
    x, y = cloud.xy[..., 0], cloud.xy[..., 1]
    ang = jnp.arctan2(y, x)
    d = jnp.where(ang > 1e-5, ang, 2.0 * jnp.pi + ang) / (2.0 * jnp.pi)
    factor = -(d - 0.5) if ccw else (d - 0.5)
    c = jnp.cos(motion[2] * factor)
    s = jnp.sin(motion[2] * factor)
    nx = c * x - s * y + motion[0] * factor
    ny = s * x + c * y + motion[1] * factor
    return cloud.replace(xy=jnp.stack([nx, ny], axis=-1))


@partial(jax.jit, static_argnames=("window_size", "scale_factor",
                                   "offset_factor", "k_strongest",
                                   "range_res", "min_distance",
                                   "max_distance"))
def _bfar_impl(image: jnp.ndarray, *, window_size: int, scale_factor: float,
               offset_factor: float, range_res: float, min_distance: float,
               max_distance: float, k_strongest: int):
    a, r = image.shape
    img = image.astype(jnp.float32)
    padded = jnp.pad(img, ((0, 0), (1, 0)))
    csum = jnp.cumsum(padded, axis=1)

    def windowsum(start, size):
        lo = jnp.clip(start, 0, r)
        hi = jnp.clip(start + size, 0, r)
        return (jnp.take_along_axis(csum, hi[None, :], axis=1)
                - jnp.take_along_axis(csum, lo[None, :], axis=1)), hi - lo

    rng = jnp.arange(r)
    lead, n_lead = windowsum(rng - window_size, jnp.int32(window_size))
    trail, n_trail = windowsum(rng + 1, jnp.int32(window_size))
    count = jnp.maximum(n_lead + n_trail, 1).astype(jnp.float32)
    noise = (lead + trail) / count[None, :]
    detected = img > (scale_factor * noise + offset_factor)

    gated = jnp.where(detected, img, -1.0)
    vals, idxs = jax.lax.top_k(gated, k_strongest)
    a_idx = jnp.broadcast_to(jnp.arange(a)[:, None], vals.shape)
    xy = polar_to_xy(a_idx, idxs, a, range_res)
    min_range_bin = int(math.ceil(min_distance / range_res))
    valid = (vals > 0) & (idxs > min_range_bin) & \
        (idxs.astype(jnp.float32) <= max_distance / range_res)
    flat = lambda x: x.reshape((a * k_strongest,) + x.shape[2:])
    return PointCloud(xy=flat(xy), intensity=flat(vals), mask=flat(valid))


def bfar_filter(image: jnp.ndarray, cfg: RadarConfig) -> PointCloud:
    """BFAR detector: CFAR with an AFFINE threshold a*noise + b (the
    false-alarm-rate bound of Alhashimi et al.; the reference declares a
    BFARScan type, ScanType.h:207-213, whose filter call is commented out —
    rebuilt here so the scan-type zoo is complete).  Training window =
    ``cfar_window_size`` cells on each side (no guard cells), threshold
    parameters ``bfar_scale`` / ``bfar_offset``."""
    return _bfar_impl(
        image,
        window_size=max(cfg.cfar_window_size, 1),
        scale_factor=cfg.bfar_scale,
        offset_factor=cfg.bfar_offset,
        range_res=cfg.range_res,
        min_distance=cfg.min_distance,
        max_distance=cfg.max_distance,
        k_strongest=cfg.k_strongest,
    )


def filter_scan(image: jnp.ndarray, cfg: RadarConfig):
    """Detector dispatch on ``cfg.filter_type`` (radarDriver::Process selects
    the filter by Parameters::filter_type, radar_driver.cpp:48-73):
    "kstrong" (default, returns filtered + axial-NMS peaks clouds),
    "cacfar", or "bfar" (detector output serves as both clouds — the CFAR
    detections ARE the peaks)."""
    if cfg.filter_type == "kstrong":
        return kstrongest_filter(image, cfg)
    if cfg.filter_type == "cacfar":
        cloud = cacfar_filter(image, cfg)
        return cloud, cloud
    if cfg.filter_type == "bfar":
        cloud = bfar_filter(image, cfg)
        return cloud, cloud
    raise ValueError(f"unknown filter_type {cfg.filter_type!r}")
