"""Synthetic radar world + scan simulator.

The reference consumes recorded rosbags; this repo has no dataset on disk, so
tests, benchmarks and end-to-end demos use a simulated world: scatterers along
random wall segments (giving CFEAR features meaningful surface normals), a
smooth closed-loop trajectory, and a polar-image renderer that reproduces the
reference's bin conventions (theta = 2*pi*(a+1)/A, r = res*(bin+0.5)) so the
whole preprocessing stack is exercised bit-for-bit like real data would.

Host-side NumPy: this is a data source, not a device code path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SimWorld:
    points: np.ndarray  # [M, 2] scatterer positions (world frame)
    reflectivity: np.ndarray  # [M] in (0, 1]


def make_world(rng: np.random.Generator, num_walls: int = 60,
               extent: float = 80.0, points_per_meter: float = 3.0) -> SimWorld:
    """Random wall segments densely sampled into scatterers."""
    pts = []
    for _ in range(num_walls):
        start = rng.uniform(-extent, extent, size=2)
        ang = rng.uniform(0, 2 * np.pi)
        length = rng.uniform(8.0, 35.0)
        n = max(int(length * points_per_meter), 2)
        t = np.linspace(0, length, n)
        seg = start + t[:, None] * np.array([np.cos(ang), np.sin(ang)])
        seg = seg + rng.normal(scale=0.03, size=seg.shape)
        pts.append(seg)
    points = np.concatenate(pts, axis=0)
    reflectivity = rng.uniform(0.4, 1.0, size=points.shape[0])
    return SimWorld(points=points.astype(np.float64), reflectivity=reflectivity)


def loop_trajectory(num_frames: int, *, radius: float = 60.0,
                    step: float = 0.9, laps: float = 1.15,
                    noise: float = 0.0,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Closed circular loop revisiting its start: [N, 3] (x, y, yaw) poses.

    ``laps`` > 1 revisits the loop start, producing true loop closures.
    """
    total_angle = 2 * np.pi * laps
    # arc length per frame ~ step
    dtheta = step / radius
    n = num_frames
    angles = np.arange(n) * dtheta
    angles = angles * (total_angle / max(angles[-1], 1e-9)) if angles[-1] > total_angle else angles
    x = radius * np.cos(angles) - radius
    y = radius * np.sin(angles)
    yaw = angles + np.pi / 2  # heading along the tangent
    traj = np.stack([x, y, np.arctan2(np.sin(yaw), np.cos(yaw))], axis=1)
    if noise and rng is not None:
        traj[:, :2] += rng.normal(scale=noise, size=(n, 2))
    return traj


def render_scan(world: SimWorld, pose: np.ndarray, *, num_azimuths: int = 400,
                num_range_bins: int = 512, range_res: float = 0.2,
                peak_intensity: float = 180.0, noise_floor: float = 25.0,
                rng: Optional[np.random.Generator] = None,
                beam_spread: int = 1) -> np.ndarray:
    """Render the polar image [A, R] (uint8) seen from ``pose``.

    Scatterers deposit a small range-axis intensity kernel at their
    (azimuth, range) bin; background is low-level noise below the z_min=60
    gate.  Inverse of the reference bin->point mapping
    (radar_filters.cpp:316-331).
    """
    a_count, r_count = num_azimuths, num_range_bins
    c, s = np.cos(pose[2]), np.sin(pose[2])
    rel = world.points - pose[:2]
    # world -> sensor frame
    px = c * rel[:, 0] + s * rel[:, 1]
    py = -s * rel[:, 0] + c * rel[:, 1]
    r = np.hypot(px, py)
    ang = np.mod(np.arctan2(py, px), 2 * np.pi)
    # theta = 2*pi*(a+1)/A  =>  a = round(theta*A/(2*pi) - 1) mod A
    a_idx = np.mod(np.round(ang * a_count / (2 * np.pi) - 1).astype(int), a_count)
    r_idx = np.round(r / range_res - 0.5).astype(int)
    keep = (r_idx >= 2) & (r_idx < r_count - 2)

    img = np.zeros((a_count, r_count), np.float32)
    # distance attenuation keeps far returns above z_min but weaker
    atten = 1.0 / (1.0 + r / (r_count * range_res))
    amp = peak_intensity * world.reflectivity * atten
    kernel = [(0, 1.0)]
    for d in range(1, beam_spread + 1):
        kernel += [(-d, 0.45 / d), (d, 0.45 / d)]
    for off, w in kernel:
        np.add.at(img, (a_idx[keep], np.clip(r_idx[keep] + off, 0, r_count - 1)),
                  amp[keep] * w)
    if rng is not None:
        img += rng.normal(loc=noise_floor, scale=6.0, size=img.shape)
    else:
        img += noise_floor
    return np.clip(img, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class SimSequence:
    """A rendered sequence: polar images + ground-truth poses."""

    images: np.ndarray  # [N, A, R] uint8
    gt_poses: np.ndarray  # [N, 3]
    range_res: float
    num_azimuths: int
    num_range_bins: int


def make_sequence(num_frames: int = 60, seed: int = 0, *, num_azimuths: int = 400,
                  num_range_bins: int = 512, range_res: float = 0.2,
                  traj_kwargs: Optional[dict] = None) -> SimSequence:
    rng = np.random.default_rng(seed)
    world = make_world(rng)
    traj = loop_trajectory(num_frames, **(traj_kwargs or {}))
    imgs = np.stack([
        render_scan(world, traj[i], num_azimuths=num_azimuths,
                    num_range_bins=num_range_bins, range_res=range_res, rng=rng)
        for i in range(num_frames)
    ])
    return SimSequence(images=imgs, gt_poses=traj, range_res=range_res,
                       num_azimuths=num_azimuths, num_range_bins=num_range_bins)


@dataclasses.dataclass
class PGOInstance:
    """A synthetic TBV-scale pose-graph instance (double-lap circuit).

    Mirrors the reference's Oxford evaluation graph shape: an odometry chain
    with realistic drift noise plus loop-closure edges at revisits
    (ceresoptimizer.cpp operates on ~4471 keyframes, one chain + sparse
    loops).  Used by bench.py stage 3 and the PGO regression tests.
    """

    poses: np.ndarray  # [N, 3] odometry-composed initial estimate
    gt: np.ndarray  # [N, 3]
    idx: np.ndarray  # [E_cap, 2]
    meas: np.ndarray  # [E_cap, 3]
    etype: np.ndarray  # [E_cap]
    mask: np.ndarray  # [E_cap] bool
    n_loops: int

    @property
    def loop_cap(self) -> int:
        return max(((self.n_loops + 63) // 64) * 64, 64)


def make_pgo_instance(n_nodes: int, seed: int = 0, *, keyframe_dist: float = 1.5,
                      odo_sigma=(0.03, 0.03, 0.003),
                      loop_sigma=(0.05, 0.05, 0.005),
                      loop_stride: int = 7, edge_chunk: int = 1024,
                      odometry_type: int = 0,
                      loop_type: int = 2) -> PGOInstance:
    """Closed circuit traversed twice at keyframe spacing, noisy odometry
    composed into a drifting initial estimate (anchored at gt[0] so the gauge
    matches GT — ADVICE r1: never compare ATE across a constant gauge offset),
    ground-truth-consistent loop edges every ``loop_stride`` keyframes on the
    second lap."""
    rng = np.random.default_rng(seed)
    per_lap = n_nodes // 2
    circ_r = per_lap * keyframe_dist / (2 * np.pi)
    gt = np.zeros((n_nodes, 3), np.float32)
    for i in range(n_nodes):
        a = 2 * np.pi * (i % per_lap) / per_lap
        gt[i] = [circ_r * np.cos(a), circ_r * np.sin(a), a + np.pi / 2]

    def _rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        th = (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], th],
                        np.float32)

    def _comp(a, t):
        c, s = np.cos(a[2]), np.sin(a[2])
        return np.array([a[0] + c * t[0] - s * t[1],
                         a[1] + s * t[0] + c * t[1], a[2] + t[2]], np.float32)

    odo = [_rel(gt[i], gt[i + 1]) + rng.normal(0, odo_sigma).astype(np.float32)
           for i in range(n_nodes - 1)]
    poses = np.zeros((n_nodes, 3), np.float32)
    poses[0] = gt[0]
    for i in range(n_nodes - 1):
        poses[i + 1] = _comp(poses[i], odo[i])
    loop_pairs = [(i, i - per_lap) for i in range(per_lap, n_nodes, loop_stride)]
    e = n_nodes - 1 + len(loop_pairs)
    e_cap = max(((e + edge_chunk - 1) // edge_chunk) * edge_chunk, edge_chunk)
    idx = np.zeros((e_cap, 2), np.int32)
    meas = np.zeros((e_cap, 3), np.float32)
    etype = np.zeros((e_cap,), np.int32)
    mask = np.zeros((e_cap,), bool)
    for i in range(n_nodes - 1):
        idx[i], meas[i], etype[i], mask[i] = (i, i + 1), odo[i], odometry_type, True
    for k, (a, b) in enumerate(loop_pairs):
        j = n_nodes - 1 + k
        idx[j], etype[j], mask[j] = (a, b), loop_type, True
        meas[j] = _rel(gt[a], gt[b]) + rng.normal(0, loop_sigma)
    return PGOInstance(poses=poses, gt=gt, idx=idx, meas=meas, etype=etype,
                       mask=mask, n_loops=len(loop_pairs))


def _se2_rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    th = (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], th],
                    np.float32)


def _se2_comp(a: np.ndarray, t: np.ndarray) -> np.ndarray:
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * t[0] - s * t[1],
                     a[1] + s * t[0] + c * t[1], a[2] + t[2]], np.float32)


def load_reference_keyframe_gt(path: str) -> np.ndarray:
    """Read a KITTI-format keyframe trajectory (3x4 row-major per line, the
    reference's gt/00.txt layout, eval_trajectory.cpp:254-311) into planar
    SE(2) poses [N, 3] (x, y, yaw)."""
    m = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    yaw = np.arctan2(m[:, 1, 0], m[:, 0, 0])
    return np.stack([m[:, 0, 3], m[:, 1, 3], yaw], -1).astype(np.float32)


def find_loop_pairs(gt: np.ndarray, *, max_dist: float = 6.0,
                    min_idx_gap: int = 100, stride: int = 3) -> list:
    """Revisit pairs on a real trajectory: for every ``stride``-th keyframe,
    the nearest earlier keyframe at least ``min_idx_gap`` behind and within
    ``max_dist`` (the loop-label geometry of EvaluationManager.cpp:12-27).
    Vectorized [N, N] distance program — N ~ 4.5k keyframes is small."""
    d = np.linalg.norm(gt[:, None, :2] - gt[None, :, :2], axis=-1)
    n = len(gt)
    i_idx = np.arange(n)
    far = i_idx[None, :] > i_idx[:, None] - min_idx_gap  # mask out recents
    d = np.where(far, np.inf, d)
    nn = np.argmin(d, axis=1)
    ok = d[i_idx, nn] < max_dist
    return [(int(i), int(nn[i])) for i in range(0, n, stride) if ok[i]]


def make_trajectory_pgo_instance(
        gt: np.ndarray, seed: int = 0, *,
        odo_sigma=(0.02, 0.02, 7e-4),
        yaw_bias_rw: float = 3e-7,
        loop_sigma=(0.15, 0.15, 0.01),
        max_dist: float = 6.0, min_idx_gap: int = 100, loop_stride: int = 2,
        edge_chunk: int = 1024, odometry_type: int = 0,
        loop_type: int = 2) -> PGOInstance:
    """Realistic-drift pose-graph instance on a REAL route geometry.

    ``gt`` [N, 3] is a real keyframe trajectory (e.g. the reference's
    published Oxford 10-12-32 keyframe GT).  Odometry edges are GT relative
    motion corrupted by white noise PLUS a random-walk yaw bias — the
    signature drift of scan-matching radar odometry (slowly varying heading
    bias integrating into super-linear position error; CFEAR's Oxford
    odometry lands at ~7-29 m ATE, BASELINE.md).  Loop edges connect revisit
    pairs found on the GT route (EvaluationManager 6 m label geometry) with
    accepted-loop registration accuracy.  The result reproduces the
    reference's qualitative PGO behavior: odometry ATE >> SLAM ATE
    (18.5 -> 3.9 m over the 8-sequence Oxford evaluation, SURVEY §6.1).
    """
    rng = np.random.default_rng(seed)
    gt = np.asarray(gt, np.float32)
    n = len(gt)
    bias = np.cumsum(rng.normal(0.0, yaw_bias_rw, n - 1))
    odo = []
    for i in range(n - 1):
        e = rng.normal(0, odo_sigma)
        e[2] += bias[i]
        odo.append(_se2_rel(gt[i], gt[i + 1]) + e.astype(np.float32))
    poses = np.zeros((n, 3), np.float32)
    poses[0] = gt[0]
    for i in range(n - 1):
        poses[i + 1] = _se2_comp(poses[i], odo[i])
    loop_pairs = find_loop_pairs(gt, max_dist=max_dist,
                                 min_idx_gap=min_idx_gap, stride=loop_stride)
    e = n - 1 + len(loop_pairs)
    e_cap = max(((e + edge_chunk - 1) // edge_chunk) * edge_chunk, edge_chunk)
    idx = np.zeros((e_cap, 2), np.int32)
    meas = np.zeros((e_cap, 3), np.float32)
    etype = np.zeros((e_cap,), np.int32)
    mask = np.zeros((e_cap,), bool)
    for i in range(n - 1):
        idx[i], meas[i], etype[i], mask[i] = (i, i + 1), odo[i], \
            odometry_type, True
    for k, (a, b) in enumerate(loop_pairs):
        j = n - 1 + k
        idx[j], etype[j], mask[j] = (a, b), loop_type, True
        meas[j] = _se2_rel(gt[a], gt[b]) + rng.normal(0, loop_sigma)
    return PGOInstance(poses=poses, gt=gt, idx=idx, meas=meas, etype=etype,
                       mask=mask, n_loops=len(loop_pairs))


def interpolate_at_arclength(traj: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Interpolate an SE(2) trajectory [N, 3] at the given cumulative
    arc-lengths ``s`` (linear xy, shortest-arc yaw).  Used to resample a
    full-rate odometry trajectory at keyframe positions: arc-length is the
    gauge-free correspondence between an estimate and GT (scan-matching
    odometry has ~1% scale error but metres of absolute drift)."""
    d = np.linalg.norm(np.diff(traj[:, :2], axis=0), axis=1)
    arc = np.concatenate([[0.0], np.cumsum(d)])
    s = np.clip(s, 0.0, arc[-1])
    hi = np.clip(np.searchsorted(arc, s), 1, len(traj) - 1)
    lo = hi - 1
    seg = np.maximum(arc[hi] - arc[lo], 1e-9)
    t = ((s - arc[lo]) / seg)[:, None]
    xy = traj[lo, :2] * (1 - t) + traj[hi, :2] * t
    dyaw = np.arctan2(np.sin(traj[hi, 2] - traj[lo, 2]),
                      np.cos(traj[hi, 2] - traj[lo, 2]))
    yaw = traj[lo, 2] + t[:, 0] * dyaw
    return np.stack([xy[:, 0], xy[:, 1],
                     np.arctan2(np.sin(yaw), np.cos(yaw))], axis=1).astype(
        np.float32)


def make_real_odometry_pgo_instance(
        odom: np.ndarray, gt: np.ndarray, seed: int = 0, *,
        loop_sigma=(0.15, 0.15, 0.01),
        max_dist: float = 6.0, min_idx_gap: int = 100, loop_stride: int = 2,
        edge_chunk: int = 1024, odometry_type: int = 0,
        loop_type: int = 2) -> PGOInstance:
    """Pose-graph instance with the REAL drift profile: odometry edges are
    the actual relative motions of a measured radar-odometry trajectory
    (e.g. the reference's published Oxford 10-12-32 CFEAR output,
    evaluation/data/oxford_all_tbv_model_8/job_0/odom/01.txt), keyframe-
    matched to ``gt`` [N, 3].  Loop edges connect GT revisit pairs
    (EvaluationManager 6 m geometry) with accepted-loop registration
    accuracy — the oracle for retrieval+registration, isolating the PGO.

    ``odom`` must already be resampled to the same N keyframes as ``gt``
    (see ``interpolate_at_arclength``).  Unlike the synthetic instances, the
    initial estimate IS the real odometry trajectory, so ``ate_rmse(poses,
    gt)`` is the real odometry ATE and the post-PGO ATE is directly
    comparable to the published SLAM row (job_0 est/result.txt: 4.07 m)."""
    rng = np.random.default_rng(seed)
    odom = np.asarray(odom, np.float32)
    gt = np.asarray(gt, np.float32)
    n = len(gt)
    assert len(odom) == n, (len(odom), n)
    odo = [_se2_rel(odom[i], odom[i + 1]) for i in range(n - 1)]
    loop_pairs = find_loop_pairs(gt, max_dist=max_dist,
                                 min_idx_gap=min_idx_gap, stride=loop_stride)
    e = n - 1 + len(loop_pairs)
    e_cap = max(((e + edge_chunk - 1) // edge_chunk) * edge_chunk, edge_chunk)
    idx = np.zeros((e_cap, 2), np.int32)
    meas = np.zeros((e_cap, 3), np.float32)
    etype = np.zeros((e_cap,), np.int32)
    mask = np.zeros((e_cap,), bool)
    for i in range(n - 1):
        idx[i], meas[i], etype[i], mask[i] = (i, i + 1), odo[i], \
            odometry_type, True
    for k, (a, b) in enumerate(loop_pairs):
        j = n - 1 + k
        idx[j], etype[j], mask[j] = (a, b), loop_type, True
        meas[j] = _se2_rel(gt[a], gt[b]) + rng.normal(0, loop_sigma)
    return PGOInstance(poses=odom.copy(), gt=gt, idx=idx, meas=meas,
                       etype=etype, mask=mask, n_loops=len(loop_pairs))


def inject_odometry_drift(kf_poses: np.ndarray, constraints_idx: np.ndarray,
                          constraints_meas: np.ndarray, gt: np.ndarray,
                          *, target_ate_m: float = 4.0, seed: int = 0,
                          trans_noise_pct: float = 1.28):
    """Perturb keyframe odometry with a calibrated drift model and re-chain.

    The simulated world is far more feature-rich than real radar, so the
    measured e2e odometry barely drifts (VERDICT r3 weak #4: ATE 0.064 m
    makes loop closure decorative).  This injects the dominant real radar
    odometry error modes — a systematic yaw-rate bias (banana-shaped drift)
    plus per-step white noise at the reference's 1.28 % translation error
    (SURVEY §6.1) — into the odometry CONSTRAINTS, then re-chains the
    keyframe poses, exactly the relation the real system has between its
    (drifting) odometry and the GT.  The yaw bias is scaled so the drifted
    trajectory's ATE vs GT hits ``target_ate_m`` (secant calibration).

    Everything downstream (odometry-coupled retrieval, SC detection,
    registration, verification, PGO) then runs on the drifted odometry with
    REAL scan payloads.  Returns (drifted_poses [N,3], drifted_meas [E,3]).
    """
    from ..eval.trajectory import ate_rmse

    rng = np.random.default_rng(seed)
    meas = np.asarray(constraints_meas, np.float64).copy()
    idx = np.asarray(constraints_idx)
    step_len = np.linalg.norm(meas[:, :2], axis=1)
    white_t = rng.normal(size=(len(meas), 2)) * \
        (trans_noise_pct / 100.0) * step_len[:, None]
    white_r = rng.normal(size=len(meas)) * np.radians(0.05)

    def chain(scale):
        m = meas.copy()
        m[:, :2] += white_t
        m[:, 2] += white_r + scale * step_len  # yaw-rate bias [rad/m]
        poses = np.asarray(kf_poses, np.float64).copy()
        for e in range(len(idx)):
            a, b = int(idx[e, 0]), int(idx[e, 1])
            poses[b] = _se2_comp(poses[a], m[e])
        return poses.astype(np.float32), m.astype(np.float32)

    # secant calibration of the yaw-rate bias against the ATE target
    s0, s1 = 0.0, 1e-3
    a0 = ate_rmse(chain(s0)[0], gt)
    a1 = ate_rmse(chain(s1)[0], gt)
    for _ in range(20):
        if abs(a1 - target_ate_m) < 0.05 * target_ate_m:
            break
        if abs(a1 - a0) < 1e-9:
            break
        s2 = s1 + (target_ate_m - a1) * (s1 - s0) / (a1 - a0)
        s0, a0 = s1, a1
        s1 = float(np.clip(s2, -0.05, 0.05))
        a1 = ate_rmse(chain(s1)[0], gt)
    return chain(s1)
