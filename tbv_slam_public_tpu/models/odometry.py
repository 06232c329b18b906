"""CFEAR radar odometry: keyframe fuser as one jitted frame step.

Re-design of OdometryKeyframeFuser (reference odometrykeyframefuser.cpp:143-260)
as a pure function over a fixed-shape state pytree: the per-frame pipeline
(motion compensation -> features -> window registration -> sanity check ->
keyframe gate -> buffer roll) compiles to a single XLA program; the host loop
only feeds polar images and collects scalar outputs plus fused keyframes.

No queues, no threads, no mutable keyframe deque: the keyframe window is a
stacked Cells pytree rolled under jit.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se2
from ..core.config import TBVConfig
from ..core.timing import timing
from ..core.types import Cells, PointCloud, make_cells, pytree_dataclass
from ..ops import features, radar, registration


@pytree_dataclass
class OdometryState:
    kf_cells: Cells  # [S, C, ...] keyframe window, oldest..newest
    kf_poses: jnp.ndarray  # [S, 3]
    kf_mask: jnp.ndarray  # [S] bool
    T_prev: jnp.ndarray  # [3] pose of the previous frame
    Tmot: jnp.ndarray  # [3] previous frame-to-frame motion (local)
    frame_idx: jnp.ndarray  # [] int32


@pytree_dataclass
class OdometryOutput:
    pose: jnp.ndarray  # [3] current frame pose (world)
    fused: jnp.ndarray  # [] bool — became a keyframe
    success: jnp.ndarray  # [] bool — registration succeeded
    constraint: jnp.ndarray  # [3] relative pose last-keyframe -> current
    cov: jnp.ndarray  # [3, 3]
    score: jnp.ndarray  # []
    num_residuals: jnp.ndarray  # [] int32
    cells: Cells  # current frame features (for keyframe storage)
    cloud: PointCloud  # filtered cloud (motion compensated)
    peaks: PointCloud  # peaks cloud (motion compensated)


def init_state(cfg: TBVConfig) -> OdometryState:
    s = cfg.odometry.submap_scan_size
    c = cfg.features.cell_capacity
    cells1 = make_cells(c)
    kf_cells = jax.tree.map(lambda x: jnp.stack([x] * s), cells1)
    return OdometryState(
        kf_cells=kf_cells,
        kf_poses=jnp.zeros((s, 3), jnp.float32),
        kf_mask=jnp.zeros((s,), bool),
        T_prev=jnp.zeros(3, jnp.float32),
        Tmot=jnp.zeros(3, jnp.float32),
        frame_idx=jnp.asarray(0, jnp.int32),
    )


def _push_keyframe(state: OdometryState, cells: Cells, pose: jnp.ndarray):
    kf_cells = jax.tree.map(
        lambda buf, new: jnp.concatenate([buf[1:], new[None]], axis=0),
        state.kf_cells, cells)
    kf_poses = jnp.concatenate([state.kf_poses[1:], pose[None]], axis=0)
    kf_mask = jnp.concatenate([state.kf_mask[1:], jnp.ones((1,), bool)], axis=0)
    return state.replace(kf_cells=kf_cells, kf_poses=kf_poses, kf_mask=kf_mask)


@partial(jax.jit, static_argnames=("cfg",))
def first_frame(state: OdometryState, image: jnp.ndarray, cfg: TBVConfig):
    """Frame 0: seed the keyframe window at the origin
    (odometrykeyframefuser.cpp:171-178)."""
    cloud, peaks = radar.filter_scan(image, cfg.radar)
    cells = features.compute_cells(cloud, cfg.features)
    state = _push_keyframe(state, cells, jnp.zeros(3, jnp.float32))
    state = state.replace(frame_idx=state.frame_idx + 1)
    out = OdometryOutput(
        pose=jnp.zeros(3, jnp.float32), fused=jnp.asarray(True),
        success=jnp.asarray(True), constraint=jnp.zeros(3, jnp.float32),
        cov=jnp.eye(3, dtype=jnp.float32),
        score=jnp.asarray(0.0, jnp.float32),
        num_residuals=jnp.asarray(0, jnp.int32), cells=cells, cloud=cloud,
        peaks=peaks)
    return state, out


@partial(jax.jit, static_argnames=("cfg",))
def odometry_step(state: OdometryState, image: jnp.ndarray, cfg: TBVConfig):
    """One odometry frame (odometrykeyframefuser.cpp:143-260)."""
    ocfg = cfg.odometry

    cloud, peaks = radar.filter_scan(image, cfg.radar)
    if ocfg.compensate and not ocfg.time_continuous:
        cloud = radar.motion_compensate(cloud, state.Tmot, ocfg.radar_ccw)
        peaks = radar.motion_compensate(peaks, state.Tmot, ocfg.radar_ccw)
    cells = features.compute_cells(cloud, cfg.features)

    Tguess = se2.compose(state.T_prev, state.Tmot) if ocfg.use_guess else state.T_prev

    prior = None
    if ocfg.soft_constraint:
        # soft velocity prior toward the constant-velocity guess
        # (n_scan_normal.cpp:371-375)
        prior = jnp.diag(jnp.asarray([10.0, 10.0, 31.6], jnp.float32))
    kf_cells0, kf_poses0, kf_mask0 = (
        state.kf_cells, state.kf_poses, state.kf_mask)
    if ocfg.time_continuous:
        # RegisterTimeContinuous (n_scan_normal.cpp:67-80): per-cell velocity
        # correction inside the P2P solve, velocity = previous motion.
        res = registration.register_time_continuous(
            cells, Tguess, kf_cells0, kf_poses0, kf_mask0,
            cfg.registration, state.Tmot, ccw=ocfg.radar_ccw,
            guess=Tguess if prior is not None else None,
            guess_sqrt_info=prior,
        )
    else:
        res = registration.register_window(
            cells, Tguess, kf_cells0, kf_poses0, kf_mask0,
            cfg.registration,
            guess=Tguess if prior is not None else None,
            guess_sqrt_info=prior,
        )
    Tcurrent = jnp.where(res.success, res.pose, Tguess)

    # Acceleration/velocity sanity check (odometrykeyframefuser.cpp:76-94)
    Tmot_curr = se2.relative(state.T_prev, Tcurrent)
    dt = ocfg.sensor_period
    vel = jnp.linalg.norm(Tmot_curr[:2]) / dt
    acc = jnp.linalg.norm(Tmot_curr[:2] - state.Tmot[:2]) / (dt * dt)
    sane = (vel <= ocfg.vel_limit) & (acc <= ocfg.acc_limit)
    Tcurrent = jnp.where(sane, Tcurrent, Tguess)
    Tmot = se2.relative(state.T_prev, Tcurrent)

    # Keyframe gate vs the newest keyframe (odometrykeyframefuser.cpp:62-73)
    last_kf = state.kf_poses[-1]
    diff = se2.relative(last_kf, Tcurrent)
    fuse = (
        (jnp.linalg.norm(diff[:2]) > ocfg.min_keyframe_dist)
        | (jnp.abs(diff[2]) > jnp.deg2rad(ocfg.min_keyframe_rot_deg))
    ) if ocfg.use_keyframe else jnp.asarray(True)
    fuse = fuse & res.success

    store_cells = cells
    if ocfg.time_continuous:
        # keyframe window stores the undistorted (velocity-corrected) features
        store_cells = registration.motion_correct_cells(
            cells, state.Tmot, ocfg.radar_ccw)
    new_state = _push_keyframe(state, store_cells, Tcurrent)
    state = jax.tree.map(
        lambda a, b: jnp.where(
            jnp.reshape(fuse, (1,) * a.ndim), a, b) if a.ndim else
        jnp.where(fuse, a, b),
        new_state, state)
    state = state.replace(
        T_prev=Tcurrent, Tmot=Tmot, frame_idx=state.frame_idx + 1)

    # Odometry constraint in the last keyframe's frame; covariance rotated
    # into that frame (odometrykeyframefuser.cpp:428-445).
    rot = se2.rotmat(-last_kf[2])
    cov = res.cov
    if ocfg.use_sampled_covariance or ocfg.cov_source == "sampled":
        cov_s, ok = registration.sampled_covariance(
            store_cells, Tcurrent, kf_cells0, kf_poses0, kf_mask0,
            cfg.registration, res.score, res.num_residuals,
            xy_range=ocfg.cov_sampling_xy_range,
            yaw_range=ocfg.cov_sampling_yaw_range,
            steps=ocfg.cov_sampling_samples_per_axis,
            cov_scaler=ocfg.cov_sampling_scaler)
        cov = jnp.where(ok, cov_s, cov)
    elif ocfg.cov_source == "ceres":
        # Ceres-covariance-style output (n_scan_normal.cpp:390-431)
        cov_c, ok = registration.ceres_covariance(
            store_cells, Tcurrent, kf_cells0, kf_poses0, kf_mask0,
            cfg.registration, res.score, res.num_residuals)
        cov = jnp.where(ok, cov_c, cov)
    cov_rot = cov.at[:2, :2].set(rot @ cov[:2, :2] @ rot.T)

    out = OdometryOutput(
        pose=Tcurrent, fused=fuse, success=res.success, constraint=diff,
        cov=cov_rot, score=res.score, num_residuals=res.num_residuals,
        cells=store_cells, cloud=cloud, peaks=peaks)
    return state, out


@partial(jax.jit, static_argnames=("cfg",), donate_argnames=("state",))
def odometry_scan(state: OdometryState, images: jnp.ndarray,
                  cfg: TBVConfig):
    """K odometry frames as ONE device program (lax.scan over the frame
    step).

    The per-frame host loop costs a dispatch and a host fetch per frame.
    Scanning a chunk keeps the sequential frame dependency on device and
    reduces host traffic
    to one image upload + two fetches per chunk (scalars for every frame;
    payload gather for the fused ones).  State is donated: it lives on
    device across chunks.
    """

    def step(st, img):
        st, out = odometry_step(st, img, cfg)
        return st, out

    return jax.lax.scan(step, state, images)


@partial(jax.jit, static_argnames=("cfg",))
def batched_first_frame(states, images, cfg: TBVConfig):
    """Vmapped frame 0 over a batch of sequences."""
    return jax.vmap(lambda s, i: first_frame(s, i, cfg))(states, images)


@partial(jax.jit, static_argnames=("cfg",))
def batched_odometry_step(states, images, cfg: TBVConfig):
    """One odometry frame for B sequences at once (SURVEY §7.1: "multiple
    sequences batch data-parallel").  The per-frame dependency is sequential
    per sequence, but across sequences everything batches, so the
    registration/feature programs run at batch-B occupancy instead of
    latency-bound batch-1."""
    return jax.vmap(lambda s, i: odometry_step(s, i, cfg))(states, images)


def init_batched_state(cfg: TBVConfig, batch: int) -> OdometryState:
    one = init_state(cfg)
    return jax.tree.map(lambda x: jnp.stack([x] * batch), one)


class OdometryPipeline:
    """Host-side driver: feeds images, collects keyframes and constraints.

    The analogue of the offline_odometry node (offline_odometry.cpp:57-146)
    minus ROS: keyframe clouds/features/poses are buffered as NumPy for the
    SLAM back-end, and frame poses are recorded for trajectory export.
    """

    def __init__(self, cfg: TBVConfig):
        self.cfg = cfg
        self.state = init_state(cfg)
        self.frame_poses: List[np.ndarray] = []
        self.frame_stamps: List[float] = []
        self.frame_covs: List[np.ndarray] = []  # per-frame registration cov
        # keyframe store (the simple_graph analogue)
        self.kf_poses: List[np.ndarray] = []
        self.kf_stamps: List[float] = []
        self.kf_cells = []
        self.kf_peaks = []
        self.kf_clouds = []
        self.kf_gt: List[np.ndarray] = []  # GT at keyframe stamps (if fed)
        self.kf_constraints: List[dict] = []
        self._last_kf_idx: Optional[int] = None

    def process(self, image: np.ndarray, stamp: float = 0.0,
                gt_pose: Optional[np.ndarray] = None) -> OdometryOutput:
        image = jnp.asarray(image)
        if int(self.state.frame_idx) == 0:
            with timing.timer("odometry_first_frame"):
                self.state, out = first_frame(self.state, image, self.cfg)
        else:
            with timing.timer("odometry_step"):
                self.state, out = odometry_step(self.state, image, self.cfg)
        # ONE device->host fetch for the per-frame scalars instead of one
        # transfer per leaf
        pose_h, cov_h, fused_h, constraint_h = jax.device_get(
            (out.pose, out.cov, out.fused, out.constraint))
        self._record_frame(pose_h, cov_h, bool(fused_h), constraint_h, stamp,
                           gt_pose,
                           lambda: jax.device_get(
                               (out.cells, out.peaks, out.cloud)))
        return out

    def _record_frame(self, pose_h, cov_h, fused: bool, constraint_h, stamp,
                      gt_pose, fetch_payload) -> None:
        """Shared per-frame bookkeeping; ``fetch_payload()`` returns
        (cells, peaks, cloud) as host trees and is only called on fuse."""
        self.frame_poses.append(pose_h)
        self.frame_stamps.append(stamp)
        self.frame_covs.append(cov_h)
        if fused:
            kf_idx = len(self.kf_poses)
            self.kf_poses.append(pose_h)
            self.kf_stamps.append(stamp)
            if gt_pose is not None:
                self.kf_gt.append(np.asarray(gt_pose, np.float32))
            cells_h, peaks_h, cloud_h = fetch_payload()
            self.kf_cells.append(cells_h)
            self.kf_peaks.append(peaks_h)
            self.kf_clouds.append(cloud_h)
            if self._last_kf_idx is not None:
                self.kf_constraints.append(dict(
                    id_begin=self._last_kf_idx,
                    id_end=kf_idx,
                    t_be=constraint_h,
                    cov=cov_h,
                ))
            self._last_kf_idx = kf_idx

    def process_chunk(self, images: np.ndarray, stamps=None,
                      gt_poses=None) -> int:
        """Run a CHUNK of frames as one device program (odometry_scan).

        Per-chunk host traffic: one [K, A, R] image upload, one scalar fetch
        for all K frames, one gathered payload fetch for the fused frames —
        instead of 2-3 round trips per frame.  Returns the number of
        keyframes fused.  Frame 0 (window seeding) runs via ``process``.
        """
        images = np.asarray(images)
        k = images.shape[0]
        if k == 0:
            return 0
        stamps = [0.0] * k if stamps is None else list(stamps)
        gts = [None] * k if gt_poses is None else list(gt_poses)
        start = 0
        n_kf0 = len(self.kf_poses)
        if int(self.state.frame_idx) == 0:
            self.process(images[0], stamps[0], gt_pose=gts[0])
            start = 1
            if k == 1:
                return len(self.kf_poses) - n_kf0
        with timing.timer("odometry_scan_chunk"):
            self.state, outs = odometry_scan(
                self.state, jnp.asarray(images[start:]), self.cfg)
            # fetch 1: tiny per-frame scalars for the whole chunk
            poses_h, covs_h, fused_h, constraints_h = jax.device_get(
                (outs.pose, outs.cov, outs.fused, outs.constraint))
            fused_idx = np.nonzero(fused_h)[0]
            payload_h = None
            if fused_idx.size:
                # fetch 2: keyframe payloads, gathered ON DEVICE first so
                # only fused frames are copied to the host
                idx = jnp.asarray(fused_idx)
                payload_h = jax.device_get(jax.tree.map(
                    lambda x: x[idx], (outs.cells, outs.peaks, outs.cloud)))
        pay_pos = {int(f): j for j, f in enumerate(fused_idx)}
        for i in range(k - start):
            take = (lambda j: lambda: jax.tree.map(
                lambda x: x[j], payload_h))(pay_pos.get(i))
            self._record_frame(
                poses_h[i], covs_h[i], bool(fused_h[i]), constraints_h[i],
                stamps[start + i], gts[start + i], take)
        return len(self.kf_poses) - n_kf0
