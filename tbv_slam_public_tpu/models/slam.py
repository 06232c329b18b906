"""TBV SLAM facade: odometry + loop closure + pose-graph optimization.

Re-design of TBVSLAM / PoseGraph (reference tbv_slam/src/tbv_slam/
{tbv_slam.cpp:9-48, posegraph.cpp}) without threads or queues: a
deterministic schedule — per-frame odometry, loop-closure waves over
completed keyframes, and explicit PGO epochs — replacing the reference's
AddNodeThread/AddConstraintThread/OptimizerThread machinery (the offline,
deterministic path is the parity target; README.md:106-108 documents the
online mode's nondeterminism).

The graph is SoA: keyframe poses [N, 3], odometry/loop constraints as padded
GraphEdges consumed by ops.posegraph.optimize.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se2
from ..core.config import TBVConfig
from ..core.timing import timing
from ..core.types import LOOP_APPEARANCE, MINI_LOOP, ODOMETRY
from ..eval import trajectory as traj_eval
from ..ops import posegraph
from .loopclosure import LoopCloser, LoopConstraint
from .odometry import OdometryOutput, OdometryPipeline


class PoseGraph:
    """Host-side SoA pose graph over keyframes (reference posegraph.h:57-225).

    Keeps both the odometry-chained world poses and the optimized estimate;
    edges are padded in chunks so the jitted optimizer compiles per capacity
    bucket.
    """

    def __init__(self, cfg: TBVConfig, mesh=None):
        # ``mesh``: optional jax.sharding.Mesh enabling solver="distributed"
        # (edge-sharded psum-CG over the mesh, parallel.pgo).
        self.cfg = cfg
        self.mesh = mesh
        self.poses: List[np.ndarray] = []  # current (optimized) estimate
        self.stamps: List[float] = []
        self.gt: List[Optional[np.ndarray]] = []
        self.edges: List[dict] = []

    def add_node(self, pose: np.ndarray, stamp: float = 0.0,
                 gt: Optional[np.ndarray] = None) -> int:
        """Append a keyframe; rebases on the previous optimized pose through
        the newest odometry constraint (AddNode, posegraph.cpp:52-73) when one
        is attached via add_odometry_constraint afterwards."""
        self.poses.append(np.asarray(pose, np.float32))
        self.stamps.append(stamp)
        self.gt.append(None if gt is None else np.asarray(gt, np.float32))
        return len(self.poses) - 1

    def add_odometry_constraint(self, id_begin: int, id_end: int,
                                t_be: np.ndarray,
                                cov: Optional[np.ndarray] = None) -> None:
        self.edges.append(dict(idx=(id_begin, id_end),
                               meas=np.asarray(t_be, np.float32),
                               etype=ODOMETRY,
                               cov=None if cov is None
                               else np.asarray(cov, np.float32)))
        # rebase the new node on the optimized begin pose (posegraph.cpp:52-73)
        # host numpy: a jnp op here would be a device dispatch per keyframe
        self.poses[id_end] = se2.compose_np(self.poses[id_begin],
                                            np.asarray(t_be, np.float32))

    def add_loop_constraint(self, c: LoopConstraint,
                            etype: int = LOOP_APPEARANCE) -> None:
        self.edges.append(dict(idx=(c.id_from, c.id_to),
                               meas=np.asarray(c.t_be, np.float32),
                               etype=etype,
                               cov=None if getattr(c, "cov", None) is None
                               else np.asarray(c.cov, np.float32)))

    @property
    def num_nodes(self) -> int:
        return len(self.poses)

    def num_loops(self) -> int:
        return sum(1 for e in self.edges
                   if e["etype"] in (LOOP_APPEARANCE, MINI_LOOP))

    def traveled_distance(self) -> float:
        """Sum of odometry constraint norms (posegraph.cpp:151-160)."""
        return float(sum(np.linalg.norm(e["meas"][:2]) for e in self.edges
                         if e["etype"] == ODOMETRY))

    def _padded(self, chunk: int):
        n = len(self.poses)
        e = len(self.edges)
        ncap = max(((n + chunk - 1) // chunk) * chunk, chunk)
        ecap = max(((e + chunk - 1) // chunk) * chunk, chunk)
        poses = np.zeros((ncap, 3), np.float32)
        poses[:n] = np.stack(self.poses) if n else 0.0
        node_mask = np.zeros((ncap,), bool)
        node_mask[:n] = True
        idx = np.zeros((ecap, 2), np.int32)
        meas = np.zeros((ecap, 3), np.float32)
        etype = np.zeros((ecap,), np.int32)
        mask = np.zeros((ecap,), bool)
        covs = np.tile(np.eye(3, dtype=np.float32), (ecap, 1, 1))
        has_cov = np.zeros((ecap,), bool)
        for i, ed in enumerate(self.edges):
            idx[i] = ed["idx"]
            meas[i] = ed["meas"]
            etype[i] = ed["etype"]
            mask[i] = True
            c = ed.get("cov")
            if c is not None and np.all(np.isfinite(c)):
                covs[i], has_cov[i] = c, True
        if self.cfg.pgo.replace_cov_by_identity or not has_cov.any():
            sqrt_info = np.asarray(posegraph.default_sqrt_info(
                jnp.asarray(etype), self.cfg.pgo))
        else:
            # measured-information path (ceresoptimizer.cpp:92-100): edges
            # carrying a registration covariance are whitened by
            # chol(cov^{-1} * loop_scale); edges without one keep the
            # identity-scaled default
            meas_si = np.asarray(posegraph.measured_sqrt_info(
                jnp.asarray(covs), jnp.asarray(etype), self.cfg.pgo))
            def_si = np.asarray(jax.vmap(jnp.diag)(posegraph.default_sqrt_info(
                jnp.asarray(etype), self.cfg.pgo)))
            sqrt_info = np.where(has_cov[:, None, None], meas_si, def_si)
        edges = posegraph.make_edges(idx, meas, sqrt_info, etype, mask)
        return poses, node_mask, edges

    def optimize(self, solver: str = "auto") -> posegraph.PGOResult:
        """ForceOptimize (posegraph.cpp:112-130) — one full robust LM solve.

        ``solver="auto"`` picks the structured chain+Woodbury solver when the
        odometry edges form the keyframe chain and loops are sparse (the
        normal SLAM case), falling back to the dense Cholesky otherwise.
        ``solver="distributed"`` runs the edge-sharded psum-CG LM over the
        mesh passed to the constructor (parallel.pgo.optimize_distributed —
        the multi-chip path; requires a mesh).
        """
        chunk = self.cfg.pgo.edge_capacity_chunk
        poses, node_mask, edges = self._padded(chunk)
        if solver == "distributed":
            if self.mesh is None:
                raise ValueError("solver='distributed' requires a mesh "
                                 "(PoseGraph(cfg, mesh=...))")
            from ..parallel import pgo as par_pgo

            with timing.timer("pose_graph_optimization"):
                res = par_pgo.optimize_distributed(
                    self.mesh, jnp.asarray(poses), jnp.asarray(node_mask),
                    edges, self.cfg.pgo)
                res.poses.block_until_ready()
            out = np.asarray(res.poses)
            for i in range(len(self.poses)):
                self.poses[i] = out[i]
            return res
        loop_cap = None
        n_chain = sum(1 for e in self.edges
                      if e["etype"] == ODOMETRY
                      and e["idx"][1] == e["idx"][0] + 1)
        n_other = len(self.edges) - n_chain
        if solver == "auto":
            if n_chain >= max(4, len(self.poses) // 2) \
                    and n_other * 6 < 3 * len(self.poses):
                solver = "schur"
            else:
                solver = "cholesky"
        if solver == "schur":
            # computed for BOTH auto-resolved and explicitly requested schur
            # (an explicit --solver schur used to crash on loop_cap=None)
            loop_cap = max(((n_other + 63) // 64) * 64, 64)
        with timing.timer("pose_graph_optimization"):
            res = posegraph.optimize(jnp.asarray(poses), jnp.asarray(node_mask),
                                     edges, self.cfg.pgo, solver=solver,
                                     loop_cap=loop_cap)
            res.poses.block_until_ready()
        out = np.asarray(res.poses)
        for i in range(len(self.poses)):
            self.poses[i] = out[i]
        return res

    def poses_array(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 3))

    def gt_array(self) -> Optional[np.ndarray]:
        if any(g is None for g in self.gt) or not self.gt:
            return None
        return np.stack(self.gt)

    def align_to_gt(self) -> Optional[Dict[str, float]]:
        """SVD best-fit to GT + ATE metrics (Align, posegraph.cpp:235-263)."""
        gt = self.gt_array()
        if gt is None:
            return None
        est = self.poses_array()
        return dict(
            ate_rmse=traj_eval.ate_rmse(est, gt),
            ate_mean=traj_eval.ate_mean(est, gt),
        )


@dataclass
class SLAMSummary:
    num_frames: int
    num_keyframes: int
    num_loops: int
    traveled_distance: float
    pgo_cost0: float
    pgo_cost: float
    metrics: Optional[Dict[str, float]]


def run_offline_slam(cfg: TBVConfig, simple_graph, solver: str = "cholesky",
                     batched: bool = True, mesh=None) -> "TBVSLAM":
    """SLAM from an odometry-stage checkpoint (the tbv_slam_offline path:
    load simple_graph -> loop closure to exhaustion -> one optimization,
    tbv_slam_offline.cpp:215-356).  Returns the populated TBVSLAM; call
    ``.finish()`` happened internally — read ``.summary``.

    ``batched=True`` runs loop closure in offline wave mode: all retrievals
    and all candidate registrations as batched device programs
    (LoopCloser.process_all_batched) instead of the per-keyframe host loop —
    same constraints, far better accelerator occupancy.
    """
    import jax.numpy as jnp

    slam = TBVSLAM(cfg, mesh=mesh)
    g = simple_graph
    n = g.num_keyframes
    take = lambda tree, i: jax.tree.map(lambda x: jnp.asarray(x[i]), tree)
    for i in range(n):
        gt = None if g.kf_gt is None else g.kf_gt[i]
        slam.graph.add_node(g.kf_poses[i], float(g.kf_stamps[i]), gt=gt)
        slam.loops.add_keyframe(take(g.peaks, i), take(g.cells, i),
                                g.kf_poses[i])
    covs = getattr(g, "constraints_cov", None)
    for k, (idx, meas) in enumerate(zip(g.constraints_idx,
                                        g.constraints_meas)):
        cov = None if covs is None or k >= len(covs) else covs[k]
        slam.graph.add_odometry_constraint(int(idx[0]), int(idx[1]), meas,
                                           cov=cov)
    if batched:
        with timing.timer("loop_wave_batched"):
            for lc in slam.loops.process_all_batched():
                slam.graph.add_loop_constraint(lc)
    slam.summary = slam.finish(optimize=True, solver=solver)
    return slam


class TBVSLAM:
    """Full pipeline on one sequence (the tbv_slam_offline analogue,
    tbv_slam_offline.cpp:215-356 — deterministic single-stream schedule)."""

    def __init__(self, cfg: TBVConfig, train_alignment: bool = False,
                 mesh=None):
        # ``mesh``: optional jax.sharding.Mesh — loop-candidate waves shard
        # their pair axis and the graph gains solver="distributed".
        self.cfg = cfg
        self.odometry = OdometryPipeline(cfg)
        self.loops = LoopCloser(cfg, mesh=mesh)
        self.graph = PoseGraph(cfg, mesh=mesh)
        self._frames = 0
        self._kf_to_node: List[int] = []
        self._kf_since_opt = 0
        self.pgo_epochs = 0
        # Online alignment-classifier training (tbv_slam_online.cpp:185-188):
        # feed each keyframe to the learner; finish() refits and swaps the
        # loop verifier's alignment model.
        self.alignment_learner = None
        if train_alignment:
            from .verification import AlignmentLearner

            self.alignment_learner = AlignmentLearner(cfg.verification)
        # Additional strategies (TBVSLAM ctor instantiates the enabled ones,
        # tbv_slam.cpp:9-30).
        from .strategies import ProximityCloser

        self.mini_closure = ProximityCloser(cfg, self.loops) \
            if cfg.loopclosure.miniclosure_enabled else None
        self.gt_vicinity = ProximityCloser(cfg, self.loops, gt_vicinity=True) \
            if cfg.loopclosure.gt_vicinity_enabled else None

    def process_frame(self, image: np.ndarray, stamp: float = 0.0,
                      gt_pose: Optional[np.ndarray] = None,
                      search_loops: bool = True) -> OdometryOutput:
        """Odometry step; on keyframe fuse, feed the graph and the loop
        closer (processing any keyframes whose context is complete)."""
        self._frames += 1
        n_kf_before = len(self.odometry.kf_poses)
        out = self.odometry.process(image, stamp, gt_pose=gt_pose)
        if len(self.odometry.kf_poses) > n_kf_before:
            kf_idx = len(self.odometry.kf_poses) - 1
            pose = self.odometry.kf_poses[kf_idx]
            node = self.graph.add_node(pose, stamp, gt=gt_pose)
            self._kf_to_node.append(node)
            if self.odometry.kf_constraints:
                c = self.odometry.kf_constraints[-1]
                if c["id_end"] == kf_idx:
                    self.graph.add_odometry_constraint(
                        c["id_begin"], c["id_end"], c["t_be"],
                        cov=c.get("cov"))
            self.loops.add_keyframe(self.odometry.kf_peaks[kf_idx],
                                    self.odometry.kf_cells[kf_idx], pose)
            if self.alignment_learner is not None:
                self.alignment_learner.add_training_pair(
                    self.odometry.kf_peaks[kf_idx],
                    self.odometry.kf_cells[kf_idx], pose)
            if search_loops:
                for lc in self.loops.process_pending():
                    self.graph.add_loop_constraint(lc)
            # periodic optimization epoch (OptimizerThread semantics,
            # posegraph.cpp:132-149): the optimize() rebases all poses; the
            # next odometry constraint then composes off the corrected pose.
            self._kf_since_opt += 1
            every = self.cfg.pgo.optimize_every
            if every > 0 and self._kf_since_opt >= every \
                    and self.graph.num_loops() > 0:
                self.graph.optimize(solver="auto")
                self._kf_since_opt = 0
                self.pgo_epochs += 1
        return out

    def process_frames_chunked(self, images, stamps=None, gt_poses=None,
                               chunk: int = 16,
                               search_loops: bool = False) -> int:
        """Feed a whole sequence in device-scanned chunks
        (OdometryPipeline.process_chunk): ~2 host round trips per ``chunk``
        frames instead of 2-3 per frame.  Keyframe/graph bookkeeping is
        identical to per-frame ``process_frame``; loop search (if requested)
        runs between chunks.  Returns the total keyframe count.
        """
        n = len(images)
        stamps = [0.0] * n if stamps is None else list(stamps)
        gts = [None] * n if gt_poses is None else list(gt_poses)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            kf_before = len(self._kf_to_node)
            self._frames += hi - lo
            self.odometry.process_chunk(images[lo:hi], stamps[lo:hi],
                                        gts[lo:hi])
            self._sync_new_keyframes(kf_before)
            if search_loops:
                for lc in self.loops.process_pending():
                    self.graph.add_loop_constraint(lc)
        return len(self._kf_to_node)

    def _sync_new_keyframes(self, kf_before: int) -> None:
        """Graph + loop-closer bookkeeping for keyframes fused since
        ``kf_before`` (the chunked-path twin of process_frame's fuse block)."""
        od = self.odometry
        by_end = {c["id_end"]: c for c in od.kf_constraints
                  if c["id_end"] >= kf_before}
        for kf_idx in range(kf_before, len(od.kf_poses)):
            pose = od.kf_poses[kf_idx]
            gt = od.kf_gt[kf_idx] if len(od.kf_gt) > kf_idx else None
            node = self.graph.add_node(pose, od.kf_stamps[kf_idx], gt=gt)
            self._kf_to_node.append(node)
            c = by_end.get(kf_idx)
            if c is not None:
                self.graph.add_odometry_constraint(
                    c["id_begin"], c["id_end"], c["t_be"], cov=c.get("cov"))
            self.loops.add_keyframe(od.kf_peaks[kf_idx], od.kf_cells[kf_idx],
                                    pose)
            if self.alignment_learner is not None:
                self.alignment_learner.add_training_pair(
                    od.kf_peaks[kf_idx], od.kf_cells[kf_idx], pose)

    def finish(self, optimize: bool = True,
               solver: str = "cholesky") -> SLAMSummary:
        """Drain pending loop closures, run the final optimization and the
        GT alignment (RunBasicEvaluation + Align, tbv_slam_offline.cpp:269)."""
        if self.alignment_learner is not None \
                and self.alignment_learner.num_samples >= 26:
            self.alignment_learner.fit()
            self.loops.align_model = self.alignment_learner.model
        for lc in self.loops.finish():
            self.graph.add_loop_constraint(lc)
        if self.mini_closure is not None:
            for lc in self.mini_closure.search(self.graph.poses_array()):
                self.graph.add_loop_constraint(lc, etype=MINI_LOOP)
        if self.gt_vicinity is not None:
            for lc in self.gt_vicinity.search(self.graph.poses_array(),
                                              gt_poses=self.graph.gt_array()):
                self.graph.add_loop_constraint(lc)
        if optimize and self.graph.num_nodes > 1:
            res = self.graph.optimize(solver=solver)
            cost0, cost = float(res.cost0), float(res.cost)
        else:
            cost0 = cost = 0.0
        return SLAMSummary(
            num_frames=self._frames,
            num_keyframes=self.graph.num_nodes,
            num_loops=self.graph.num_loops(),
            traveled_distance=self.graph.traveled_distance(),
            pgo_cost0=cost0, pgo_cost=cost,
            metrics=self.graph.align_to_gt(),
        )
