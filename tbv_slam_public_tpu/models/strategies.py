"""Proximity-based loop-closure strategies: MiniClosure and GTVicinityClosure.

Re-design of the reference's non-ScanContext strategies
(reference tbv_slam/src/tbv_slam/loopclosure.cpp:393-555):

- **MiniClosure** (loopclosure.cpp:469-555): for every origin keyframe, walk
  forward accumulating odometry travel distance; among revisit candidates
  whose travel distance lies in [min_d_travel, max_d_travel] and whose
  CURRENT-estimate euclidean distance is <= max_d_close, pick the pair
  minimizing eucl/travel; register (identity relative guess — the miniloop
  constraint's t_be defaults to identity, utils.cpp:30-34) and verify.
- **GTVicinityClosure** (loopclosure.cpp:393-467): the debug oracle — same
  selection but the travel window is evaluated pairwise (no early break) and,
  with ``gt_loop`` (loopclosure.cpp:327-339), the constraint is taken directly
  from the ground-truth relative pose when it is within 5 m.

The reference's double host loop over pose iterators becomes ONE jitted
selection program: an [N, N] travel/euclidean masked ratio matrix with a
per-row argmin (poses are a few thousand keyframes; N^2 tensor work is
trivial on an accelerator and replaces the pair_attempted_/origin_attempted_
bookkeeping).  Registration + verification of the selected pairs reuses the
batched candidate wave (models.loopclosure.register_and_verify_pairs).

VerifyByOdometry (loopclosure.cpp:776-806) is computed in closed form from
the odometry keyframe poses: the composed relative motion's translation norm
equals |p_from - p_to| in the odometry frame, and the traveled distance is a
cumulative sum of odometry-constraint norms.
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
from .loopclosure import LoopCloser, LoopConstraint, register_and_verify_pairs


@partial(jax.jit, static_argnames=("pairwise_travel",))
def proximity_candidates(
    poses: jnp.ndarray,  # [N, 3] current (optimized) pose estimates
    node_mask: jnp.ndarray,  # [N] bool
    travel_cum: jnp.ndarray,  # [N] cumulative odometry travel distance
    min_d_travel: float,
    max_d_travel: float,
    max_d_close: float,
    pairwise_travel: bool = False,
):
    """Per-origin best revisit candidate (MiniClosure selection,
    loopclosure.cpp:485-525).

    Returns (best [N] int32, valid [N] bool): for each origin i the candidate
    j > i minimizing eucl(i,j)/travel(i,j) subject to
    min_d_travel <= travel <= max_d_travel and eucl <= max_d_close.
    ``pairwise_travel`` keeps GTVicinityClosure's variant (travel evaluated
    per pair with no window break — identical maths here since the masked
    matrix form never "breaks").
    """
    del pairwise_travel  # both variants reduce to the same masked matrix
    xy = poses[:, :2]
    d2 = (jnp.sum(xy * xy, 1)[:, None] + jnp.sum(xy * xy, 1)[None, :]
          - 2.0 * xy @ xy.T)
    eucl = jnp.sqrt(jnp.maximum(d2, 0.0))
    travel = travel_cum[None, :] - travel_cum[:, None]  # [i, j] = cum_j - cum_i
    n = poses.shape[0]
    upper = jnp.arange(n)[None, :] > jnp.arange(n)[:, None]
    ok = (upper & node_mask[:, None] & node_mask[None, :]
          & (travel >= min_d_travel) & (travel <= max_d_travel)
          & (eucl <= max_d_close))
    ratio = jnp.where(ok, eucl / jnp.maximum(travel, 1e-9), jnp.inf)
    best = jnp.argmin(ratio, axis=1).astype(jnp.int32)
    valid = jnp.isfinite(jnp.min(ratio, axis=1))
    return best, valid


@jax.jit
def verify_by_odometry(
    odom_poses: jnp.ndarray,  # [N, 3] odometry (un-optimized) keyframe poses
    travel_cum: jnp.ndarray,  # [N]
    id_from: jnp.ndarray,  # [M] int (from > to)
    id_to: jnp.ndarray,  # [M] int
    sigma: float,
    nearby_margin: float = 5.0,
) -> jnp.ndarray:
    """Odometry-consistency dissimilarity (VerifyByOdometry,
    loopclosure.cpp:776-806): 1 - exp(-rel_err^2 / (2 sigma^2)) with
    rel_err = max(|p_from - p_to| - 5, 0) / traveled(from, to)."""
    est = jnp.linalg.norm(odom_poses[id_from, :2] - odom_poses[id_to, :2],
                          axis=-1)
    trav = jnp.abs(travel_cum[id_from] - travel_cum[id_to])
    err = jnp.maximum(est - nearby_margin, 0.0)
    rel = err / jnp.maximum(trav, 1e-9)
    return 1.0 - jnp.exp(-rel * rel / (2.0 * sigma * sigma))


def odometry_travel_cumsum(odom_poses: np.ndarray) -> np.ndarray:
    """Cumulative travel distance from consecutive odometry keyframe poses
    (TraveledDistance accumulation, posegraph.cpp:151-160)."""
    if len(odom_poses) == 0:
        return np.zeros((0,), np.float32)
    xy = np.asarray(odom_poses)[:, :2]
    step = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(step)]).astype(np.float32)


class ProximityCloser:
    """Host driver for MiniClosure / GTVicinityClosure over an existing
    LoopCloser's keyframe store (scans, models and candidate log are shared
    with the ScanContext strategy, mirroring the shared loopclosure base
    class, loopclosure.h:75-303)."""

    def __init__(self, cfg: TBVConfig, loops: LoopCloser,
                 gt_vicinity: bool = False):
        self.cfg = cfg
        self.loops = loops
        self.gt_vicinity = gt_vicinity
        self._origin_attempted: set = set()

    def search(
        self,
        graph_poses: np.ndarray,  # [N, 3] current pose estimates
        gt_poses: Optional[np.ndarray] = None,  # [N, 3] for GT vicinity
        pair_chunk: int = 64,
    ) -> List[LoopConstraint]:
        """One exhaustive search pass; returns accepted constraints.

        Origins already searched are skipped on later calls
        (origin_attempted_, loopclosure.cpp:486-487)."""
        cfg = self.cfg
        lc = cfg.loopclosure
        n = len(self.loops.kf_odom)
        if n < 2:
            return []
        ref_poses = gt_poses if (self.gt_vicinity and gt_poses is not None) \
            else graph_poses
        ref_poses = np.asarray(ref_poses, np.float32)[:n]
        odom = np.stack(self.loops.kf_odom)
        travel = odometry_travel_cumsum(odom)

        node_mask = np.ones((n,), bool)
        for i in self._origin_attempted:
            if i < n:
                node_mask[i] = False  # row already searched

        best, valid = proximity_candidates(
            jnp.asarray(ref_poses), jnp.asarray(node_mask),
            jnp.asarray(travel), lc.min_d_travel, lc.max_d_travel,
            lc.max_d_close)
        best = np.asarray(best)
        valid = np.asarray(valid) & node_mask
        pairs = [(int(max(i, best[i])), int(min(i, best[i])))
                 for i in range(n) if valid[i]]
        self._origin_attempted.update(range(n))
        if not pairs:
            return []

        if self.gt_vicinity and lc.gt_loop and gt_poses is not None:
            return self._gt_constraints(pairs, np.asarray(gt_poses))
        return self._register_verify(pairs, odom, travel, pair_chunk)

    # -- gt_loop oracle (loopclosure.cpp:327-339) --------------------------
    def _gt_constraints(self, pairs, gt_poses) -> List[LoopConstraint]:
        out = []
        for a, b in pairs:  # a = from > b = to
            rel = np.asarray(se2.relative(jnp.asarray(gt_poses[a]),
                                          jnp.asarray(gt_poses[b])))
            if np.linalg.norm(rel[:2]) < 5.0:
                c = LoopConstraint(id_from=a, id_to=b, t_be=rel, prob=1.0,
                                   quality=dict(gt_loop=1.0))
                self.loops.constraints.append(c)
                out.append(c)
        return out

    # -- registered + verified mini loops ----------------------------------
    def _register_verify(self, pairs, odom, travel,
                         pair_chunk) -> List[LoopConstraint]:
        cfg = self.cfg
        loops = self.loops
        accepted: List[LoopConstraint] = []
        stack = lambda items: jax.tree.map(lambda *x: jnp.stack(x), *items)
        id_from = np.asarray([a for a, _ in pairs])
        id_to = np.asarray([b for _, b in pairs])
        odom_b = np.asarray(verify_by_odometry(
            jnp.asarray(odom), jnp.asarray(travel), jnp.asarray(id_from),
            jnp.asarray(id_to), cfg.verification.odom_sigma_error))
        if not cfg.verification.verify_via_odometry:
            # VerifyByOdometry early-out sets similarity = 1
            # (loopclosure.cpp:777-781).
            odom_b = np.ones_like(odom_b)

        with timing.timer("mini_loop_register_verify"):
            for lo in range(0, len(pairs), pair_chunk):
                sel = list(range(lo, min(lo + pair_chunk, len(pairs))))
                n_real = len(sel)
                if len(pairs) > pair_chunk and n_real < pair_chunk:
                    sel = sel + [sel[-1]] * (pair_chunk - n_real)
                q_cells = stack([loops.kf_cells[id_from[i]] for i in sel])
                q_peaks = stack([loops.kf_peaks[id_from[i]] for i in sel])
                c_cells = stack([loops.kf_cells[id_to[i]] for i in sel])
                c_peaks = stack([loops.kf_peaks[id_to[i]] for i in sel])
                m = len(sel)
                zeros = jnp.zeros((m,), jnp.float32)
                res = register_and_verify_pairs(
                    q_cells, q_peaks, c_cells, c_peaks,
                    jnp.zeros((m, 3), jnp.float32), zeros,  # identity guess
                    zeros,  # sc_sim = 0 (CreateMiniloopConstraint)
                    jnp.asarray(odom_b[[i for i in sel]], jnp.float32),
                    jnp.ones((m,), bool),
                    loops.align_model, loops.loop_model, cfg)
                res = jax.device_get(res)
                for k in range(n_real):
                    i = sel[k]
                    r = jax.tree.map(lambda x: x[k], res)
                    loops.candidate_log.append(dict(
                        id_from=int(id_from[i]), id_to=int(id_to[i]),
                        prob=float(r.prob), sc_sim=0.0,
                        odom_bounds=float(odom_b[i]),
                        alignment_quality=float(r.align_quality),
                        x6=np.asarray(r.x6).tolist(),
                        t_be=np.asarray(r.t_be).tolist(), guess_nr=-1,
                        reg_ok=bool(r.reg_ok)))
                    if bool(r.valid) and float(r.prob) > \
                            cfg.verification.model_threshold:
                        c = LoopConstraint(
                            id_from=int(id_from[i]), id_to=int(id_to[i]),
                            t_be=np.asarray(r.t_be), prob=float(r.prob),
                            quality=dict(
                                sc_sim=0.0, odom_bounds=float(odom_b[i]),
                                alignment_quality=float(r.align_quality),
                                mini_loop=1.0))
                        loops.constraints.append(c)
                        accepted.append(c)
        return accepted
