"""Alignment verification: CorAl + CFEAR features, learned classifiers.

Re-design of ScanLearningInterface (reference alignmentinterface.cpp:281-500)
and the loop VerificationModel (loopclosure.cpp:210-238):

- ``alignment_features``: the 6-feature vector [CorAl(joint, sep, overlap),
  CFEAR(score, n_residuals, mean feature count)] for a scan pair at given
  world poses,
- ``AlignmentLearner``: 13-perturbation training-data generation
  (aligned + 4 small/medium/large offsets, alignmentinterface.cpp:479-495),
  IRLS logistic fit, linear alignment score (COMBINED_COST),
- ``verification_probability``: sigmoid over [odom-bounds, sc-sim,
  alignment_quality] with the published trained_loop_classifier coefficients
  as default.

Feature computation is jittable and vmap-able over candidate batches.
"""
from __future__ import annotations

import math
from functools import partial
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se2
from ..core.config import RegistrationConfig, VerificationConfig
from ..core.types import Cells, PointCloud
from ..ops import coral, logistic, registration


def _transform_cloud(cloud: PointCloud, pose: jnp.ndarray) -> PointCloud:
    return cloud.replace(xy=se2.apply(pose, cloud.xy))


def _cfear_eval_cfg(cfg: VerificationConfig) -> RegistrationConfig:
    # CFEARQuality uses P2L, Huber(0.3), uniform weights, base radius 2
    # (AlignmentQuality.cpp:330-340, alignmentinterface.cpp:465).
    return RegistrationConfig(cost="P2L", loss="huber",
                              loss_limit=cfg.cfear_loss_limit, weight_option=0)


@partial(jax.jit, static_argnames=("cfg",))
def alignment_features(
    src_peaks: PointCloud, src_cells: Cells, src_pose: jnp.ndarray,
    ref_peaks: PointCloud, ref_cells: Cells, ref_pose: jnp.ndarray,
    cfg: VerificationConfig,
) -> jnp.ndarray:
    """[6] feature vector: X_CorAl ++ X_CFEAR (alignmentinterface.cpp:349-368).

    ``src`` plays the role of the current/from scan (moved by perturbations or
    the registered loop pose); ``ref`` is the fixed scan.
    """
    src_w = _transform_cloud(src_peaks, src_pose)
    ref_w = _transform_cloud(ref_peaks, ref_pose)
    cres = coral.coral_quality(src_w, ref_w, radius=cfg.coral_radius,
                               eps=cfg.coral_entropy_eps,
                               mode=cfg.coral_mode)
    x_coral = jnp.stack([cres.joint, cres.sep, cres.overlap])

    rcfg = _cfear_eval_cfg(cfg)
    tgt = jax.tree.map(lambda x: x[None], ref_cells)
    cost, n_res = registration.evaluate_cost(
        src_cells, src_pose, tgt, ref_pose[None], jnp.ones(1, bool), rcfg)
    tot_size = (jnp.sum(src_cells.valid) + jnp.sum(ref_cells.valid)) / 2.0
    x_cfear = jnp.stack([cost, n_res.astype(cost.dtype),
                         tot_size.astype(cost.dtype)])
    return jnp.concatenate([x_coral, x_cfear])


def make_perturbations(cfg: VerificationConfig) -> np.ndarray:
    """[13, 3] training perturbations (alignmentinterface.cpp:479-495)."""
    r = cfg.range_error
    out = [[0.0, 0.0, 0.0]]
    for scale, th in ((1, math.radians(0.5)), (2, math.radians(2.0)),
                      (4, math.radians(15.0))):
        d = scale * r
        out += [[d, 0, th], [0, d, th], [-d, 0, th], [0, -d, th]]
    return np.asarray(out, np.float32)


@partial(jax.jit, static_argnames=("cfg",))
def perturbed_training_features(
    cur_peaks: PointCloud, cur_cells: Cells, cur_pose: jnp.ndarray,
    prev_peaks: PointCloud, prev_cells: Cells, prev_pose: jnp.ndarray,
    perturbations: jnp.ndarray,  # [K, 3]
    cfg: VerificationConfig,
):
    """Features for every perturbation of the current scan; y = aligned."""

    def one(pert):
        pose = se2.compose(cur_pose, pert)
        return alignment_features(cur_peaks, cur_cells, pose,
                                  prev_peaks, prev_cells, prev_pose, cfg)

    x = jax.vmap(one)(perturbations)
    y = (jnp.sum(jnp.abs(perturbations), axis=1) < 1e-4).astype(jnp.float32)
    return x, y


@partial(jax.jit, static_argnames=("cfg",))
def batched_training_features(
    cur_peaks, cur_cells, cur_poses,  # [B, ...] stacked scan pairs
    prev_peaks, prev_cells, prev_poses,
    perturbations: jnp.ndarray,  # [K, 3]
    cfg: VerificationConfig,
):
    """Perturbed training features for a stacked batch of scan pairs in ONE
    device program (flattened [B*K, 6] / [B*K]) — the per-pair
    ``AlignmentLearner.add_training_pair`` loop costs a dispatch and a host
    fetch per keyframe."""

    def one(cp, cc, cpos, pp, pc, ppos):
        return perturbed_training_features(cp, cc, cpos, pp, pc, ppos,
                                           perturbations, cfg)

    x, y = jax.vmap(one)(cur_peaks, cur_cells, cur_poses,
                         prev_peaks, prev_cells, prev_poses)
    return x.reshape(-1, x.shape[-1]), y.reshape(-1)


class AlignmentLearner:
    """Host-side trainer for the combined 6-feature alignment classifier.

    Mirrors ScanLearningInterface (alignmentinterface.h:127-218): accumulate
    perturbed training pairs, fit, expose the linear alignment score.  Starts
    from the published coefficients so inference works untrained.
    """

    def __init__(self, cfg: VerificationConfig):
        self.cfg = cfg
        self.model = logistic.from_values(cfg.alignment_coefs[0],
                                          cfg.alignment_coefs[1:])
        self._perts = jnp.asarray(make_perturbations(cfg))
        self._x: List[np.ndarray] = []
        self._y: List[np.ndarray] = []
        self._prev = None
        self._frames = 0

    def add_training_pair(self, peaks: PointCloud, cells: Cells,
                          pose: np.ndarray) -> bool:
        """Feed a new keyframe; returns True when a pair was generated
        (>= 0.5 m from the previous one, alignmentinterface.cpp:303-308)."""
        self._frames += 1
        cur = (peaks, cells, jnp.asarray(pose, jnp.float32))
        if self._prev is None:
            self._prev = cur
            return False
        if float(jnp.linalg.norm(cur[2][:2] - self._prev[2][:2])) < \
                self.cfg.min_dist_btw_scans:
            return False
        x, y = perturbed_training_features(
            cur[0], cur[1], cur[2], self._prev[0], self._prev[1],
            self._prev[2], self._perts, self.cfg)
        self._x.append(np.asarray(x))
        self._y.append(np.asarray(y))
        self._prev = cur
        return True

    @property
    def num_samples(self) -> int:
        return sum(len(y) for y in self._y)

    def fit(self) -> None:
        x = jnp.asarray(np.concatenate(self._x))
        y = jnp.asarray(np.concatenate(self._y))
        self.model = logistic.fit(x, y, balanced=True)

    def alignment_quality(self, x6: jnp.ndarray) -> jnp.ndarray:
        """COMBINED_COST: the raw linear score (alignmentinterface.cpp:358)."""
        return logistic.predict_linear(self.model, x6)

    def save(self, path: str) -> None:
        logistic.save_coefficients(self.model, path)

    def load(self, path: str) -> None:
        self.model = logistic.load_coefficients(path)


def verification_probability(model: logistic.LogisticModel,
                             odom_bounds, sc_sim, alignment_quality):
    """Loop acceptance probability (VerificationModel, loopclosure.cpp:220-238)."""
    x = jnp.stack([jnp.asarray(odom_bounds, jnp.float32),
                   jnp.asarray(sc_sim, jnp.float32),
                   jnp.asarray(alignment_quality, jnp.float32)], axis=-1)
    return logistic.predict_proba(model, x)


def default_loop_model(cfg: VerificationConfig) -> logistic.LogisticModel:
    return logistic.from_values(cfg.loop_coefs[0], cfg.loop_coefs[1:])


def train_loop_model_from_file(path: str) -> logistic.LogisticModel:
    """Fit the loop classifier from a training-data file with rows
    ``y, odom, sc, align`` (model_parameters/tbv_model_8.txt format,
    loopclosure.h:199-227).

    Balanced class weights, matching the reference's sklearn
    LogisticRegression(class_weight="balanced") (alignmentinterface.cpp:205):
    on the real tbv_model_8.txt data this reproduces the published
    trained_loop_classifier.txt coefficients to ~5 decimals."""
    data = np.loadtxt(path, delimiter=",")
    y = jnp.asarray(data[:, 0], jnp.float32)
    x = jnp.asarray(data[:, 1:4], jnp.float32)
    return logistic.fit(x, y, balanced=True)


def odometry_consistency(kf_positions: np.ndarray, id_from: int,
                         id_to: int, sigma: float) -> float:
    """VerifyByOdometry (loopclosure.cpp:776-806): accumulated odometry
    between the two keyframes vs the estimated loop distance.

    Returns the ODOM_BOUNDS similarity (0 = consistent loop, 1 = unlikely).
    """
    lo, hi = sorted((id_from, id_to))
    seg = np.diff(kf_positions[lo:hi + 1], axis=0)
    trav = float(np.sum(np.linalg.norm(seg, axis=1)))
    est = float(np.linalg.norm(kf_positions[hi] - kf_positions[lo]))
    err = max(est - 5.0, 0.0)
    rel = err / max(trav, 1e-9)
    return 1.0 - math.exp(-rel * rel / (2.0 * sigma * sigma))
