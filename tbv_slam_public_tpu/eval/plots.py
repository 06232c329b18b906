"""Evaluation plots (matplotlib, Agg backend).

Rebuilds the reference's plotting layer: trajectory figures
(evaluation/2_plot_trajectory, Fig 5-6), loop-closure PR/ROC curves
(evaluation/3_loop_closure, Fig 4) and segment-error plots
(kitti_odometry.py plot_error).

matplotlib is imported only when a plot is drawn: it is optional, and each
function raises ImportError when it is absent.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectories(path: str, trajs: Dict[str, np.ndarray],
                      title: str = "", align_to: Optional[str] = "gt") -> None:
    """XY trajectory overlay; keys are labels ('gt', 'est', 'odom', ...)."""
    plt = _pyplot()
    from . import trajectory as tj

    fig, ax = plt.subplots(figsize=(6, 6))
    ref = trajs.get(align_to) if align_to else None
    for label, p in trajs.items():
        xy = p[:, :2]
        if ref is not None and label != align_to and len(p) == len(ref):
            xy = tj.align_trajectory(p, ref)
        style = dict(lw=1.2)
        if label == "gt":
            style.update(color="black", ls="--", lw=1.0)
        ax.plot(xy[:, 0], xy[:, 1], label=label, **style)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend()
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_pr_curves(path: str, curves: Dict[str, tuple],
                   title: str = "Loop closure PR") -> None:
    """curves: label -> (precision [K], recall [K])."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    for label, (p, r) in curves.items():
        order = np.argsort(r)
        ax.plot(np.asarray(r)[order], np.asarray(p)[order], label=label)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1.02)
    ax.set_ylim(0, 1.02)
    ax.legend()
    ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_segment_errors(path: str, lengths: Sequence[float],
                        trans_pct: Sequence[float],
                        rot_deg: Sequence[float]) -> None:
    """Error-vs-segment-length bars (kitti_odometry plot_error analogue)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    axes[0].plot(lengths, trans_pct, "o-")
    axes[0].set_xlabel("Segment length [m]")
    axes[0].set_ylabel("Translation error [%]")
    axes[1].plot(lengths, rot_deg, "o-")
    axes[1].set_xlabel("Segment length [m]")
    axes[1].set_ylabel("Rotation error [deg/100m]")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_constraint_map(path: str, poses: np.ndarray,
                        edges: List[dict],
                        keyframe_clouds: Optional[List] = None,
                        gt: Optional[np.ndarray] = None,
                        max_map_points: int = 60000) -> None:
    """Pose-graph constraint/map view — the PoseGraphVis artifact
    (posegraph.cpp:373-691: merged keyframe cloud map + per-type constraint
    markers + paths) as a static figure.

    ``edges`` are PoseGraph edge dicts (idx/etype); ``keyframe_clouds`` an
    optional list of per-keyframe PointCloud peaks (world map rendered by
    transforming each into its keyframe pose).
    """
    plt = _pyplot()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(9, 9))
    if keyframe_clouds is not None and len(keyframe_clouds) == len(poses):
        pts = []
        for pose, pc in zip(poses, keyframe_clouds):
            xy = np.asarray(pc.xy)
            m = np.asarray(pc.mask)
            c, s = np.cos(pose[2]), np.sin(pose[2])
            w = np.stack([c * xy[:, 0] - s * xy[:, 1] + pose[0],
                          s * xy[:, 0] + c * xy[:, 1] + pose[1]], -1)
            pts.append(w[m])
        pts = np.concatenate(pts) if pts else np.zeros((0, 2))
        if len(pts) > max_map_points:
            pts = pts[:: len(pts) // max_map_points + 1]
        ax.scatter(pts[:, 0], pts[:, 1], s=0.3, c="0.75", linewidths=0,
                   label="map", rasterized=True)
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 1], color="0.4", lw=0.8, label="gt")
    ax.plot(poses[:, 0], poses[:, 1], color="#4053d3", lw=1.2, label="est")
    type_style = {0: None, 1: ("#b51d14", "loop"), 2: ("#ddb310", "mini"),
                  3: ("#00beff", "candidate")}
    seen = set()
    for e in edges:
        style = type_style.get(e["etype"], ("#fb49b0", "other"))
        if style is None:
            continue
        color, name = style
        a, b = e["idx"]
        ax.plot([poses[a, 0], poses[b, 0]], [poses[a, 1], poses[b, 1]],
                color=color, lw=0.9, alpha=0.8,
                label=name if name not in seen else None)
        seen.add(name)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=160)
    plt.close(fig)
