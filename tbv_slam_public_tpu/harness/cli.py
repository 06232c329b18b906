"""Command-line entry points (the reference's L5 nodes, rebuilt).

Subcommands:

- ``odometry``: run CFEAR odometry over a dataset, write KITTI/TUM
  trajectories + the ``simple_graph.npz`` checkpoint (offline_odometry.cpp
  analogue, offline_odometry.cpp:57-146),
- ``slam``: run loop closure + PGO from a checkpoint, write results
  (tbv_slam_offline.cpp:215-356),
- ``online``: full per-frame pipeline from images (tbv_slam_online.cpp,
  deterministic schedule),
- ``eval``: KITTI evaluation of pose files (eval_odom.py),
- ``sweep``: parameter-sweep job farm (tbv_slam/python/eval.py).

Config overrides are dotted ``key=value`` tokens after the subcommand args,
e.g. ``radar.k_strongest=40`` (the boost::program_options analogue).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np


def _build_cfg(meta: dict, overrides: List[str]):
    """Config from dataset meta + dotted overrides.  A leading
    ``preset=<name>`` token starts from a published configuration
    (core.config.PRESETS) instead of the defaults."""
    import dataclasses

    from ..core.config import (PRESETS, TBVConfig, RadarConfig,
                               apply_overrides, parse_cli_overrides)

    overrides = list(overrides or [])
    preset = None
    for tok in list(overrides):
        if tok.startswith("preset="):
            preset = tok.split("=", 1)[1]
            overrides.remove(tok)
    if preset:
        cfg = PRESETS[preset]()
        cfg = dataclasses.replace(cfg, radar=dataclasses.replace(
            cfg.radar, num_azimuths=meta["num_azimuths"],
            num_range_bins=meta["num_range_bins"],
            range_res=meta["range_res"]))
    else:
        cfg = TBVConfig(radar=RadarConfig(
            num_azimuths=meta["num_azimuths"],
            num_range_bins=meta["num_range_bins"],
            range_res=meta["range_res"]))
    if overrides:
        cfg = apply_overrides(cfg, parse_cli_overrides(overrides))
    return cfg


def _write_pars(cfg, outdir: str) -> None:
    from ..core.config import to_pars_text

    with open(os.path.join(outdir, "pars.txt"), "w") as f:
        f.write(to_pars_text(cfg) + "\n")


def _write_timing(outdir: str) -> None:
    from ..core.timing import timing

    with open(os.path.join(outdir, "time_statistics.txt"), "w") as f:
        f.write(timing.present())


def _export_trajectories(outdir: str, est: np.ndarray,
                         gt: Optional[np.ndarray], stamps, sub: str,
                         seq: int = 0, covs=None) -> dict:
    from ..eval import kitti, trajectory

    d = os.path.join(outdir, sub)
    os.makedirs(d, exist_ok=True)
    trajectory.write_kitti(os.path.join(d, "00.txt"), est)
    trajectory.write_tum(os.path.join(d, "00.tum"), np.asarray(stamps), est)
    if covs is not None and len(covs) == len(est):
        # cov_<seq>.txt (WriteCov, eval_trajectory.cpp:278-283)
        trajectory.write_cov(os.path.join(d, "cov_00.txt"),
                             np.asarray(stamps), np.asarray(covs))
    metrics = {}
    if gt is not None and len(gt) == len(est):
        trajectory.write_kitti(os.path.join(d, "00_gt.txt"), gt)
        m = kitti.evaluate(gt, est)
        kitti.write_result(os.path.join(d, "result.txt"), seq, m)
        metrics = m.as_dict()
    return metrics


def cmd_odometry(args, overrides: List[str]) -> int:
    from ..core.timing import timing
    from ..io import checkpoint, oxford
    from ..models.odometry import OdometryPipeline

    frames, meta = oxford.open_sequence(args.dataset)
    cfg = _build_cfg(meta, overrides)
    os.makedirs(args.output, exist_ok=True)
    timing.reset()

    pipe = OdometryPipeline(cfg)
    n = 0
    gts = []
    chunk = max(int(getattr(args, "chunk", 0) or 0), 0)
    buf = []  # (image, stamp, gt) accumulated for chunked device scans
    for fr in frames:
        if args.max_frames and n >= args.max_frames:
            break
        if chunk > 1:
            buf.append((fr.image, fr.stamp, fr.gt_pose))
            if len(buf) == chunk:
                pipe.process_chunk(np.stack([b[0] for b in buf]),
                                   [b[1] for b in buf], [b[2] for b in buf])
                buf.clear()
        else:
            pipe.process(fr.image, stamp=fr.stamp, gt_pose=fr.gt_pose)
        gts.append(fr.gt_pose)
        n += 1
    for img, stamp, gt_pose in buf:  # tail (< chunk frames)
        pipe.process(img, stamp=stamp, gt_pose=gt_pose)

    est = np.asarray(pipe.frame_poses)
    gt = np.stack(gts) if gts and all(g is not None for g in gts) else None
    metrics = _export_trajectories(args.output, est, gt, pipe.frame_stamps,
                                   "odom", covs=pipe.frame_covs)
    checkpoint.save_simple_graph(
        os.path.join(args.output, "simple_graph.npz"),
        checkpoint.from_odometry(pipe))
    _write_pars(cfg, args.output)
    _write_timing(args.output)
    print(json.dumps(dict(frames=n, keyframes=len(pipe.kf_poses), **metrics)))
    return 0


def _write_slam_plots(outdir: str, slam, odom, est, gt, labeled) -> None:
    """Trajectory, constraint-map and loop PR figures under ``plots/``;
    raises ImportError when matplotlib is not installed."""
    from ..eval import loops as loops_eval
    from ..eval import plots

    plots.plot_trajectories(os.path.join(outdir, "plots", "trajectory.png"),
                            dict(gt=gt, est=est, odom=odom))
    plots.plot_constraint_map(
        os.path.join(outdir, "plots", "constraint_map.png"),
        est, slam.graph.edges, keyframe_clouds=slam.loops.kf_peaks, gt=gt)
    if labeled:
        probs = np.asarray([r["prob"] for r in labeled])
        labels = np.asarray([r["is_loop"] for r in labeled], float)
        _, prec, rec = loops_eval.pr_curve(probs, labels)
        plots.plot_pr_curves(os.path.join(outdir, "plots", "loop_pr.png"),
                             {"TBV": (prec, rec)})


def cmd_slam(args, overrides: List[str]) -> int:
    from ..core.timing import timing
    from ..eval import loops as loops_eval
    from ..io import checkpoint
    from ..models.slam import run_offline_slam

    g = checkpoint.load_simple_graph(args.graph)
    cfg = _build_cfg(dict(num_azimuths=400, num_range_bins=3768,
                          range_res=0.0438), overrides)
    os.makedirs(args.output, exist_ok=True)
    timing.reset()

    slam = run_offline_slam(cfg, g, solver=args.solver)
    s = slam.summary
    est = slam.graph.poses_array()
    gt = slam.graph.gt_array()
    metrics = _export_trajectories(args.output, est, gt, slam.graph.stamps,
                                   "est")
    _export_trajectories(args.output, g.kf_poses, gt, g.kf_stamps, "odom")
    if gt is not None:
        labeled = loops_eval.label_candidate_log(slam.loops.candidate_log, gt)
        loops_eval.write_loop_csv(
            os.path.join(args.output, "loop", "loop.csv"), labeled)
        probs = np.asarray([r["prob"] for r in labeled])
        labels = np.asarray([r["is_loop"] for r in labeled], float)
        if len(labeled):
            cm = loops_eval.classifier_metrics(probs, labels)
            loops_eval.write_result_txt(
                os.path.join(args.output, "loop", "result.txt"), cm)
    checkpoint.save_full_graph(os.path.join(args.output, "full_graph.npz"),
                               slam.graph, slam=slam)
    if gt is not None:
        try:
            _write_slam_plots(args.output, slam, g.kf_poses, est, gt,
                              labeled)
        except ImportError as e:
            print(f"no plots written: {e}", file=sys.stderr)
    _write_pars(cfg, args.output)
    _write_timing(args.output)
    print(json.dumps({**(s.metrics or {}), **metrics,
                      "keyframes": s.num_keyframes, "loops": s.num_loops,
                      "traveled": s.traveled_distance}))
    return 0


def cmd_online(args, overrides: List[str]) -> int:
    from ..core.timing import timing
    from ..io import checkpoint, oxford
    from ..models.slam import TBVSLAM

    frames, meta = oxford.open_sequence(args.dataset)
    cfg = _build_cfg(meta, overrides)
    os.makedirs(args.output, exist_ok=True)
    timing.reset()

    slam = TBVSLAM(cfg, train_alignment=getattr(args, "train_alignment",
                                                False))
    n = 0
    for fr in frames:
        if args.max_frames and n >= args.max_frames:
            break
        slam.process_frame(fr.image, stamp=fr.stamp, gt_pose=fr.gt_pose)
        n += 1
    s = slam.finish(optimize=True)
    if slam.alignment_learner is not None:
        slam.alignment_learner.save(
            os.path.join(args.output, "trained_alignment_classifier.txt"))
    est = slam.graph.poses_array()
    gt = slam.graph.gt_array()
    metrics = _export_trajectories(args.output, est, gt, slam.graph.stamps,
                                   "est")
    checkpoint.save_full_graph(os.path.join(args.output, "full_graph.npz"),
                               slam.graph, slam=slam)
    _write_pars(cfg, args.output)
    _write_timing(args.output)
    print(json.dumps({**(s.metrics or {}), **metrics, "frames": n,
                      "keyframes": s.num_keyframes, "loops": s.num_loops}))
    return 0


def cmd_train_alignment(args, overrides: List[str]) -> int:
    """Alignment-classifier training (the odometry_training_node analogue,
    odometry_training_node.cpp:1-80): run odometry, generate 13-perturbation
    training pairs per keyframe, fit, save coefficients + ROC data."""
    from ..io import oxford
    from ..models.odometry import OdometryPipeline
    from ..models.verification import AlignmentLearner
    from ..ops import logistic
    from ..eval import loops as loops_eval
    import jax
    import jax.numpy as jnp

    frames, meta = oxford.open_sequence(args.dataset)
    cfg = _build_cfg(meta, overrides)
    os.makedirs(args.output, exist_ok=True)

    pipe = OdometryPipeline(cfg)
    learner = AlignmentLearner(cfg.verification)
    n = 0
    n_kf = 0
    for fr in frames:
        if args.max_frames and n >= args.max_frames:
            break
        pipe.process(fr.image, stamp=fr.stamp, gt_pose=fr.gt_pose)
        while n_kf < len(pipe.kf_poses):
            learner.add_training_pair(
                jax.tree.map(jnp.asarray, pipe.kf_peaks[n_kf]),
                jax.tree.map(jnp.asarray, pipe.kf_cells[n_kf]),
                pipe.kf_poses[n_kf])
            n_kf += 1
        n += 1
    learner.fit()
    coef_path = os.path.join(args.output, "trained_alignment_classifier.txt")
    learner.save(coef_path)

    # training metrics + ROC data
    x = np.concatenate(learner._x)
    y = np.concatenate(learner._y)
    probs = np.asarray(logistic.predict_proba(learner.model, jnp.asarray(x)))
    cm = loops_eval.classifier_metrics(probs, y)
    loops_eval.write_result_txt(os.path.join(args.output, "result.txt"), cm)
    ths, prec, rec = loops_eval.pr_curve(probs, y)
    np.savetxt(os.path.join(args.output, "roc.csv"),
               np.stack([ths, prec, rec], 1), delimiter=",",
               header="threshold,precision,recall")
    print(json.dumps(dict(samples=int(len(y)), **cm.as_dict())))
    return 0


def cmd_train_loop(args, overrides: List[str]) -> int:
    """Loop-verification classifier training (loopclosure.h:199-227): fit on
    a loop.csv (features + GT labels) or a ``y,odom,sc,align`` data file."""
    import jax.numpy as jnp

    from ..eval import loops as loops_eval
    from ..ops import logistic

    if args.loop_csv:
        rows = loops_eval.read_loop_csv(args.loop_csv)
        x = np.asarray([[r["odom_bounds"], r["sc_sim"],
                         r["alignment_quality"]] for r in rows], np.float32)
        y = np.asarray([r["is_loop"] for r in rows], np.float32)
    else:
        data = np.loadtxt(args.data, delimiter=",")
        y = data[:, 0].astype(np.float32)
        x = data[:, 1:4].astype(np.float32)
    model = logistic.fit(jnp.asarray(x), jnp.asarray(y), balanced=False)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    logistic.save_coefficients(model, args.output)
    probs = np.asarray(logistic.predict_proba(model, jnp.asarray(x)))
    cm = loops_eval.classifier_metrics(probs, y)
    print(json.dumps(dict(samples=int(len(y)), **cm.as_dict())))
    return 0


def cmd_evaluate_scans(args, overrides: List[str]) -> int:
    """Perturbation-sweep scan evaluator (the coral scanEvaluator,
    ScanEvaluator.h:53-124): sweep offsets over consecutive keyframe pairs
    from a checkpoint, dump per-sample alignment features to CSV for
    separability analysis."""
    import jax
    import jax.numpy as jnp

    from ..io import checkpoint
    from ..models import verification as verif

    g = checkpoint.load_simple_graph(args.graph)
    cfg = _build_cfg(dict(num_azimuths=400, num_range_bins=3768,
                          range_res=0.0438), overrides)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)

    offsets = np.linspace(-args.range_max, args.range_max, args.range_steps)
    thetas = np.radians(np.linspace(-args.theta_max_deg, args.theta_max_deg,
                                    args.theta_steps))
    perts = np.asarray([[dx, dy, th] for dx in offsets for dy in offsets
                        for th in thetas], np.float32)

    take = lambda tree, i: jax.tree.map(lambda x: jnp.asarray(x[i]), tree)
    rows = []
    n_pairs = min(g.num_keyframes - 1, args.max_pairs)
    for i in range(n_pairs):
        x, y = verif.perturbed_training_features(
            take(g.peaks, i + 1), take(g.cells, i + 1),
            jnp.asarray(g.kf_poses[i + 1]),
            take(g.peaks, i), take(g.cells, i), jnp.asarray(g.kf_poses[i]),
            jnp.asarray(perts), cfg.verification)
        x = np.asarray(x)
        for k in range(len(perts)):
            rows.append([i, *perts[k], float(np.asarray(y)[k]), *x[k]])

    header = ("pair,dx,dy,dtheta,aligned,"
              "coral_joint,coral_sep,coral_overlap,"
              "cfear_score,cfear_nres,cfear_size")
    np.savetxt(args.output, np.asarray(rows), delimiter=",", header=header,
               comments="")
    print(json.dumps(dict(pairs=n_pairs, samples=len(rows))))
    return 0


def cmd_baseline(args, overrides: List[str]) -> int:
    """Aggregate sweep results into Tab I/II-style tables (1_baseline)."""
    from ..eval import baseline

    report = baseline.write_baseline(
        args.root, args.output or os.path.join(args.root, "baseline.txt"))
    print(report)
    return 0


def cmd_reoptimize(args, overrides: List[str]) -> int:
    """Re-run PGO on a saved full graph with overridden weights.

    The debug_optimizer / dynamic_reconfigure analogue
    (tbv_slam_offline.cpp:289-330 + cfg/OptimizationParams.cfg): the
    reference re-optimizes the loaded graph live whenever loop/odom
    covariance scaling, loop_scaling or replace_cov_by_identity change.
    Here each invocation applies ``pgo.*`` overrides (e.g.
    ``pgo.loop_scaling=1e4``) and reports metrics before/after so parameter
    effects can be compared across runs.
    """
    from ..io import checkpoint

    cfg = _build_cfg(dict(num_azimuths=400, num_range_bins=3768,
                          range_res=0.0438), overrides)
    graph = checkpoint.load_full_graph(args.graph, cfg)
    pre = graph.align_to_gt()
    res = graph.optimize(solver=args.solver)
    post = graph.align_to_gt()
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        checkpoint.save_full_graph(args.output, graph)
    out = dict(cost0=float(res.cost0), cost=float(res.cost),
               iterations=int(res.iterations))
    if pre is not None:
        out.update(ate_rmse_before=pre["ate_rmse"],
                   ate_rmse_after=post["ate_rmse"])
    print(json.dumps(out))
    return 0


def cmd_constraints(args, overrides: List[str]) -> int:
    """Dump / re-verify the loop constraints of a saved full graph.

    The DebugConstraints analogue (loopclosure.cpp:809-863) without the
    interactive getchar/rviz loop: every loop-type constraint is listed with
    its relative pose, measured covariance and — when the checkpoint carries
    scan payloads and ``--reverify`` is set — a freshly recomputed alignment
    quality (PredAlignment at the stored t_be, alignmentinterface.cpp:349-368)
    so stored acceptance decisions can be audited offline.  With GT present,
    each constraint also gets the EvaluationManager label geometry (<4 m,
    <2.5 deg positive-ok gate, EvaluationManager.cpp:12-27).
    """
    import csv

    import jax.numpy as jnp
    import numpy as np

    from ..core import se2
    from ..core.types import ODOMETRY
    from ..io import checkpoint
    from ..models import verification as verif
    from ..ops import logistic

    cfg = _build_cfg(dict(num_azimuths=400, num_range_bins=3768,
                          range_res=0.0438), overrides)
    z = np.load(args.graph)
    has_payloads = "peaks_xy" in z.files
    graph = checkpoint.load_full_graph(args.graph, cfg)
    gt = graph.gt_array()
    slam = None
    if args.reverify:
        if not has_payloads:
            print("error: checkpoint has no scan payloads; re-save with "
                  "save_full_graph(..., slam=...)", file=sys.stderr)
            return 2
        slam = checkpoint.load_full_graph_slam(args.graph, cfg)
    align_model = logistic.from_values(cfg.verification.alignment_coefs[0],
                                       cfg.verification.alignment_coefs[1:])

    rows = []
    for ed in graph.edges:
        if ed["etype"] == ODOMETRY:
            continue
        a, b = ed["idx"]
        row = dict(id_from=int(a), id_to=int(b), etype=int(ed["etype"]),
                   t_x=float(ed["meas"][0]), t_y=float(ed["meas"][1]),
                   t_yaw=float(ed["meas"][2]),
                   has_cov=ed.get("cov") is not None)
        if ed.get("cov") is not None:
            c = np.asarray(ed["cov"])
            row.update(cov_xx=float(c[0, 0]), cov_yy=float(c[1, 1]),
                       cov_tt=float(c[2, 2]))
        if gt is not None:
            t_gt = np.asarray(se2.relative(jnp.asarray(gt[a]),
                                           jnp.asarray(gt[b])))
            err_t = float(np.linalg.norm(ed["meas"][:2] - t_gt[:2]))
            err_r = abs(float(se2.wrap_angle(
                jnp.asarray(ed["meas"][2] - t_gt[2]))))
            row.update(gt_err_m=round(err_t, 4),
                       gt_err_deg=round(np.degrees(err_r), 4),
                       positive_ok=bool(err_t < 4.0
                                        and err_r < np.radians(2.5)))
        if slam is not None:
            lp = slam.loops
            x6 = verif.alignment_features(
                lp.kf_peaks[a], lp.kf_cells[a], jnp.zeros(3, jnp.float32),
                lp.kf_peaks[b], lp.kf_cells[b],
                jnp.asarray(ed["meas"], jnp.float32), cfg.verification)
            row["alignment_quality"] = float(
                logistic.predict_linear(align_model, x6))
        rows.append(row)

    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        keys = sorted({k for r in rows for k in r})
        with open(args.output, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
    n_pos = sum(1 for r in rows if r.get("positive_ok"))
    print(json.dumps(dict(n_loops=len(rows),
                          n_with_cov=sum(1 for r in rows if r["has_cov"]),
                          n_positive_ok=n_pos if gt is not None else None,
                          reverified=slam is not None,
                          rows=rows if args.print_rows else None)))
    return 0


def cmd_eval(args, overrides: List[str]) -> int:
    from ..eval import kitti

    m = kitti.evaluate_files(args.gt, args.est, args.output)
    print(json.dumps(m.as_dict()))
    return 0


def cmd_sweep(args, overrides: List[str]) -> int:
    from .sweep import run_sweep

    results = run_sweep(args.par_file, args.dataset, args.output,
                        base_overrides=overrides, workers=args.workers,
                        max_frames=args.max_frames, mode=args.mode)
    print(json.dumps(results))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="tbv", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("odometry")
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--chunk", type=int, default=0,
                   help="process frames in lax.scan device chunks of this "
                        "size (2 host transfers per chunk instead of 2-3 "
                        "per frame)")
    p.set_defaults(fn=cmd_odometry)

    p = sub.add_parser("slam")
    p.add_argument("--graph", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--solver", default="auto",
                   choices=["auto", "schur", "cholesky", "cg"])
    p.set_defaults(fn=cmd_slam)

    p = sub.add_parser("online")
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--train-alignment", action="store_true",
                   help="train the alignment classifier during the run "
                        "(tbv_slam_online.cpp:185-188)")
    p.set_defaults(fn=cmd_online)

    p = sub.add_parser("reoptimize")
    p.add_argument("--graph", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--solver", default="auto",
                   choices=["auto", "schur", "cholesky", "cg"])
    p.set_defaults(fn=cmd_reoptimize)

    p = sub.add_parser("constraints")
    p.add_argument("--graph", required=True)
    p.add_argument("--output", default="")
    p.add_argument("--reverify", action="store_true")
    p.add_argument("--print-rows", action="store_true")
    p.set_defaults(fn=cmd_constraints)

    p = sub.add_parser("eval")
    p.add_argument("--gt", required=True)
    p.add_argument("--est", required=True)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("train-alignment")
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--max-frames", type=int, default=0)
    p.set_defaults(fn=cmd_train_alignment)

    p = sub.add_parser("train-loop")
    p.add_argument("--loop-csv", default=None)
    p.add_argument("--data", default=None)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_train_loop)

    p = sub.add_parser("baseline")
    p.add_argument("--root", required=True)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=cmd_baseline)

    p = sub.add_parser("evaluate-scans")
    p.add_argument("--graph", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--range-max", type=float, default=1.0)
    p.add_argument("--range-steps", type=int, default=3)
    p.add_argument("--theta-max-deg", type=float, default=2.0)
    p.add_argument("--theta-steps", type=int, default=3)
    p.add_argument("--max-pairs", type=int, default=50)
    p.set_defaults(fn=cmd_evaluate_scans)

    p = sub.add_parser("sweep")
    p.add_argument("--par-file", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--mode", default="online",
                   choices=["online", "odometry"])
    p.set_defaults(fn=cmd_sweep)

    args, overrides = ap.parse_known_args(argv)
    if args.fn is not cmd_sweep:
        # sweep workers are processes of their own; the parent stays off JAX
        from ..core.runtime import enable_compile_cache

        enable_compile_cache()
    return args.fn(args, overrides)


if __name__ == "__main__":
    sys.exit(main())
