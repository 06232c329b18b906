#!/usr/bin/env python
"""Smoke test of the radar SLAM main path on NVIDIA GPUs.

    python chip_smoke.py           # phases 0-5 on one GPU
    python chip_smoke.py --multi   # the 4-GPU loop phase + distributed PGO,
                                   # compared with the same run on one GPU

Runs the published TBV-8 Oxford deployment (``core.config.tbv8_oxford``:
P2P odometry, k_strongest=40, resolution 3, submap 4, N_CANDIDATES=1,
speedup) at the Oxford CTS350-X geometry (400 x 3768 bins at 0.0438 m,
``peaks_capacity=4096``) on scans rendered by ``io.simulate`` from a fixed
seed along a trajectory that revisits its start.  Every phase prints one
line with its result and wall time; a failed phase prints its traceback and
the script exits 1.  The last line of standard output is one JSON object
naming the device.  Without a GPU the script exits 2 and prints no result.

Stated tolerances:

- CorAl kernel vs the plain form (HIGHEST precision) and a float64 numpy
  brute force: counts exact, moments rtol 1e-5 / atol 1e-4 (float32 sums in
  another order).  Coordinates sit on a 1/64 m grid, so |p - q|^2 is exact
  near the radius for every evaluation order and a count cannot flip on a
  last-bit difference.
- One full-width odometry step, GPU vs the CPU backend: pose within 2e-3 m
  and 2e-4 rad, same keyframe decision.
- 8 loop pairs, GPU vs CPU: t_be within 5e-3 m and 5e-4 rad, probability
  within 1e-3, same acceptance.
- ``--multi``: the same accepted loop set as one GPU, ATE within 0.1 m (the
  distributed solver is preconditioned CG, the one-GPU solver a direct
  chain factorization: both stop at the LM's relative-cost tolerance).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

import tbv_slam_public_tpu  # noqa: F401  (fails outside the repository)

FRAMES = 305  # frame 0 + 19 scanned chunks of 16: one compiled chunk shape
CHUNK = 16
SEED = 7
CORAL_PAIRS = 64
CORAL_WIDTHS = (1024, 4096)
WAVE = 64  # LoopCloser.process_all_batched pair_chunk
CPU_PAIRS = 8

FIXTURE_REAL_ODOM = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
    "oxford_10-12-32_real_odometry.npz")
PUBLISHED_TBV_ATE = 4.072  # est/result.txt:4 of the reference's job_0

ODOM_ATE_MAX = 1.0  # m, simulated odometry over ~240 m
LOOP_PRECISION_MIN = 0.9


class NoGPU(RuntimeError):
    pass


@dataclasses.dataclass
class Sizes:
    """What the phases run at (the defaults are the published deployment;
    a CPU rehearsal passes smaller ones)."""
    cfg: object
    frames: int = FRAMES
    chunk: int = CHUNK
    coral_pairs: int = CORAL_PAIRS
    coral_widths: tuple = CORAL_WIDTHS
    wave: int = WAVE
    cpu_pairs: int = CPU_PAIRS
    reps: int = 5


def published_cfg():
    from tbv_slam_public_tpu.core.config import tbv8_oxford

    cfg = tbv8_oxford()
    r = cfg.radar
    assert (r.num_azimuths, r.num_range_bins, r.range_res) == \
        (400, 3768, 0.0438), r
    assert cfg.verification.peaks_capacity == 4096
    return cfg


def _timed(fn, reps):
    """(median warm seconds, first-call seconds), each call ending in
    block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), first


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(m, k)}


# ---- phase 0 ---------------------------------------------------------------
def phase_device():
    import jax

    from tbv_slam_public_tpu.core import runtime

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGPU(f"JAX found no GPU (platform {devs[0].platform!r})")
    cards = runtime.nvidia_smi_cards()
    print(cards[0] if cards else "nvidia-smi: no card reported", flush=True)
    return dict(jax=jax.__version__, kind=devs[0].device_kind,
                count=len(devs), card=cards[0] if cards else None)


# ---- phase 1 ---------------------------------------------------------------
def einsum_moments(queries, qmask, points, pmask, radius):
    """The plain form before the fused rewrite: [Q, P, 2] relative
    coordinates and a batched einsum for the second moment (A/B only)."""
    import jax.numpy as jnp

    rel = points[None, :, :] - queries[:, None, :]
    d2 = jnp.sum(rel * rel, axis=-1)
    m = (d2 <= radius * radius) & pmask[None, :] & qmask[:, None]
    fm = m.astype(queries.dtype)
    rel = rel * fm[:, :, None]
    return (jnp.sum(fm, axis=1), jnp.sum(rel, axis=1),
            jnp.einsum("qpi,qpj->qij", rel, rel))


def coral_clouds(rng, pairs, n):
    """World-scale clustered clouds (wall-like clusters of 32 returns out to
    +-165 m), two overlapping clouds per pair, on a 1/64 m grid."""
    centers = rng.uniform(-160.0, 160.0, (pairs, n // 32, 1, 2))

    def cloud():
        pts = centers + rng.normal(0.0, 1.0, (pairs, n // 32, 32, 2))
        pts = np.round(pts.reshape(pairs, n, 2) * 64.0) / 64.0
        return pts.astype(np.float32), rng.uniform(size=(pairs, n)) < 0.9

    return cloud() + cloud()


def _check_moments(got, want, what):
    n, s1, s2 = (np.asarray(x, np.float64) for x in got)
    n0, s10, s20 = (np.asarray(x, np.float64) for x in want)
    if not np.array_equal(n, n0):
        raise AssertionError(f"{what}: counts differ at "
                             f"{int((n != n0).sum())} queries")
    np.testing.assert_allclose(s1, s10, rtol=1e-5, atol=1e-4, err_msg=what)
    np.testing.assert_allclose(s2, s20, rtol=1e-5, atol=1e-4, err_msg=what)


def phase_coral(sz: Sizes):
    import jax

    from tbv_slam_public_tpu.ops import coral
    from tbv_slam_public_tpu.pallas import coral_moments

    radius = 1.0
    forms = {
        "triton_kernel": coral_moments.neighbor_moments,
        "xla_fused": coral._neighbor_moments,
        "xla_einsum": einsum_moments,
    }
    batched = {name: jax.jit(jax.vmap(
        lambda q, qm, p, pm, f=f: f(q, qm, p, pm, radius)))
        for name, f in forms.items()}
    rng = np.random.default_rng(SEED)
    out = {}
    for n in sz.coral_widths:
        args = [jax.device_put(a)
                for a in coral_clouds(rng, sz.coral_pairs, n)]
        got = batched["triton_kernel"](*args)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(jax.vmap(
                lambda q, qm, p, pm: coral._neighbor_moments(
                    q, qm, p, pm, radius)))(*args)
        _check_moments(got, ref, f"kernel vs plain (Q=P={n})")
        # float64 brute force on a slice: pair 0, first 256 queries
        q, qm, p, pm = (np.asarray(a[0], np.float64) for a in args)
        q, qm = q[:256], qm[:256].astype(bool)
        rel = p[None] - q[:, None]
        msk = ((rel ** 2).sum(-1) <= radius ** 2) & pm.astype(bool)[None] \
            & qm[:, None]
        rel = rel * msk[..., None]
        _check_moments([g[0][:256] for g in got],
                       (msk.sum(1), rel.sum(1),
                        np.einsum("qpi,qpj->qij", rel, rel)),
                       f"kernel vs float64 (Q=P={n})")
        times = {}
        for name, fn in batched.items():
            sec, first = _timed(lambda: fn(*args), sz.reps)
            times[name] = dict(ms=sec * 1e3, first_call_s=first)
            print(f"  coral A/B Q=P={n} x{sz.coral_pairs} pairs {name}: "
                  f"{sec * 1e3:.4f} ms (first call {first:.2f} s)",
                  flush=True)
        out[f"q{n}"] = dict(mean_neighbours=float(
            np.asarray(got[0]).sum() / max(np.asarray(args[1]).sum(), 1)),
            **{k: round(v["ms"], 4) for k, v in times.items()})
    return out


# ---- phase 2 ---------------------------------------------------------------
def render(cfg, frames, seed=SEED):
    """Scans along a circle of 0.11*frames m radius, 0.8 m per frame, that
    revisits its start (the io.oxford simulator trajectory), with GT
    relative to the first pose."""
    from tbv_slam_public_tpu.io import simulate

    seq = simulate.make_sequence(
        num_frames=frames, seed=seed, num_azimuths=cfg.radar.num_azimuths,
        num_range_bins=cfg.radar.num_range_bins,
        range_res=cfg.radar.range_res,
        traj_kwargs=dict(radius=0.11 * frames, step=0.8, laps=1.25))
    g0 = seq.gt_poses[0]
    gt = np.stack([simulate._se2_rel(g0, g) for g in seq.gt_poses])
    return seq.images, gt.astype(np.float32)


def run_odometry(cfg, images, gt, chunk):
    """OdometryPipeline over all frames: frame 0, then scanned chunks."""
    from tbv_slam_public_tpu.models.odometry import OdometryPipeline

    pipe = OdometryPipeline(cfg)
    stamps = [0.25 * i for i in range(len(images))]
    pipe.process(images[0], stamps[0], gt_pose=gt[0])
    for lo in range(1, len(images), chunk):
        hi = min(lo + chunk, len(images))
        pipe.process_chunk(images[lo:hi], stamps[lo:hi], gt[lo:hi])
    return pipe


def phase_odometry(sz: Sizes, ctx: dict):
    import jax
    import jax.numpy as jnp

    from tbv_slam_public_tpu.eval import trajectory as tj
    from tbv_slam_public_tpu.models import odometry

    cfg = sz.cfg
    t0 = time.perf_counter()
    images, gt = render(cfg, sz.frames + 1)  # the last frame: CPU check
    render_s = time.perf_counter() - t0
    mem = _memory(odometry.odometry_scan.lower(
        odometry.init_state(cfg), jnp.asarray(images[1:1 + sz.chunk]),
        cfg).compile())
    print(f"  odometry_scan[{sz.chunk}] memory_analysis: {json.dumps(mem)}",
          flush=True)
    t0 = time.perf_counter()
    pipe = run_odometry(cfg, images[:-1], gt[:-1], sz.chunk)
    odo_s = time.perf_counter() - t0
    n_kf = len(pipe.kf_poses)
    est = np.stack(pipe.frame_poses)
    ate = tj.ate_rmse(est, gt[:-1])
    # keyframes every >= 1.5 m over 0.8 m steps: at most frames*0.8/1.5
    kf_max = int(sz.frames * 0.8 / cfg.odometry.min_keyframe_dist) + 2
    if not (kf_max // 3 <= n_kf <= kf_max):
        raise AssertionError(f"{n_kf} keyframes, expected "
                             f"{kf_max // 3}..{kf_max}")
    if not ate <= ODOM_ATE_MAX:
        raise AssertionError(f"odometry ATE {ate:.3f} m > {ODOM_ATE_MAX}")
    ctx.update(pipe=pipe, gt=gt[:-1])

    # one full-width step on the GPU and on the CPU backend
    cpu = jax.devices("cpu")[0]
    state = pipe.state
    img = jnp.asarray(images[-1])
    s_g, o_g = odometry.odometry_step(state, img, cfg)
    s_c, o_c = odometry.odometry_step(jax.device_put(state, cpu),
                                      jax.device_put(img, cpu), cfg)
    if not o_c.pose.devices() == {cpu}:
        raise AssertionError("CPU step did not run on the CPU")
    pg, pc = np.asarray(o_g.pose), np.asarray(o_c.pose)
    dxy = float(np.linalg.norm(pg[:2] - pc[:2]))
    dth = float(abs(pg[2] - pc[2]))
    if dxy > 2e-3 or dth > 2e-4 or bool(o_g.fused) != bool(o_c.fused):
        raise AssertionError(f"GPU vs CPU step: dxy={dxy:.2e} m "
                             f"dth={dth:.2e} rad fused {bool(o_g.fused)} vs "
                             f"{bool(o_c.fused)}")
    return dict(frames=sz.frames, keyframes=n_kf, ate_m=round(ate, 4),
                render_s=round(render_s, 2), odometry_s=round(odo_s, 2),
                gpu_cpu_step_dxy_m=dxy, gpu_cpu_step_dth_rad=dth)


# ---- phase 3 ---------------------------------------------------------------
def drifted_graph(pipe, gt):
    """The odometry checkpoint with the reference's 1.28 %/m radar-odometry
    drift injected into its constraints (simulated scans barely drift)."""
    from tbv_slam_public_tpu.io import checkpoint, simulate

    g = checkpoint.from_odometry(pipe)
    traveled = float(np.linalg.norm(g.constraints_meas[:, :2], axis=1).sum())
    poses, meas = simulate.inject_odometry_drift(
        g.kf_poses, g.constraints_idx, g.constraints_meas, g.kf_gt,
        target_ate_m=max(1.0, 0.0128 * traveled), seed=3)
    return dataclasses.replace(g, kf_poses=poses, constraints_meas=meas)


def train_alignment(cfg, graph, chunk):
    """In-run alignment-classifier training on the run's own consecutive
    keyframes (13 perturbations each, alignmentinterface.cpp:479-495), as
    the reference's online node does (tbv_slam_online.cpp:185-188): the
    published coefficients were fitted on real radar and score simulated
    scans far below their threshold.  Returns cfg carrying the fit."""
    import jax
    import jax.numpy as jnp

    from tbv_slam_public_tpu.models import verification as verif
    from tbv_slam_public_tpu.models.loopclosure import LoopCloser
    from tbv_slam_public_tpu.ops import logistic

    closer = LoopCloser(cfg)  # peaks compaction + the device store
    for i in range(graph.num_keyframes):
        closer.add_keyframe(jax.tree.map(lambda x: x[i], graph.peaks),
                            jax.tree.map(lambda x: x[i], graph.cells),
                            graph.kf_poses[i])
    cells, peaks, odom = closer._device_store()
    perts = jnp.asarray(verif.make_perturbations(cfg.verification))
    take = lambda tree, i: jax.tree.map(lambda x: x[i], tree)
    ids = list(range(1, graph.num_keyframes))
    xs, ys = [], []
    for lo in range(0, len(ids), chunk):
        sel = ids[lo:lo + chunk]
        n_real = len(sel)
        cur = jnp.asarray(sel + [sel[-1]] * (chunk - n_real))
        x, y = verif.batched_training_features(
            take(peaks, cur), take(cells, cur), odom[cur],
            take(peaks, cur - 1), take(cells, cur - 1), odom[cur - 1],
            perts, cfg.verification)
        xs.append(np.asarray(x)[:n_real * len(perts)])
        ys.append(np.asarray(y)[:n_real * len(perts)])
    model = logistic.fit(jnp.asarray(np.concatenate(xs)),
                         jnp.asarray(np.concatenate(ys)), balanced=True)
    coefs = (float(model.intercept),
             *(float(c) for c in np.asarray(model.coef)))
    return dataclasses.replace(cfg, verification=dataclasses.replace(
        cfg.verification, alignment_coefs=coefs))


def loop_precision(constraints, gt):
    from tbv_slam_public_tpu.eval import loops as loops_eval

    ok = [all(loops_eval.candidate_labels(gt, c.id_from, c.id_to,
                                          np.asarray(c.t_be, np.float64)))
          for c in constraints]
    return sum(ok) / max(len(ok), 1)


def wave_inputs(slam, n):
    """One pair wave of ``n`` logged candidate pairs (repeated to fill)."""
    import jax.numpy as jnp

    from tbv_slam_public_tpu.models import loopclosure as lc

    log = slam.loops.candidate_log
    rows = [log[i % len(log)] for i in range(n)]
    cells, peaks, _ = slam.loops._device_store()
    q_idx = jnp.asarray([r["id_from"] for r in rows], jnp.int32)
    c_idx = jnp.asarray([r["id_to"] for r in rows], jnp.int32)
    trees = lc.gather_pair_trees(cells, peaks, q_idx, c_idx)
    yaw = jnp.asarray([r["t_be"][2] for r in rows], jnp.float32)
    sc = jnp.asarray([r["sc_sim"] for r in rows], jnp.float32)
    od = jnp.asarray([r["odom_bounds"] for r in rows], jnp.float32)
    return (*trees, jnp.zeros((n, 3), jnp.float32), yaw, sc, od,
            jnp.ones((n,), bool), slam.loops.align_model,
            slam.loops.loop_model)


def wave_ab(cfg, args, reps):
    """register_and_verify_pairs with each CorAl form (compiled anew)."""
    import jax

    from tbv_slam_public_tpu.models import loopclosure as lc
    from tbv_slam_public_tpu.ops import coral

    dispatch = coral._moments_dispatch
    forms = {"triton_kernel": dispatch, "xla_fused": coral._neighbor_moments,
             "xla_einsum": einsum_moments}
    out = {}
    try:
        for name, fn in forms.items():
            coral._moments_dispatch = fn
            jax.clear_caches()
            sec, first = _timed(
                lambda: lc.register_and_verify_pairs(*args, cfg), reps)
            out[name] = dict(ms=sec * 1e3, first_call_s=first)
            print(f"  wave A/B {args[4].shape[0]} pairs {name}: "
                  f"{sec * 1e3:.4f} ms (first call {first:.2f} s)",
                  flush=True)
    finally:
        coral._moments_dispatch = dispatch
        jax.clear_caches()
    return out


def phase_slam(sz: Sizes, ctx: dict, ab: bool = True):
    import jax

    from tbv_slam_public_tpu.eval import trajectory as tj
    from tbv_slam_public_tpu.models import loopclosure as lc
    from tbv_slam_public_tpu.models.slam import run_offline_slam

    graph = drifted_graph(ctx["pipe"], ctx["gt"])
    gt = graph.kf_gt
    ate0 = tj.ate_rmse(graph.kf_poses, gt)
    t0 = time.perf_counter()
    cfg = train_alignment(sz.cfg, graph, sz.wave)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slam = run_offline_slam(cfg, graph, solver="auto")
    slam_s = time.perf_counter() - t0
    s = slam.summary
    ate1 = s.metrics["ate_rmse"]
    prec = loop_precision(slam.loops.constraints, gt)
    ctx.update(graph=graph, slam=slam)
    if s.num_loops < 1:
        raise AssertionError("no loop accepted")
    if prec < LOOP_PRECISION_MIN:
        raise AssertionError(f"loop precision {prec:.3f} < "
                             f"{LOOP_PRECISION_MIN}")
    if not ate1 <= ate0:
        raise AssertionError(f"ATE after PGO {ate1:.3f} > before {ate0:.3f}")

    args = wave_inputs(slam, sz.wave)
    mem = _memory(lc.register_and_verify_pairs.lower(*args, cfg).compile())
    print(f"  register_and_verify_pairs[{sz.wave}] memory_analysis: "
          f"{json.dumps(mem)}", flush=True)
    res_g = jax.device_get(lc.register_and_verify_pairs(*args, cfg))
    cpu = jax.devices("cpu")[0]
    k = sz.cpu_pairs
    cpu_args = jax.device_put(
        [jax.tree.map(lambda x: x[:k], a) for a in args[:9]], cpu)
    res_c = jax.device_get(lc.register_and_verify_pairs(
        *cpu_args, *jax.device_put(args[9:], cpu), cfg))
    d_t = np.abs(res_g.t_be[:k] - res_c.t_be)
    d_p = float(np.abs(res_g.prob[:k] - res_c.prob).max())
    thr = cfg.verification.model_threshold
    same = np.array_equal(res_g.prob[:k] > thr, res_c.prob > thr)
    if d_t[:, :2].max() > 5e-3 or d_t[:, 2].max() > 5e-4 or d_p > 1e-3 \
            or not same:
        raise AssertionError(
            f"GPU vs CPU pairs: t_be {d_t.max(0)}, prob {d_p:.2e}, "
            f"same acceptance {same}")
    out = dict(keyframes=s.num_keyframes, loops=s.num_loops,
               candidates=len(slam.loops.candidate_log),
               loop_precision=round(prec, 4), ate_before_m=round(ate0, 4),
               ate_after_m=round(ate1, 4), train_s=round(train_s, 2),
               slam_s=round(slam_s, 2),
               gpu_cpu_pairs_dt=d_t.max(0).tolist(), gpu_cpu_pairs_dprob=d_p)
    if ab:
        out["wave_ab_ms"] = {k_: round(v["ms"], 4) for k_, v in
                             wave_ab(cfg, args, sz.reps).items()}
    return out


# ---- phase 4 ---------------------------------------------------------------
def phase_pgo():
    import jax.numpy as jnp

    from tbv_slam_public_tpu.core.config import PGOConfig
    from tbv_slam_public_tpu.eval import trajectory as tj
    from tbv_slam_public_tpu.io import simulate
    from tbv_slam_public_tpu.ops import posegraph

    z = np.load(FIXTURE_REAL_ODOM)
    inst = simulate.make_real_odometry_pgo_instance(z["odom"], z["gt"],
                                                    seed=0)
    cfg = PGOConfig()
    n = len(inst.poses)
    ncap = ((n + 31) // 32) * 32
    poses = np.zeros((ncap, 3), np.float32)
    poses[:n] = inst.poses
    nmask = np.zeros((ncap,), bool)
    nmask[:n] = True
    si = np.asarray(posegraph.default_sqrt_info(jnp.asarray(inst.etype), cfg))
    edges = posegraph.make_edges(inst.idx, inst.meas, si, inst.etype,
                                 inst.mask)
    t0 = time.perf_counter()
    res = posegraph.optimize(jnp.asarray(poses), jnp.asarray(nmask), edges,
                             cfg, solver="schur", loop_cap=inst.loop_cap)
    est = np.asarray(res.poses)[:n]
    wall = time.perf_counter() - t0
    ate0, ate1 = tj.ate_rmse(inst.poses, inst.gt), tj.ate_rmse(est, inst.gt)
    if not float(res.cost) < float(res.cost0):
        raise AssertionError(f"cost {float(res.cost)} >= {float(res.cost0)}")
    if not ate1 < PUBLISHED_TBV_ATE:
        raise AssertionError(f"ATE {ate1:.3f} m >= {PUBLISHED_TBV_ATE}")
    return dict(nodes=n, loops=int(inst.n_loops), ate_before_m=round(ate0, 4),
                ate_after_m=round(ate1, 4), iterations=int(res.iterations),
                first_call_s=round(wall, 2))


# ---- phase 5 ---------------------------------------------------------------
def _cli(argv):
    from tbv_slam_public_tpu.harness import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return json.loads([ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("{")][-1])


def phase_cli():
    small = ["radar.k_strongest=4", "features.cell_capacity=192",
             "features.grid_extent=60.0", "registration.cost=P2L"]
    with tempfile.TemporaryDirectory() as d:
        odo, slam_dir = os.path.join(d, "odo"), os.path.join(d, "slam")
        m_odo = _cli(["odometry", "--dataset", "sim:60:5", "--output", odo,
                      *small])
        m_slam = _cli(["slam", "--graph",
                       os.path.join(odo, "simple_graph.npz"),
                       "--output", slam_dir, *small,
                       "verification.model_threshold=0.5"])
        for f in ("odom/00.txt", "simple_graph.npz", "pars.txt"):
            if not os.path.exists(os.path.join(odo, f)):
                raise AssertionError(f"odometry wrote no {f}")
        for f in ("est/00.txt", "loop/loop.csv", "full_graph.npz"):
            if not os.path.exists(os.path.join(slam_dir, f)):
                raise AssertionError(f"slam wrote no {f}")
        if "ate_rmse" not in m_slam:
            raise AssertionError(f"slam JSON has no ate_rmse: {m_slam}")
    return dict(keyframes=m_odo["keyframes"], loops=m_slam["loops"],
                ate_rmse=round(m_slam["ate_rmse"], 4))


# ---- --multi ---------------------------------------------------------------
def phase_multi(sz: Sizes, n_dev: int = 4):
    import jax
    from jax.sharding import Mesh

    from tbv_slam_public_tpu.models import loopclosure as lc
    from tbv_slam_public_tpu.models.slam import run_offline_slam
    from tbv_slam_public_tpu.parallel import retrieval as par_ret

    devs = jax.devices()
    if len(devs) < n_dev:
        raise AssertionError(f"--multi needs {n_dev} devices, found "
                             f"{len(devs)}")
    mesh = Mesh(np.asarray(devs[:n_dev]), ("candidates",))
    images, gt = render(sz.cfg, sz.frames)
    graph = drifted_graph(run_odometry(sz.cfg, images, gt, sz.chunk), gt)
    cfg = train_alignment(sz.cfg, graph, sz.wave)
    t0 = time.perf_counter()
    one = run_offline_slam(cfg, graph, solver="auto")
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    many = run_offline_slam(cfg, graph, mesh=mesh, solver="distributed")
    many_s = time.perf_counter() - t0
    l1 = sorted((c.id_from, c.id_to) for c in one.loops.constraints)
    l4 = sorted((c.id_from, c.id_to) for c in many.loops.constraints)
    ate1 = one.summary.metrics["ate_rmse"]
    ate4 = many.summary.metrics["ate_rmse"]
    if l1 != l4:
        raise AssertionError(f"accepted loops differ: {l1} vs {l4}")
    if not l1:
        raise AssertionError("no loop accepted")
    if abs(ate1 - ate4) > 0.1:
        raise AssertionError(f"ATE {ate4:.3f} m on {n_dev} devices vs "
                             f"{ate1:.3f} m on one")

    # sharded retrieval against the one-device DB: the same top-k
    db = many.loops.db
    spread = {d.id for d in db.desc.sharding.device_set}
    if len(spread) != n_dev:
        raise AssertionError(f"DB on devices {spread}, not all {n_dev}")
    n = one.summary.num_keyframes
    cells, peaks, odom = one.loops._device_store()
    q = jax.numpy.arange(n, dtype=jax.numpy.int32)
    d, r = lc.build_contexts_batched(peaks, odom, q,
                                     jax.numpy.asarray(n, jax.numpy.int32),
                                     cfg)
    det1 = jax.device_get(lc.detect_vmapped(cfg)(one.loops.db, d, r, q))
    det4 = jax.device_get(lc.detect_vmapped(cfg, mesh)(db, d, r, q))
    if not (np.array_equal(det1.valid, det4.valid) and np.array_equal(
            np.where(det1.valid, det1.index, -1),
            np.where(det4.valid, det4.index, -1))):
        raise AssertionError("sharded detect top-k differs")
    peak = [dv.memory_stats().get("peak_bytes_in_use", 0)
            for dv in devs[:n_dev]] if devs[0].platform == "gpu" else []
    if peak and min(peak) < 2 ** 20:
        raise AssertionError(f"device peak bytes {peak}: work stayed on "
                             "device 0")
    return dict(devices=n_dev, keyframes=n, loops=len(l1),
                ate_one_m=round(ate1, 4), ate_many_m=round(ate4, 4),
                one_s=round(one_s, 2), many_s=round(many_s, 2),
                peak_bytes=peak)


# ---- main ------------------------------------------------------------------
class Phases:
    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            res = fn(*args)
        except NoGPU:
            raise
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return None
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: "
              f"{json.dumps(res)}", flush=True)
        return res


def run_single(sz: Sizes, ph: Phases, ab: bool = True):
    ctx = {}
    ph.run("coral_kernel", phase_coral, sz)
    if ph.run("odometry", phase_odometry, sz, ctx) is not None:
        ph.run("slam", phase_slam, sz, ctx, ab)
    else:
        ph.failed.append("slam")
    ph.run("pgo_real_odometry", phase_pgo)
    ph.run("cli", phase_cli)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU loop phase + PGO and its "
                         "one-GPU comparison")
    args = ap.parse_args(argv)

    import jax

    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.lower().split(","):
        # the CPU backend as well, for the GPU-vs-CPU comparisons
        jax.config.update("jax_platforms", plats + ",cpu")
    from tbv_slam_public_tpu.core import runtime

    ph = Phases()
    try:
        info = ph.run("device", phase_device)
    except NoGPU as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if info is None:
        return 1
    print(f"compile cache: {runtime.enable_compile_cache()}", flush=True)
    sz = Sizes(cfg=published_cfg())
    if args.multi:
        ph.run("multi", phase_multi, sz)
    else:
        run_single(sz, ph)
    if ph.failed:
        print(f"chip_smoke: failed phases {ph.failed}", file=sys.stderr)
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
