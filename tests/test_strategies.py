"""MiniClosure / GTVicinityClosure strategies and time-continuous
registration (reference loopclosure.cpp:393-555, n_scan_normal.cpp:67-80)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tbv_slam_public_tpu.core import se2
from tbv_slam_public_tpu.core.config import (FeatureConfig, LoopClosureConfig,
                                             OdometryConfig, RadarConfig,
                                             RegistrationConfig, TBVConfig)
from tbv_slam_public_tpu.core.types import MINI_LOOP
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.models import strategies
from tbv_slam_public_tpu.ops import features, radar, registration


def square_trajectory(side=20, step=1.0, legs=4):
    """Axis-aligned square loop; with legs > 4 the path re-traverses the
    first legs SAME-HEADING (so revisit pairs have ~identity relative pose,
    the regime MiniClosure's identity registration guess targets)."""
    poses = [np.zeros(3, np.float32)]
    headings = [0.0, np.pi / 2, np.pi, -np.pi / 2]
    for leg in range(legs):
        h = headings[leg % 4]
        for _ in range(side):
            p = poses[-1].copy()
            p[0] += step * np.cos(h)
            p[1] += step * np.sin(h)
            p[2] = h
            poses.append(p)
    return np.stack(poses)


def test_proximity_candidates_square_loop():
    poses = square_trajectory(side=20)
    n = poses.shape[0]
    travel = strategies.odometry_travel_cumsum(poses)
    best, valid = strategies.proximity_candidates(
        jnp.asarray(poses), jnp.ones((n,), bool), jnp.asarray(travel),
        min_d_travel=25.0, max_d_travel=500.0, max_d_close=5.0)
    best, valid = np.asarray(best), np.asarray(valid)
    # the origin must pair with the loop-completing end of the square
    assert valid[0]
    assert best[0] >= n - 6
    # early-middle nodes have no revisit within 5 m
    assert not valid[n // 2]


def test_proximity_candidates_respects_travel_window():
    # straight line: all pairs far apart in euclidean OR within min travel
    poses = np.zeros((50, 3), np.float32)
    poses[:, 0] = np.arange(50, dtype=np.float32)
    travel = strategies.odometry_travel_cumsum(poses)
    best, valid = strategies.proximity_candidates(
        jnp.asarray(poses), jnp.ones((50,), bool), jnp.asarray(travel),
        min_d_travel=25.0, max_d_travel=500.0, max_d_close=15.0)
    assert not np.asarray(valid).any()


def test_verify_by_odometry_consistency():
    # consistent odometry: est distance ~ 0 at the loop -> similarity ~ 0
    poses = square_trajectory(side=20)
    travel = strategies.odometry_travel_cumsum(poses)
    n = poses.shape[0]
    sim_consistent = float(strategies.verify_by_odometry(
        jnp.asarray(poses), jnp.asarray(travel),
        jnp.asarray([n - 1]), jnp.asarray([0]), 0.05)[0])
    assert sim_consistent < 0.05
    # drifted odometry: large apparent separation -> similarity ~ 1
    drift = poses.copy()
    drift[:, 0] += np.linspace(0, 30, n, dtype=np.float32)
    travel_d = strategies.odometry_travel_cumsum(drift)
    sim_drift = float(strategies.verify_by_odometry(
        jnp.asarray(drift), jnp.asarray(travel_d),
        jnp.asarray([n - 1]), jnp.asarray([0]), 0.05)[0])
    assert sim_drift > 0.95


def _mini_cfg():
    return TBVConfig(
        radar=RadarConfig(num_azimuths=120, num_range_bins=200, range_res=0.35,
                          k_strongest=8, min_distance=1.0, max_distance=65.0),
        features=FeatureConfig(resolution=3.0, cell_capacity=256,
                               grid_extent=60.0),
        registration=RegistrationConfig(cost="P2L", weight_option=4),
        odometry=OdometryConfig(submap_scan_size=3, compensate=False),
        loopclosure=LoopClosureConfig(
            miniclosure_enabled=True, min_d_travel=25.0, max_d_travel=500.0,
            max_d_close=10.0),
    )


@pytest.fixture(scope="module")
def loop_world():
    rng = np.random.default_rng(5)
    world = simulate.make_world(rng, num_walls=60, extent=50.0)
    return world, rng


def _scan(world, pose, cfg, rng):
    img = simulate.render_scan(
        world, np.asarray(pose), num_azimuths=cfg.radar.num_azimuths,
        num_range_bins=cfg.radar.num_range_bins, range_res=cfg.radar.range_res,
        rng=rng)
    cloud, peaks = radar.kstrongest_filter(jnp.asarray(img), cfg.radar)
    cells = features.compute_cells(cloud, cfg.features)
    return jax.tree.map(np.asarray, peaks), jax.tree.map(np.asarray, cells)


@pytest.fixture(scope="module")
def mini_search(loop_world):
    """Square loop with mild drift, searched once by MiniClosure."""
    from tbv_slam_public_tpu.models.loopclosure import LoopCloser

    world, rng = loop_world
    cfg = _mini_cfg()
    gt = square_trajectory(side=12, step=1.2, legs=5)  # 1.25 laps:
    # same-heading revisits (the MiniClosure regime)
    n = gt.shape[0]
    # drifted odometry estimate (what the graph believes before closure)
    drift = gt.copy()
    drift[:, 0] += np.linspace(0, 3.0, n, dtype=np.float32)

    loops = LoopCloser(cfg)
    for i in range(n):
        peaks, cells = _scan(world, gt[i], cfg, rng)
        loops.add_keyframe(peaks, cells, drift[i])

    strat = strategies.ProximityCloser(cfg, loops)
    accepted = strat.search(graph_poses=drift)
    return cfg, strat, loops, accepted, drift, gt


def test_miniclosure_finds_and_verifies_loop(mini_search):
    """MiniClosure must register+verify the revisit pair and produce an
    accurate relative pose."""
    cfg, strat, loops, accepted, drift, gt = mini_search
    assert len(accepted) >= 1, "miniclosure found no loops"
    for c in accepted:
        assert c.id_from > c.id_to
        assert abs(c.id_from - c.id_to) > 10
        assert c.quality["mini_loop"] == 1.0
    # among accepted loops, the same-heading revisits (identity-guess
    # regime) must meet the reference's positive-ok gate: <4 m and <2.5 deg
    # (EvaluationManager.cpp:12-27)
    same_heading = []
    for c in accepted:
        t_gt = np.asarray(se2.relative(jnp.asarray(gt[c.id_from]),
                                       jnp.asarray(gt[c.id_to])))
        if abs(float(se2.wrap_angle(jnp.asarray(t_gt[2])))) < 0.1:
            same_heading.append((c, t_gt))
    assert same_heading, "no same-heading revisit pair accepted"
    for c, t_gt in same_heading:
        assert np.linalg.norm(c.t_be[:2] - t_gt[:2]) < 4.0
        assert abs(float(se2.wrap_angle(jnp.asarray(c.t_be[2] - t_gt[2])))) \
            < np.radians(2.5)
    # second search pass: origins already attempted -> nothing new
    assert strat.search(graph_poses=drift) == []


def test_miniclosure_candidate_log_has_alignment_features(mini_search):
    """Mini-loop candidate rows carry the same fields as the ScanContext
    closer's, x6 included: consumers re-score any logged candidate from its
    6-feature alignment vector (the bench does so for every row)."""
    cfg, strat, loops, accepted, drift, gt = mini_search
    rows = [r for r in loops.candidate_log if r["guess_nr"] == -1]
    assert rows
    ac = np.asarray(cfg.verification.alignment_coefs)
    for r in rows:
        assert len(r["x6"]) == 6
        np.testing.assert_allclose(np.asarray(r["x6"]) @ ac[1:] + ac[0],
                                   r["alignment_quality"], rtol=1e-4,
                                   atol=1e-3)


def test_gt_vicinity_oracle(loop_world):
    """gt_loop mode: constraints taken directly from GT relative poses."""
    from tbv_slam_public_tpu.models.loopclosure import LoopCloser

    world, rng = loop_world
    import dataclasses

    cfg = _mini_cfg()
    cfg = dataclasses.replace(
        cfg, loopclosure=dataclasses.replace(
            cfg.loopclosure, gt_vicinity_enabled=True, gt_loop=True))
    gt = square_trajectory(side=12, step=1.2, legs=5)
    n = gt.shape[0]
    loops = LoopCloser(cfg)
    for i in range(n):
        peaks, cells = _scan(world, gt[i], cfg, rng)
        loops.add_keyframe(peaks, cells, gt[i])
    strat = strategies.ProximityCloser(cfg, loops, gt_vicinity=True)
    accepted = strat.search(graph_poses=gt, gt_poses=gt)
    assert len(accepted) >= 1
    for c in accepted:
        t_gt = np.asarray(se2.relative(jnp.asarray(gt[c.id_from]),
                                       jnp.asarray(gt[c.id_to])))
        np.testing.assert_allclose(c.t_be, t_gt, atol=1e-5)
        assert c.prob == 1.0


def test_slam_miniclosure_integration(loop_world):
    """TBVSLAM with miniclosure enabled tags accepted edges MINI_LOOP."""
    from tbv_slam_public_tpu.models.slam import TBVSLAM

    world, rng = loop_world
    cfg = _mini_cfg()
    gt = square_trajectory(side=12, step=1.2, legs=5)
    slam = TBVSLAM(cfg)
    assert slam.mini_closure is not None
    # feed keyframes directly through the loop/graph stores (odometry-free
    # integration test of the strategy wiring)
    for i in range(gt.shape[0]):
        peaks, cells = _scan(world, gt[i], cfg, rng)
        slam.graph.add_node(gt[i], stamp=i * 0.25, gt=gt[i])
        if i > 0:
            rel = np.asarray(se2.relative(jnp.asarray(gt[i - 1]),
                                          jnp.asarray(gt[i])))
            slam.graph.add_odometry_constraint(i - 1, i, rel)
        slam.loops.add_keyframe(peaks, cells, gt[i])
    slam.loops._processed = gt.shape[0]  # skip the SC strategy in finish()
    summary = slam.finish(optimize=True)
    mini_edges = [e for e in slam.graph.edges if e["etype"] == MINI_LOOP]
    assert len(mini_edges) >= 1
    assert summary.num_loops >= 1


# ---- time-continuous registration (C5 RegisterTimeContinuous) -------------

def test_cell_rel_timestamps_range():
    xy = np.array([[1.0, 0.001], [0.0, 1.0], [-1.0, 0.001], [0.0, -1.0]],
                  np.float32)
    t = np.asarray(registration.cell_rel_timestamps(jnp.asarray(xy), False))
    # azimuth 0 -> -0.5 (sweep start); pi/2 -> -0.25; pi -> 0; -pi/2 -> +0.25
    np.testing.assert_allclose(t, [-0.5, -0.25, 0.0, 0.25], atol=1e-3)
    t_ccw = np.asarray(registration.cell_rel_timestamps(jnp.asarray(xy), True))
    np.testing.assert_allclose(t_ccw, -t, atol=1e-6)


def test_motion_correct_cells_zero_vel_identity():
    from tbv_slam_public_tpu.core.types import make_cells

    cells = make_cells(8)
    cells = cells.replace(
        mean=jnp.asarray(np.random.default_rng(0).normal(size=(8, 2)),
                         jnp.float32),
        normal=jnp.ones((8, 2), jnp.float32),
        valid=jnp.ones((8,), bool))
    out = registration.motion_correct_cells(cells, jnp.zeros(3), False)
    np.testing.assert_allclose(np.asarray(out.mean), np.asarray(cells.mean),
                               atol=1e-7)


def test_register_time_continuous_recovers_pose(loop_world):
    """A distorted scan registered time-continuously must recover the pose at
    least as well as plain P2P on the distorted cloud."""
    world, rng = loop_world
    cfg = _mini_cfg()
    rcfg = cfg.registration
    gt_pose = np.asarray([1.0, 0.4, 0.03], np.float32)
    vel = jnp.asarray([1.0, 0.4, 0.03], jnp.float32)

    img_ref = simulate.render_scan(
        world, np.zeros(3), num_azimuths=cfg.radar.num_azimuths,
        num_range_bins=cfg.radar.num_range_bins, range_res=cfg.radar.range_res,
        rng=rng)
    cloud_ref, _ = radar.kstrongest_filter(jnp.asarray(img_ref), cfg.radar)
    tgt_cells = features.compute_cells(cloud_ref, cfg.features)

    img_cur = simulate.render_scan(
        world, gt_pose, num_azimuths=cfg.radar.num_azimuths,
        num_range_bins=cfg.radar.num_range_bins, range_res=cfg.radar.range_res,
        rng=rng)
    cloud_cur, _ = radar.kstrongest_filter(jnp.asarray(img_cur), cfg.radar)
    # synthesize motion distortion: shift each point BACK by its sweep-time
    # share of the motion (the inverse of what correction undoes)
    t = registration.cell_rel_timestamps(cloud_cur.xy, False)
    ang = -t * vel[2]
    c, s = jnp.cos(ang), jnp.sin(ang)
    px, py = cloud_cur.xy[:, 0], cloud_cur.xy[:, 1]
    distorted = cloud_cur.replace(xy=jnp.stack(
        [c * px - s * py - t * vel[0], s * px + c * py - t * vel[1]], -1))
    src_cells = features.compute_cells(distorted, cfg.features)

    tgt = jax.tree.map(lambda x: x[None], tgt_cells)
    tgt_poses = jnp.zeros((1, 3), jnp.float32)
    ones = jnp.ones((1,), bool)
    guess = jnp.asarray(gt_pose) + jnp.asarray([0.3, -0.2, 0.01])

    res_tc = registration.register_time_continuous(
        src_cells, guess, tgt, tgt_poses, ones, rcfg, vel, ccw=False)
    res_p2p = registration.register_window(
        src_cells, guess, tgt, tgt_poses, ones,
        __import__("dataclasses").replace(rcfg, cost="P2P"))
    err_tc = float(jnp.linalg.norm(res_tc.pose[:2] - gt_pose[:2]))
    err_p2p = float(jnp.linalg.norm(res_p2p.pose[:2] - gt_pose[:2]))
    assert res_tc.success
    assert err_tc < 0.5, err_tc
    assert err_tc <= err_p2p + 0.05, (err_tc, err_p2p)
