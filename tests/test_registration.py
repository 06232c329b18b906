"""Registration GN solver tests: known-transform recovery on simulated scans
(semantics of n_scan_normal.cpp:82-460)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tbv_slam_public_tpu.core import se2
from tbv_slam_public_tpu.core.config import FeatureConfig, RadarConfig, RegistrationConfig
from tbv_slam_public_tpu.core.types import PointCloud
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.ops import features, radar, registration


RADAR_CFG = RadarConfig(num_azimuths=200, num_range_bins=256, range_res=0.3,
                        k_strongest=12, min_distance=1.0, max_distance=75.0)
FEAT_CFG = FeatureConfig(resolution=3.0, cell_capacity=256, grid_extent=80.0)


def scan_cells(world, pose, rng=None):
    img = simulate.render_scan(world, pose, num_azimuths=RADAR_CFG.num_azimuths,
                               num_range_bins=RADAR_CFG.num_range_bins,
                               range_res=RADAR_CFG.range_res, rng=rng)
    cloud, _ = radar.kstrongest_filter(img, RADAR_CFG)
    return features.compute_cells(cloud, FEAT_CFG)


def stack_targets(cells_list):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *cells_list)


@pytest.mark.parametrize("cost", ["P2L", "P2P", "P2D"])
def test_pairwise_recovery(cost):
    """Two noisy views of the same world; recover the relative pose."""
    rng = np.random.default_rng(1)
    world = simulate.make_world(rng, num_walls=50, extent=60.0)
    pose_a = np.array([0.0, 0.0, 0.0])
    pose_b = np.array([1.2, 0.6, 0.05])

    cells_a = scan_cells(world, pose_a, np.random.default_rng(2))
    cells_b = scan_cells(world, pose_b, np.random.default_rng(3))

    cfg = RegistrationConfig(cost=cost, weight_option=4)
    tgt = stack_targets([cells_a])
    # start from identity: ~1.3 m / 3 deg initial error
    res = registration.register_window(
        cells_b, jnp.zeros(3, jnp.float32), tgt,
        jnp.asarray(pose_a, jnp.float32)[None],
        jnp.ones(1, bool), cfg)
    assert bool(res.success)
    got = np.asarray(res.pose)
    err_t = np.hypot(got[0] - pose_b[0], got[1] - pose_b[1])
    err_r = abs(se2.wrap_angle(jnp.asarray(got[2] - pose_b[2])))
    # P2P aligns cell means, which shift with viewpoint sampling along walls,
    # so it tolerates more bias than the point-to-line/distribution costs.
    tol_t = 0.25 if cost == "P2P" else 0.15
    assert err_t < tol_t, f"{cost}: trans err {err_t}"
    assert float(err_r) < 0.012, f"{cost}: rot err {err_r}"


def test_window_registration_multiple_targets():
    rng = np.random.default_rng(4)
    world = simulate.make_world(rng, num_walls=50, extent=60.0)
    poses = [np.array([0.0, 0, 0]), np.array([1.0, 0.2, 0.02]),
             np.array([2.0, 0.5, 0.05])]
    cells = [scan_cells(world, p, np.random.default_rng(10 + i))
             for i, p in enumerate(poses)]
    src_pose_true = np.array([3.0, 0.9, 0.08])
    src = scan_cells(world, src_pose_true, np.random.default_rng(20))

    cfg = RegistrationConfig(cost="P2P", weight_option=4)
    tgt = stack_targets(cells)
    guess = jnp.asarray([2.9, 0.8, 0.06], jnp.float32)
    res = registration.register_window(
        src, guess, tgt, jnp.asarray(poses, jnp.float32), jnp.ones(3, bool), cfg)
    got = np.asarray(res.pose)
    assert np.hypot(got[0] - 3.0, got[1] - 0.9) < 0.12
    assert abs(got[2] - 0.08) < 0.01


def test_target_mask_excludes_scans():
    """Masked-out target scans contribute no residuals."""
    rng = np.random.default_rng(5)
    world = simulate.make_world(rng, num_walls=40)
    cells_a = scan_cells(world, np.zeros(3), np.random.default_rng(6))
    src = scan_cells(world, np.array([0.5, 0.0, 0.0]), np.random.default_rng(7))
    cfg = RegistrationConfig(cost="P2P")
    tgt = stack_targets([cells_a, cells_a])
    mask = jnp.asarray([True, False])
    res_masked = registration.register_window(
        src, jnp.zeros(3, jnp.float32), tgt,
        jnp.zeros((2, 3), jnp.float32), mask, cfg)
    res_single = registration.register_window(
        src, jnp.zeros(3, jnp.float32), stack_targets([cells_a]),
        jnp.zeros((1, 3), jnp.float32), jnp.ones(1, bool), cfg)
    assert int(res_masked.num_residuals) == int(res_single.num_residuals)


def test_no_valid_targets_fails_gracefully():
    rng = np.random.default_rng(8)
    world = simulate.make_world(rng, num_walls=40)
    src = scan_cells(world, np.zeros(3), np.random.default_rng(9))
    cfg = RegistrationConfig(cost="P2P")
    tgt = stack_targets([src])
    res = registration.register_window(
        src, jnp.zeros(3, jnp.float32), tgt, jnp.zeros((1, 3), jnp.float32),
        jnp.zeros(1, bool), cfg)
    assert not bool(res.success)
    np.testing.assert_allclose(np.asarray(res.pose), 0.0)


def test_evaluate_cost_lower_when_aligned():
    """CFEAR-quality building block: aligned pair scores lower cost/residual."""
    rng = np.random.default_rng(11)
    world = simulate.make_world(rng, num_walls=50)
    a = scan_cells(world, np.zeros(3), np.random.default_rng(12))
    b = scan_cells(world, np.array([1.0, 0.3, 0.02]), np.random.default_rng(13))
    cfg = RegistrationConfig(cost="P2L", loss_limit=0.3, weight_option=0)
    tgt = stack_targets([a])
    tp = jnp.zeros((1, 3), jnp.float32)
    ones = jnp.ones(1, bool)
    cost_aligned, n_aligned = registration.evaluate_cost(
        b, jnp.asarray([1.0, 0.3, 0.02], jnp.float32), tgt, tp, ones, cfg)
    cost_off, n_off = registration.evaluate_cost(
        b, jnp.asarray([2.5, 1.5, 0.1], jnp.float32), tgt, tp, ones, cfg)
    assert float(cost_aligned) / max(int(n_aligned), 1) < \
        float(cost_off) / max(int(n_off), 1)
    assert int(n_aligned) > int(n_off)


def test_vmap_batched_registration():
    """Loop-candidate style: vmap over a batch of source/target pairs."""
    rng = np.random.default_rng(14)
    world = simulate.make_world(rng, num_walls=50)
    offsets = [np.array([0.8, 0.2, 0.03]), np.array([-0.5, 0.4, -0.02])]
    tgt_cells = scan_cells(world, np.zeros(3), np.random.default_rng(15))
    srcs = [scan_cells(world, o, np.random.default_rng(16 + i))
            for i, o in enumerate(offsets)]
    cfg = RegistrationConfig(cost="P2L", weight_option=0)

    src_b = jax.tree.map(lambda *xs: jnp.stack(xs), *srcs)
    tgt_b = jax.tree.map(lambda x: jnp.broadcast_to(x[None, None], (2, 1) + x.shape),
                         tgt_cells)
    fn = jax.vmap(lambda s, t, p0: registration.register_window(
        s, p0, t, jnp.zeros((1, 3), jnp.float32), jnp.ones(1, bool), cfg))
    res = fn(src_b, tgt_b, jnp.zeros((2, 3), jnp.float32))
    for i, o in enumerate(offsets):
        got = np.asarray(res.pose[i])
        assert np.hypot(got[0] - o[0], got[1] - o[1]) < 0.15
        assert abs(se2.wrap_angle(jnp.asarray(got[2] - o[2]))) < 0.012


def test_sampled_covariance_convex_quadratic(rng):
    """On a well-constrained synthetic pair the cost surface around the
    optimum is convex; the sampled covariance must be SPD and small."""
    import jax
    import jax.numpy as jnp
    from tbv_slam_public_tpu.core.config import (FeatureConfig, RadarConfig,
                                                 RegistrationConfig, TBVConfig)
    from tbv_slam_public_tpu.io import simulate
    from tbv_slam_public_tpu.ops import features, radar, registration

    cfg = TBVConfig(
        radar=RadarConfig(num_azimuths=100, num_range_bins=200, range_res=0.4,
                          k_strongest=8, min_distance=1.0, max_distance=70.0),
        features=FeatureConfig(cell_capacity=256, grid_extent=70.0),
        registration=RegistrationConfig(cost="P2L", weight_option=4))
    world = simulate.make_world(rng, num_walls=50, extent=40.0)

    def scan(pose):
        img = simulate.render_scan(world, pose, num_azimuths=100,
                                   num_range_bins=200, range_res=0.4, rng=rng)
        cloud, _ = radar.kstrongest_filter(jnp.asarray(img), cfg.radar)
        return features.compute_cells(cloud, cfg.features)

    tgt_cells = scan(np.zeros(3))
    src_cells = scan(np.array([0.8, 0.2, 0.03]))
    tgt = jax.tree.map(lambda x: x[None], tgt_cells)
    res = registration.register_window(
        src_cells, jnp.zeros(3), tgt, jnp.zeros((1, 3)), jnp.ones(1, bool),
        cfg.registration)
    assert bool(res.success)
    cov, ok = registration.sampled_covariance(
        src_cells, res.pose, tgt, jnp.zeros((1, 3)), jnp.ones(1, bool),
        cfg.registration, res.score, res.num_residuals)
    assert bool(ok), "quadratic fit should be convex at a good optimum"
    cov = np.asarray(cov)
    eig = np.linalg.eigvalsh(cov)
    assert np.all(eig > 0)
    assert cov[0, 0] < 1.0 and cov[1, 1] < 1.0  # well-constrained
    np.testing.assert_allclose(cov, cov.T, atol=1e-7)


@pytest.mark.parametrize("loss", ["tukey", "softlone", "combined", "cauchy"])
def test_loss_options_recover_offset(loss):
    """Every reference loss option (losstype, registration.h:60) must still
    recover a small rigid offset."""
    import dataclasses

    rng = np.random.default_rng(0)
    world = simulate.make_world(rng, num_walls=40, extent=60.0)
    cfg = RegistrationConfig(cost="P2L", weight_option=4, loss=loss,
                             loss_limit=0.5)
    src = scan_cells(world, np.array([1.0, 0.4, 0.05]),
                     np.random.default_rng(2))
    tgt = scan_cells(world, np.zeros(3), np.random.default_rng(3))
    res = registration.register_window(
        src, jnp.zeros(3, jnp.float32), stack_targets([tgt]),
        jnp.zeros((1, 3), jnp.float32), jnp.ones(1, bool), cfg)
    assert bool(res.success)
    np.testing.assert_allclose(np.asarray(res.pose), [1.0, 0.4, 0.05],
                               atol=0.15)


def test_register_joint_many_to_many():
    """many_to_many_refinement (n_scan_normal.cpp:360-365): jointly refining
    a window of perturbed scans must pull every movable scan back toward its
    true pose (first scan gauge-fixed)."""
    rng = np.random.default_rng(1)
    world = simulate.make_world(rng, num_walls=40, extent=60.0)
    cfg = RegistrationConfig(cost="P2L", weight_option=4)
    true_poses = np.asarray([[0.0, 0.0, 0.0], [2.0, 0.3, 0.05],
                             [4.0, 0.8, 0.1]], np.float32)
    cells = [scan_cells(world, p, np.random.default_rng(10 + i))
             for i, p in enumerate(true_poses)]
    scans = jax.tree.map(lambda *x: jnp.stack(x), *cells)
    init = true_poses.copy()
    init[1] += [0.5, -0.3, 0.03]
    init[2] += [-0.4, 0.4, -0.04]
    out = registration.register_joint(
        scans, jnp.asarray(init), jnp.ones((3,), bool),
        jnp.zeros((3,), bool), cfg)
    assert bool(out.success)
    opt = np.asarray(out.pose)
    np.testing.assert_allclose(opt[0], true_poses[0], atol=1e-6)  # gauge
    err0 = np.abs(init[1:, :2] - true_poses[1:, :2]).max()
    err1 = np.abs(opt[1:, :2] - true_poses[1:, :2]).max()
    assert err1 < 0.35 * err0, (err0, err1)


def test_ceres_covariance_output():
    """Ceres-covariance-style output (n_scan_normal.cpp:390-431): SPD, scaled
    by final cost / dof, and larger when the cost surface is flatter."""
    rng = np.random.default_rng(2)
    world = simulate.make_world(rng, num_walls=40, extent=60.0)
    cfg = RegistrationConfig(cost="P2L", weight_option=4)
    src = scan_cells(world, np.array([1.0, 0.2, 0.02]),
                     np.random.default_rng(4))
    tgt = scan_cells(world, np.zeros(3), np.random.default_rng(5))
    tgts = stack_targets([tgt])
    poses = jnp.zeros((1, 3), jnp.float32)
    mask = jnp.ones(1, bool)
    res = registration.register_window(
        src, jnp.zeros(3, jnp.float32), tgts, poses, mask, cfg)
    cov, ok = registration.ceres_covariance(
        src, res.pose, tgts, poses, mask, cfg, res.score, res.num_residuals)
    assert bool(ok)
    c = np.asarray(cov)
    np.testing.assert_allclose(c, c.T, atol=1e-8)
    assert np.all(np.linalg.eigvalsh(c) > 0)
    assert np.all(np.diag(c) < 1.0)  # well-constrained scene


def test_sampled_covariance_shared_association_matches_reassociated(rng):
    """The default fixed-correspondence grid sampling must agree with the
    literal per-sample re-association (the sample offsets are tiny against
    the association radius, so the correspondence sets coincide)."""
    import jax
    import jax.numpy as jnp
    from tbv_slam_public_tpu.core.config import (FeatureConfig, RadarConfig,
                                                 RegistrationConfig, TBVConfig)
    from tbv_slam_public_tpu.io import simulate
    from tbv_slam_public_tpu.ops import features, radar, registration

    cfg = TBVConfig(
        radar=RadarConfig(num_azimuths=100, num_range_bins=200, range_res=0.4,
                          k_strongest=8, min_distance=1.0, max_distance=70.0),
        features=FeatureConfig(cell_capacity=256, grid_extent=70.0),
        registration=RegistrationConfig(cost="P2L", weight_option=4))
    world = simulate.make_world(rng, num_walls=50, extent=40.0)

    def scan(pose):
        img = simulate.render_scan(world, pose, num_azimuths=100,
                                   num_range_bins=200, range_res=0.4, rng=rng)
        cloud, _ = radar.kstrongest_filter(jnp.asarray(img), cfg.radar)
        return features.compute_cells(cloud, cfg.features)

    tgt_cells = scan(np.zeros(3))
    src_cells = scan(np.array([0.8, 0.2, 0.03]))
    tgt = jax.tree.map(lambda x: x[None], tgt_cells)
    res = registration.register_window(
        src_cells, jnp.zeros(3), tgt, jnp.zeros((1, 3)), jnp.ones(1, bool),
        cfg.registration)
    args = (src_cells, res.pose, tgt, jnp.zeros((1, 3)), jnp.ones(1, bool),
            cfg.registration, res.score, res.num_residuals)
    cov_fast, ok_fast = registration.sampled_covariance(*args)
    cov_ref, ok_ref = registration.sampled_covariance(*args,
                                                      reassociate=True)
    assert bool(ok_fast) == bool(ok_ref)
    np.testing.assert_allclose(np.asarray(cov_fast), np.asarray(cov_ref),
                               rtol=0.25, atol=1e-4)


@pytest.mark.parametrize("cost", ["P2L", "P2D"])
def test_associate_onehot_matches_numpy_gather(rng, cost):
    """The packed one-hot winner-attribute selection must be EXACT —
    bitwise equal to a plain numpy argmin + row gather (the one-hot row has
    a single 1.0, so every output element is one f32 product at HIGHEST
    precision)."""
    import math

    cs, ct = 96, 80
    src = features.compute_cells(
        PointCloud(xy=jnp.asarray(rng.uniform(-40, 40, (cs * 4, 2)),
                                  jnp.float32),
                   intensity=jnp.asarray(rng.uniform(60, 200, (cs * 4,)),
                                         jnp.float32),
                   mask=jnp.ones((cs * 4,), bool)),
        FeatureConfig(resolution=3.0, cell_capacity=cs, grid_extent=50.0))
    t_mean = rng.uniform(-40, 40, (1, ct, 2)).astype(np.float32)
    nrm = rng.normal(size=(1, ct, 2)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    t_cov = np.broadcast_to(0.2 * np.eye(2, dtype=np.float32),
                            (1, ct, 2, 2)).copy()
    t_cov[..., 0, 0] += rng.uniform(0, 0.3, (1, ct)).astype(np.float32)
    t_n = rng.uniform(3, 30, (1, ct)).astype(np.float32)
    t_plan = rng.uniform(0, 1, (1, ct)).astype(np.float32)
    t_valid = rng.uniform(size=(1, ct)) > 0.25
    pose = jnp.asarray([0.5, -0.3, 0.1], jnp.float32)

    cost_code = registration.cost_code(cost)
    a = registration.associate(
        src, pose, jnp.asarray(t_mean), jnp.asarray(nrm), jnp.asarray(t_cov),
        jnp.asarray(t_n), jnp.asarray(t_plan), jnp.asarray(t_valid),
        2.0, weight_option=4, cost=cost_code, regularization=0.1,
        cov_scale=1.0, angle_gate_cos=math.cos(math.radians(30.0)))

    # numpy reference: argmin + direct row gather
    src_w = np.asarray(se2.apply(pose, src.mean))
    d2 = np.sum((src_w[:, None, :] - t_mean[0][None, :, :]) ** 2, -1)
    d2 = np.where(t_valid[0][None, :], d2, np.inf)
    nn = np.argmin(d2, axis=1)
    np.testing.assert_array_equal(np.asarray(a.tgt_mean_w[0]),
                                  t_mean[0][nn])
    np.testing.assert_array_equal(np.asarray(a.tgt_normal_w[0]), nrm[0][nn])
    in_radius = (d2[np.arange(cs), nn] < 4.0) & t_valid[0][nn]
    # masked-out rows must agree with the gated reference
    assert not np.any(np.asarray(a.mask[0]) & ~in_radius)
    if cost == "P2D":
        # sqrtinfo derives from the gathered covariance: check the gather
        # by reconstructing it from the returned sqrt-information
        si = np.asarray(a.tgt_sqrtinfo[0])  # U^-T with U^T U = m
        m_ref = (0.1 * np.eye(2) + t_cov[0][nn]) * 1.0
        m_rec = np.linalg.inv(si @ np.swapaxes(si, -1, -2))
        ok = np.asarray(a.mask[0])
        np.testing.assert_allclose(m_rec[ok], m_ref[ok], rtol=2e-4,
                                   atol=2e-5)
