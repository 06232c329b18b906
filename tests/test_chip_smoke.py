"""chip_smoke.py's phases rehearsed on the CPU at a tiny size: the same
checks and comparisons the GPU run makes, with the kernel interpreted."""
import dataclasses
import functools

import pytest

import chip_smoke as cs
from tbv_slam_public_tpu.core.config import tbv8_oxford
from tbv_slam_public_tpu.pallas import coral_moments


def _tiny_sizes() -> "cs.Sizes":
    base = tbv8_oxford()
    cfg = dataclasses.replace(
        base,
        radar=dataclasses.replace(
            base.radar, num_azimuths=160, num_range_bins=320, range_res=0.35,
            k_strongest=10, min_distance=1.5, max_distance=100.0),
        features=dataclasses.replace(base.features, cell_capacity=256,
                                     grid_extent=100.0),
        scancontext=dataclasses.replace(base.scancontext, db_chunk=256),
        verification=dataclasses.replace(base.verification,
                                         peaks_capacity=512),
        loopclosure=dataclasses.replace(base.loopclosure,
                                        local_map_capacity=1024),
    )
    return cs.Sizes(cfg=cfg, frames=1 + 8 * 15, chunk=15, coral_pairs=2,
                    coral_widths=(64,), wave=16, cpu_pairs=4, reps=1)


@pytest.fixture
def interpreted_kernel(monkeypatch):
    monkeypatch.setattr(coral_moments, "neighbor_moments", functools.partial(
        coral_moments.neighbor_moments, interpret=True))


def test_chip_smoke_single_device_phases(interpreted_kernel):
    sz = _tiny_sizes()
    coral = cs.phase_coral(sz)
    assert set(coral["q64"]) >= {"triton_kernel", "xla_fused", "xla_einsum"}
    ctx = {}
    odo = cs.phase_odometry(sz, ctx)
    assert odo["keyframes"] > 10 and odo["ate_m"] < cs.ODOM_ATE_MAX
    slam = cs.phase_slam(sz, ctx)
    assert slam["loops"] >= 1
    assert slam["loop_precision"] >= cs.LOOP_PRECISION_MIN
    assert slam["ate_after_m"] <= slam["ate_before_m"]
    assert set(slam["wave_ab_ms"]) == {"triton_kernel", "xla_fused",
                                       "xla_einsum"}


def test_chip_smoke_multi_device_phase():
    """--multi on four of the test mesh's CPU devices: the same accepted
    loops and ATE as one device, a sharded DB, the same retrieval top-k."""
    out = cs.phase_multi(_tiny_sizes(), n_dev=4)
    assert out["devices"] == 4 and out["loops"] >= 1
    assert abs(out["ate_one_m"] - out["ate_many_m"]) <= 0.1
