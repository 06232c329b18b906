"""Configuration system.

Replaces the reference's three-tier config (boost::program_options flags + ROS
param server + sweep CSVs; see tbv_slam_offline.cpp:66-213 and
odometrykeyframefuser.h:118-155) with plain dataclasses that:

- carry the reference's defaults (and the published CFEAR-3 / TBV-8 values),
- serialize to a flat ``pars.txt``-style text for run reproducibility,
- can be overridden from CLI ``key=value`` pairs and sweep files.

Static-shape capacities (point/cell/edge padding) live here too — they define
the compiled shapes of every kernel.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class RadarConfig:
    """Polar radar preprocessing (reference radar_driver.h:32-120 defaults,
    published Oxford run values in evaluation/data job_0/odom/pars.txt)."""

    num_azimuths: int = 400
    num_range_bins: int = 3768  # Oxford CTS350-X polar image width
    range_res: float = 0.0438  # meters per range bin
    z_min: float = 60.0  # minimum intensity
    k_strongest: int = 12  # published CFEAR-3 run uses 40
    min_distance: float = 2.5  # meters
    max_distance: float = 200.0
    filter_type: str = "kstrong"  # "kstrong" | "cacfar"
    nms_window: int = 3  # axial NMS half-window (radar_filters.cpp:240)
    # CA-CFAR (cfar.h:7-42)
    cfar_guard_cells: int = 40
    cfar_window_size: int = 1
    cfar_false_alarm_rate: float = 1.0
    # BFAR affine threshold a*noise + b (BFARScan, ScanType.h:207-213)
    bfar_scale: float = 1.1
    bfar_offset: float = 20.0
    # point capacity of the filtered cloud = num_azimuths * k_strongest
    # (peaks cloud shares the same padded capacity)


@dataclass(frozen=True)
class FeatureConfig:
    """CFEAR oriented-surface-point extraction (pointnormal.cpp:265-297)."""

    resolution: float = 3.0  # grid/neighborhood radius r (published run: 3)
    downsample_factor: float = 1.0  # leaf = resolution / factor
    min_neighbors: int = 6
    weight_intensity: bool = True
    intensity_floor: float = 60.0  # weight = max(I - floor, 0)
    max_cond: float = 10000.0
    min_det: float = 1e-5
    grid_extent: float = 200.0  # world half-extent for voxel ids
    cell_capacity: int = 512  # padded feature count per scan


@dataclass(frozen=True)
class RegistrationConfig:
    """Sliding-window Gauss-Newton registration (n_scan_normal.h:27-85)."""

    cost: str = "P2P"  # "P2L" | "P2D" | "P2P" (published odometry: P2P)
    loss: str = "huber"
    loss_limit: float = 0.1
    weight_option: int = 4  # 0 uniform .. 4 combined (registration.cpp:67-75)
    radius: float = 2.0  # association radius (registration.h:122)
    max_outer_iterations: int = 8  # re-association iterations
    min_outer_iterations: int = 3
    max_inner_iterations: int = 20  # LM iterations per association
    score_tolerance: float = 1e-5
    angle_gate_deg: float = 30.0  # normal similarity gate cos(pi/6)
    regularization: float = 0.01  # P2D covariance regularization
    cov_scale: float = 1.0
    init_lambda: float = 1e-4  # LM damping seed


@dataclass(frozen=True)
class OdometryConfig:
    """Keyframe fuser (odometrykeyframefuser.h:85-155)."""

    submap_scan_size: int = 4  # keyframes in registration window (published: 4)
    min_keyframe_dist: float = 1.5
    min_keyframe_rot_deg: float = 5.0
    use_guess: bool = True
    use_keyframe: bool = True
    compensate: bool = True
    radar_ccw: bool = False
    soft_constraint: bool = False
    # RegisterTimeContinuous: per-cell velocity correction inside the solve
    # instead of the up-front cloud compensation (n_scan_normal.cpp:67-80)
    time_continuous: bool = False
    sensor_period: float = 0.25  # 4 Hz radar
    vel_limit: float = 200.0
    acc_limit: float = 200.0
    # constraint covariance source: "default" = identity-scaled
    # (n_scan_normal.cpp:171-175), "sampled" = C7 grid sampling, "ceres" =
    # GN-Hessian-inverse with Censi score scaling (n_scan_normal.cpp:390-431)
    cov_source: str = "default"
    # C7 sampled covariance (odometrykeyframefuser.h:106-110)
    use_sampled_covariance: bool = False
    cov_sampling_xy_range: float = 0.4
    cov_sampling_yaw_range: float = 0.0043625
    cov_sampling_samples_per_axis: int = 3
    cov_sampling_scaler: float = 4.0


@dataclass(frozen=True)
class ScanContextConfig:
    """Radar ScanContext (RadarScancontext.h:31-131; published TBV-8 pars)."""

    num_ring: int = 40
    num_sector: int = 120
    max_radius: float = 80.0
    search_ratio: float = 0.1
    num_candidates_from_tree: int = 10
    n_candidates: int = 3  # published: 3
    desc_function: str = "sum"  # "sum" | "max"
    desc_divider: float = 1000.0
    no_point: float = 0.0
    augment_sc: bool = True
    augment_offsets: Tuple[float, ...] = (-2.0, 2.0, -4.0, 4.0)  # lateral (y)
    odometry_coupled_closure: bool = True
    odom_sigma_error: float = 0.05
    distance_exclude_recent: float = 10.0
    sc_dist_threshold: float = 0.8  # published TBV-8
    db_chunk: int = 1024  # DB padding growth quantum (compile-shape bucket)


@dataclass(frozen=True)
class VerificationConfig:
    """CorAl + CFEAR alignment quality and classifiers
    (alignmentinterface.cpp:296-368, loopclosure.cpp:220-238)."""

    coral_radius: float = 1.0
    coral_entropy_eps: float = 1e-8
    # CorAl scoring mode: "entropy" (ent_cfg=entropy, the published TBV
    # configuration) or "kl" (ent_cfg=kl, ComputeKLDiv
    # AlignmentQuality.cpp:49-73)
    coral_mode: str = "entropy"
    cfear_loss_limit: float = 0.3
    peaks_capacity: int = 4096  # padded peaks per aggregated verification cloud
    # combined 6-feature alignment model [1 + 3 CorAl + 3 CFEAR]
    # (model_parameters/trained_alignment_classifier.txt)
    alignment_coefs: Tuple[float, ...] = (
        -8.42595, -15.2287, 7.47573, -0.0680198, -1.74182, 0.0945444, 0.022217,
    )
    # loop verification model over [odom-bounds, sc-sim, alignment_quality]
    # (model_parameters/trained_loop_classifier.txt: intercept then coefs)
    loop_coefs: Tuple[float, ...] = (4.53196, -5.06267, -11.9655, 0.268186)
    model_threshold: float = 0.9  # published run
    all_candidates: bool = False  # published: best candidate only
    verify_via_odometry: bool = True
    odom_sigma_error: float = 0.05
    # training-data perturbation magnitudes (alignmentinterface.cpp:479-495)
    range_error: float = 0.5
    min_dist_btw_scans: float = 0.5


@dataclass(frozen=True)
class LoopClosureConfig:
    """ScanContextClosure strategy (loopclosure.h:75-396)."""

    n_aggregate: int = 1  # +- keyframes merged into the local map
    use_peaks: bool = True
    transl_guess: bool = True
    speedup: bool = False
    registration_max_outer: int = 4  # SetParameters(4, 10) loopclosure.cpp:58
    registration_max_inner: int = 10
    local_map_capacity: int = 4096  # padded local-map point capacity
    max_candidates_per_frame: int = 16  # static batch for candidate solves
    # MiniClosure / GTVicinityClosure strategies
    # (DerivedMiniClosureParameters, loopclosure.h:93-99)
    miniclosure_enabled: bool = False
    gt_vicinity_enabled: bool = False  # GT-based debug oracle
    gt_loop: bool = False  # take constraints directly from GT (<5 m)
    min_d_travel: float = 25.0
    max_d_travel: float = 500.0
    max_d_close: float = 15.0


@dataclass(frozen=True)
class PGOConfig:
    """Pose-graph optimization (ceresoptimizer.cpp:13-110)."""

    odom_vxx: float = 0.01
    odom_vyy: float = 0.01
    odom_vtt: float = 0.001
    loop_scaling: float = 500000.0
    replace_cov_by_identity: bool = True
    cauchy_scale: float = 0.1  # Cauchy loss on loop edges
    lago_init: bool = True  # two-stage linear (rotation/position) init
    max_iterations: int = 64
    # Termination (r3, measured on the real-odometry Oxford 10-12-32
    # instance): this pose-graph problem is LARGE-RESIDUAL (real odometry
    # disagrees with loop closures at the optimum — that is the point), so
    # Gauss-Newton/LM converges LINEARLY even with exact f64 solves
    # (verified against scipy splu: cost ratio ~0.5-0.9/iter forever), while
    # the trajectory estimate is stationary much earlier: ATE is flat
    # (3.5-3.8 m, fluctuating) from the first iteration whose relative cost
    # decrease falls under ~1%.  1e-2 with the two-consecutive-small rule
    # stops there; tightening to 1e-5 buys ~45 more iterations and ZERO ATE
    # change (measured: 3.58 vs 3.60 m on the 4470-node instance).
    function_tolerance: float = 1e-2
    # Line-search LM (the default, r3): ONE structured solve per iteration
    # at the current lambda, then pick the best step SCALE from step_ladder
    # by plain cost evaluations (cheap — no extra factorizations).  Measured
    # on the real-odometry Oxford instance this halves the per-iteration
    # solve count vs the r2 damping ladder at identical final ATE.  When the
    # full step wins, lambda shrinks (Gauss-Newton regime); when a damped
    # step wins, lambda grows (trust-region shrink).
    line_search: bool = True
    step_ladder: Tuple[float, ...] = (1.0, 0.5, 0.25)
    # Legacy r2 strategy (used when line_search=False): explore
    # damping_ladder x lambda per iteration — one structured solve each.
    tri_damping: bool = True
    # damping multipliers explored per iteration when tri_damping is on;
    # fewer candidates = proportionally cheaper iterations (each is one
    # structured solve), more = better trust-region exploration on the
    # robustified cost's plateaus
    # (0.1, 1): measured on the Oxford-route instance to keep the 3-ladder's
    # ATE while cutting solve count ~1/3 (the 10x candidate is mostly
    # redundant with the reject path's lambda*10)
    damping_ladder: Tuple[float, ...] = (0.1, 1.0)
    # Iterative-refinement depth of the structured (schur) solve:
    # 2 = inner single-column refinement + one full-solve Woodbury
    # refinement (max accuracy), 1 = inner only, 0 = none.  On the
    # 4470-node real-odometry instance: 2 -> ATE 3.61 m, 1 -> 3.71 m,
    # 0 -> 3.76 m (and solve error costs extra LM iterations).  Default
    # favors accuracy; its cost on the GPU is unmeasured.
    schur_refine: int = 2
    # Segment-size cap for the partitioned (substructured) chain solve.  On
    # the 4470-node real-odometry instance seg cap 16 gave ATE 3.539 m and
    # 128 gave 3.614 m; smaller segments mean many small batched Cholesky
    # factorizations plus a larger separator system.  Speed on the GPU is
    # unmeasured.
    schur_seg: int = 16
    cg_iterations: int = 100
    cg_tol: float = 1e-6
    init_lambda: float = 1e-6
    edge_capacity_chunk: int = 1024
    # Online-mode periodic optimization: run a PGO epoch every K keyframes
    # during the run (the OptimizerThread cadence, posegraph.cpp:132-149,
    # made deterministic).  0 = optimize only at finish (offline parity).
    optimize_every: int = 0


@dataclass(frozen=True)
class TBVConfig:
    """Top-level pipeline configuration."""

    radar: RadarConfig = field(default_factory=RadarConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    registration: RegistrationConfig = field(default_factory=RegistrationConfig)
    odometry: OdometryConfig = field(default_factory=OdometryConfig)
    scancontext: ScanContextConfig = field(default_factory=ScanContextConfig)
    verification: VerificationConfig = field(default_factory=VerificationConfig)
    loopclosure: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    pgo: PGOConfig = field(default_factory=PGOConfig)

    @property
    def point_capacity(self) -> int:
        return self.radar.num_azimuths * self.radar.k_strongest


def cfear3_oxford() -> TBVConfig:
    """The published CFEAR-3 / TBV SLAM-8 Oxford configuration
    (evaluation/data/oxford_all_tbv_model_8/job_0/{pars.txt,odom/pars.txt})."""
    return TBVConfig(
        radar=RadarConfig(k_strongest=40),
        features=FeatureConfig(resolution=3.0),
        registration=RegistrationConfig(cost="P2P", weight_option=4),
        odometry=OdometryConfig(submap_scan_size=4),
    )


def tbv8_oxford() -> TBVConfig:
    """TBV SLAM-8 Oxford run configuration (script/pars/par_oxford_tbv_8.csv:
    N_CANDIDATES=1, augment + odometry-coupled retrieval, speedup on,
    model_threshold 0.9) on top of the CFEAR-3 odometry."""
    cfg = cfear3_oxford()
    return dataclasses.replace(
        cfg,
        scancontext=dataclasses.replace(cfg.scancontext, n_candidates=1),
        loopclosure=dataclasses.replace(cfg.loopclosure, speedup=True),
    )


def tbv8_mulran() -> TBVConfig:
    """TBV SLAM-8 MulRan configuration (script/pars/mulran/
    par_mulran_all_tbv_8.csv: N_CANDIDATES=3; sensor geometry 3360 bins at
    0.05952 m, image rotated at ingestion — radar_driver.cpp:74-90)."""
    cfg = cfear3_oxford()
    return dataclasses.replace(
        cfg,
        radar=dataclasses.replace(cfg.radar, num_range_bins=3360,
                                  range_res=0.05952),
        scancontext=dataclasses.replace(cfg.scancontext, n_candidates=3),
    )


PRESETS = {
    "cfear3_oxford": cfear3_oxford,
    "tbv8_oxford": tbv8_oxford,
    "tbv8_mulran": tbv8_mulran,
}


def _flatten(cfg: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def to_pars_text(cfg: TBVConfig) -> str:
    """Flat ``key, value`` dump, the analogue of pars.txt reproducibility."""
    return "\n".join(f"{k}, {v}" for k, v in sorted(_flatten(cfg).items()))


def apply_overrides(cfg: TBVConfig, overrides: Dict[str, Any]) -> TBVConfig:
    """Apply dotted-path overrides like ``{"radar.k_strongest": 40}``."""

    def set_path(obj, path: List[str], value):
        if len(path) == 1:
            fld = {f.name: f for f in dataclasses.fields(obj)}[path[0]]
            ftype = fld.type if isinstance(fld.type, type) else type(getattr(obj, path[0]))
            if ftype is tuple and isinstance(value, str):
                # tuple fields (e.g. pgo.damping_ladder=0.1,1) parse as
                # comma-separated floats
                value = tuple(float(x) for x in value.split(","))
            elif not isinstance(value, ftype) and ftype in (int, float, bool, str):
                if ftype is bool and isinstance(value, str):
                    value = value.lower() in ("1", "true", "yes")
                else:
                    value = ftype(value)
            return dataclasses.replace(obj, **{path[0]: value})
        child = set_path(getattr(obj, path[0]), path[1:], value)
        return dataclasses.replace(obj, **{path[0]: child})

    for key, value in overrides.items():
        cfg = set_path(cfg, key.split("."), value)
    return cfg


def parse_cli_overrides(args: List[str]) -> Dict[str, Any]:
    """Parse ``a.b=c`` CLI tokens into an override dict."""
    out: Dict[str, Any] = {}
    for tok in args:
        if "=" not in tok:
            raise ValueError(f"override must be key=value, got {tok!r}")
        k, v = tok.split("=", 1)
        out[k] = v
    return out
