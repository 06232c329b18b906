"""Accelerator-native radar SLAM framework with the capabilities of TBV Radar SLAM.

A brand-new JAX/XLA/Pallas implementation (not a port) of the TBV radar SLAM
pipeline (reference: dan11003/tbv_slam_public):

- ``ops.radar``         — polar radar filtering (k-strongest, CA-CFAR, axial NMS)
- ``ops.features``      — CFEAR oriented-surface-point features
- ``ops.registration``  — sliding-window P2L/P2D/P2P Gauss-Newton scan registration
- ``ops.scancontext``   — radar ScanContext place recognition (batched descriptor matmuls)
- ``ops.coral``         — CorAl entropy-based alignment quality
- ``ops.logistic``      — logistic-regression verification classifiers
- ``ops.pgo``           — sparse pose-graph optimization (robust Gauss-Newton + PCG)
- ``models.odometry``   — CFEAR odometry keyframe fuser
- ``models.loopclosure``— ScanContext loop retrieval + verification pipeline
- ``models.slam``       — TBV SLAM facade
- ``parallel``          — multi-chip sharding (candidate sweeps, distributed PGO)
- ``io``                — dataset loaders, synthetic radar simulator, checkpoints
- ``eval``              — KITTI-style odometry metrics, loop PR evaluation

Design stance: arrays not objects, static shapes with masks, batched
Gauss-Newton instead of Ceres, masked brute-force association instead of
kd-trees, collectives instead of threads.
"""

__version__ = "0.1.0"
