"""Loop-candidate sweeps sharded across the device mesh.

The reference registers + verifies 6799 loop candidates sequentially on one
CPU (time_statistics: Register 8.5 ms + Verify 24.4 ms each,
loopclosure.cpp:621-733).  On a device mesh this is embarrassingly parallel:
a wave of (query, candidate) pairs is one vmapped batch, sharded across
devices on the
``candidates`` axis with replicated models — no communication until results
are gathered.

Also hosts the data-parallel alignment-classifier training step: per-pair
13-perturbation feature generation is dp-sharded, then the logistic IRLS fit
runs on all-gathered features (psum'd moments, alignmentinterface.cpp:296-347
semantics).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import TBVConfig
from ..core.types import Cells, PointCloud
from ..models import loopclosure as lc
from ..models import verification as verif
from ..ops import logistic

AXIS = "candidates"


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


@partial(jax.jit, static_argnames=("mesh", "cfg", "replicated_query"))
def _sharded_wave(mesh, args, models, cfg, replicated_query):
    """shard_map of a candidate wave: each device runs the single-device
    program on its slice of the pair axis.  The CorAl moments are a Pallas
    kernel on the GPU, which XLA's partitioner cannot split, so the batch is
    split explicitly rather than by sharding annotations."""
    from jax import shard_map

    axis = mesh.axis_names[0]
    fn = lc.register_and_verify if replicated_query \
        else lc.register_and_verify_pairs
    specs = tuple(P() if replicated_query and i < 2 else P(axis)
                  for i in range(len(args)))
    return shard_map(
        lambda a, m: fn(*a, *m, cfg), mesh=mesh,
        in_specs=(specs, P()), out_specs=P(axis), check_vma=False,
    )(args, models)


def sharded_register_and_verify(
    mesh: Mesh,
    q_cells: Cells, q_peaks: PointCloud,  # replicated query
    c_cells: Cells, c_peaks: PointCloud,  # [K, ...] candidate batch
    taug: jnp.ndarray, yaw: jnp.ndarray, sc_sim: jnp.ndarray,
    odom_bounds: jnp.ndarray, cand_valid: jnp.ndarray,
    align_model: logistic.LogisticModel,
    loop_model: logistic.LogisticModel,
    cfg: TBVConfig,
) -> lc.CandidateResult:
    """One candidate wave over the mesh; K must divide by mesh size.  No
    cross-candidate communication: each device solves its candidates."""
    return _sharded_wave(
        mesh, (q_cells, q_peaks, c_cells, c_peaks, taug, yaw, sc_sim,
               odom_bounds, cand_valid), (align_model, loop_model), cfg,
        True)


def sharded_register_and_verify_pairs(
    mesh: Mesh,
    q_cells: Cells, q_peaks: PointCloud,  # [M, ...] per-pair queries
    c_cells: Cells, c_peaks: PointCloud,  # [M, ...] candidates
    taug: jnp.ndarray, yaw: jnp.ndarray, sc_sim: jnp.ndarray,
    odom_bounds: jnp.ndarray, pair_valid: jnp.ndarray,
    align_model: logistic.LogisticModel,
    loop_model: logistic.LogisticModel,
    cfg: TBVConfig,
) -> lc.CandidateResult:
    """Flat pair wave (every element has its OWN query — the offline wave
    form of LoopCloser.process_all_batched) sharded on the pair axis.
    M must divide by mesh size; no cross-pair communication."""
    return _sharded_wave(
        mesh, (q_cells, q_peaks, c_cells, c_peaks, taug, yaw, sc_sim,
               odom_bounds, pair_valid), (align_model, loop_model), cfg,
        False)


@partial(jax.jit, static_argnames=("cfg",))
def _training_features_and_fit(
    cur_peaks, cur_cells, cur_poses,  # [B, ...] dp-sharded scan pairs
    prev_peaks, prev_cells, prev_poses,
    perturbations,  # [13, 3] replicated
    cfg: TBVConfig,
):
    """Per-pair perturbed features + one IRLS fit on the global batch."""

    def one(cp, cc, cpos, pp, pc, ppos):
        return verif.perturbed_training_features(
            cp, cc, cpos, pp, pc, ppos, perturbations, cfg.verification)

    x, y = jax.vmap(one)(cur_peaks, cur_cells, cur_poses,
                         prev_peaks, prev_cells, prev_poses)
    x = x.reshape(-1, x.shape[-1])
    y = y.reshape(-1)
    model = logistic.fit(x, y, balanced=True)
    return model, x, y


def alignment_training_step(
    mesh: Mesh,
    cur_peaks, cur_cells, cur_poses,
    prev_peaks, prev_cells, prev_poses,
    cfg: TBVConfig,
):
    """Data-parallel alignment-model training step over scan-pair batch [B].

    Feature generation (13 perturbations x CorAl + CFEAR per pair) shards on
    the batch axis; the logistic fit's normal equations are tiny (7x7), so
    XLA all-gathers the [13B, 6] feature matrix and solves replicated.
    """
    axis = mesh.axis_names[0]
    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    put_s = lambda t: jax.tree.map(lambda x: jax.device_put(x, shard), t)

    perts = jax.device_put(jnp.asarray(verif.make_perturbations(
        cfg.verification)), repl)
    return _training_features_and_fit(
        put_s(cur_peaks), put_s(cur_cells), put_s(cur_poses),
        put_s(prev_peaks), put_s(prev_cells), put_s(prev_poses),
        perts, cfg)
