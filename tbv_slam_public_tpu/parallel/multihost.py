"""Multi-host orchestration helpers.

The reference's largest-scale mechanism is a single-machine multiprocess job
farm (tbv_slam/python/eval.py).  The equivalents here (SURVEY §2.6 / §5.8):

- ``initialize()``: bring up ``jax.distributed`` so all hosts form one
  global device mesh,
- ``global_mesh(axis)``: a Mesh over ALL global devices — pass it to
  parallel.candidates / parallel.pgo and the same psum/sharding code runs
  across hosts unchanged,
- ``my_jobs(items)``: deterministic round-robin partition of independent
  work (sequences, sweep jobs) over hosts — the eval.py job-farm analogue
  where jobs don't need to share a mesh,
- ``scaling_report(frames, seconds)``: frames/s bookkeeping for the
  BASELINE scaling-efficiency measurement (per-host numbers all_gather'd).

Single-process runs degrade gracefully: every helper works with one host.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, TypeVar

import numpy as np

T = TypeVar("T")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var fallbacks; no-op when the
    runtime is already initialized or single-process."""
    import jax

    if jax.process_count() > 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except (ValueError, RuntimeError):
        pass  # single-process / already initialized


def process_info():
    import jax

    return jax.process_index(), jax.process_count()


def global_mesh(axis: str = "candidates"):
    """Mesh over all global devices (every host's chips)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def my_jobs(items: Sequence[T]) -> List[T]:
    """Round-robin partition of independent jobs across hosts."""
    import jax

    pid, n = jax.process_index(), jax.process_count()
    return [x for i, x in enumerate(items) if i % n == pid]


def all_hosts_sum(value: float) -> float:
    """Sum a host-local scalar across processes (psum over the mesh)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    if jax.process_count() == 1:
        return float(value)
    mesh = global_mesh("hosts")
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("hosts")),
        np.asarray([value] * jax.local_device_count(), np.float32))
    return float(jnp.sum(arr) / jax.local_device_count())


def scaling_report(frames: int, seconds: float) -> dict:
    """Aggregate frames/s across hosts; efficiency = rate_N / (N * rate_1)
    is computed by the caller against a stored single-host baseline."""
    import jax

    total_frames = all_hosts_sum(float(frames))
    rate = total_frames / max(seconds, 1e-9)
    return dict(hosts=jax.process_count(), frames=int(total_frames),
                seconds=seconds, frames_per_s=rate)
