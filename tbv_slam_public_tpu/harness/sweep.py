"""Parameter-sweep job farm + result aggregation.

Rebuild of the reference experiment harness (tbv_slam/python/eval.py:1-60 and
merge_eval.py): a parameter file lists one flag per row with one or more
values; jobs are the cartesian product; each job runs the pipeline into its
own ``job_<k>`` directory; results are merged into one CSV table.

Parameter-file format (the reference's script/pars/*.csv convention):

    radar.k_strongest,12,40
    registration.cost,P2L,P2P

-> 4 jobs.  Lines starting with '#' are comments.

With ``workers=N > 1`` jobs run in N worker subprocesses, each with a fresh
JAX runtime — the analogue of the reference's multiprocessing Pool of rosrun
invocations.  A JAX process reserves most of a GPU's memory, so on GPUs each
worker is pinned to its own card through ``CUDA_VISIBLE_DEVICES`` and N may
not exceed the visible cards; the parent process stays off JAX.  With
``workers=1`` jobs run in-process (sharing compiled kernels across jobs).
"""
from __future__ import annotations

import csv
import itertools
import json
import os
import queue
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ..core import runtime


def read_par_file(path: str) -> List[List[str]]:
    """Parameter rows -> list of ``key=value`` token lists (one per job)."""
    keys: List[str] = []
    values: List[List[str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",") if p.strip()]
            if len(parts) < 2:
                continue
            keys.append(parts[0])
            values.append(parts[1:])
    jobs = []
    for combo in itertools.product(*values):
        jobs.append([f"{k}={v}" for k, v in zip(keys, combo)])
    return jobs


def _run_job_inprocess(mode: str, dataset: str, outdir: str,
                       overrides: List[str], max_frames: int) -> Dict:
    from . import cli

    argv = [mode, "--dataset", dataset, "--output", outdir]
    if max_frames:
        argv += ["--max-frames", str(max_frames)]
    argv += overrides
    import contextlib
    import io as _io

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    lines = [l for l in buf.getvalue().splitlines() if l.startswith("{")]
    return json.loads(lines[-1]) if lines else {}


def _run_job_subprocess(mode: str, dataset: str, outdir: str,
                        overrides: List[str], max_frames: int,
                        env: Optional[Dict[str, str]] = None) -> Dict:
    argv = [sys.executable, "-m", "tbv_slam_public_tpu.harness.cli", mode,
            "--dataset", dataset, "--output", outdir]
    if max_frames:
        argv += ["--max-frames", str(max_frames)]
    argv += overrides
    out = subprocess.run(argv, capture_output=True, text=True, check=True,
                         env=env)
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    return json.loads(lines[-1]) if lines else {}


def worker_envs(workers: int) -> List[Optional[Dict[str, str]]]:
    """Environment of each sweep worker process: on GPUs one card each
    (``CUDA_VISIBLE_DEVICES``), refusing more workers than visible cards;
    on the CPU the inherited environment."""
    gpus = runtime.visible_gpus()
    if gpus is None:
        return [None] * workers
    if workers > len(gpus):
        raise ValueError(
            f"{workers} sweep workers but {len(gpus)} visible GPU(s): each "
            "worker needs a card of its own")
    return [{**os.environ, "CUDA_VISIBLE_DEVICES": gpus[i]}
            for i in range(workers)]


def _run_pinned(job_ids: List[int], job_args, workers: int) -> Dict[int, Dict]:
    """Run jobs in subprocesses, at most one per worker slot at a time, each
    slot on its own card."""
    envs = worker_envs(workers)
    todo: "queue.Queue[int]" = queue.Queue()
    for k in job_ids:
        todo.put(k)
    done: Dict[int, Dict] = {}

    def slot(env):
        while True:
            try:
                k = todo.get_nowait()
            except queue.Empty:
                return
            done[k] = _run_job_subprocess(*job_args(k), env=env)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        for fut in [ex.submit(slot, env) for env in envs]:
            fut.result()
    return done


def run_sweep(par_file: str, dataset: str, output: str,
              base_overrides: Optional[List[str]] = None, workers: int = 1,
              max_frames: int = 0, mode: str = "online") -> List[Dict]:
    """Run the cartesian sweep; returns per-job summary dicts and writes
    ``merged.csv`` (merge_eval.py analogue) plus ``sweep_report.json``.

    Multi-host (SURVEY §2.6 P6): when launched in-process
    (``workers=1``) under ``jax.distributed`` (one process per host), the
    job list is round-robin partitioned across hosts via
    :func:`parallel.multihost.my_jobs` — each host runs and merges only its
    share.  Single-process runs take every job.
    """
    jobs = read_par_file(par_file)
    os.makedirs(output, exist_ok=True)
    results: List[Dict] = []
    t0 = time.perf_counter()

    def job_args(k: int) -> Tuple[str, str, str, List[str], int]:
        outdir = os.path.join(output, f"job_{k}")
        overrides = (base_overrides or []) + jobs[k]
        return (mode, dataset, outdir, overrides, max_frames)

    if workers <= 1:
        from ..parallel import multihost

        my_job_ids = multihost.my_jobs(list(range(len(jobs))))
        for k in my_job_ids:
            res = _run_job_inprocess(*job_args(k))
            res["job"] = k
            res["pars"] = " ".join(jobs[k])
            results.append(res)
        # cross-host throughput bookkeeping (scaling_report aggregates the
        # per-host job counts; single-process: hosts=1, all jobs local)
        report = multihost.scaling_report(len(results),
                                          time.perf_counter() - t0)
    else:
        # the parent stays off JAX: a runtime here would hold a card
        my_job_ids = list(range(len(jobs)))
        done = _run_pinned(my_job_ids, job_args, workers)
        for k in my_job_ids:
            res = done[k]
            res["job"] = k
            res["pars"] = " ".join(jobs[k])
            results.append(res)
        seconds = time.perf_counter() - t0
        report = dict(hosts=1, frames=len(results), seconds=seconds,
                      frames_per_s=len(results) / max(seconds, 1e-9))
    report["total_jobs"] = len(jobs)
    report["my_jobs"] = list(my_job_ids)
    with open(os.path.join(output, "sweep_report.json"), "w") as f:
        json.dump(report, f)

    # merged.csv: union of keys over all jobs
    keys = sorted({k for r in results for k in r.keys()})
    with open(os.path.join(output, "merged.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in results:
            w.writerow(r)
    return results
