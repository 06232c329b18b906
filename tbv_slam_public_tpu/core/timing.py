"""Named-counter timing/statistics reporter.

Equivalent of the reference's global ``CFEAR_Radarodometry::timing`` singleton
(statistics.h:19-46): accumulate named scalar samples, report mean/std/count,
dump to ``time_statistics.txt`` for parity tables.  Adds a context-manager
stopwatch and optional jax.profiler trace hooks.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple


class Statistics:
    def __init__(self) -> None:
        self._samples: Dict[str, List[float]] = defaultdict(list)

    def document(self, name: str, value: float) -> None:
        self._samples[name].append(float(value))

    @contextlib.contextmanager
    def timer(self, name: str):
        """Stopwatch in milliseconds, matching the reference's ToMs units."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append((time.perf_counter() - t0) * 1e3)

    def get(self, name: str) -> Tuple[float, float, int]:
        """(mean, std, count) for a counter; zeros when absent."""
        xs = self._samples.get(name, [])
        if not xs:
            return (0.0, 0.0, 0)
        n = len(xs)
        mean = sum(xs) / n
        var = sum((x - mean) ** 2 for x in xs) / n
        return (mean, var ** 0.5, n)

    def present(self) -> str:
        lines = []
        for name in sorted(self._samples):
            mean, std, n = self.get(name)
            lines.append(f"{name}\nmean: {mean:.6f}, std: {std:.6f}, count: {n}")
        return "\n".join(lines)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.present() + "\n")

    def reset(self) -> None:
        self._samples.clear()

    @contextlib.contextmanager
    def profile(self, trace_dir: str):
        """jax.profiler trace around a region (SURVEY §5.1: the device-side
        flamegraph complement to the named counters).  View with
        ``tensorboard --logdir trace_dir`` or xprof."""
        import jax

        with jax.profiler.trace(trace_dir):
            yield


#: process-global instance, mirroring the reference singleton usage pattern.
timing = Statistics()
