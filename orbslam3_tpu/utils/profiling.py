"""Profiling & observability (the reference's Tracy / REGISTER_TIMES
parity — SURVEY §5.1/§5.5).

The reference wraps every pipeline stage in Tracy zones
(ZoneNamedN, include/tracy.hpp) and keeps per-stage ms fields
(mTime_PreIntIMU etc., include/Tracking.h:306-309).  Here:

  * `StageTimer` collects per-stage wall times (with device sync) and
    prints rolling percentiles — the REGISTER_TIMES equivalent;
  * `trace()` wraps `jax.profiler.trace` for Perfetto/XProf captures —
    the Tracy-server equivalent;
  * `Verbose` mirrors the reference's leveled stdout logger
    (include/Verbose.h:10-35).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax
import numpy as np


class Verbose:
    """Leveled logger (reference Verbose::PrintMess)."""
    QUIET, NORMAL, VERBOSE, VERY_VERBOSE, DEBUG = range(5)
    level = NORMAL

    @classmethod
    def print(cls, msg: str, level: int = 1):
        if level <= cls.level:
            print(msg, flush=True)


class StageTimer:
    """Per-stage timing accumulator with device synchronization."""

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        self.times[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.times[name].append(seconds)

    def summary(self) -> str:
        lines = []
        for name, ts in sorted(self.times.items()):
            a = np.asarray(ts) * 1e3
            lines.append(
                f"{name:28s} n={len(a):5d} median={np.median(a):8.2f}ms "
                f"p90={np.percentile(a, 90):8.2f}ms mean={a.mean():8.2f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str = "/tmp/orbslam3_tpu_trace"):
    """Capture an XLA profile viewable in XProf/Perfetto
    (the equivalent of running the Tracy server)."""
    with jax.profiler.trace(logdir):
        yield
    print(f"profile written to {logdir}", flush=True)
