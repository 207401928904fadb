"""Profiling and throughput instrumentation.

The reference's only instrumentation is wall-clock prints per chain
(``/root/reference/point.py:55,87,125``).  Here the equivalents are
first-class: ``trace`` wraps ``jax.profiler`` for XProf/TensorBoard
device traces of the kernels, ``annotate`` names host-side regions
inside a trace, and ``throughput`` measures a solves-per-second figure
the same way ``bench.py`` does (best of ``windows`` timing windows).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass


@contextlib.contextmanager
def trace(logdir: str = "traces"):
    """Device trace context: view with TensorBoard / xprof.

    >>> with trace("traces"):
    ...     surf_forward_batch(...)[0].block_until_ready()
    """
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named host region inside an active trace (TraceAnnotation)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


@dataclass
class Throughput:
    """Result of :func:`throughput`."""

    value: float          # units/second (best window)
    unit: str
    best_s: float         # best window seconds per call
    windows_s: list[float] = None  # all window timings

    def __str__(self):
        return f"{self.value:,.1f} {self.unit}/s (best {self.best_s:.4f} s)"


def throughput(fn, n_units: int, unit: str = "solves", iters: int = 2,
               windows: int = 3) -> Throughput:
    """Best-window throughput of ``fn`` (which must return jax arrays).

    Compiles/warms up once, then times ``windows`` windows of ``iters``
    calls each and reports the best — the same methodology as
    ``bench.py``.  All iteration results are retained and synced by a
    host fetch of their first element, so no dropped output escapes
    the timing.
    """
    import jax
    import numpy as np

    def _force(r):
        for leaf in jax.tree.leaves(r):
            if getattr(leaf, "ndim", 0) > 0:
                np.asarray(leaf[:1])
            else:
                np.asarray(leaf)

    _force(fn())
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        rs = [fn() for _ in range(iters)]
        for r in rs:
            _force(r)
        times.append((time.perf_counter() - t0) / iters)
    best = min(times)
    return Throughput(value=n_units / best, unit=unit, best_s=best,
                      windows_s=times)
