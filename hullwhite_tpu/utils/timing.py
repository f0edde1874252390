"""Wall-clock benchmarking: the analogue of the reference's cudaEvent
harness (benchmark_kernel, benchmark_reductions.cu:17-72: warmups, then
timed runs).

Each call is timed on its own, from dispatch to ``jax.block_until_ready``
of its result, after ``warmup`` untimed calls (the first compiles).  The
median of the timed calls is reported: it ignores a stray slow call
without being pulled low the way a minimum is.
"""

from __future__ import annotations

import statistics
import time

import jax


def bench(fn, *args, n: int = 20, warmup: int = 1, clock=time.perf_counter):
    """(median seconds per call, last result) over ``n`` timed calls."""
    if n < 1:
        raise ValueError("n must be >= 1")
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = clock()
        out = jax.block_until_ready(fn(*args))
        times.append(clock() - t0)
    return statistics.median(times), out
