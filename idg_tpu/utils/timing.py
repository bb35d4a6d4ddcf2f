"""Device timing harness.

The reference times kernels with cudaEvent-bracketed launch loops:
NR_WARM_UP_RUNS warm-ups, then NR_ITERATIONS timed launches, reporting the
mean (app/CUDA/util.cpp:81-161). Here: compile excluded, warm-up launches,
then NR_WINDOWS timed windows of NR_ITERATIONS back-to-back launches, each
window closed by `jax.block_until_ready` on the last output. The headline
is the minimum window; the median and quartiles ride along so pairs of runs
can be judged against their spread.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import jax
import numpy as np

from ..config import HarnessConfig


@dataclasses.dataclass(frozen=True)
class TimingResult:
    seconds: float          # min-window seconds per iteration
    iterations: int         # iterations per window
    warmup_runs: int
    all_seconds: tuple      # per-window wall times

    def _per_iter(self) -> np.ndarray:
        return np.asarray(self.all_seconds) / self.iterations

    @property
    def seconds_mean(self) -> float:
        return float(self._per_iter().mean())

    @property
    def seconds_median(self) -> float:
        return float(np.median(self._per_iter()))

    @property
    def seconds_quartiles(self) -> tuple:
        q1, q3 = np.percentile(self._per_iter(), [25, 75])
        return float(q1), float(q3)

    @property
    def seconds_std(self) -> float:
        """Per-iteration standard deviation across windows (0 with one)."""
        w = self._per_iter()
        return float(w.std(ddof=1)) if w.size > 1 else 0.0


def time_kernel(
    fn: Callable,
    *args,
    harness: Optional[HarnessConfig] = None,
    profile_dir: Optional[str] = None,
) -> TimingResult:
    """Warm-up + timed launch windows (p_run_kernel semantics,
    app/CUDA/util.cpp:81-128). `fn` returns device arrays. IDG_PROFILE_DIR
    (or `profile_dir`) wraps the windows in a jax.profiler trace."""
    cfg = harness or HarnessConfig.from_env()
    profile_dir = profile_dir or os.environ.get("IDG_PROFILE_DIR") or None

    jax.block_until_ready(fn(*args))           # compile excluded
    for _ in range(cfg.nr_warm_up_runs):
        jax.block_until_ready(fn(*args))

    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    iters = max(1, cfg.nr_iterations)
    windows = []
    for _ in range(max(1, cfg.nr_windows)):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        windows.append(time.perf_counter() - t0)
    if profile_dir:
        jax.profiler.stop_trace()

    return TimingResult(
        seconds=min(windows) / iters,
        iterations=iters,
        warmup_runs=cfg.nr_warm_up_runs,
        all_seconds=tuple(windows),
    )


@dataclasses.dataclass(frozen=True)
class SustainedResult:
    seconds: float        # sustained per-launch seconds (total / launches)
    launches: int         # launches completed inside the window
    window_seconds: float  # actual wall time of the sustained window
    chunk_seconds: tuple  # per-chunk per-launch times (drift signal)

    @property
    def drift_pct(self) -> float:
        """Last-chunk vs first-chunk per-launch drift in percent; positive
        means launches got slower as the window ran (a card at its power
        limit lowers its clocks)."""
        c = self.chunk_seconds
        if len(c) < 2 or c[0] <= 0:
            return 0.0
        return float(100.0 * (c[-1] - c[0]) / c[0])


def time_kernel_sustained(
    fn: Callable,
    *args,
    duration_s: float = 10.0,
    harness: Optional[HarnessConfig] = None,
) -> SustainedResult:
    """Launch `fn` back-to-back for ~`duration_s` seconds in chunks of
    about duration/20 and report the sustained per-launch time — the
    reference's ~10 s energy-loop window (app/CUDA/util.cpp:131-155). The
    per-chunk series shows clock decay under the power limit."""
    cfg = harness or HarnessConfig.from_env()
    jax.block_until_ready(fn(*args))           # compile excluded
    for _ in range(cfg.nr_warm_up_runs):
        jax.block_until_ready(fn(*args))

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    est = max(time.perf_counter() - t0, 1e-6)
    chunk_iters = max(1, int(duration_s / 20.0 / est))

    chunks = []
    launches = 0
    start = time.perf_counter()
    while time.perf_counter() - start < duration_s:
        c0 = time.perf_counter()
        out = None
        for _ in range(chunk_iters):
            out = fn(*args)
        jax.block_until_ready(out)
        chunks.append((time.perf_counter() - c0) / chunk_iters)
        launches += chunk_iters
    total = time.perf_counter() - start
    return SustainedResult(
        seconds=total / max(launches, 1),
        launches=launches,
        window_seconds=total,
        chunk_seconds=tuple(chunks),
    )
