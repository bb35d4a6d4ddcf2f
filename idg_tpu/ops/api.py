"""Public kernel-run API: host-boundary complex↔split conversion + jit.

Device kernels are complex-free (split f32 pairs); this module is the one
place the conversion happens, and the one place the correctness guards
(`_resolve`) pick the kernel's w-term rank. Tests, the CLI, the benchmark
and chip_smoke.py all go through here.

`kernel_kw` passes kernel options through: the CPU tests hand the Pallas
kernels `interpret=True` and `precision=lax.Precision.HIGHEST`.
"""

from __future__ import annotations

import inspect
import math
import warnings
from functools import lru_cache, partial

import jax
import numpy as np

from ..config import IDGParams
from ..types import (
    Observation,
    combine_complex,
    split_complex,
    split_observation,
)
from .common import uniform_channel_spacing
from .registry import get_kernel

# Comfortably inside the 1e-5 normalized-RMS comparator gate
# (tests/test_util.hpp:84).
W_TAYLOR_TOL = 3e-6
MAX_W_RANK = 6


@lru_cache(maxsize=None)
def _accepts(workload: str, version: str, param: str) -> bool:
    fn = get_kernel(workload, version).fn
    return param in inspect.signature(fn).parameters


def kernel_fn(workload: str, version: str, w_rank: int | None = None,
              **kernel_kw):
    """The registered kernel with its resolved w_rank and options bound;
    call as fn(params, sobs[, subgrids])."""
    fn = get_kernel(workload, version).fn
    if w_rank is not None and _accepts(workload, version, "w_rank"):
        kernel_kw["w_rank"] = w_rank
    return partial(fn, **kernel_kw) if kernel_kw else fn


def _jitted(workload: str, version: str, w_rank: int | None = None,
            **kernel_kw):
    return jax.jit(kernel_fn(workload, version, w_rank, **kernel_kw),
                   static_argnums=0)


def max_mu_n(params: IDGParams, obs: Observation) -> float:
    """Host-side upper bound on |μ·n| = |(w_off − w·k)·n|, the argument of
    the separable kernels' rank-w Taylor of e^{iμ·n} (ops/xla/separable.py).

    PER-SUBGRID extremes: each subgrid's w plane (w_off from its coord_z)
    is chosen to cancel its OWN w·k range, so a global w-vs-w_off bound
    would be wildly pessimistic for w-plane-partitioned data. Still an
    upper bound — k and w extremes within the subgrid are combined
    worst-case."""
    w = np.asarray(obs.uvw, np.float64)[..., 2].reshape(-1)
    k = np.asarray(obs.wavenumbers, np.float64)
    md = obs.metadata
    t = params.nr_timesteps_subgrid
    idx = np.asarray(md.time_offset, np.int64)[:, None] + np.arange(t)
    ws = w[idx]                                        # [S, T]
    w_lo, w_hi = ws.min(axis=1), ws.max(axis=1)        # [S]
    k_lo, k_hi = float(k.min()), float(k.max())
    wk = np.stack([w_lo * k_lo, w_lo * k_hi, w_hi * k_lo, w_hi * k_hi])
    wk_lo, wk_hi = wk.min(axis=0), wk.max(axis=0)      # [S]
    z = np.asarray(md.coord_z, np.float64)
    w_off = 2.0 * np.pi * float(params.w_step) * (z + 0.5)
    mu_abs = float(np.maximum(np.abs(w_off - wk_lo), np.abs(w_off - wk_hi)).max())
    # n_max over the subgrid (math.hpp:19-24 stable form), f64
    half = params.image_size / 2.0
    tmp = 2.0 * half * half  # l² + m² at the subgrid corner
    n_max = tmp / (1.0 + math.sqrt(max(0.0, 1.0 - tmp))) if tmp <= 1.0 else 1.0
    return float(mu_abs * n_max)


def required_w_rank(params: IDGParams, obs: Observation,
                    tol: float = W_TAYLOR_TOL) -> int | None:
    """Smallest Taylor rank r with truncation bound |μ·n|^r / r! < tol, or
    None when no rank ≤ MAX_W_RANK suffices (Taylor impractical — use a
    direct full-phase kernel instead)."""
    x = max_mu_n(params, obs)
    for r in range(1, MAX_W_RANK + 1):
        if x ** r / math.factorial(r) < tol:
            return r
    return None


def _resolve(workload: str, version: str, params: IDGParams,
             obs: Observation, w_rank=None):
    """Apply the API-boundary correctness guards; returns (version, w_rank).

    1. Channel-recurrence kernels silently assume uniform wavenumber spacing
       (the reference v8's assumption, gridder_v8.cu:135-186); on
       non-uniform inputs fall back to the registered non-recurrence rung.
    2. Low-rank w·n Taylor kernels need rank r with |μ·n|^r/r! inside the
       tolerance; the rank is raised above the kernel's default when the
       observation's w range demands it (w_rank None keeps the default).

    An explicitly passed w_rank is respected as an override (benchmark
    knob), with a warning when it is below the required rank.
    """
    entry = get_kernel(workload, version)
    if entry.uniform_channels and not uniform_channel_spacing(obs.wavenumbers):
        if entry.fallback is None:
            raise ValueError(
                f"{workload} {version} assumes uniform channel spacing and the "
                "observation's wavenumbers are non-uniform; no fallback is "
                "registered — pick a non-recurrence version"
            )
        warnings.warn(
            f"{workload} {version} assumes uniform channel spacing; "
            f"wavenumbers are non-uniform — falling back to {entry.fallback}",
            stacklevel=3,
        )
        version = entry.fallback

    if not _accepts(workload, version, "w_rank"):
        # direct full-phase kernels: exact in w, nothing to guard
        return version, None
    need = required_w_rank(params, obs)
    if w_rank is not None:
        if need is None or w_rank < need:
            warnings.warn(
                f"w_rank={w_rank} override is below the required rank "
                f"{need} for this observation's w range (|mu*n| bound "
                f"exceeds {W_TAYLOR_TOL:g}); results may miss the 1e-5 "
                "gate",
                stacklevel=3,
            )
        return version, w_rank
    if need is None:
        raise ValueError(
            f"{workload} {version}: the observation's w range puts |mu*n| "
            f"beyond rank-{MAX_W_RANK} Taylor accuracy; use a direct "
            "full-phase kernel (xla_v2) instead"
        )
    default = inspect.signature(get_kernel(workload, version).fn
                                ).parameters["w_rank"].default
    return version, (need if need > default else None)


def run_gridder(params: IDGParams, obs: Observation, version: str = "xla_v2",
                w_rank=None, **kernel_kw) -> np.ndarray:
    """Run a gridder kernel; returns c64[S, P, N, N] (host)."""
    version, w_rank = _resolve("gridder", version, params, obs, w_rank)
    re, im = _jitted("gridder", version, w_rank, **kernel_kw)(
        params, split_observation(obs))
    return combine_complex(np.asarray(re), np.asarray(im))


def run_degridder(params: IDGParams, obs: Observation, subgrids,
                  version: str = "xla_v2", w_rank=None,
                  **kernel_kw) -> np.ndarray:
    """Run a degridder kernel; returns c64[S, T, C, P] (host)."""
    version, w_rank = _resolve("degridder", version, params, obs, w_rank)
    re, im = _jitted("degridder", version, w_rank, **kernel_kw)(
        params, split_observation(obs), split_complex(subgrids))
    return combine_complex(np.asarray(re), np.asarray(im))


def device_observation(obs: Observation, with_vis: bool = True):
    """The split observation on the device. The degridder has no
    visibility input, so `with_vis=False` leaves the ~1.6 GB perf-problem
    planes on the host."""
    import dataclasses

    sobs = split_observation(obs)
    if not with_vis:
        sobs = dataclasses.replace(sobs, vis_re=None, vis_im=None)
    return jax.device_put(sobs)


def staged_runner(workload: str, version: str, params: IDGParams,
                  obs: Observation, subgrids=None, w_rank=None, **kernel_kw):
    """For benchmarking: (fn, args) with the inputs already on the device,
    so the timed call holds only device work (the reference times kernel
    launches on pre-staged device buffers the same way,
    app/CUDA/util.cpp:109-126). `version` and `w_rank` must already be
    resolved (`_resolve`)."""
    fn = _jitted(workload, version, w_rank, **kernel_kw)
    sobs = device_observation(obs, with_vis=workload == "gridder")
    if workload == "gridder":
        return fn, (params, sobs)
    return fn, (params, sobs, jax.device_put(split_complex(subgrids)))


def pipeline_parts(direction: str, params: IDGParams, obs: Observation,
                   version: str, w_rank=None, **kernel_kw):
    """One imaging pass as jitted stages on device-resident inputs.

    direction "grid":   gridder → subgrid iDFT → grid scatter-add;
    direction "degrid": grid gather → subgrid DFT → degridder.
    Returns (kernel_fn, grid_fn, pass_fn, args): pass_fn(*args) is the
    whole pass; the stage timed alone is kernel_fn(*args) for "grid" and
    grid_fn(*args) for "degrid". `version`/`w_rank` must be resolved."""
    from .grid import grid_to_subgrids, subgrids_to_grid

    g, n = params.grid_size, params.subgrid_size
    md = obs.metadata
    cx, cy = jax.device_put((np.asarray(md.coord_x), np.asarray(md.coord_y)))
    kern = kernel_fn("gridder" if direction == "grid" else "degridder",
                     version, w_rank, **kernel_kw)
    if direction == "grid":
        sobs = device_observation(obs)

        def grid_fn(sub):
            return subgrids_to_grid(sub, cx, cy, g)

        kernel = jax.jit(lambda s: kern(params, s))
        return kernel, jax.jit(grid_fn), \
            jax.jit(lambda s: grid_fn(kern(params, s))), (sobs,)
    if direction != "degrid":
        raise ValueError(f"unknown pipeline direction {direction!r}")
    sobs = device_observation(obs, with_vis=False)
    rng = np.random.default_rng(11)
    grid = jax.device_put(tuple(
        rng.normal(size=(params.nr_correlations, g, g)).astype(np.float32)
        for _ in range(2)))

    def extract(gr):
        return grid_to_subgrids(gr, cx, cy, n)

    return (jax.jit(lambda sub: kern(params, sobs, sub)), jax.jit(extract),
            jax.jit(lambda gr: kern(params, sobs, extract(gr))), (grid,))
