"""The phases of chip_smoke.py that run on the card (see its docstring).

Each phase prints its own lines and raises on failure; `Smoke.phase` in
chip_smoke.py records the failure and goes on. Everything runs in the
calling process.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import numpy as np

from .config import HarnessConfig, IDGParams
from .data import initialize_subgrids, make_perf_observation, make_w_observation
from .models.reference import degridder_reference, gridder_reference
from .ops.api import _resolve, device_observation, kernel_fn, pipeline_parts
from .ops.pallas.common import TF32_X3
from .types import Observation, combine_complex, split_complex, split_observation
from .utils.compare import TOLERANCE, check_error
from .utils.costs import workload_costs
from .utils.timing import time_kernel

VERSION = "pallas_triton"
XLA = "xla_v4"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _c(pair) -> np.ndarray:
    return combine_complex(np.asarray(pair[0]), np.asarray(pair[1]))


def _gate(phase: str, what: str, got, want, scale: bool = False) -> None:
    """check_error at the 1e-5 gate; `scale` first divides both by max|want|
    (grids, whose magnitudes grow with the subgrid count)."""
    got, want = np.asarray(got), np.asarray(want)
    if scale:
        s = float(np.abs(want).max()) or 1.0
        got, want = got / s, want / s
    res = check_error(got, want, verbose=False)
    say(phase, f"{what}: normalised RMS error {res.mean_error:.3e} "
               f"(limit {TOLERANCE:g}) {'ok' if res.passed else 'FAILED'}")
    if not res.passed:
        raise AssertionError(f"{what}: error {res.mean_error:.3e}")


def _slice_obs(params: IDGParams, obs: Observation, count: int):
    """The first `count` subgrids of an observation, all widths kept."""
    md = obs.metadata
    t = params.nr_timesteps_subgrid
    rows = np.asarray(md.time_offset)[:count]
    lo, hi = int(rows.min()), int(rows.max()) + t
    md = type(md)(**{f.name: np.asarray(getattr(md, f.name))[:count]
                     for f in dataclasses.fields(md)})
    md = dataclasses.replace(md, time_offset=md.time_offset - lo)
    flat = obs.uvw.reshape(-1, 3)[lo:hi]
    vis = obs.visibilities.reshape(-1, params.nr_channels,
                                   params.nr_correlations)[lo:hi]
    return dataclasses.replace(obs, uvw=flat, visibilities=vis, metadata=md)


# ---- one card --------------------------------------------------------------

def phase_compile(state):
    params, obs = state["params"], state["obs"]
    sobs = device_observation(obs)
    sub = jax.device_put(split_complex(state["subgrids"]))
    state["sobs"], state["sub"] = sobs, sub
    for workload, extra in (("gridder", ()), ("degridder", (sub,))):
        version, rank = _resolve(workload, VERSION, params, obs)
        fn = jax.jit(functools.partial(kernel_fn(workload, version, rank),
                                       params))
        t0 = time.time()
        compiled = fn.lower(sobs, *extra).compile()
        say("compile", f"{workload} {version} rank={rank or 1} compiled in "
                       f"{time.time() - t0:.1f} s")
        say("compile", f"{workload} memory_analysis: "
                       f"{compiled.memory_analysis()}")
        state[workload] = fn


def phase_oracle(state):
    say("oracle", f"dot precision {TF32_X3.name}")
    params = state["params"]
    small = _slice_obs(params, state["obs"], 64)
    w_params = dataclasses.replace(params, nr_stations=12, nr_timeslots=1)
    w_params, w_obs, _ = make_w_observation(w_params)
    for name, p, obs in (("perf[:64]", params, small),
                         (f"w-obs[{w_params.nr_subgrids}]", w_params, w_obs)):
        sub = initialize_subgrids(p.nr_subgrids, p.nr_correlations,
                                  p.subgrid_size)
        sobs = split_observation(obs)
        for workload in ("gridder", "degridder"):
            version, rank = _resolve(workload, VERSION, p, obs)
            fn = kernel_fn(workload, version, rank)
            if workload == "gridder":
                got = _c(jax.jit(functools.partial(fn, p))(sobs))
                want = gridder_reference(p, obs, chunk=16)
            else:
                got = _c(jax.jit(functools.partial(fn, p))(
                    sobs, split_complex(sub)))
                want = degridder_reference(p, obs, sub, chunk=16)
            _gate("oracle", f"{workload} {name} rank={rank or 1} vs f64 oracle",
                  got, want)


def _np_shift_dft(x: np.ndarray, inverse: bool) -> np.ndarray:
    """fftshift → (i)FFT2 → fftshift over the last two axes."""
    f = np.fft.ifft2 if inverse else np.fft.fft2
    ax = (-2, -1)
    return np.fft.fftshift(f(np.fft.fftshift(x, axes=ax), axes=ax), axes=ax)


def _np_grid_add(sub: np.ndarray, cx, cy, g: int) -> np.ndarray:
    """Host grid stage: iFFT each subgrid, np.add.at onto the wrapped grid."""
    s, p, n, _ = sub.shape
    tiles = _np_shift_dft(sub.astype(np.complex128), inverse=True)
    iy = (np.asarray(cy, np.int64)[:, None] + np.arange(n)) % g     # [S, N]
    ix = (np.asarray(cx, np.int64)[:, None] + np.arange(n)) % g
    flat = (iy[:, :, None] * g + ix[:, None, :]).reshape(-1)         # [S·N·N]
    grid = np.zeros((p, g * g), np.complex128)
    for pol in range(p):
        np.add.at(grid[pol], flat, tiles[:, pol].reshape(-1))
    return grid.reshape(p, g, g)


def _np_grid_extract(grid: np.ndarray, cx, cy, n: int) -> np.ndarray:
    """Host grid stage: slice each (wrapped) tile, FFT it."""
    g = grid.shape[-1]
    padded = np.concatenate([grid, grid[:, :n]], axis=1)
    padded = np.concatenate([padded, padded[:, :, :n]], axis=2)
    tiles = np.stack([padded[:, y % g:y % g + n, x % g:x % g + n]
                      for x, y in zip(np.asarray(cx), np.asarray(cy))])
    return _np_shift_dft(tiles, inverse=False)


def phase_main_path(state):
    params, obs = state["params"], state["obs"]
    sobs, sub = state["sobs"], state["sub"]
    g, n = params.grid_size, params.subgrid_size
    md = obs.metadata
    results = {}
    for workload, extra in (("gridder", ()), ("degridder", (sub,))):
        got = state[workload](sobs, *extra)
        version, rank = _resolve(workload, VERSION, params, obs)
        ref = jax.jit(functools.partial(kernel_fn(workload, XLA, rank),
                                        params))(sobs, *extra)
        results[workload] = got
        _gate("main", f"{workload} {version} vs {XLA} (HIGHEST), "
                      f"{params.nr_subgrids} subgrids", _c(got), _c(ref))
        del ref

    # gridded pipeline vs host composition on the checked subgrids
    version, rank = _resolve("gridder", VERSION, params, obs)
    _, _, pass_fn, pargs = pipeline_parts("grid", params, obs, version, rank)
    grid = _c(pass_fn(*pargs))
    want = _np_grid_add(_c(results["gridder"]), md.coord_x, md.coord_y, g)
    _gate("main", "gridded pipeline vs np.fft + np.add.at (scaled by max|grid|)",
          grid, want, scale=True)

    # degrid pipeline vs host extraction feeding the checked degridder
    version, rank = _resolve("degridder", VERSION, params, obs)
    kernel, _, pass_fn, pargs = pipeline_parts("degrid", params, obs,
                                               version, rank)
    vis = _c(pass_fn(*pargs))
    host_grid = _c(jax.device_get(pargs[0]))
    tiles = _np_grid_extract(host_grid, md.coord_x, md.coord_y, n)
    want = _c(kernel(split_complex(tiles.astype(np.complex64))))
    _gate("main", "degrid pipeline vs slicing + np.fft into the degridder",
          vis, want)


def phase_timing(state):
    params, obs = state["params"], state["obs"]
    sobs, sub = state["sobs"], state["sub"]
    _, _, mvis = workload_costs(params)
    harness = HarnessConfig(nr_warm_up_runs=1, nr_iterations=3, nr_windows=1)
    card = state["card"]
    for workload, extra in (("gridder", ()), ("degridder", (sub,))):
        version, rank = _resolve(workload, VERSION, params, obs)
        fns = {version: state[workload],
               XLA: jax.jit(functools.partial(
                   kernel_fn(workload, XLA, rank), params))}
        best = {}
        for name in (version, XLA, version, XLA):
            t = time_kernel(fns[name], sobs, *extra, harness=harness).seconds
            best[name] = min(best.get(name, t), t)
        for name, t in best.items():
            say("timing", f"{workload} {name} rank={rank or 1}: "
                          f"{t * 1e3:.3f} ms, {mvis / t:.1f} MVis/s on {card}")
    for direction, kname in (("grid", "gridder"), ("degrid", "degridder")):
        version, rank = _resolve(kname, VERSION, params, obs)
        kernel, grid_fn, pass_fn, pargs = pipeline_parts(
            direction, params, obs, version, rank)
        t_pass = time_kernel(pass_fn, *pargs, harness=harness).seconds
        if direction == "grid":
            t_kernel = time_kernel(kernel, *pargs, harness=harness).seconds
            t_grid = t_pass - t_kernel
        else:
            t_grid = time_kernel(grid_fn, *pargs, harness=harness).seconds
            t_kernel = t_pass - t_grid
        say("timing", f"pipeline {direction} {version}: {t_pass * 1e3:.3f} ms, "
                      f"{mvis / t_pass:.1f} MVis/s; stage split: {kname} "
                      f"{t_kernel * 1e3:.1f} ms, grid stage "
                      f"{t_grid * 1e3:.1f} ms on {card}")


def run_one_card(smoke) -> None:
    params = IDGParams.from_env()
    obs = make_perf_observation(params)
    state = {
        "params": params, "obs": obs, "card": smoke.card,
        "subgrids": initialize_subgrids(
            params.nr_subgrids, params.nr_correlations, params.subgrid_size),
    }
    say("compile", f"perf problem: grid {params.grid_size}, "
                   f"{params.nr_subgrids} subgrids, N {params.subgrid_size}, "
                   f"T {params.nr_timesteps_subgrid}, C {params.nr_channels}, "
                   f"{workload_costs(params)[2]:.2f} MVis")
    smoke.phase("compile", phase_compile, state)
    if "compile" in smoke.failed:
        return
    smoke.phase("oracle", phase_oracle, state)
    smoke.phase("main", phase_main_path, state)
    smoke.phase("timing", phase_timing, state)


# ---- four cards ------------------------------------------------------------

def phase_four_cards(state):
    from .ops.grid import grid_to_subgrids, subgrids_to_grid
    from .parallel import make_mesh
    from .parallel.sharded import (
        shard_observation,
        sharded_grid_to_degridder,
        sharded_grid_to_degridder_gather,
        sharded_gridder_to_grid,
    )

    params, obs, card = state["params"], state["obs"], state["card"]
    _, _, mvis = workload_costs(params)
    version, rank = _resolve("gridder", VERSION, params, obs)
    dversion, drank = _resolve("degridder", VERSION, params, obs)
    md = obs.metadata
    harness = HarnessConfig(nr_warm_up_runs=1, nr_iterations=3, nr_windows=2)

    # one-card pipeline on device 0
    sobs1 = device_observation(obs)
    gk = kernel_fn("gridder", version, rank)
    dk = kernel_fn("degridder", dversion, drank)
    cx, cy = jax.device_put((np.asarray(md.coord_x), np.asarray(md.coord_y)))

    @jax.jit
    def one_card(s):
        grid = subgrids_to_grid(gk(params, s), cx, cy, params.grid_size)
        tiles = grid_to_subgrids(grid, cx, cy, params.subgrid_size)
        return grid, dk(params, s, tiles)

    grid1, vis1 = one_card(sobs1)
    grid1, vis1 = _c(grid1), _c(vis1)
    t1 = time_kernel(one_card, sobs1, harness=harness).seconds
    say("four-cards", f"one card: {t1 * 1e3:.3f} ms, {mvis / t1:.1f} MVis/s")
    del sobs1

    mesh = make_mesh(4)
    say("four-cards", f"flat mesh {mesh.shape} over "
                      f"{[d.id for d in mesh.devices]}")
    sobs4, s_pad = shard_observation(params, split_observation(obs), mesh)
    say("four-cards", f"{params.nr_subgrids} subgrids split "
                      f"{s_pad // 4} per card")
    for label, sharded, degrid in (
            ("psum", False, sharded_grid_to_degridder),
            ("psum_scatter + all_gather", True,
             sharded_grid_to_degridder_gather)):
        grid_fn = sharded_gridder_to_grid(params, mesh, version,
                                          grid_sharded=sharded, w_rank=rank)
        deg_fn = degrid(params, mesh, dversion, w_rank=drank)

        def pipeline(s, grid_fn=grid_fn, deg_fn=deg_fn):
            grid = grid_fn(s)
            return grid, deg_fn(s, grid)

        grid4, vis4 = pipeline(sobs4)
        _gate("four-cards", f"{label}: grid vs one card (scaled by max|grid|)",
              _c(grid4), grid1, scale=True)
        _gate("four-cards", f"{label}: visibilities vs one card",
              _c(vis4)[:params.nr_subgrids], vis1)
        t4 = time_kernel(pipeline, sobs4, harness=harness).seconds
        say("four-cards", f"{label}: {t4 * 1e3:.3f} ms, {mvis / t4:.1f} "
                          f"MVis/s, {t1 / t4:.2f}x one card on {card}")


def run_four_cards(smoke) -> None:
    params = IDGParams.from_env()
    state = {"params": params, "obs": make_perf_observation(params),
             "card": smoke.card}
    smoke.phase("four-cards", phase_four_cards, state)


__all__ = ["run_four_cards", "run_one_card"]
