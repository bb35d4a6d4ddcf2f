"""Quantitative gridder→grid→degridder roundtrip checks (BASELINE.json
configs[1]: "gridder→degridder roundtrip correctness").

Three levels, each with a real tolerance assertion (not finiteness):

1. Analytic point-sample recovery: with identity Jones, flat taper, and
   uv·k samples snapped to the subgrid's Fourier lattice, the roundtrip
   vis → gridder → iFFT+grid-add → extract+FFT → degridder is EXACTLY
   N²·vis (the off-lattice cross terms are full-period geometric sums = 0).
   Derivation: degridder ∘ gridder gives
   vis'[t,c] = Σ_{t',c'} vis[t',c'] Σ_{y,x} e^{i(φ_{t'c'}−φ_{tc})(y,x)};
   the per-subgrid phase offset po cancels between the two directions
   (models/reference.py:96,146), and for lattice-aligned u·k the pixel sum
   is N²·δ_{tc,t'c'}. The grid stage is lossless here (single tile; the
   iFFT∘FFT pair cancels).
2. Composed-golden comparison on DISJOINT tiles: the device pipeline must
   match degridder_reference(gridder_reference(vis)) at the 1e-5 gate,
   because a disjoint grid stage is the identity.
3. Composed-golden comparison on OVERLAPPING tiles (the natural random
   metadata): expected computed with an f64 NumPy overlap-add grid stage;
   catches any scatter/gather/wrap/layout regression.
"""

import dataclasses

import numpy as np
import pytest
from jax import lax

from idg_tpu import IDGParams, make_observation
from idg_tpu.models.reference import degridder_reference, gridder_reference
from idg_tpu.ops.api import run_degridder, run_gridder
from idg_tpu.ops.grid import grid_to_subgrids, subgrids_to_grid
from idg_tpu.types import Metadata, combine_complex, split_complex
from idg_tpu.utils.compare import check_error


CPU_PALLAS = {"interpret": True, "precision": lax.Precision.HIGHEST}


def _kw(version):
    return CPU_PALLAS if version.startswith("pallas") else {}


def _device_pipeline(params, obs, grid_version, degrid_version):
    """vis → gridder → iFFT+grid-add → extract+FFT → degridder → vis'."""
    sub = run_gridder(params, obs, version=grid_version, **_kw(grid_version))
    md = obs.metadata
    grid = subgrids_to_grid(
        split_complex(sub), md.coord_x, md.coord_y, params.grid_size,
        apply_fft=True,
    )
    tiles = grid_to_subgrids(
        grid, md.coord_x, md.coord_y, params.subgrid_size, apply_fft=True
    )
    tiles_c = combine_complex(np.asarray(tiles[0]), np.asarray(tiles[1]))
    return run_degridder(params, obs, tiles_c, version=degrid_version,
                         **_kw(degrid_version))


# --------------------------------------------------------------------------
# 1. analytic point-sample recovery
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lattice_problem():
    params = IDGParams(
        grid_size=64, subgrid_size=16, nr_stations=2, nr_timeslots=1,
        nr_timesteps_subgrid=8, nr_channels=1,
    )
    obs, _ = make_observation(params)
    n = params.subgrid_size
    t_count = params.nr_timesteps_subgrid

    # uv·k on the subgrid Fourier lattice: u = a·(2π/image_size)/k with
    # integer a, distinct (a, b) per timestep (mod N). w = 0.
    k = np.array([1.0], np.float32)
    step = 2.0 * np.pi / params.image_size
    a = np.arange(t_count, dtype=np.float64)            # 0..7, distinct mod 16
    b = (2.0 * a) % n                                   # distinct pairs
    uvw = np.zeros((params.nr_subgrids * t_count, 3), np.float64)
    uvw[:, 0] = a * step
    uvw[:, 1] = b * step
    uvw = uvw.reshape(params.nr_subgrids, t_count, 3).astype(np.float32)

    # identity Jones, flat taper
    aterms = np.zeros_like(np.asarray(obs.aterms))
    aterms[..., 0] = 1.0
    aterms[..., 3] = 1.0
    spheroidal = np.ones_like(np.asarray(obs.spheroidal))

    rng = np.random.default_rng(42)
    vis = (
        rng.standard_normal((params.nr_subgrids * t_count, 1, 4))
        + 1j * rng.standard_normal((params.nr_subgrids * t_count, 1, 4))
    ).astype(np.complex64)

    md = obs.metadata
    md = dataclasses.replace(
        md,
        coord_x=np.full_like(np.asarray(md.coord_x), 8),
        coord_y=np.full_like(np.asarray(md.coord_y), 8),
    )
    obs = dataclasses.replace(
        obs, uvw=uvw, wavenumbers=k, visibilities=vis, aterms=aterms,
        spheroidal=spheroidal, metadata=md,
    )
    return params, obs, vis


@pytest.mark.parametrize(
    "grid_version,degrid_version,tol",
    [
        # xla_v2 is full f32: the single-direction 1e-5 gate holds through
        # the composition.
        ("xla_v2", "xla_v2", 1e-5),
        # the Pallas kernels (interpret mode, f32 dots) hold the same gate
        ("pallas_triton", "pallas_triton", 1e-5),
    ],
)
def test_roundtrip_recovers_lattice_visibilities(
    lattice_problem, grid_version, degrid_version, tol
):
    params, obs, vis = lattice_problem
    got = _device_pipeline(params, obs, grid_version, degrid_version)
    n2 = float(params.subgrid_size) ** 2
    expected = (n2 * vis).reshape(
        params.nr_subgrids, params.nr_timesteps_subgrid, 1, 4
    )
    result = check_error(got, expected, tolerance=tol, verbose=False)
    assert result.passed, f"normalized error {result.mean_error}"


# --------------------------------------------------------------------------
# 2. disjoint tiles: pipeline == composed golden
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def disjoint_problem():
    params = IDGParams(
        grid_size=128, subgrid_size=16, nr_stations=3, nr_timeslots=2,
        nr_timesteps_subgrid=16, nr_channels=4,
    )
    obs, _ = make_observation(params)
    # place the S=6 tiles on a disjoint lattice
    s = params.nr_subgrids
    n = params.subgrid_size
    g = params.grid_size
    slots = np.stack(
        np.meshgrid(np.arange(0, g, n), np.arange(0, g, n), indexing="ij"), -1
    ).reshape(-1, 2)[:s]
    md = dataclasses.replace(
        obs.metadata,
        coord_x=slots[:, 1].astype(np.asarray(obs.metadata.coord_x).dtype),
        coord_y=slots[:, 0].astype(np.asarray(obs.metadata.coord_y).dtype),
    )
    return params, dataclasses.replace(obs, metadata=md)


def test_roundtrip_disjoint_matches_composed_golden(disjoint_problem):
    params, obs = disjoint_problem
    golden_sub = gridder_reference(params, obs)
    expected = degridder_reference(params, obs, golden_sub)
    got = _device_pipeline(params, obs, "xla_v2", "xla_v2")
    result = check_error(got, expected, verbose=False)
    assert result.passed, f"normalized error {result.mean_error}"


# --------------------------------------------------------------------------
# 3. overlapping tiles: pipeline == f64 overlap-add composed golden
# --------------------------------------------------------------------------

def _np_grid_stage(params, obs, subgrids):
    """f64 NumPy grid stage: iFFT+shift → periodic overlap-add → extract →
    shift+FFT (the same convention as ops/grid.py, independent code)."""
    g, n = params.grid_size, params.subgrid_size
    sub = np.asarray(subgrids, np.complex128)
    sub = np.fft.fftshift(
        np.fft.ifft2(np.fft.fftshift(sub, axes=(-2, -1))), axes=(-2, -1)
    )
    cx = np.asarray(obs.metadata.coord_x, np.int64) % g
    cy = np.asarray(obs.metadata.coord_y, np.int64) % g
    grid = np.zeros((sub.shape[1], g, g), np.complex128)
    for s in range(sub.shape[0]):
        ys = (cy[s] + np.arange(n)) % g
        xs = (cx[s] + np.arange(n)) % g
        grid[:, ys[:, None], xs[None, :]] += sub[s]
    tiles = np.stack(
        [
            grid[:, (cy[s] + np.arange(n))[:, None] % g,
                 (cx[s] + np.arange(n))[None, :] % g]
            for s in range(sub.shape[0])
        ]
    )
    return np.fft.fftshift(
        np.fft.fft2(np.fft.fftshift(tiles, axes=(-2, -1))), axes=(-2, -1)
    )


def test_roundtrip_overlapping_matches_composed_golden(small_params, small_obs):
    # the natural random metadata coords overlap (S=6 tiles, 128² grid,
    # wrap-around included by the % g)
    golden_sub = gridder_reference(small_params, small_obs)
    tiles = _np_grid_stage(small_params, small_obs, golden_sub)
    expected = degridder_reference(
        small_params, small_obs, tiles.astype(np.complex64)
    )
    got = _device_pipeline(small_params, small_obs, "xla_v2", "xla_v2")
    result = check_error(got, expected, verbose=False)
    assert result.passed, f"normalized error {result.mean_error}"


@pytest.mark.parametrize("direction", ["grid", "degrid"])
def test_pipeline_parts_match_composition(direction, small_params, small_obs):
    """ops.api.pipeline_parts (the CLI/bench/chip_smoke pipelines) equals
    the stage-by-stage composition, and its stages compose to its pass."""
    import jax

    from idg_tpu.ops.api import pipeline_parts

    params, obs = small_params, small_obs
    md = obs.metadata
    kernel, grid_fn, pass_fn, args = pipeline_parts(
        direction, params, obs, "pallas_triton", **CPU_PALLAS)
    got = pass_fn(*args)
    if direction == "grid":
        sub = run_gridder(params, obs, version="pallas_triton", **CPU_PALLAS)
        want = subgrids_to_grid(split_complex(sub), md.coord_x, md.coord_y,
                                params.grid_size)
        staged = grid_fn(kernel(*args))
    else:
        tiles = grid_to_subgrids(args[0], md.coord_x, md.coord_y,
                                 params.subgrid_size)
        want = split_complex(run_degridder(
            params, obs, combine_complex(*map(np.asarray, tiles)),
            version="pallas_triton", **CPU_PALLAS))
        staged = kernel(grid_fn(*args))
    jax.block_until_ready(got)
    for a, b in ((got, want), (got, staged)):
        scale = float(np.abs(np.asarray(b[0])).max())
        np.testing.assert_allclose(np.asarray(a[0]) / scale,
                                   np.asarray(b[0]) / scale, atol=1e-5)
        np.testing.assert_allclose(np.asarray(a[1]) / scale,
                                   np.asarray(b[1]) / scale, atol=1e-5)
