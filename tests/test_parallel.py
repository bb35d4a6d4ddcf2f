"""Multi-device sharding and grid-stage tests on the 8-device virtual CPU
mesh.

The reference has no multi-device capability to test (SURVEY.md §2.7); this
layer is new. Every test checks the sharded path bit-matches (or 1e-5-matches)
the single-device kernel run on the same inputs.
"""

import numpy as np
import pytest

import jax
from jax import lax

from idg_tpu import IDGParams, make_observation
from idg_tpu.ops.api import run_gridder
from idg_tpu.ops.grid import grid_to_subgrids, subgrids_to_grid
from idg_tpu.ops.registry import get_kernel
from idg_tpu.parallel import make_mesh, sharded_degridder, sharded_gridder
from idg_tpu.parallel.sharded import (
    shard_observation,
    sharded_grid_to_degridder,
    sharded_gridder_to_grid,
)
from idg_tpu.types import combine_complex, split_complex, split_observation
from idg_tpu.utils.compare import check_error

CPU_PALLAS = {"interpret": True, "precision": lax.Precision.HIGHEST}


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return make_mesh()


@pytest.fixture(scope="module")
def par_params():
    # S = B * timeslots = 10 * 4 = 40, divisible by 8.
    return IDGParams(
        grid_size=128,
        subgrid_size=16,
        nr_stations=5,
        nr_timeslots=4,
        nr_timesteps_subgrid=16,
        nr_channels=8,
    )


@pytest.fixture(scope="module")
def par_obs(par_params):
    obs, _ = make_observation(par_params)
    return obs


def test_sharded_gridder_matches_single_device(mesh, par_params, par_obs):
    expected = run_gridder(par_params, par_obs, version="xla_v2")
    sobs = split_observation(par_obs)
    sharded_sobs, s_pad = shard_observation(par_params, sobs, mesh)
    assert s_pad == par_params.nr_subgrids  # already divisible
    re, im = sharded_gridder(par_params, mesh, "xla_v2")(sharded_sobs)
    got = combine_complex(np.asarray(re), np.asarray(im))
    assert check_error(got, expected, verbose=False).passed


def test_sharded_gridder_pads_odd_subgrid_count(mesh):
    # S = 3 baselines * 2 = 6, not divisible by 8 -> padded to 8.
    params = IDGParams(
        grid_size=128, subgrid_size=16, nr_stations=3, nr_timeslots=2,
        nr_timesteps_subgrid=16, nr_channels=4,
    )
    obs, _ = make_observation(params)
    expected = run_gridder(params, obs, version="xla_v2")
    sharded_sobs, s_pad = shard_observation(params, split_observation(obs), mesh)
    assert s_pad == 8
    re, im = sharded_gridder(params, mesh, "xla_v2")(sharded_sobs)
    got = combine_complex(np.asarray(re), np.asarray(im))[: params.nr_subgrids]
    assert check_error(got, expected, verbose=False).passed


def test_sharded_degridder_matches_single_device(mesh, par_params, par_obs):
    from idg_tpu.data import initialize_subgrids

    subgrids = initialize_subgrids(
        par_params.nr_subgrids, par_params.nr_correlations, par_params.subgrid_size
    )
    sobs = split_observation(par_obs)
    kernel = get_kernel("degridder", "xla_v2").fn
    exp_re, exp_im = jax.jit(kernel, static_argnums=0)(
        par_params, sobs, split_complex(subgrids)
    )
    expected = combine_complex(np.asarray(exp_re), np.asarray(exp_im))

    sharded_sobs, _ = shard_observation(par_params, sobs, mesh)
    sub_pair = split_complex(subgrids)
    re, im = sharded_degridder(par_params, mesh, "xla_v2")(sharded_sobs, sub_pair)
    got = combine_complex(np.asarray(re), np.asarray(im))
    assert check_error(got, expected, verbose=False).passed


def test_sharded_grid_reduction_matches_local(mesh, par_params, par_obs):
    """gridder → FFT → scatter-add → psum equals the single-device pipeline."""
    sobs = split_observation(par_obs)
    kernel = get_kernel("gridder", "xla_v2").fn
    sub = jax.jit(kernel, static_argnums=0)(par_params, sobs)
    md = par_obs.metadata
    expected = subgrids_to_grid(
        sub, md.coord_x, md.coord_y, par_params.grid_size, apply_fft=True
    )
    sharded_sobs, _ = shard_observation(par_params, sobs, mesh)
    fn = sharded_gridder_to_grid(par_params, mesh, "xla_v2", apply_fft=True)
    got = fn(sharded_sobs)
    np.testing.assert_allclose(
        np.asarray(got[0]), np.asarray(expected[0]), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(got[1]), np.asarray(expected[1]), atol=2e-4
    )


def test_sharded_grid_reduction_scatter_variant(mesh, par_params, par_obs):
    """psum_scatter grid rows concatenate to the psum (replicated) grid."""
    sobs = split_observation(par_obs)
    sharded_sobs, _ = shard_observation(par_params, sobs, mesh)
    full = sharded_gridder_to_grid(par_params, mesh, "xla_v2")(sharded_sobs)
    rows = sharded_gridder_to_grid(
        par_params, mesh, "xla_v2", grid_sharded=True
    )(sharded_sobs)
    np.testing.assert_allclose(
        np.asarray(rows[0]), np.asarray(full[0]), atol=1e-5
    )


def test_sharded_pipeline_roundtrip_matches_single_device(
    mesh, par_params, par_obs
):
    """Full sharded roundtrip (gridder → grid psum → extract → degridder)
    matches the single-device pipeline at the 1e-5 gate — a quantitative
    adjoint/layout check, not a finiteness smoke test."""
    sobs = split_observation(par_obs)

    # single-device pipeline on the same inputs
    kernel = get_kernel("gridder", "xla_v2").fn
    sub = jax.jit(kernel, static_argnums=0)(par_params, sobs)
    md = par_obs.metadata
    grid_1dev = subgrids_to_grid(
        sub, md.coord_x, md.coord_y, par_params.grid_size, apply_fft=True
    )
    tiles = grid_to_subgrids(
        grid_1dev, md.coord_x, md.coord_y, par_params.subgrid_size,
        apply_fft=True,
    )
    dekernel = get_kernel("degridder", "xla_v2").fn
    exp_re, exp_im = jax.jit(dekernel, static_argnums=0)(
        par_params, sobs, tiles
    )
    expected = combine_complex(np.asarray(exp_re), np.asarray(exp_im))

    sharded_sobs, _ = shard_observation(par_params, sobs, mesh)
    grid = sharded_gridder_to_grid(par_params, mesh, "xla_v2")(sharded_sobs)
    vis = sharded_grid_to_degridder(par_params, mesh, "xla_v2")(
        sharded_sobs, grid
    )
    got = combine_complex(np.asarray(vis[0]), np.asarray(vis[1]))
    assert got.shape == (
        par_params.nr_subgrids,
        par_params.nr_timesteps_subgrid,
        par_params.nr_channels,
        par_params.nr_correlations,
    )
    assert check_error(got, expected, verbose=False).passed


def test_fft_matmul_matches_numpy(par_params):
    """DFT-matmul FFT equals np.fft on random subgrids."""
    from idg_tpu.ops.grid import fft2_pair

    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 4, 16, 16)) + 1j * rng.standard_normal((3, 4, 16, 16))).astype(np.complex64)
    got = fft2_pair(split_complex(x), inverse=False)
    expected = np.fft.fft2(x)
    np.testing.assert_allclose(
        combine_complex(np.asarray(got[0]), np.asarray(got[1])),
        expected.astype(np.complex64),
        atol=1e-3,
    )
    inv = fft2_pair(split_complex(x), inverse=True)
    np.testing.assert_allclose(
        combine_complex(np.asarray(inv[0]), np.asarray(inv[1])),
        np.fft.ifft2(x).astype(np.complex64),
        atol=1e-5,
    )


def test_fft_shift_pair_folds_both_shifts(par_params):
    """fft2_shift_pair == fftshift → (i)DFT → fftshift for even AND odd n
    (odd n exercises the distinct output-side permutation — regression
    for the σ_out = σ_in assumption that only holds for even n)."""
    from idg_tpu.ops.grid import fft2_pair, fft2_shift_pair, fftshift2_pair

    rng = np.random.default_rng(11)
    for n in (7, 16):
        x = split_complex(
            (rng.standard_normal((2, n, n))
             + 1j * rng.standard_normal((2, n, n))).astype(np.complex64))
        for inverse in (False, True):
            got = fft2_shift_pair(x, inverse=inverse)
            want = fftshift2_pair(fft2_pair(fftshift2_pair(x),
                                            inverse=inverse))
            for i in (0, 1):
                np.testing.assert_allclose(
                    np.asarray(got[i]), np.asarray(want[i]), atol=1e-4)


def test_scatter_gather_inverse(par_params):
    """grid_to_subgrids(subgrids_to_grid(x)) recovers x for disjoint tiles
    (no FFT, coords on a disjoint lattice)."""
    n = par_params.subgrid_size
    g = par_params.grid_size
    s = (g // n) ** 2
    coords = np.stack(
        np.meshgrid(np.arange(0, g, n), np.arange(0, g, n), indexing="ij"), -1
    ).reshape(-1, 2)
    rng = np.random.default_rng(3)
    sub = rng.standard_normal((s, 4, n, n)).astype(np.float32)
    pair = (sub, -sub)
    grid = subgrids_to_grid(
        pair, coords[:, 1], coords[:, 0], g, apply_fft=False
    )
    back = grid_to_subgrids(
        grid, coords[:, 1], coords[:, 0], n, apply_fft=False
    )
    np.testing.assert_allclose(np.asarray(back[0]), sub, atol=1e-6)


def test_sharded_pallas_gridder_matches_single_device(mesh, par_params, par_obs):
    """The Pallas kernel (interpret mode on CPU) composes with shard_map:
    each shard reads its rows at the localized time offsets."""
    expected = run_gridder(par_params, par_obs, version="pallas_triton",
                           **CPU_PALLAS)
    sobs = split_observation(par_obs)
    sharded_sobs, _ = shard_observation(par_params, sobs, mesh)
    re, im = sharded_gridder(par_params, mesh, "pallas_triton",
                             kernel_kw=CPU_PALLAS)(sharded_sobs)
    got = combine_complex(np.asarray(re), np.asarray(im))
    assert check_error(got, expected, verbose=False).passed


def test_fft_grid_roundtrip_disjoint_tiles(par_params):
    """iFFT+scatter then gather+FFT reproduces subgrids on disjoint tiles."""
    n = par_params.subgrid_size
    g = par_params.grid_size
    s = (g // n) ** 2
    coords = np.stack(
        np.meshgrid(np.arange(0, g, n), np.arange(0, g, n), indexing="ij"), -1
    ).reshape(-1, 2)
    rng = np.random.default_rng(11)
    sub = rng.standard_normal((s, 4, n, n)).astype(np.float32)
    pair = (sub, 0.5 * sub)
    grid = subgrids_to_grid(pair, coords[:, 1], coords[:, 0], g, apply_fft=True)
    back = grid_to_subgrids(grid, coords[:, 1], coords[:, 0], n, apply_fft=True)
    np.testing.assert_allclose(np.asarray(back[0]), sub, atol=1e-4)
    np.testing.assert_allclose(np.asarray(back[1]), 0.5 * sub, atol=1e-4)


def test_grid_gather_wraps(small_params):
    """grid_to_subgrids at an overhanging coordinate reads the opposite
    edge (periodic), consistent with the scatter side."""
    import jax.numpy as jnp

    from idg_tpu.ops.grid import grid_to_subgrids

    g, n, p = 32, 8, 4
    grid = np.zeros((p, g, g), np.float32)
    grid[:, 0, 0] = 5.0   # top-left corner value
    pair = (jnp.asarray(grid), jnp.asarray(np.zeros_like(grid)))
    # tile starting near the bottom-right corner wraps onto (0, 0)
    sub = grid_to_subgrids(
        pair, jnp.asarray([g - 2]), jnp.asarray([g - 2]), n, apply_fft=False
    )
    got = np.asarray(sub[0])[0, 0]
    assert got[2, 2] == 5.0  # (g-2+2) % g == 0 on both axes


def _random_tiles(rng, s, p, n):
    return tuple(rng.normal(size=(s, p, n, n)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("apply_fft", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_add_extract_adjoint(apply_fft, seed):
    """<add(x), g> == <x, extract(g)> for the real inner product of the
    split pairs: extraction is the exact adjoint of the add, including
    wrapping tiles (the DFT is unitary up to its 1/N² scale, so with the
    FFT the extract side carries that factor)."""
    rng = np.random.default_rng(seed)
    s, p, n, g = 9, 4, 8, 32
    x = _random_tiles(rng, s, p, n)
    gr = tuple(rng.normal(size=(p, g, g)).astype(np.float32) for _ in range(2))
    cx = rng.integers(0, g, s).astype(np.int32)
    cy = rng.integers(0, g, s).astype(np.int32)
    ax = subgrids_to_grid(x, cx, cy, g, apply_fft=apply_fft)
    eg = grid_to_subgrids(gr, cx, cy, n, apply_fft=apply_fft)
    lhs = sum(float(np.vdot(np.asarray(a, np.float64), b))
              for a, b in zip(ax, gr))
    scale = 1.0 / (n * n) if apply_fft else 1.0
    # <ifft(x), y>_R == <x, fft(y)>_R / N² for the split real inner product
    rhs = scale * (float(np.vdot(np.asarray(x[0], np.float64),
                                 np.asarray(eg[0])))
                   + float(np.vdot(np.asarray(x[1], np.float64),
                                   np.asarray(eg[1]))))
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("corner", [(0, 0), (29, 3), (3, 29), (31, 31)])
def test_grid_add_wraps(corner):
    """A tile placed near an edge adds its overhang onto the opposite edge
    (periodic), and the add conserves the tile's mass."""
    g, n, p = 32, 8, 4
    cy, cx = corner
    tile = np.zeros((1, p, n, n), np.float32)
    tile[0, :, n - 1, n - 1] = 3.0          # the tile's last pixel
    grid = subgrids_to_grid((tile, tile), np.asarray([cx]), np.asarray([cy]),
                            g, apply_fft=False)
    got = np.asarray(grid[0])
    assert got[0, (cy + n - 1) % g, (cx + n - 1) % g] == 3.0
    assert float(got.sum()) == float(tile.sum())


@pytest.mark.parametrize("apply_fft", [False, True])
def test_grid_add_accumulates_into_existing_grid(apply_fft):
    """`grid_in` adds the tiles onto an existing grid (multi-pass
    accumulation): the result is the fresh add plus the old grid."""
    rng = np.random.default_rng(5)
    s, p, n, g = 7, 4, 16, 128
    sub = _random_tiles(rng, s, p, n)
    cx = rng.integers(0, g, s).astype(np.int32)
    cy = rng.integers(0, g, s).astype(np.int32)
    expected = subgrids_to_grid(sub, cx, cy, g, apply_fft=apply_fft)
    base = (np.full((p, g, g), 1.5, np.float32),
            np.full((p, g, g), -0.5, np.float32))
    got = subgrids_to_grid(sub, cx, cy, g, apply_fft=apply_fft, grid_in=base)
    np.testing.assert_allclose(np.asarray(got[0]),
                               np.asarray(expected[0]) + 1.5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(got[1]),
                               np.asarray(expected[1]) - 0.5, atol=2e-6)


def test_grid_add_matches_numpy_add_at(small_params):
    """The windowed scatter-add equals np.add.at over wrapped indices."""
    rng = np.random.default_rng(2)
    s, p, n, g = 11, 4, 8, 32
    sub = _random_tiles(rng, s, p, n)
    cx = rng.integers(0, g, s)
    cy = rng.integers(0, g, s)
    got = subgrids_to_grid(sub, cx.astype(np.int32), cy.astype(np.int32), g,
                           apply_fft=False)
    want = np.zeros((p, g, g), np.float64)
    iy = (cy[:, None] + np.arange(n)) % g          # [S, N]
    ix = (cx[:, None] + np.arange(n)) % g
    for i in range(s):
        np.add.at(want, (slice(None), iy[i][:, None], ix[i][None, :]),
                  sub[0][i])
    np.testing.assert_allclose(np.asarray(got[0]), want, atol=1e-5)


@pytest.mark.parametrize("grid_sharded", [False, True])
def test_flat_mesh_grid_reduction_matches_local(mesh, par_params, par_obs,
                                                grid_sharded):
    """The 8-device flat mesh reduces the grid with psum (replicated) or
    psum_scatter (row blocks); both equal the single-device add."""
    assert mesh.axis_names == ("data",) and mesh.devices.shape == (8,)
    sobs = split_observation(par_obs)
    kernel = get_kernel("gridder", "xla_v4").fn
    sub = jax.jit(kernel, static_argnums=0)(par_params, sobs)
    md = par_obs.metadata
    expected = subgrids_to_grid(sub, md.coord_x, md.coord_y,
                                par_params.grid_size)
    sharded_sobs, _ = shard_observation(par_params, sobs, mesh)
    got = sharded_gridder_to_grid(par_params, mesh, "xla_v4",
                                  grid_sharded=grid_sharded)(sharded_sobs)
    scale = float(np.abs(np.asarray(expected[0])).max())
    for i in (0, 1):
        np.testing.assert_allclose(np.asarray(got[i]) / scale,
                                   np.asarray(expected[i]) / scale, atol=1e-5)
