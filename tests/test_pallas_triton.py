"""The Pallas (Triton route) gridder and degridder in interpret mode.

On the CPU the kernels run with `interpret=True` and full-f32 dots
(`precision=HIGHEST`); the card's TF32x3 preset has no CPU lowering. Each
case compares against the f64 oracle (models/reference.py) at the
reference's 1e-5 normalised-RMS gate.
"""

import dataclasses
import inspect
import warnings

import numpy as np
import pytest
from jax import lax

from idg_tpu import IDGParams, make_observation, make_w_observation
from idg_tpu.models.reference import degridder_reference, gridder_reference
from idg_tpu.ops.api import _resolve, run_degridder, run_gridder
from idg_tpu.ops.pallas import common
from idg_tpu.ops.pallas.degridder import degridder_pallas_triton
from idg_tpu.ops.pallas.gridder import gridder_pallas_triton
from idg_tpu.ops.registry import get_kernel
from idg_tpu.types import Metadata
from idg_tpu.utils.compare import check_error

CPU = {"interpret": True, "precision": lax.Precision.HIGHEST}


def _params(n=16, t=16, c=8, stations=3, timeslots=2):
    return IDGParams(grid_size=128, subgrid_size=n, nr_stations=stations,
                     nr_timeslots=timeslots, nr_timesteps_subgrid=t,
                     nr_channels=c)


def _problem(params, seed=0):
    return make_observation(params, seed=seed, include_subgrids=True)


def _distinct_slots(obs, params):
    """Every subgrid reads its own a-term slot (aterm_index = timeslot),
    on top of the distinct station pairs the baselines already give."""
    md = obs.metadata
    slots = (np.arange(params.nr_subgrids) % params.nr_timeslots).astype(np.int32)
    return dataclasses.replace(
        obs, metadata=dataclasses.replace(md, aterm_index=slots))


def _nonuniform(obs):
    k = np.array(obs.wavenumbers, copy=True)
    k[-1] *= 1.05
    return dataclasses.replace(obs, wavenumbers=k)


def _grid_err(params, obs, **kw):
    got = run_gridder(params, obs, version="pallas_triton", **CPU, **kw)
    return check_error(got, gridder_reference(params, obs), verbose=False)


def _degrid_err(params, obs, sub, **kw):
    got = run_degridder(params, obs, sub, version="pallas_triton", **CPU, **kw)
    return check_error(got, degridder_reference(params, obs, sub),
                       verbose=False)


# ---- oracle parity over shapes, ranks and tails ---------------------------

@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("w_rank", [1, 2])
@pytest.mark.parametrize("t", [16, 21])
def test_gridder_matches_oracle(n, w_rank, t):
    """T = 21 is not a multiple of the 2-timestep tile (16 visibilities at
    C = 8): the last tile's rows past the subgrid read as zero."""
    params = _params(n=n, t=t)
    obs, _ = _problem(params)
    res = _grid_err(params, obs, w_rank=w_rank)
    assert res.passed, res.mean_error


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("w_rank", [1, 2])
@pytest.mark.parametrize("t", [16, 21])
def test_degridder_matches_oracle(n, w_rank, t):
    """T = 21 is not a multiple of the 8-timestep tile (64 visibilities at
    C = 8): the padded tail timesteps are computed and sliced away."""
    params = _params(n=n, t=t)
    obs, sub = _problem(params)
    res = _degrid_err(params, obs, sub, w_rank=w_rank)
    assert res.passed, res.mean_error


@pytest.mark.parametrize("c", [4, 16])
def test_gridder_channel_counts(c):
    params = _params(c=c)
    obs, _ = _problem(params)
    assert _grid_err(params, obs).passed


@pytest.mark.parametrize("c", [4, 16])
def test_degridder_channel_counts(c):
    params = _params(c=c)
    obs, sub = _problem(params)
    assert _degrid_err(params, obs, sub).passed


def test_gridder_distinct_stations_and_slots():
    params = _params(stations=4, timeslots=3)
    obs, _ = _problem(params)
    obs = _distinct_slots(obs, params)
    assert len(set(np.asarray(obs.metadata.aterm_index))) == 3
    assert len(set(np.asarray(obs.metadata.station1))) > 1
    assert _grid_err(params, obs).passed


def test_degridder_distinct_stations_and_slots():
    params = _params(stations=4, timeslots=3)
    obs, sub = _problem(params)
    obs = _distinct_slots(obs, params)
    assert _degrid_err(params, obs, sub).passed


def test_gridder_noncanonical_time_offsets():
    """Reversed subgrid order: each program reads its rows at its own
    time_offset, not at s·T."""
    params = _params()
    obs, _ = _problem(params)
    md = obs.metadata
    rev = Metadata(**{f.name: np.asarray(getattr(md, f.name))[::-1].copy()
                      for f in dataclasses.fields(md)})
    obs = dataclasses.replace(obs, metadata=rev)
    assert _grid_err(params, obs).passed


# ---- the API guard --------------------------------------------------------

@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_nonuniform_channels_pass_the_guard(workload):
    """Channels fold into uvw (no recurrence), so non-uniform wavenumbers
    need no fallback: the guard passes the kernel through unwarned and the
    result stays inside the gate."""
    params = _params()
    obs, sub = _problem(params)
    obs = _nonuniform(obs)
    assert not get_kernel(workload, "pallas_triton").uniform_channels
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _resolve(workload, "pallas_triton", params, obs) == (
            "pallas_triton", None)
        res = (_grid_err(params, obs) if workload == "gridder"
               else _degrid_err(params, obs, sub))
    assert res.passed, res.mean_error


@pytest.fixture(scope="module")
def w_problem():
    return make_w_observation(_params(), include_subgrids=True)


@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_guard_raises_rank_on_nonzero_w(workload, w_problem):
    """Rank 1 (the kernel default, exact for w = 0) is short on w ≠ 0
    data; the guard raises it and the result meets the gate."""
    params, obs, sub = w_problem
    version, rank = _resolve(workload, "pallas_triton", params, obs)
    assert version == "pallas_triton" and rank is not None and rank > 1
    res = (_grid_err(params, obs) if workload == "gridder"
           else _degrid_err(params, obs, sub))
    assert res.passed, res.mean_error


def test_rank_one_misses_the_gate_on_nonzero_w(w_problem):
    """Documents what the guard is for: forcing rank 1 on w ≠ 0 data warns
    and misses the gate."""
    params, obs, _ = w_problem
    with pytest.warns(UserWarning, match="below the required rank"):
        res = _grid_err(params, obs, w_rank=1)
    assert not res.passed


# ---- wrapper: shapes, tiles, defaults -------------------------------------

@pytest.mark.parametrize("kwargs, match", [
    (dict(subgrid_size=12), "power-of-two subgrid size"),
    (dict(subgrid_size=8), "power-of-two subgrid size"),
    (dict(nr_channels=3), "power-of-two channel count"),
    (dict(nr_channels=24), "power-of-two channel count"),
    (dict(nr_correlations=2), "4 correlations"),
])
def test_check_shapes_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        common.check_shapes(dataclasses.replace(_params(), **kwargs))


@pytest.mark.parametrize("c, tile_t", [(1, 64), (4, 16), (8, 8), (16, 4),
                                       (64, 1), (128, 1)])
def test_tile_covers_tile_v_visibilities(c, tile_t):
    """A tile is tile_v visibilities, or one timestep of all channels."""
    params = _params(c=c)
    assert common.tile_timesteps(params, 64) == tile_t
    assert tile_t * c == max(64, c)


def test_kernel_tiles():
    from idg_tpu.ops.pallas import degridder, gridder

    assert gridder.TILE_V == 16 and degridder.TILE_V == 64
    assert gridder.NUM_WARPS == degridder.NUM_WARPS == 4
    assert common.tile_timesteps(_params(c=16), gridder.TILE_V) == 1


@pytest.mark.parametrize("fn", [gridder_pallas_triton,
                                degridder_pallas_triton])
def test_kernel_defaults(fn):
    """The card's defaults: TF32x3 dots, rank 1, compiled (not
    interpreted). The kernel never picks these from the platform."""
    sig = inspect.signature(fn).parameters
    assert sig["precision"].default is lax.DotAlgorithmPreset.TF32_TF32_F32_X3
    assert sig["w_rank"].default == 1
    assert sig["interpret"].default is False


def test_output_shapes_and_dtypes():
    from idg_tpu.types import split_complex, split_observation

    params = _params(t=21)
    obs, sub = _problem(params)
    sobs = split_observation(obs)
    g = gridder_pallas_triton(params, sobs, **CPU)
    d = degridder_pallas_triton(params, sobs, split_complex(sub), **CPU)
    s, p, n = params.nr_subgrids, params.nr_correlations, params.subgrid_size
    assert [x.shape for x in g] == [(s, p, n, n)] * 2
    assert [x.shape for x in d] == [(s, 21, params.nr_channels, p)] * 2
    assert all(x.dtype == np.float32 for x in (*g, *d))


def test_subgrid_tables():
    from idg_tpu.ops.common import phase_offset_parts

    params = _params()
    obs, _ = _problem(params)
    md = obs.metadata
    meta, pos = common.subgrid_tables(params, md)
    assert meta.shape == (params.nr_subgrids, 4) and meta.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(meta[:, 0]), md.time_offset)
    np.testing.assert_array_equal(np.asarray(meta[:, 2]), md.station1)
    po_x, po_y = phase_offset_parts(params, md)
    np.testing.assert_array_equal(np.asarray(pos[:, 0]), np.asarray(po_x))
    np.testing.assert_array_equal(np.asarray(pos[:, 1]), np.asarray(po_y))
    assert not np.any(np.asarray(pos[:, 2]))       # w_step = 0: no w plane


def test_jones_helpers_match_complexpair():
    """The kernels' list-form 2×2 Jones algebra equals ops/complexpair."""
    from idg_tpu.ops.complexpair import apply_aterm_gridder

    rng = np.random.default_rng(3)
    a1, a2, px = (tuple(rng.normal(size=(5, 4)) for _ in range(2))
                  for _ in range(3))
    want = apply_aterm_gridder(px, a1, a2)
    lst = [[(x[0][:, q], x[1][:, q]) for q in range(4)] for x in (a1, a2, px)]
    got = common.jones_mul(common.jones_mul(common.jones_herm(lst[0]),
                                            lst[2]), lst[1])
    for q in range(4):
        np.testing.assert_allclose(got[q][0], np.asarray(want[0])[:, q],
                                   atol=1e-12)
        np.testing.assert_allclose(got[q][1], np.asarray(want[1])[:, q],
                                   atol=1e-12)
