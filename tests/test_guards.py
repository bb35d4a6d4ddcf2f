"""API-boundary correctness guards and the nonzero-w path.

Covers:
- non-uniform channel spacing: recurrence kernels (reference v8's silent
  assumption, gridder_v8.cu:135-186) must NOT silently return wrong results
  through the public API — they fall back to a non-recurrence rung;
- w-term Taylor rank: auto-escalation when the observation's |μ·n| bound
  exceeds the tolerance, for the XLA separable kernel and the Pallas
  kernel alike;
- nonzero-w generator (make_w_observation) end-to-end against the golden
  oracle, including w_step ≠ 0 / coord_z ≠ 0 (the reference's w machinery,
  init.cpp:182-199, gridder_reference.cpp:32-39).

The Pallas kernel runs in interpret mode with full-f32 dots here (CPU).
"""

import dataclasses
import warnings

import numpy as np
import pytest
from jax import lax

from idg_tpu import make_w_observation
from idg_tpu.models.reference import degridder_reference, gridder_reference
from idg_tpu.data import initialize_subgrids
from idg_tpu.ops.api import (
    _resolve,
    max_mu_n,
    required_w_rank,
    run_degridder,
    run_gridder,
)
from idg_tpu.ops.registry import get_kernel
from idg_tpu.types import Observation
from idg_tpu.utils.compare import check_error

CPU_PALLAS = {"interpret": True, "precision": lax.Precision.HIGHEST}


def _kw(version):
    return CPU_PALLAS if version.startswith("pallas") else {}


def _with_nonuniform_channels(obs: Observation) -> Observation:
    k = np.array(obs.wavenumbers, copy=True)
    k[-1] *= 1.05  # break uniform spacing in the last channel
    return dataclasses.replace(obs, wavenumbers=k)


# --------------------------------------------------------------------------
# non-uniform channel spacing
# --------------------------------------------------------------------------

def test_recurrence_kernels_marked():
    for workload, version in [("gridder", "xla_v3"), ("degridder", "xla_v3")]:
        e = get_kernel(workload, version)
        assert e.uniform_channels, (workload, version)
        assert e.fallback is not None, (workload, version)
        assert not get_kernel(workload, e.fallback).uniform_channels


def test_nonuniform_channels_recurrence_is_wrong_raw(small_params, small_obs):
    """Documents the hazard the guard exists for: the raw recurrence kernel
    (bypassing the API) exceeds the gate on non-uniform wavenumbers."""
    from idg_tpu.ops.api import _jitted
    from idg_tpu.types import split_observation, combine_complex

    obs = _with_nonuniform_channels(small_obs)
    golden = gridder_reference(small_params, obs)
    fn = _jitted("gridder", "xla_v3")
    re, im = fn(small_params, split_observation(obs))
    raw = combine_complex(np.asarray(re), np.asarray(im))
    assert not check_error(raw, golden, verbose=False).passed


@pytest.mark.parametrize("version", ["xla_v3"])
def test_gridder_nonuniform_channels_falls_back(version, small_params, small_obs):
    obs = _with_nonuniform_channels(small_obs)
    golden = gridder_reference(small_params, obs)
    with pytest.warns(UserWarning, match="uniform channel spacing"):
        got = run_gridder(small_params, obs, version=version)
    result = check_error(got, golden, verbose=False)
    assert result.passed, f"{version}: error {result.mean_error}"


@pytest.mark.parametrize("version", ["xla_v3"])
def test_degridder_nonuniform_channels_falls_back(version, small_params, small_obs):
    obs = _with_nonuniform_channels(small_obs)
    sub = initialize_subgrids(
        small_params.nr_subgrids, small_params.nr_correlations,
        small_params.subgrid_size,
    )
    golden = degridder_reference(small_params, obs, sub)
    with pytest.warns(UserWarning, match="uniform channel spacing"):
        got = run_degridder(small_params, obs, sub, version=version)
    result = check_error(got, golden, verbose=False)
    assert result.passed, f"{version}: error {result.mean_error}"


# --------------------------------------------------------------------------
# w-rank guard
# --------------------------------------------------------------------------

def _stress_w_obs(params, obs, w_value):
    """Constant large w with NO compensating w plane (coord_z = 0): μ = −w·k."""
    uvw = np.array(obs.uvw, copy=True)
    uvw[:, :, 2] = w_value
    return dataclasses.replace(obs, uvw=uvw)


def test_required_w_rank_zero_w(small_params, small_obs):
    assert max_mu_n(small_params, small_obs) == 0.0
    assert required_w_rank(small_params, small_obs) == 1


@pytest.mark.parametrize("version", ["xla_v4", "pallas_triton"])
def test_w_rank_escalates(version, small_params, small_obs):
    # w=600 -> |mu·n| bound ~0.049: rank 2 insufficient, rank 4 suffices
    obs = _stress_w_obs(small_params, small_obs, 600.0)
    need = required_w_rank(small_params, obs)
    assert need is not None and need > 2
    resolved, w_rank = _resolve("gridder", version, small_params, obs)
    assert resolved == version and w_rank == need


@pytest.mark.parametrize("version", ["xla_v4", "pallas_triton"])
def test_w_rank_escalation_correct(version, small_params, small_obs):
    obs = _stress_w_obs(small_params, small_obs, 600.0)
    golden = gridder_reference(small_params, obs)
    # guard escalates the rank automatically -> inside the gate
    got = run_gridder(small_params, obs, version=version, **_kw(version))
    assert check_error(got, golden, verbose=False).passed
    # a too-low rank (explicit override) warns and misses
    with pytest.warns(UserWarning, match="below the required rank"):
        got2 = run_gridder(small_params, obs, version=version, w_rank=2,
                           **_kw(version))
    assert not check_error(got2, golden, verbose=False).passed


@pytest.mark.parametrize("version", ["xla_v4", "pallas_triton"])
def test_w_rank_default_kept_on_zero_w(version, small_params, small_obs):
    """w = 0 data needs rank 1: the guard keeps the kernel's own default
    (rank 1 for both)."""
    assert _resolve("gridder", version, small_params, small_obs) == (
        version, None)


@pytest.mark.parametrize("version", ["xla_v4", "pallas_triton"])
def test_w_rank_impractical_raises(version, small_params, small_obs):
    obs = _stress_w_obs(small_params, small_obs, 2.0e4)
    assert required_w_rank(small_params, obs) is None
    with pytest.raises(ValueError, match="direct full-phase kernel \\(xla_v2\\)"):
        run_gridder(small_params, obs, version=version, **_kw(version))


def test_direct_kernels_exact_for_extreme_w(small_params, small_obs):
    """Full-phase kernels have no Taylor: exact at any w (no guard engages)."""
    obs = _stress_w_obs(small_params, small_obs, 2.0e4)
    golden = gridder_reference(small_params, obs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = run_gridder(small_params, obs, version="xla_v2")
    assert check_error(got, golden, verbose=False).passed


# --------------------------------------------------------------------------
# nonzero-w generator end-to-end (w_step != 0, coord_z != 0)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def w_problem(small_params):
    params, obs, sub = make_w_observation(
        small_params, include_subgrids=True
    )
    return params, obs, sub


def test_make_w_observation_properties(w_problem, small_params, small_obs):
    params, obs, _ = w_problem
    assert params.w_step != 0.0
    assert np.any(np.asarray(obs.uvw)[:, :, 2] != 0.0)
    assert np.any(np.asarray(obs.metadata.coord_z) != 0)
    # the u/v draws and metadata coords stay draw-for-draw identical
    np.testing.assert_array_equal(
        np.asarray(obs.uvw)[..., :2], np.asarray(small_obs.uvw)[..., :2]
    )
    np.testing.assert_array_equal(
        np.asarray(obs.metadata.coord_x), np.asarray(small_obs.metadata.coord_x)
    )
    # the w-plane partition keeps the Taylor argument small
    assert required_w_rank(params, obs) <= 3


@pytest.mark.parametrize(
    "version", ["xla_reference", "xla_v2", "xla_v4", "pallas_triton"],
)
def test_gridder_nonzero_w(version, w_problem):
    params, obs, _ = w_problem
    golden = gridder_reference(params, obs)
    got = run_gridder(params, obs, version=version, **_kw(version))
    result = check_error(got, golden, verbose=False)
    assert result.passed, f"{version}: error {result.mean_error}"


@pytest.mark.parametrize(
    "version", ["xla_reference", "xla_v2", "xla_v4", "pallas_triton"],
)
def test_degridder_nonzero_w(version, w_problem):
    params, obs, sub = w_problem
    golden = degridder_reference(params, obs, sub)
    got = run_degridder(params, obs, sub, version=version, **_kw(version))
    result = check_error(got, golden, verbose=False)
    assert result.passed, f"{version}: error {result.mean_error}"
