"""Compiled Pallas kernels on the card (marker `gpu`; skip elsewhere).

The CPU tests run the same kernels in interpret mode with full-f32 dots;
these compile them for the GPU through Triton and run them with the card's
TF32x3 dots against the f64 oracle at the 1e-5 gate.
"""

import numpy as np
import pytest

from idg_tpu import IDGParams, make_observation, make_w_observation
from idg_tpu.models.reference import degridder_reference, gridder_reference
from idg_tpu.ops.api import run_degridder, run_gridder
from idg_tpu.utils.compare import check_error

pytestmark = pytest.mark.gpu

PARAMS = IDGParams(grid_size=1024, subgrid_size=32, nr_stations=4,
                   nr_timeslots=2, nr_timesteps_subgrid=128, nr_channels=16)


@pytest.mark.parametrize("w_obs", [False, True])
def test_gridder_on_card(card, w_obs):
    if w_obs:
        params, obs, _ = make_w_observation(PARAMS)
    else:
        params, (obs, _) = PARAMS, make_observation(PARAMS)
    got = run_gridder(params, obs, version="pallas_triton")
    res = check_error(got, gridder_reference(params, obs), verbose=False)
    assert res.passed, res.mean_error


@pytest.mark.parametrize("w_obs", [False, True])
def test_degridder_on_card(card, w_obs):
    if w_obs:
        params, obs, sub = make_w_observation(PARAMS, include_subgrids=True)
    else:
        params = PARAMS
        obs, sub = make_observation(PARAMS, include_subgrids=True)
    got = run_degridder(params, obs, sub, version="pallas_triton")
    res = check_error(got, degridder_reference(params, obs, sub),
                      verbose=False)
    assert res.passed, res.mean_error


def test_kernels_agree_with_xla_on_card(card):
    obs, _ = make_observation(PARAMS)
    a = run_gridder(PARAMS, obs, version="pallas_triton")
    b = run_gridder(PARAMS, obs, version="xla_v4")
    assert np.all(np.isfinite(a))
    assert check_error(a, b, verbose=False).passed
