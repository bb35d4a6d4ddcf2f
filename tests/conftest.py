"""Test environment: run everything on CPU with 8 virtual devices.

Multi-device sharding is tested on a virtual CPU mesh (the reference had no
multi-device capability to test at all); Pallas kernels run in interpret
mode on CPU. Env must be set before JAX initializes.

IDG_TEST_DEVICE=gpu leaves the platform alone for the tests marked `gpu`
(`IDG_TEST_DEVICE=gpu python -m pytest -m gpu tests/`; chip_smoke.py runs
them on the card). Whether a card is present is decided inside the `card`
fixture, never while modules are imported.
"""

import os

ON_CARD = os.environ.get("IDG_TEST_DEVICE") == "gpu"
if not ON_CARD:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from idg_tpu import IDGParams, make_observation  # noqa: E402


@pytest.fixture(scope="session")
def small_params() -> IDGParams:
    """Shrunken problem in the spirit of correctness mode, sized for fast
    CPU/interpret-mode runs."""
    return IDGParams(
        grid_size=128,
        subgrid_size=16,
        nr_stations=3,
        nr_timeslots=2,
        nr_timesteps_subgrid=16,
        nr_channels=8,
    )


@pytest.fixture(scope="session")
def small_obs(small_params):
    obs, _ = make_observation(small_params)
    return obs


@pytest.fixture(scope="session")
def ref_params() -> IDGParams:
    """The reference's exact correctness-mode defaults
    (tests/gridder_common.cpp:54-64): 2 stations, 2 timeslots -> 2 subgrids,
    128 timesteps, 16 channels, 32x32 subgrids."""
    return IDGParams(
        grid_size=1024,
        subgrid_size=32,
        nr_stations=2,
        nr_timeslots=2,
        nr_timesteps_subgrid=128,
        nr_channels=16,
    )


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def card():
    """The GPU the `gpu`-marked tests run on; skips without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs the GPU (JAX device is {dev.platform}); run "
                    "IDG_TEST_DEVICE=gpu python -m pytest -m gpu tests/ "
                    "on the card")
    return dev
