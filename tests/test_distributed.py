"""Multi-host distribution layer: (host × device) meshes, reductions staged
within a host then across hosts, sharded-grid degridder gather, and a REAL multi-process run
(jax.distributed over Gloo on CPU) — the north-star scaling layer
(SURVEY.md §2.7), all new capability vs the single-GPU reference.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from idg_tpu import IDGParams, make_observation
from idg_tpu.ops.registry import get_kernel
from idg_tpu.parallel.distributed import make_hier_mesh
from idg_tpu.parallel.sharded import (
    shard_observation,
    sharded_grid_to_degridder,
    sharded_grid_to_degridder_gather,
    sharded_gridder,
    sharded_gridder_to_grid,
)
from idg_tpu.types import split_complex, split_observation
from idg_tpu.utils.compare import check_error


@pytest.fixture(scope="module")
def hier_mesh():
    assert len(jax.devices()) == 8
    return make_hier_mesh(devices_per_host=2)  # 4 "hosts" x 2 devices


@pytest.fixture(scope="module")
def par_params():
    return IDGParams(
        grid_size=128,
        subgrid_size=16,
        nr_stations=5,
        nr_timeslots=4,   # 40 subgrids
        nr_timesteps_subgrid=16,
        nr_channels=8,
    )


@pytest.fixture(scope="module")
def par_obs(par_params):
    obs, _ = make_observation(par_params)
    return obs


@pytest.fixture(scope="module")
def local_reference(par_params, par_obs):
    """Single-device kernel output on the same inputs."""
    sobs = split_observation(par_obs)
    kernel = get_kernel("gridder", "xla_v2").fn
    re, im = jax.jit(kernel, static_argnums=0)(par_params, sobs)
    return np.asarray(re), np.asarray(im)


def test_hier_mesh_shape(hier_mesh):
    assert hier_mesh.axis_names == ("host", "device")
    assert hier_mesh.devices.shape == (4, 2)


def test_sharded_gridder_hier_mesh(par_params, par_obs, hier_mesh, local_reference):
    sobs, _ = shard_observation(par_params, split_observation(par_obs), hier_mesh)
    fn = sharded_gridder(par_params, hier_mesh, "xla_v2")
    re, im = fn(sobs)
    got = np.asarray(re) + 1j * np.asarray(im)
    want = local_reference[0] + 1j * local_reference[1]
    assert check_error(got, want, verbose=False).passed


@pytest.fixture(scope="module")
def replicated_grid(par_params, par_obs, hier_mesh):
    sobs, _ = shard_observation(par_params, split_observation(par_obs), hier_mesh)
    fn = sharded_gridder_to_grid(par_params, hier_mesh, "xla_v2")
    re, im = fn(sobs)
    return np.asarray(re), np.asarray(im)


def test_hierarchical_grid_psum(par_params, par_obs, hier_mesh, replicated_grid,
                                local_reference):
    """Staged host-local then cross-host reduction == local scatter-add of
    all subgrids."""
    from idg_tpu.ops.grid import subgrids_to_grid

    md = par_obs.metadata
    local = subgrids_to_grid(
        local_reference, md.coord_x, md.coord_y, par_params.grid_size
    )
    np.testing.assert_allclose(replicated_grid[0], np.asarray(local[0]), atol=2e-4)
    np.testing.assert_allclose(replicated_grid[1], np.asarray(local[1]), atol=2e-4)


def test_grid_sharded_psum_scatter_hier(par_params, par_obs, hier_mesh,
                                        replicated_grid):
    """Row-sharded (psum_scatter over device + psum over host) blocks
    reassemble into the replicated grid."""
    sobs, _ = shard_observation(par_params, split_observation(par_obs), hier_mesh)
    fn = sharded_gridder_to_grid(
        par_params, hier_mesh, "xla_v2", grid_sharded=True
    )
    re, im = fn(sobs)
    np.testing.assert_allclose(np.asarray(re), replicated_grid[0], atol=2e-4)
    np.testing.assert_allclose(np.asarray(im), replicated_grid[1], atol=2e-4)


def test_sharded_grid_degridder_gather(par_params, par_obs, hier_mesh,
                                       replicated_grid):
    """all_gather forward path on a row-sharded grid == replicated-grid path."""
    sobs, _ = shard_observation(par_params, split_observation(par_obs), hier_mesh)
    grid_fn = sharded_gridder_to_grid(
        par_params, hier_mesh, "xla_v2", grid_sharded=True
    )
    sharded_grid = grid_fn(sobs)

    fwd_sharded = sharded_grid_to_degridder_gather(par_params, hier_mesh, "xla_v2")
    vis_s = fwd_sharded(sobs, sharded_grid)

    fwd_repl = sharded_grid_to_degridder(par_params, hier_mesh, "xla_v2")
    grid_repl = tuple(jax.device_put(g) for g in replicated_grid)
    vis_r = fwd_repl(sobs, grid_repl)

    got = np.asarray(vis_s[0]) + 1j * np.asarray(vis_s[1])
    want = np.asarray(vis_r[0]) + 1j * np.asarray(vis_r[1])
    assert check_error(got, want, verbose=False).passed


def test_multiprocess_pipeline(tmp_path):
    """Two REAL processes (one per fake host), jax.distributed + Gloo
    collectives, hierarchical mesh, distribute_observation — both must
    produce the same replicated grid as a single-process run."""
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
    port = "29517"
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_NUM_PROCESSES",
                     "JAX_PROCESS_ID", "JAX_COORDINATOR_ADDRESS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", port, str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        logs.append(out.decode())
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    g0 = np.load(tmp_path / "grid_0.npy")
    g1 = np.load(tmp_path / "grid_1.npy")
    np.testing.assert_allclose(g0, g1, atol=1e-6)

    # single-process reference on the same problem (4-device global mesh
    # here vs 2x2 there — same math, same reduction result)
    params = IDGParams(
        grid_size=64, subgrid_size=16, nr_stations=5, nr_timeslots=4,
        nr_timesteps_subgrid=16, nr_channels=8,
    )
    obs, _ = make_observation(params)
    mesh = make_hier_mesh(devices_per_host=2)
    sobs, _ = shard_observation(params, split_observation(obs), mesh)
    fn = sharded_gridder_to_grid(params, mesh, "xla_v2")
    re, im = fn(sobs)
    ref = np.stack([np.asarray(re), np.asarray(im)])
    np.testing.assert_allclose(g0, ref, atol=2e-4)
