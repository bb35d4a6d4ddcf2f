"""Multi-process worker for test_distributed.py::test_multiprocess_pipeline.

Each process (one per fake "host") initializes jax.distributed against a
shared coordinator, builds the hierarchical (host × device) mesh over the
global CPU devices, runs the sharded gridder→grid pipeline, and writes its
(replicated) grid result to a per-process .npy for the parent to compare.

Usage: python _mp_worker.py <process_id> <num_processes> <port> <outdir>
"""

import os
import sys

# Run from any cwd and without an installed package: the repo root is one
# level up from this file (python puts the script dir, not the repo, on
# sys.path).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
outdir = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from idg_tpu import IDGParams, make_observation  # noqa: E402
from idg_tpu.parallel import distributed as dist  # noqa: E402
from idg_tpu.parallel.sharded import sharded_gridder_to_grid  # noqa: E402
from idg_tpu.types import split_observation  # noqa: E402

dist.init_distributed(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
)
assert jax.process_count() == nproc
assert jax.device_count() == nproc * 2

mesh = dist.make_hier_mesh()  # (nproc hosts) x (2 devices)
params = IDGParams(
    grid_size=64,
    subgrid_size=16,
    nr_stations=5,   # 10 baselines
    nr_timeslots=4,  # 40 subgrids
    nr_timesteps_subgrid=16,
    nr_channels=8,
)
obs, _ = make_observation(params)
sobs, _ = dist.distribute_observation(params, split_observation(obs), mesh)

fn = sharded_gridder_to_grid(params, mesh, "xla_v2")
grid_re, grid_im = fn(sobs)

import numpy as np  # noqa: E402

# the psum-replicated grid is fully addressable on every process
np.save(
    os.path.join(outdir, f"grid_{pid}.npy"),
    np.stack([np.asarray(grid_re), np.asarray(grid_im)]),
)
print(f"worker {pid} done", flush=True)
