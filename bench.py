#!/usr/bin/env python
"""Headline benchmark: gridder, degridder and gridded-pipeline throughput
on one GPU.

Prints ONE JSON line naming the device and, per workload, the kernel that
was timed. The headline metric/value is the GRIDDER; the degridder (the
adjoint workload, the reference's second benchmarked executable) and the
gridded pipeline (gridder → subgrid iDFT → grid scatter-add) ride the same
line. Baseline anchors = the reference's published V100 numbers: CUDA
gridder_reference 42.93 MVis/s, degridder_reference 28.03 MVis/s
(BASELINE.md; res/{gridder,degridder}/Tesla_V100-*-cuda.csv).

Env knobs: BENCH_KERNEL / BENCH_DEGRIDDER_KERNEL (registry versions;
default pallas_triton), BENCH_W_RANK, NR_ITERATIONS / NR_WARM_UP_RUNS, and
the reference's problem-size vars (GRID_SIZE, NR_STATIONS, ...).

One named kernel per workload: any failure exits non-zero. A run that
finds no GPU exits non-zero before printing a number (IDG_ALLOW_CPU=1
lets the test suite drive it on the CPU).
"""

from __future__ import annotations

import json
import os
import sys

V100_GRIDDER_REFERENCE_MVIS_S = 42.93
# same visibility count (50.19 MVis) over the degridder_reference runtime
# (1790.51 ms, res/degridder/Tesla_V100-PCIE-32GB-degridder_reference-cuda.csv)
V100_DEGRIDDER_REFERENCE_MVIS_S = 28.03


def main() -> None:
    from idg_tpu.cli import _honor_platform_env, _kernel_kw, require_gpu

    _honor_platform_env()
    require_gpu()
    import jax

    from idg_tpu import HarnessConfig, IDGParams, make_perf_observation
    from idg_tpu.data import initialize_subgrids
    from idg_tpu.ops.api import _resolve, pipeline_parts, staged_runner
    from idg_tpu.utils.costs import workload_costs
    from idg_tpu.utils.timing import time_kernel

    params = IDGParams.from_env()
    harness = HarnessConfig(
        nr_warm_up_runs=int(os.environ.get("NR_WARM_UP_RUNS", 1)),
        nr_iterations=int(os.environ.get("NR_ITERATIONS", 3)),
    )
    w_rank = os.environ.get("BENCH_W_RANK")
    w_rank = int(w_rank) if w_rank else None
    obs = make_perf_observation(params)
    subgrids = initialize_subgrids(
        params.nr_subgrids, params.nr_correlations, params.subgrid_size)
    _, _, mvis = workload_costs(params)

    def rate(workload, version):
        version, rank = _resolve(workload, version, params, obs, w_rank)
        fn, args = staged_runner(workload, version, params, obs,
                                 subgrids if workload == "degridder" else None,
                                 w_rank=rank, **_kernel_kw(version))
        return version, mvis / time_kernel(fn, *args, harness=harness).seconds

    version, gridder = rate("gridder",
                            os.environ.get("BENCH_KERNEL", "pallas_triton"))
    deg_version, degridder = rate(
        "degridder", os.environ.get("BENCH_DEGRIDDER_KERNEL", "pallas_triton"))
    _, rank = _resolve("gridder", version, params, obs, w_rank)
    _, _, pass_fn, pargs = pipeline_parts("grid", params, obs, version, rank,
                                          **_kernel_kw(version))
    pipeline = mvis / time_kernel(pass_fn, *pargs, harness=harness).seconds

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"gridder_{version}_throughput",
        "value": round(gridder, 2),
        "unit": "MVis/s",
        "vs_baseline": round(gridder / V100_GRIDDER_REFERENCE_MVIS_S, 3),
        "degridder_metric": f"degridder_{deg_version}_throughput",
        "degridder_value": round(degridder, 2),
        "degridder_unit": "MVis/s",
        "degridder_vs_baseline": round(
            degridder / V100_DEGRIDDER_REFERENCE_MVIS_S, 3),
        "pipeline_metric": f"pipeline_{version}_throughput",
        "pipeline_value": round(pipeline, 2),
        "pipeline_unit": "MVis/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    sys.exit(main())
