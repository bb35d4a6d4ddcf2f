"""idg-bench CLI: the analogue of the reference's per-kernel executables.

The reference builds one executable per kernel (tests/CMakeLists.txt:4-38);
each runs performance mode with no args or correctness mode with `-c`
(tests/gridder_common.cpp:126-140). Here one CLI selects workload/version/
mode, honors the same env vars, and adds sweep / grid / pipeline / scaling
commands (replacing scripts/run_perf_cuda.sh and extending to several cards).

  python -m idg_tpu run --workload gridder --version pallas_triton --mode perf
  python -m idg_tpu run --workload degridder --version xla_v2 --mode check
  python -m idg_tpu pipeline --direction degrid
  python -m idg_tpu sweep --mode perf
  python -m idg_tpu list

Perf modes time the GPU and refuse any other device (require_gpu).
"""

from __future__ import annotations

import argparse
import os
import sys

DEFAULT_VERSION = "pallas_triton"


def _honor_platform_env() -> None:
    """Enable the persistent compilation cache (config.setup_compilation_
    cache) and make JAX_PLATFORMS effective through jax.config."""
    from .config import setup_compilation_cache

    setup_compilation_cache()
    plat = os.environ.get("JAX_PLATFORMS")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)


def require_gpu() -> None:
    """Measurement paths time the card, never a fallback device. The test
    suite sets IDG_ALLOW_CPU=1 to drive them on the CPU; every output still
    names the device it ran on."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not os.environ.get("IDG_ALLOW_CPU"):
        raise SystemExit(
            f"no GPU found (JAX device: {dev.platform} {dev.device_kind}); "
            "perf modes measure the card only")


def _kernel_kw(version: str) -> dict:
    """Off the card the Pallas kernels run in interpret mode with full-f32
    dots (IDG_ALLOW_CPU runs and check mode on a CPU)."""
    import jax
    from jax import lax

    if version.startswith("pallas") and jax.devices()[0].platform != "gpu":
        return {"interpret": True, "precision": lax.Precision.HIGHEST}
    return {}


def _report(name, seconds, gflops, gbytes, mvis=0.0, seconds_std=None,
            extra=None, output_path=None, bound="fp32"):
    import jax

    from .utils.report import csv_extension, device_name, report, report_csv
    from .utils.roofline import roofline_fraction

    dev = device_name()
    roofline = None
    if jax.devices()[0].platform == "gpu" and gflops and gbytes:
        roofline = roofline_fraction(gflops / seconds, gflops, gbytes, dev,
                                     bound)
    report(name, seconds, gflops, gbytes, mvis, roofline=roofline,
           seconds_std=seconds_std, roofline_bound=bound)
    report_csv(name, dev, csv_extension(), seconds, gflops, gbytes, mvis,
               output_path=output_path, roofline=roofline,
               seconds_std=seconds_std, extra=extra, roofline_bound=bound)


def _dot_bound(version: str) -> str:
    """The rate a kernel's dots run at: TF32 tensor cores for the Pallas
    kernels (TF32x3), FP32 CUDA cores for XLA at precision HIGHEST."""
    return "tf32" if version.startswith("pallas") else "fp32"


def _perf_one(workload: str, version: str, mesh_size: int | None,
              w_rank: int | None = None, params=None,
              name_suffix: str = "", w_obs: bool = False,
              sustain_s: float | None = None) -> float:
    """Performance mode (p_run_gridder_ semantics, app/CUDA/util.cpp:172-249).

    Returns the min-of-windows seconds per launch (utils/timing.py).

    The version/w_rank are resolved through the API guards here, ONCE, so
    the report/CSV name always reflects the kernel actually timed: if the
    guards substitute a fallback (recurrence on non-uniform channels) the
    name carries the resolved version plus a ``_fb`` marker.
    """
    from .config import HarnessConfig, IDGParams
    from .data import initialize_subgrids, make_perf_observation
    from .ops.api import _resolve, staged_runner
    from .utils.costs import workload_costs
    from .utils.printing import print_device_info, print_parameters
    from .utils.timing import time_kernel

    require_gpu()
    if params is None:
        params = IDGParams.from_env()
    harness = HarnessConfig.from_env()
    print_device_info()

    if w_obs:
        # w-realistic benchmark data: nonzero w tracks + w-plane metadata
        # (make_w_observation), so the rank-2 w·n Taylor work is real work
        from .data import make_w_observation

        params, obs, _ = make_w_observation(params)
        name_suffix = name_suffix + "_wobs"
    else:
        obs = make_perf_observation(params)
    print_parameters(params)
    subgrids = None
    if workload == "degridder":
        subgrids = initialize_subgrids(
            params.nr_subgrids, params.nr_correlations, params.subgrid_size
        )

    # Resolve once, host-side, with the global observation in hand — this
    # also guards the mesh path, whose sharded_* builders are guard-free
    # benchmark internals (parallel/sharded.py).
    rversion, rw_rank = _resolve(workload, version, params, obs, w_rank)
    kw = _kernel_kw(rversion)

    if mesh_size:
        from .parallel import make_mesh
        from .parallel.distributed import distribute_subgrid_pair
        from .parallel.sharded import (
            shard_observation,
            sharded_degridder,
            sharded_gridder,
        )
        from .types import split_complex, split_observation

        mesh = make_mesh(mesh_size)
        sharded_sobs, s_pad = shard_observation(
            params, split_observation(obs), mesh)
        if workload == "gridder":
            fn = sharded_gridder(params, mesh, rversion, w_rank=rw_rank,
                                 kernel_kw=kw)
            args = (sharded_sobs,)
        else:
            # pad/shard the subgrid pair to the observation's padded row
            # count (shard_map needs matching, mesh-divisible axes)
            spair = distribute_subgrid_pair(
                split_complex(subgrids), mesh, s_pad)
            fn = sharded_degridder(params, mesh, rversion, w_rank=rw_rank,
                                   kernel_kw=kw)
            args = (sharded_sobs, spair)
    else:
        fn, args = staged_runner(
            workload, rversion, params, obs, subgrids, w_rank=rw_rank, **kw
        )

    timing = time_kernel(fn, *args, harness=harness)
    gflops, gbytes, mvis = workload_costs(params)
    fb = "_fb" if rversion != version else ""
    mtag = f"_mesh{mesh_size}" if mesh_size else ""
    name = f"{workload}_{rversion}{fb}{mtag}{name_suffix}"
    extra = None
    if sustain_s:
        # sustained-launch window (the reference's ~10 s energy-loop
        # semantics, app/CUDA/util.cpp:131-155, minus the power read):
        # the SUSTAINED per-launch time and the intra-window drift, a
        # clock check on the min-of-windows headline above.
        from .utils.timing import time_kernel_sustained

        sus = time_kernel_sustained(fn, *args, duration_s=sustain_s,
                                    harness=harness)
        print(f"    sustained {sus.window_seconds:.1f}s window: "
              f"{sus.seconds*1e3:.2f} ms/launch over {sus.launches} "
              f"launches (min-of-windows {timing.seconds*1e3:.2f} ms, "
              f"drift {sus.drift_pct:+.1f}%)")
        extra = {
            "sustained_ms": sus.seconds * 1e3,
            "sustain_launches": sus.launches,
            "sustain_window_s": sus.window_seconds,
            "sustain_drift_pct": sus.drift_pct,
        }
    _report(name, timing.seconds, gflops, gbytes, mvis,
            seconds_std=timing.seconds_std, extra=extra,
            output_path=harness.output_path, bound=_dot_bound(rversion))
    return timing.seconds


def _check_one(workload: str, version: str) -> bool:
    """Correctness mode (`-c` semantics, tests/gridder_common.cpp:43-124)."""
    from .config import IDGParams
    from .data import initialize_subgrids, make_observation
    from .models.reference import degridder_reference, gridder_reference
    from .ops.api import run_degridder, run_gridder
    from .utils.compare import compare_subgrids, compare_visibilities
    from .utils.printing import print_parameters

    params = IDGParams.correctness_defaults()
    print_parameters(params)
    obs, _ = make_observation(params)
    kw = _kernel_kw(version)
    if workload == "gridder":
        print(">>> Run gridder on host (golden reference)")
        golden = gridder_reference(params, obs)
        print(f">>> Run gridder on device ({version})")
        got = run_gridder(params, obs, version=version, **kw)
        result = compare_subgrids(golden, got)
    else:
        subgrids = initialize_subgrids(
            params.nr_subgrids, params.nr_correlations, params.subgrid_size
        )
        print(">>> Run degridder on host (golden reference)")
        golden = degridder_reference(params, obs, subgrids)
        print(f">>> Run degridder on device ({version})")
        got = run_degridder(params, obs, subgrids, version=version, **kw)
        result = compare_visibilities(golden, got)
    return result.passed


def cmd_run(args) -> int:
    if args.mode == "perf":
        _perf_one(args.workload, args.version, args.mesh, args.w_rank,
                  w_obs=args.w_obs, name_suffix=args.suffix,
                  sustain_s=args.sustain)
        return 0
    if args.mesh:
        print("warning: --mesh is a perf-mode option; check mode validates "
              "the single-device kernel (the sharded paths are validated "
              "by tests/test_parallel.py on a virtual mesh)")
    ok = _check_one(args.workload, args.version)
    return 0 if ok else 1


def cmd_sweep(args) -> int:
    """Run all (or selected) versions of the chosen workloads — the
    run_perf_{cuda,hip}.sh analogue. `--stations N` shrinks the problem for
    ladder comparisons; `--fullsize` runs the reference perf defaults
    (S=24,500) and suffixes the CSV names with ``_fullsize``."""
    from .config import IDGParams
    from .ops.registry import list_kernels

    params = None
    suffix = ""
    if args.fullsize:
        params = IDGParams.from_env()
        suffix = "_fullsize"
    elif args.stations:
        params = IDGParams.from_env(nr_stations=args.stations)

    failed = []
    for workload in args.workloads.split(","):
        versions = (
            [e.version for e in list_kernels(workload)]
            if args.versions == "all"
            else args.versions.split(",")
        )
        for version in versions:
            print(f"=== {workload} {version} ({args.mode}) ===", flush=True)
            if args.mode == "perf":
                _perf_one(workload, version, args.mesh, params=params,
                          name_suffix=suffix)
            elif not _check_one(workload, version):
                failed.append((workload, version))
    if failed:
        print("FAILED:", ", ".join(f"{w}/{v}" for w, v in failed))
        return 1
    return 0


def cmd_vadd(args) -> int:
    """Copy-bandwidth reference benchmark (res/vadd analogue)."""
    import jax

    from .config import HarnessConfig
    from .ops.vadd import make_vadd_inputs, vadd, vadd_gbytes
    from .utils.printing import print_device_info
    from .utils.timing import time_kernel

    require_gpu()
    print_device_info()
    harness = HarnessConfig.from_env()
    x, y = jax.device_put(make_vadd_inputs(args.n))
    timing = time_kernel(vadd, x, y, harness=harness)
    _report("vadd", timing.seconds, 0.0, vadd_gbytes(args.n),
            output_path=harness.output_path)
    return 0


def cmd_grid(args) -> int:
    """Grid-stage benchmark: batched subgrid (i)DFT + subgrid↔grid
    scatter-add/gather (ops/grid.py — the north-star extension stage; the
    reference stops at subgrids, README.md:78-80)."""
    import jax
    import numpy as np

    from .config import HarnessConfig, IDGParams
    from .data import initialize_subgrids, make_perf_observation
    from .ops.grid import grid_to_subgrids, subgrids_to_grid
    from .types import split_complex
    from .utils.costs import grid_costs
    from .utils.printing import print_device_info, print_parameters
    from .utils.timing import time_kernel

    require_gpu()
    params = IDGParams.from_env()
    harness = HarnessConfig.from_env()
    print_device_info()
    print_parameters(params)
    md = make_perf_observation(params).metadata
    cx, cy = jax.device_put((np.asarray(md.coord_x), np.asarray(md.coord_y)))
    g, n = params.grid_size, params.subgrid_size
    apply_fft = not args.no_fft

    if args.direction == "to-grid":
        data = jax.device_put(split_complex(initialize_subgrids(
            params.nr_subgrids, params.nr_correlations, n)))
        fn = jax.jit(lambda s, x, y: subgrids_to_grid(s, x, y, g, apply_fft))
        name = "grid_add"
    else:
        data = jax.device_put(tuple(
            np.zeros((params.nr_correlations, g, g), np.float32)
            for _ in range(2)))
        fn = jax.jit(lambda gr, x, y: grid_to_subgrids(gr, x, y, n, apply_fft))
        name = "grid_extract"
    timing = time_kernel(fn, data, cx, cy, harness=harness)
    gflops, gbytes, _ = grid_costs(params)
    _report(name + args.suffix, timing.seconds, gflops, gbytes,
            seconds_std=timing.seconds_std, output_path=harness.output_path)
    return 0


def cmd_pipeline(args) -> int:
    """Single-device end-to-end imaging pass. direction=grid: gridder
    kernel → subgrid iDFT → grid scatter-add; direction=degrid: grid
    gather → subgrid DFT → degridder kernel (ops.api.pipeline_parts).
    Reports the pass throughput and each stage's measured share."""
    from .config import HarnessConfig, IDGParams
    from .data import make_perf_observation
    from .ops.api import _resolve, pipeline_parts
    from .utils.costs import grid_costs, workload_costs
    from .utils.printing import print_device_info, print_parameters
    from .utils.timing import time_kernel

    require_gpu()
    params = IDGParams.from_env()
    harness = HarnessConfig.from_env()
    print_device_info()
    print_parameters(params)
    obs = make_perf_observation(params)
    degrid = args.direction == "degrid"
    kname = "degridder" if degrid else "gridder"
    version, w_rank = _resolve(kname, args.version, params, obs, args.w_rank)
    kernel_fn, grid_fn, pass_fn, pargs = pipeline_parts(
        args.direction, params, obs, version, w_rank, **_kernel_kw(version))

    timing = time_kernel(pass_fn, *pargs, harness=harness)
    if degrid:
        t_grid = min(time_kernel(grid_fn, *pargs, harness=harness).seconds,
                     timing.seconds)
        t_kernel = timing.seconds - t_grid
    else:
        t_kernel = min(time_kernel(kernel_fn, *pargs, harness=harness).seconds,
                       timing.seconds)
        t_grid = timing.seconds - t_kernel
    gflops, gbytes, mvis = workload_costs(params)
    ggflops, ggbytes, _ = grid_costs(params)
    name = f"pipeline_{'degrid_' if degrid else ''}{version}{args.suffix}"
    print(f"    stage split: {kname} {t_kernel*1e3:.1f} ms "
          f"({100*t_kernel/timing.seconds:.0f}%), grid stage "
          f"{t_grid*1e3:.1f} ms ({100*t_grid/timing.seconds:.0f}%)")
    _report(name, timing.seconds, gflops + ggflops, gbytes + ggbytes, mvis,
            seconds_std=timing.seconds_std, output_path=harness.output_path,
            extra={"grid_stage_ms": t_grid * 1e3,
                   "grid_stage_pct": 100 * t_grid / timing.seconds},
            bound=_dot_bound(version))
    return 0


def cmd_list(args) -> int:
    from .ops.registry import list_kernels

    for entry in list_kernels():
        print(f"{entry.workload:>10s}  {entry.version:<16s} [{entry.family}]  {entry.description}")
    return 0


def cmd_info(args) -> int:
    from .utils.printing import print_device_info

    print_device_info()
    return 0


def cmd_scaling(args) -> int:
    """Strong-scaling report over mesh sizes (new vs the reference; the
    BASELINE.json north-star scaling-efficiency measurement): the GLOBAL
    problem size is fixed while the mesh grows, so the efficiency column
    is speedup/n_dev relative to the smallest measured mesh (100% =
    linear speedup at fixed total work).

    Workloads: gridder / degridder (subgrid-batch data parallelism, no
    collectives), pipeline (gridder → subgrid iDFT → grid reduction,
    replicated via psum or row-sharded via psum_scatter with
    --grid-sharded), and pipeline-degrid (grid → tile gather + DFT →
    degridder; --grid-sharded keeps the grid row-sharded and all_gathers
    it — the adjoint collective of psum_scatter). With --distributed,
    initializes jax.distributed first (every process runs the same
    command)."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from .config import HarnessConfig, IDGParams
    from .data import initialize_subgrids, make_perf_observation
    from .ops.api import _resolve
    from .parallel import make_mesh
    from .parallel.distributed import (
        distribute_observation,
        distribute_subgrid_pair,
        init_distributed,
    )
    from .parallel.sharded import (
        sharded_degridder,
        sharded_grid_to_degridder,
        sharded_grid_to_degridder_gather,
        sharded_gridder,
        sharded_gridder_to_grid,
    )
    from .types import split_complex, split_observation
    from .utils.costs import workload_costs
    from .utils.timing import time_kernel

    if args.distributed:
        init_distributed()
    require_gpu()

    params = IDGParams.from_env()
    harness = HarnessConfig.from_env()
    obs = make_perf_observation(params)
    sobs = split_observation(obs)
    kernel_workload = {
        "pipeline": "gridder", "pipeline-degrid": "degridder",
    }.get(args.workload, args.workload)
    # the sharded builders are guard-free internals (parallel/sharded.py)
    version, w_rank = _resolve(kernel_workload, args.version, params, obs, None)
    kw = dict(w_rank=w_rank, kernel_kw=_kernel_kw(version))
    _, _, mvis = workload_costs(params)
    sizes = [int(s) for s in args.mesh_sizes.split(",")]
    base = base_n = None
    print(f"workload={args.workload} version={version}"
          + (f" (resolved from {args.version})" if version != args.version else ""))
    print(f"{'devices':>8s} {'ms':>10s} {'MVis/s':>12s} {'efficiency':>11s}")
    for n_dev in sizes:
        if n_dev > len(jax.devices()):
            print(f"{n_dev:>8d}  (skipped: only {len(jax.devices())} devices)")
            continue
        if args.distributed and n_dev % jax.process_count():
            # a mesh must span every process's devices in a
            # multi-controller run (see distributed._local_rows)
            print(f"{n_dev:>8d}  (skipped: not a multiple of "
                  f"{jax.process_count()} processes)")
            continue
        mesh = make_mesh(n_dev)
        sharded_sobs, s_pad = distribute_observation(params, sobs, mesh)
        if args.workload == "gridder":
            fn = sharded_gridder(params, mesh, version, **kw)
            fargs = (sharded_sobs,)
        elif args.workload == "degridder":
            spair = distribute_subgrid_pair(split_complex(initialize_subgrids(
                params.nr_subgrids, params.nr_correlations,
                params.subgrid_size)), mesh, s_pad)
            fn = sharded_degridder(params, mesh, version, **kw)
            fargs = (sharded_sobs, spair)
        elif args.workload == "pipeline-degrid":
            rng = np.random.default_rng(11)
            gsz = params.grid_size
            grid_host = tuple(
                rng.normal(size=(params.nr_correlations, gsz, gsz))
                .astype(np.float32) for _ in range(2)
            )
            if args.grid_sharded and gsz % n_dev == 0:
                spec = P(None, mesh.axis_names[-1], None)
                grid_pair = tuple(
                    jax.device_put(v, NamedSharding(mesh, spec))
                    for v in grid_host
                )
                fn = sharded_grid_to_degridder_gather(params, mesh, version,
                                                      **kw)
            else:
                if args.grid_sharded:
                    print(f"  (grid {gsz} not divisible by {n_dev} rows; "
                          "using the replicated grid)")
                grid_pair = jax.device_put(grid_host)
                fn = sharded_grid_to_degridder(params, mesh, version, **kw)
            fargs = (sharded_sobs, grid_pair)
        else:  # pipeline: gridder + iDFT + grid reduction collective
            fn = sharded_gridder_to_grid(
                params, mesh, version, grid_sharded=args.grid_sharded, **kw)
            fargs = (sharded_sobs,)
        timing = time_kernel(fn, *fargs, harness=harness)
        rate = mvis / timing.seconds
        if base is None:
            base, base_n = rate, n_dev  # first MEASURED mesh, not sizes[0]
        eff = rate / (base * n_dev / base_n)
        print(
            f"{n_dev:>8d} {timing.seconds * 1e3:>10.2f} {rate:>12.2f} "
            f"{eff:>10.1%}  (±{timing.seconds_std * 1e3:.2f} ms)"
        )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="idg-bench", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="run one kernel in perf or check mode")
    p_run.add_argument("--workload", choices=["gridder", "degridder"], required=True)
    p_run.add_argument("--version", default=DEFAULT_VERSION)
    p_run.add_argument("--mode", choices=["perf", "check"], default="perf")
    p_run.add_argument("--mesh", type=int, default=None, help="shard over N devices")
    p_run.add_argument("--w-rank", type=int, default=None,
                       help="w-term Taylor rank override (1 is exact for w==0 data)")
    p_run.add_argument("--w-obs", action="store_true",
                       help="perf: use the nonzero-w generator (w-plane "
                            "metadata; CSV suffixed _wobs)")
    p_run.add_argument("--suffix", default="",
                       help="perf: extra CSV/report name suffix (e.g. "
                            "_lofar4096 for non-default problem sizes)")
    p_run.add_argument("--sustain", type=float, default=None, metavar="S",
                       help="perf: also run a sustained ~S-second launch "
                            "window (the reference's energy-loop "
                            "semantics) and record sustained ms/launch + "
                            "drift in the CSV")
    p_run.set_defaults(fn=cmd_run)

    p_sweep = sub.add_parser("sweep", help="run many kernels (run_perf_*.sh analogue)")
    p_sweep.add_argument("--workloads", default="gridder,degridder")
    p_sweep.add_argument("--versions", default="all")
    p_sweep.add_argument("--mode", choices=["perf", "check"], default="perf")
    p_sweep.add_argument("--mesh", type=int, default=None)
    p_sweep.add_argument("--stations", type=int, default=None,
                         help="shrink the problem to N stations (ladder size)")
    p_sweep.add_argument("--fullsize", action="store_true",
                         help="reference perf defaults + _fullsize CSV suffix")
    p_sweep.set_defaults(fn=cmd_sweep)

    p_vadd = sub.add_parser("vadd", help="copy-bandwidth reference benchmark")
    p_vadd.add_argument("--n", type=int, default=256 * 1024 * 1024)
    p_vadd.set_defaults(fn=cmd_vadd)

    p_grid = sub.add_parser(
        "grid", help="grid-stage benchmark (subgrid DFT + scatter-add/gather)")
    p_grid.add_argument("--direction", choices=["to-grid", "to-subgrids"],
                        default="to-grid")
    p_grid.add_argument("--no-fft", action="store_true",
                        help="scatter/gather only (skip the subgrid DFT)")
    p_grid.add_argument("--suffix", default="",
                        help="extra CSV/report name suffix (e.g. _8192)")
    p_grid.set_defaults(fn=cmd_grid)

    p_pipe = sub.add_parser(
        "pipeline",
        help="end-to-end pass: gridder -> iDFT -> grid scatter-add, or "
             "grid gather -> DFT -> degridder")
    p_pipe.add_argument("--direction", choices=["grid", "degrid"],
                        default="grid")
    p_pipe.add_argument("--version", default=DEFAULT_VERSION)
    p_pipe.add_argument("--w-rank", type=int, default=None)
    p_pipe.add_argument("--suffix", default="")
    p_pipe.set_defaults(fn=cmd_pipeline)

    sub.add_parser("list", help="list registered kernels").set_defaults(fn=cmd_list)
    sub.add_parser("info", help="print device info").set_defaults(fn=cmd_info)

    p_scal = sub.add_parser("scaling",
                            help="strong-scaling efficiency report "
                                 "(fixed global problem over mesh sizes)")
    p_scal.add_argument("--workload",
                        choices=["gridder", "degridder", "pipeline",
                                 "pipeline-degrid"],
                        default="gridder")
    p_scal.add_argument("--version", default=DEFAULT_VERSION)
    p_scal.add_argument("--mesh-sizes", default="1,2,4")
    p_scal.add_argument("--grid-sharded", action="store_true",
                        help="pipeline: psum_scatter row-sharded grid")
    p_scal.add_argument("--distributed", action="store_true",
                        help="initialize jax.distributed (multi-host)")
    p_scal.set_defaults(fn=cmd_scaling)

    args = parser.parse_args(argv)
    _honor_platform_env()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
