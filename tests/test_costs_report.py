"""Cost models (app/common/common.cpp:100-159) and reporters (:27-98)."""

import os

import numpy as np
import pytest

from idg_tpu import IDGParams
from idg_tpu.utils import bytes_gridder, flops_gridder, report, report_csv, workload_costs


def test_flops_formula():
    # flops/vis = 5+5 + 2C + 8CP; plus 6 per subgrid pixel
    C, P, N = 16, 4, 32
    nr_timesteps, nr_subgrids = 1000, 10
    expected = nr_timesteps * N * N * (10 + 2 * C + 8 * C * P) + nr_subgrids * N * N * 6
    assert flops_gridder(C, nr_timesteps, nr_subgrids, N, P) == expected


def test_bytes_formula():
    C, P, N = 16, 4, 32
    nr_timesteps, nr_subgrids = 1000, 10
    expected = (
        nr_timesteps * (3 * 4 + C * P * 2 * 4)
        + nr_subgrids * N * N * (2 * P * 2 * 4 + 2 * P * 2 * 4 + 4)
    )
    assert bytes_gridder(C, nr_timesteps, nr_subgrids, N, P) == expected


def test_default_workload_matches_reference_aggregates():
    """At perf defaults: ~50.18 MVis per pass (BASELINE.md derivation)."""
    p = IDGParams()
    gflops, gbytes, mvis = workload_costs(p)
    assert abs(mvis - 50.176) < 0.01
    assert gflops / gbytes == np.float32(gflops / gbytes)  # finite
    # arithmetic intensity ~359 FLOP/byte, as in every committed CSV
    assert abs(gflops / gbytes - 359.08) < 0.5


def test_report_console(capsys):
    report("gridder_v1", 0.5, gflops=100.0, gbytes=10.0, mvis=50.0)
    out = capsys.readouterr().out
    assert "500.00 ms" in out
    assert "200.00 GFLOP/s" in out
    assert "20.00 GB/s" in out
    assert "10.00 FLOP/Byte" in out
    assert "100.00 MVis/s" in out


def test_report_csv(tmp_path):
    path = report_csv(
        "gridder_v1",
        "NVIDIA H100 80GB HBM3",
        "-gpu.csv",
        0.5,
        gflops=100.0,
        gbytes=10.0,
        mvis=50.0,
        output_path=str(tmp_path),
    )
    assert path is not None and os.path.exists(path)
    assert os.path.basename(path) == "NVIDIA-H100-80GB-HBM3-gridder_v1-gpu.csv"
    lines = open(path).read().strip().splitlines()
    assert lines[0] == "ms,500.00"
    assert "GFLOP/s,200.00" in lines
    assert "MVis/s,100.00" in lines
    # Power provenance: no energy measured -> explicit n/a rows.
    assert "W,n/a" in lines and "MVis/J,n/a" in lines


def test_report_csv_power_rows_when_measured(tmp_path):
    path = report_csv(
        "gridder_v1", "dev", "-gpu.csv", 0.5, gflops=100.0, mvis=50.0,
        joules=25.0, output_path=str(tmp_path),
    )
    metrics = dict(
        line.split(",") for line in open(path).read().strip().splitlines()
    )
    assert float(metrics["W"]) == 50.0  # 25 J / 0.5 s
    assert float(metrics["GFLOP/s/W"]) == 4.0  # 100 GFLOP / 25 J
    assert "n/a" not in metrics.values()


def test_report_csv_missing_device(capsys, tmp_path):
    assert report_csv("g", "", "-gpu.csv", 0.5, output_path=str(tmp_path)) is None
    assert "not provided" in capsys.readouterr().out


def test_grid_costs_positive():
    from idg_tpu.config import IDGParams
    from idg_tpu.utils.costs import bytes_grid, flops_grid, grid_costs

    p = IDGParams(nr_stations=3)
    gflops, gbytes, mvis = grid_costs(p)
    assert gflops > 0 and gbytes > 0 and mvis == 0.0
    assert flops_grid(p.nr_subgrids, p.subgrid_size, 4) == int(
        p.nr_subgrids * (2 * 4 * 8 * p.subgrid_size ** 3
                         + p.subgrid_size ** 2 * 6
                         + p.subgrid_size ** 2 * 4 * 2)
    )
    assert bytes_grid(1, 16, 4, 64) == int(
        3 * 16 * 16 * 4 * 8 + 2 * 64 * 64 * 4 * 8
    )


def test_timing_result_variance():
    from idg_tpu.utils.timing import TimingResult

    t = TimingResult(
        seconds=1.0e-3, iterations=10, warmup_runs=1,
        all_seconds=(0.010, 0.012, 0.011),
    )
    assert abs(t.seconds_mean - (0.011 + 0.012 + 0.010) / 3 / 10) < 1e-12
    assert abs(t.seconds_median - 0.0011) < 1e-12
    q1, q3 = t.seconds_quartiles
    assert q1 <= t.seconds_median <= q3
    assert t.seconds_std > 0
    single = TimingResult(
        seconds=1e-3, iterations=5, warmup_runs=1,
        all_seconds=(0.006,),
    )
    assert single.seconds_std == 0.0


def test_report_csv_stddev_row(tmp_path):
    from idg_tpu.utils.report import report_csv

    path = report_csv(
        "unit_test", "dev", "-gpu.csv", 0.01, gflops=1.0,
        output_path=str(tmp_path), seconds_std=0.0001,
    )
    metrics = dict(
        line.split(",") for line in open(path).read().strip().splitlines()
    )
    assert "ms_stddev" in metrics and float(metrics["ms_stddev"]) == 0.1


def test_time_kernel_sustained():
    """Sustained window (the reference's ~10 s energy-loop semantics,
    app/CUDA/util.cpp:131-155): per-launch estimate within sanity bounds,
    launch count consistent with the window, drift_pct well-defined."""
    import jax
    import jax.numpy as jnp

    from idg_tpu.config import HarnessConfig
    from idg_tpu.utils.timing import SustainedResult, time_kernel_sustained

    fn = jax.jit(lambda x: x * 2.0 + 1.0)
    x = jnp.arange(1024.0)
    h = HarnessConfig(nr_warm_up_runs=1, nr_iterations=2)
    res = time_kernel_sustained(fn, x, duration_s=0.3, harness=h)
    assert res.launches >= 1
    assert res.window_seconds >= 0.3
    assert 0 < res.seconds < res.window_seconds
    assert abs(res.seconds * res.launches - res.window_seconds) \
        < 0.5 * res.window_seconds
    assert isinstance(res.drift_pct, float)

    flat = SustainedResult(seconds=1e-3, launches=100, window_seconds=0.1,
                           chunk_seconds=(1e-3, 1.2e-3))
    assert abs(flat.drift_pct - 20.0) < 1e-9
    single = SustainedResult(seconds=1e-3, launches=10, window_seconds=0.01,
                             chunk_seconds=(1e-3,))
    assert single.drift_pct == 0.0


@pytest.mark.parametrize("bound", ["tf32", "fp32"])
def test_report_names_roofline_bound(tmp_path, capsys, bound):
    """A roofline share names the peak it is taken against."""
    from idg_tpu.utils.report import report, report_csv

    report("k", 0.01, gflops=1.0, gbytes=1.0, roofline=0.25,
           roofline_bound=bound)
    assert f"25.00 roofline_pct ({bound})" in capsys.readouterr().out
    path = report_csv("k", "dev", "-gpu.csv", 0.01, gflops=1.0, gbytes=1.0,
                      output_path=str(tmp_path), roofline=0.25,
                      roofline_bound=bound)
    rows = dict(line.split(",") for line in open(path).read().splitlines())
    assert rows["roofline_pct"] == "25.00" and rows["roofline_bound"] == bound
