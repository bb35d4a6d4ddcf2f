"""CLI smoke tests (subprocess, CPU, shrunken problems via env vars —
exercising the same env-var config surface as the reference binaries).

Perf modes refuse any device but the GPU; IDG_ALLOW_CPU=1 lets these tests
drive them on the CPU, and every CSV then names the cpu platform."""

import json
import os

import pytest
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL_ENV = {
    "GRID_SIZE": "128",
    "SUBGRID_SIZE": "16",
    "NR_STATIONS": "3",
    "NR_TIMESLOTS": "2",
    "NR_TIMESTEPS_SUBGRID": "16",
    "NR_CHANNELS": "8",
    "NR_ITERATIONS": "2",
    "NR_WARM_UP_RUNS": "1",
    "IDG_ALLOW_CPU": "1",
}


def _run(args, extra_env=None, timeout=300):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-m", "idg_tpu"] + args,
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout,
    )


def test_cli_list():
    proc = _run(["list"])
    assert proc.returncode == 0, proc.stderr
    assert "gridder" in proc.stdout and "xla_v4" in proc.stdout


def test_cli_check_gridder():
    proc = _run(
        ["run", "--workload", "gridder", "--version", "xla_v2", "--mode", "check"],
        extra_env=SMALL_ENV,
    )
    assert proc.returncode == 0, proc.stderr
    assert ">>> Result PASSED" in proc.stdout


def test_cli_check_degridder():
    proc = _run(
        ["run", "--workload", "degridder", "--version", "xla_v4", "--mode", "check"],
        extra_env=SMALL_ENV,
    )
    assert proc.returncode == 0, proc.stderr
    assert ">>> Result PASSED" in proc.stdout


@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_cli_check_pallas(workload):
    """Check mode drives the Pallas kernel (interpret mode off the card)
    against the oracle."""
    proc = _run(
        ["run", "--workload", workload, "--version", "pallas_triton",
         "--mode", "check"],
        extra_env=SMALL_ENV,
    )
    assert proc.returncode == 0, proc.stderr
    assert ">>> Result PASSED" in proc.stdout


def test_cli_perf_writes_csv(tmp_path):
    env = dict(SMALL_ENV, OUTPUT_PATH=str(tmp_path))
    proc = _run(
        ["run", "--workload", "gridder", "--version", "xla_v2", "--mode", "perf"],
        extra_env=env,
    )
    assert proc.returncode == 0, proc.stderr
    csvs = list(tmp_path.glob("*gridder_xla_v2-cpu.csv"))
    assert len(csvs) == 1
    lines = csvs[0].read_text().strip().splitlines()
    metrics = dict(line.split(",") for line in lines)
    assert set(metrics) >= {"ms", "GFLOP/s", "GB/s", "FLOP/Byte", "MVis/s"}


def test_cli_perf_sharded(tmp_path):
    env = dict(
        SMALL_ENV,
        OUTPUT_PATH=str(tmp_path),
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    proc = _run(
        ["run", "--workload", "gridder", "--version", "xla_v2",
         "--mode", "perf", "--mesh", "8"],
        extra_env=env,
    )
    assert proc.returncode == 0, proc.stderr


def test_bench_emits_one_json_line(tmp_path):
    env = dict(os.environ)
    env.update(SMALL_ENV)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env["BENCH_KERNEL"] = "xla_v2"
    env["BENCH_DEGRIDDER_KERNEL"] = "xla_v4"
    proc = subprocess.run(
        [sys.executable, "bench.py"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert set(payload) >= {"metric", "value", "unit", "vs_baseline"}
    assert payload["value"] > 0
    # the named kernels are the ones timed — no fallback
    assert payload["metric"] == "gridder_xla_v2_throughput"
    assert payload["degridder_metric"] == "degridder_xla_v4_throughput"
    assert payload["degridder_value"] > 0 and payload["pipeline_value"] > 0
    assert payload["degridder_unit"] == payload["pipeline_unit"] == "MVis/s"
    assert payload["device"]["platform"] == "cpu"
    assert payload["device"]["kind"] == "cpu" and payload["device"]["count"] >= 1


def _bench_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "IDG_ALLOW_CPU"}
    env.update({k: v for k, v in SMALL_ENV.items() if k != "IDG_ALLOW_CPU"})
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    return env


def test_bench_refuses_cpu():
    """On a machine without a GPU, bench.py exits non-zero, says so, and
    prints no number."""
    proc = subprocess.run(
        [sys.executable, "bench.py"], capture_output=True, text=True,
        env=_bench_env(), cwd=REPO, timeout=300,
    )
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert proc.stdout.strip() == ""


def test_bench_unknown_kernel_fails():
    """A named kernel that does not exist is an error, not a fallback."""
    proc = subprocess.run(
        [sys.executable, "bench.py"], capture_output=True, text=True,
        env=_bench_env(IDG_ALLOW_CPU="1", BENCH_KERNEL="pallas_v6"),
        cwd=REPO, timeout=300,
    )
    assert proc.returncode != 0
    assert "no kernel ('gridder', 'pallas_v6')" in proc.stderr
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("args", [
    ["run", "--workload", "gridder", "--version", "xla_v2"],
    ["grid"],
    ["pipeline", "--version", "xla_v2"],
    ["vadd", "--n", "1024"],
])
def test_cli_perf_modes_refuse_cpu(args):
    env = {k: v for k, v in SMALL_ENV.items() if k != "IDG_ALLOW_CPU"}
    proc = _run(args, extra_env=env)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr


@pytest.mark.parametrize("direction, name", [("to-grid", "grid_add"),
                                             ("to-subgrids", "grid_extract")])
def test_cli_grid_stage(tmp_path, direction, name):
    env = dict(SMALL_ENV, OUTPUT_PATH=str(tmp_path), NR_WINDOWS="2")
    proc = _run(["grid", "--direction", direction], extra_env=env)
    assert proc.returncode == 0, proc.stderr
    csvs = list(tmp_path.glob(f"*{name}-cpu.csv"))
    assert len(csvs) == 1
    metrics = dict(
        line.split(",") for line in csvs[0].read_text().strip().splitlines()
    )
    assert set(metrics) >= {"ms", "ms_stddev", "GFLOP/s", "GB/s"}


def test_cli_scaling_pipeline():
    env = dict(
        SMALL_ENV,
        NR_TIMESLOTS="4",
        NR_STATIONS="5",
        NR_WINDOWS="2",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    proc = _run(
        ["scaling", "--workload", "pipeline", "--version", "xla_v2",
         "--mesh-sizes", "8"],
        extra_env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert "MVis/s" in proc.stdout


def test_cli_sweep_stations_suffix(tmp_path):
    env = dict(SMALL_ENV, OUTPUT_PATH=str(tmp_path), NR_WINDOWS="2")
    proc = _run(
        ["sweep", "--workloads", "gridder", "--versions", "xla_v2",
         "--stations", "3"],
        extra_env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert list(tmp_path.glob("*gridder_xla_v2-cpu.csv"))


@pytest.mark.parametrize("direction, version, name", [
    ("grid", "xla_v2", "pipeline_xla_v2"),
    ("degrid", "xla_v4", "pipeline_degrid_xla_v4"),
])
def test_cli_pipeline_both_directions(tmp_path, direction, version, name):
    env = dict(SMALL_ENV, OUTPUT_PATH=str(tmp_path), NR_WINDOWS="2")
    proc = _run(["pipeline", "--direction", direction, "--version", version],
                extra_env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "stage split" in proc.stdout
    csv = next(tmp_path.glob(f"*{name}-cpu.csv")).read_text()
    assert "grid_stage_ms" in csv


def test_cli_run_sustain(tmp_path):
    """--sustain S runs the sustained launch window (reference energy-loop
    semantics) and records sustained_ms + drift in the CSV."""
    env = dict(SMALL_ENV, OUTPUT_PATH=str(tmp_path), NR_WINDOWS="2")
    proc = _run(["run", "--workload", "gridder", "--version", "xla_v2",
                 "--sustain", "0.3"], extra_env=env)
    assert proc.returncode == 0, proc.stderr
    assert "sustained" in proc.stdout
    csv = next(tmp_path.glob("*gridder_xla_v2-cpu.csv")).read_text()
    assert "sustained_ms" in csv and "sustain_drift_pct" in csv


@pytest.mark.slow
def test_cli_scaling_pipeline_degrid():
    env = dict(
        SMALL_ENV,
        NR_TIMESLOTS="4",
        NR_STATIONS="5",
        NR_WINDOWS="2",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    for extra in ([], ["--grid-sharded"]):
        proc = _run(
            ["scaling", "--workload", "pipeline-degrid", "--version",
             "xla_v2", "--mesh-sizes", "8"] + extra,
            extra_env=env, timeout=600,
        )
        assert proc.returncode == 0, proc.stderr
        # a measured row, not just the header ("skipped" rows have no %)
        assert "100.0%" in proc.stdout, proc.stdout
