"""Console + CSV result reporting.

Same derived metrics, console table, and CSV schema as the reference
(app/common/common.cpp:27-98): runtime ms, GFLOP/s, GB/s, FLOP/Byte, MVis/s,
and (when energy is known) W / GFLOP/s/W / MVis/J. CSV files are written to
$OUTPUT_PATH as ``<device>-<name><ext>`` with one ``metric,value`` row each;
the extension names the platform the run used, ``-gpu.csv`` on the card
(reference: -cuda.csv/-hip.csv).
"""

from __future__ import annotations

import os
import re
from typing import Optional

from ..config import get_env_var


def _metrics(seconds, gflops, gbytes, mvis, joules, roofline=None,
             seconds_std=None):
    rows = [("ms", seconds * 1e3)]
    if seconds_std is not None:
        rows.append(("ms_stddev", seconds_std * 1e3))
    if gflops:
        rows.append(("GFLOP/s", gflops / seconds))
    if gbytes:
        rows.append(("GB/s", gbytes / seconds))
    if gflops and gbytes:
        rows.append(("FLOP/Byte", gflops / gbytes))
    if mvis:
        rows.append(("MVis/s", mvis / seconds))
    if joules:
        rows.append(("W", joules / seconds))
        rows.append(("GFLOP/s/W", gflops / joules))
        rows.append(("MVis/J", mvis / joules))
    if roofline is not None:
        rows.append(("roofline_pct", 100.0 * roofline))
    return rows


def report(
    name: str,
    seconds: float,
    gflops: float = 0.0,
    gbytes: float = 0.0,
    mvis: float = 0.0,
    joules: float = 0.0,
    roofline: Optional[float] = None,
    seconds_std: Optional[float] = None,
    roofline_bound: Optional[str] = None,
) -> None:
    """Console one-liner (common.cpp:27-56 format; roofline % and the ±σ
    noise bound are new). `roofline_bound` names the peak the roofline
    share is taken against (utils/roofline.py)."""
    head = f"{name:>20s}: {seconds * 1e3:7.2f} ms"
    if seconds_std is not None:
        head += f" (±{seconds_std * 1e3:.2f})"
    parts = [head]
    for label, value in _metrics(seconds, gflops, gbytes, mvis, joules, roofline)[1:]:
        if label == "roofline_pct" and roofline_bound:
            label = f"roofline_pct ({roofline_bound})"
        parts.append(f"{value:7.2f} {label}")
    print(", ".join(parts))


def report_csv(
    name: str,
    device_name: str,
    file_extension: str,
    seconds: float,
    gflops: float = 0.0,
    gbytes: float = 0.0,
    mvis: float = 0.0,
    joules: float = 0.0,
    output_path: Optional[str] = None,
    roofline: Optional[float] = None,
    seconds_std: Optional[float] = None,
    extra: Optional[dict] = None,
    roofline_bound: Optional[str] = None,
) -> Optional[str]:
    """CSV emitter (common.cpp:58-98). Returns the written path. `extra`
    appends workload-specific rows (e.g. the pipeline's stage split)."""
    if not device_name or not file_extension:
        print(">>> Device name or file extension not provided")
        return None
    path = output_path if output_path is not None else get_env_var("OUTPUT_PATH", ".")
    print(f"Saving output in {path}")
    os.makedirs(path, exist_ok=True)
    device_name = re.sub(r"[/ ]", "-", device_name)
    file_path = os.path.join(path, f"{device_name}-{name}{file_extension}")
    print(file_path)
    with open(file_path, "w") as f:
        for label, value in _metrics(
            seconds, gflops, gbytes, mvis, joules, roofline, seconds_std
        ):
            f.write(f"{label},{value:.4g}\n" if label == "ms_stddev"
                    else f"{label},{value:.2f}\n")
        if not joules:
            # The reference fills these via libpowersensor
            # (app/CUDA/util.cpp:131-155); without an energy reading emit
            # explicit n/a rows, so a reader can tell "not measured" from
            # "forgotten".
            for label in ("W", "GFLOP/s/W", "MVis/J"):
                f.write(f"{label},n/a\n")
        if roofline is not None and roofline_bound:
            f.write(f"roofline_bound,{roofline_bound}\n")
        for label, value in (extra or {}).items():
            f.write(f"{label},{value:.2f}\n")
    return file_path


def device_name() -> str:
    """Device identifier for CSV filenames: the JAX device kind, e.g.
    'NVIDIA H100 80GB HBM3' (the reference uses the CUDA device name)."""
    import jax

    return jax.devices()[0].device_kind


def csv_extension() -> str:
    """``-<platform>.csv``, e.g. ``-gpu.csv``."""
    import jax

    return f"-{jax.devices()[0].platform}.csv"
