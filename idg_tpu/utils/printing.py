"""Pretty-printers: parameter table and subgrid/visibility diff dumps.

Mirrors app/common/print.{hpp,cpp}: the parameter table (print.cpp:3-60) and
the truncated element/diff dumps used as debug aids (print.cpp:62-186, caps at
print.hpp:9-27).
"""

from __future__ import annotations

import numpy as np

from ..config import IDGParams

PRINT_MAX_SUBGRIDS = 1
PRINT_MAX_PIXELS = 4
PRINT_MAX_BASELINES = 1
PRINT_MAX_TIMESTEPS = 2
PRINT_MAX_CHANNELS = 2


def print_parameters(params: IDGParams) -> None:
    """Parameter table (print.cpp:3-60 layout)."""
    rows = [
        ("Number of stations", params.nr_stations),
        ("Number of channels", params.nr_channels),
        ("Number of timesteps", params.nr_timesteps_subgrid),
        ("Number of correlations", params.nr_correlations),
        ("Number of timeslots", params.nr_timeslots),
        ("Imagesize", params.image_size),
        ("Grid size", params.grid_size),
        ("Subgrid size", params.subgrid_size),
        ("W step size", params.w_step),
        ("Number of baselines", params.nr_baselines),
        ("Number of subgrids", params.nr_subgrids),
        ("Total number of timesteps", params.total_nr_timesteps),
    ]
    print("-----------")
    print("PARAMETERS:")
    for label, value in rows:
        print(f"{label:<30s}== {value:>10}")
    print("-----------")


def _fmt(z) -> str:
    return f"({z.real:.6f}, {z.imag:.6f})"


def print_subgrid(subgrids: np.ndarray, subgrid_idx: int = 0, pol: int = 0) -> None:
    """Truncated subgrid dump (print.cpp:62-90)."""
    sub = np.asarray(subgrids)[subgrid_idx, pol]
    ny, nx = sub.shape
    for y in range(min(ny, PRINT_MAX_PIXELS)):
        print(" ".join(_fmt(sub[y, x]) for x in range(min(nx, PRINT_MAX_PIXELS))))


def print_subgrid_diff(a: np.ndarray, b: np.ndarray, subgrid_idx: int = 0, pol: int = 0) -> None:
    """Elementwise diff dump (print.cpp:92-123)."""
    sa = np.asarray(a)[subgrid_idx, pol]
    sb = np.asarray(b)[subgrid_idx, pol]
    ny, nx = sa.shape
    for y in range(min(ny, PRINT_MAX_PIXELS)):
        print(
            " ".join(_fmt(sa[y, x] - sb[y, x]) for x in range(min(nx, PRINT_MAX_PIXELS)))
        )


def print_visibilities(vis: np.ndarray, subgrid_idx: int = 0) -> None:
    """Truncated visibility dump (print.cpp:125-154)."""
    v = np.asarray(vis)[subgrid_idx]
    for t in range(min(v.shape[0], PRINT_MAX_TIMESTEPS)):
        for c in range(min(v.shape[1], PRINT_MAX_CHANNELS)):
            print(f"t={t} c={c}: " + " ".join(_fmt(z) for z in v[t, c]))


def print_visibilities_diff(a: np.ndarray, b: np.ndarray, subgrid_idx: int = 0) -> None:
    """Elementwise visibility diff dump (print.cpp:156-186)."""
    va = np.asarray(a)[subgrid_idx]
    vb = np.asarray(b)[subgrid_idx]
    for t in range(min(va.shape[0], PRINT_MAX_TIMESTEPS)):
        for c in range(min(va.shape[1], PRINT_MAX_CHANNELS)):
            print(
                f"t={t} c={c}: "
                + " ".join(_fmt(x - y) for x, y in zip(va[t, c], vb[t, c]))
            )


class format_saver:
    """Save/restore print formatting around dump helpers (the RAII
    format_saver of print.hpp:29-43, as a NumPy printoptions context)."""

    def __enter__(self):
        self._saved = np.get_printoptions()
        return self

    def __exit__(self, *exc):
        np.set_printoptions(**self._saved)
        return False


def print_device_info() -> None:
    """Device info banner (app/CUDA/util.cpp:25-45 analogue: the reference
    prints CU count, clock and memory size; here the figures come from JAX
    device attributes and memory_stats)."""
    import jax

    dev = jax.devices()[0]
    print("Device info")
    print(f"{'Name':<30s}== {dev.device_kind:>10s}")
    print(f"{'Platform':<30s}== {dev.platform:>10s}")
    print(f"{'Device count':<30s}== {jax.device_count():>10d}")
    print(f"{'Local device count':<30s}== {jax.local_device_count():>10d}")
    print(f"{'Process count':<30s}== {jax.process_count():>10d}")
    try:
        stats = dev.memory_stats() or {}
    except Exception:
        stats = {}
    limit = stats.get("bytes_limit")
    in_use = stats.get("bytes_in_use")
    if limit:
        print(f"{'Device memory (GiB)':<30s}== {limit / 2**30:>10.2f}")
    if in_use is not None:
        print(f"{'Memory in use (GiB)':<30s}== {in_use / 2**30:>10.2f}")
