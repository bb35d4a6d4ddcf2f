"""Kernel registry: (workload, version) → callable.

The analogue of the reference's one-executable-per-kernel scheme
(tests/CMakeLists.txt:4-38): every kernel variant registers under a workload
("gridder"/"degridder") and a version string ("xla_v1", "pallas_triton", ...),
with a one-line description of its optimization delta (the ladder).

Kernel contract (replaces the 13-arg launch ABI, app/CUDA/util.cpp:233-237):
  gridder:   fn(params: IDGParams, obs: Observation) -> c64[S, P, N, N]
  degridder: fn(params: IDGParams, obs: Observation, subgrids) -> c64[S, T, C, P]
`params` is static (hashable dataclass); jit with static_argnums=0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

_REGISTRY: Dict[Tuple[str, str], "KernelEntry"] = {}

WORKLOADS = ("gridder", "degridder")


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    workload: str
    version: str
    fn: Callable
    description: str
    family: str  # "xla" | "pallas"
    # Channel-recurrence kernels (the reference v8 trick, gridder_v8.cu:
    # 135-186) advance the phasor by a single per-channel delta and are only
    # correct when the wavenumber spacing is uniform. `uniform_channels`
    # marks them; `fallback` names the nearest rung with no such assumption,
    # used by the API guard (ops/api.py) on non-uniform inputs.
    uniform_channels: bool = False
    fallback: str | None = None


def register(workload: str, version: str, description: str = "", family: str = "",
             uniform_channels: bool = False, fallback: str | None = None):
    assert workload in WORKLOADS, workload

    def deco(fn):
        key = (workload, version)
        assert key not in _REGISTRY, f"duplicate kernel {key}"
        fam = family or version.split("_")[0]
        _REGISTRY[key] = KernelEntry(
            workload, version, fn, description, fam, uniform_channels,
            fallback,
        )
        return fn

    return deco


def get_kernel(workload: str, version: str) -> KernelEntry:
    _ensure_loaded()
    key = (workload, version)
    if key not in _REGISTRY:
        avail = ", ".join(sorted(v for w, v in _REGISTRY if w == workload))
        raise KeyError(f"no kernel {key}; available {workload} versions: {avail}")
    return _REGISTRY[key]


def list_kernels(workload: str | None = None):
    _ensure_loaded()
    return sorted(
        (e for e in _REGISTRY.values() if workload is None or e.workload == workload),
        key=lambda e: (e.workload, e.family, e.version),
    )


_loaded = False


def _ensure_loaded():
    """Import kernel modules lazily so registry population is a side effect
    of importing idg_tpu.ops.* exactly once."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    from . import xla  # noqa: F401
    from . import pallas  # noqa: F401
