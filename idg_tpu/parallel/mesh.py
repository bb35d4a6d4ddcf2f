"""Device mesh construction + shard-axis padding helpers."""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1-D mesh over the first `n_devices` devices (default: all).

    The single mesh axis shards the subgrid batch — the reference's grid
    of thread-blocks (`s = blockIdx.x`,
    app/CUDA/kernels/gridder_reference.cu:14) lifted across cards. Every
    card of a host reaches every other over NVLink at the same rate, so
    one flat axis is the whole topology.
    """
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} present"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k


def pad_axis0(arr, target: int):
    """Zero-pad axis 0 of `arr` to length `target` (host-side NumPy)."""
    arr = np.asarray(arr)
    if arr.shape[0] == target:
        return arr
    pad = [(0, target - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)
