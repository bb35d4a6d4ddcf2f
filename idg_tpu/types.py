"""Core data model: structure-of-arrays observation bundles.

The reference uses AoS POD structs (idg::Metadata/Baseline/Coordinate/
UVWCoordinate/Visibility, app/common/types.hpp:11-50) over owning Array1D..4D
containers (types.hpp:58-356). In JAX the idiomatic layout is
structure-of-arrays jnp/np ndarrays with static shapes, bundled in frozen
dataclasses registered as JAX pytrees, so whole bundles pass through jit /
shard_map unchanged.

Shape conventions (B=nr_baselines, S=nr_subgrids, T=nr_timesteps_subgrid,
Ttot=timesteps per baseline, C=nr_channels, P=nr_correlations=4,
N=subgrid_size):
  uvw            f32[B, Ttot, 3]
  wavenumbers    f32[C]
  visibilities   c64[B, Ttot, C, P]
  spheroidal     f32[N, N]
  aterms         c64[nr_timeslots, nr_stations, N, N, P]   (P = xx,xy,yx,yy)
  subgrids       c64[S, P, N, N]
  metadata       SoA int32 arrays of length S
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np


def _register_pytree(cls):
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        return tuple(getattr(obj, name) for name in fields), None

    def unflatten(_, children):
        return cls(**dict(zip(fields, children)))

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_register_pytree
@dataclasses.dataclass(frozen=True)
class Metadata:
    """Per-subgrid bookkeeping, SoA (reference AoS: types.hpp:19-26).

    time_offset indexes the flattened (baseline*Ttot + t) time axis of
    uvw/visibilities, exactly like the reference's
    ``m.baseline_offset - baseline_offset_1 + m.time_offset``
    (app/CPU/kernels/gridder_reference.cpp:23-24 collapses to this because
    baseline_offset is always 0 in-tree, init.cpp:141).
    """

    time_offset: Any   # i32[S]
    nr_timesteps: Any  # i32[S] (uniform == T in all in-tree setups)
    aterm_index: Any   # i32[S]
    station1: Any      # i32[S]
    station2: Any      # i32[S]
    coord_x: Any       # i32[S]
    coord_y: Any       # i32[S]
    coord_z: Any       # i32[S] (z of the subgrid coordinate; 0 in-tree)

    @property
    def nr_subgrids(self) -> int:
        return int(np.shape(self.time_offset)[0])


@_register_pytree
@dataclasses.dataclass(frozen=True)
class Observation:
    """One synthetic observation: every input of the gridder/degridder ABI
    (the 13-arg kernel signature, app/CUDA/util.cpp:233-237), minus the
    static scalars which live in IDGParams."""

    uvw: Any           # f32[B, Ttot, 3]
    wavenumbers: Any   # f32[C]
    visibilities: Any  # c64[B, Ttot, C, P]
    spheroidal: Any    # f32[N, N]
    aterms: Any        # c64[ts, stations, N, N, P]
    metadata: Metadata

    @property
    def uvw_flat(self):
        """f32[B*Ttot, 3] view matching the reference's flat time indexing."""
        return self.uvw.reshape(-1, 3)

    @property
    def visibilities_flat(self):
        """c64[B*Ttot, C, P] view matching flat time indexing."""
        return self.visibilities.reshape(
            -1, self.visibilities.shape[-2], self.visibilities.shape[-1]
        )


@_register_pytree
@dataclasses.dataclass(frozen=True)
class SplitObservation:
    """Device-side observation: complex arrays split into f32 re/im planes.

    The device compute path is complex-free (split-complex pairs map every
    complex product onto real dots, ops/complexpair.py); splitting happens
    once at the host boundary via `split_observation`.
    """

    uvw: Any           # f32[S, T, 3]
    wavenumbers: Any   # f32[C]
    vis_re: Any        # f32[S, T, C, P]
    vis_im: Any        # f32[S, T, C, P]
    spheroidal: Any    # f32[N, N]
    at_re: Any         # f32[ts, stations, N, N, P]
    at_im: Any         # f32[ts, stations, N, N, P]
    metadata: Metadata


def split_observation(obs: Observation) -> SplitObservation:
    """Host-side complex → split-f32 conversion (NumPy; outside jit)."""
    vis = np.asarray(obs.visibilities)
    at = np.asarray(obs.aterms)
    return SplitObservation(
        uvw=np.asarray(obs.uvw, np.float32),
        wavenumbers=np.asarray(obs.wavenumbers, np.float32),
        vis_re=np.ascontiguousarray(vis.real, dtype=np.float32),
        vis_im=np.ascontiguousarray(vis.imag, dtype=np.float32),
        spheroidal=np.asarray(obs.spheroidal, np.float32),
        at_re=np.ascontiguousarray(at.real, dtype=np.float32),
        at_im=np.ascontiguousarray(at.imag, dtype=np.float32),
        metadata=obs.metadata,
    )


def split_complex(x):
    """(re, im) f32 NumPy pair from a complex array (host side)."""
    x = np.asarray(x)
    return (
        np.ascontiguousarray(x.real, dtype=np.float32),
        np.ascontiguousarray(x.imag, dtype=np.float32),
    )


def combine_complex(re, im) -> np.ndarray:
    """Host-side pair → complex64."""
    return np.asarray(re, np.float32) + 1j * np.asarray(im, np.float32)
