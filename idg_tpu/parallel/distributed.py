"""Multi-process distribution: jax.distributed init, the (host × device)
mesh for runs across hosts, and process-local sharding of a global
observation (the north-star scaling layer, SURVEY.md §2.7 /
BASELINE.md:36-40; the reference is single-GPU and has no equivalent).

One process drives every card of one host on a flat 1-D mesh
(mesh.make_mesh). Only a run across hosts (jax.process_count() > 1) needs
the 2-D mesh, whose axes follow the process boundary:

    mesh = make_hier_mesh()            # axes ("host", "device")

so the grid reduction can be staged inner-to-outer — each host psums its
local partial grid first, then one pre-reduced grid per host crosses the
network (`hierarchical_psum`).

Multi-process usage (one process per host):

    from idg_tpu.parallel import distributed as dist
    dist.init_distributed()            # env: JAX_COORDINATOR_ADDRESS, ...
    mesh = dist.make_hier_mesh()
    sobs, s_pad = dist.distribute_observation(params, sobs_global, mesh)

Every process passes the same global observation (synthetic data is cheap
to generate everywhere); `distribute_observation` keeps only the local
shard's rows on each host.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..config import IDGParams
from ..types import Metadata, SplitObservation
from .mesh import pad_axis0, pad_to_multiple


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """jax.distributed.initialize with env-var fallbacks.

    Env: JAX_COORDINATOR_ADDRESS (e.g. localhost:<port>), JAX_NUM_PROCESSES,
    JAX_PROCESS_ID. Nothing tells JAX of a cluster on its own, so all three
    are needed. Call once per process, before any other JAX API touches
    devices.
    """
    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    nproc = num_processes if num_processes is not None else os.environ.get("JAX_NUM_PROCESSES")
    if nproc is not None:
        kwargs["num_processes"] = int(nproc)
    pid = process_id if process_id is not None else os.environ.get("JAX_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def make_hier_mesh(
    devices_per_host: int | None = None,
    axis_names: tuple[str, str] = ("host", "device"),
) -> Mesh:
    """2-D (host × device) mesh over all global devices, for runs across
    hosts. Defaults to the process-local device count per host — the
    boundary between the links inside a host and the network between
    hosts. Works single-process too (1 × n_devices)."""
    devices = np.asarray(jax.devices())
    if devices_per_host is None:
        devices_per_host = jax.local_device_count()
    assert devices.size % devices_per_host == 0, (devices.size, devices_per_host)
    return Mesh(devices.reshape(-1, devices_per_host), axis_names)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """All mesh axes — the subgrid batch shards over their product."""
    return tuple(mesh.axis_names)


def flat_axis_index(axes: tuple[str, ...]):
    """Row-major flattened index of this shard across `axes` (inside
    shard_map)."""
    idx = jax.lax.axis_index(axes[0])
    for name in axes[1:]:
        idx = idx * jax.lax.axis_size(name) + jax.lax.axis_index(name)
    return idx


def hierarchical_psum(x, mesh: Mesh):
    """Stage the reduction inner-to-outer: within a host (last axis) first,
    then across hosts.

    For a 1-D mesh this is a plain psum."""
    for name in reversed(mesh.axis_names):
        x = jax.lax.psum(x, name)
    return x


def _local_rows(sharding, s_pad: int) -> tuple[int, int]:
    """This process's contiguous [lo, hi) row range of an axis-0-sharded
    [s_pad, ...] array, derived from the sharding itself (NOT from
    process_count: a mesh need not span every process's devices
    uniformly). Raises when this process owns no shard of the mesh —
    such a mesh cannot be used from here in a multi-controller run."""
    idx_map = sharding.addressable_devices_indices_map((s_pad,))
    if not idx_map:
        raise ValueError(
            "this process has no addressable devices in the mesh; "
            "multi-process runs need meshes that span every process "
            "(e.g. n_dev a multiple of jax.process_count())"
        )
    starts = [sl[0].start or 0 for sl in idx_map.values()]
    stops = [s_pad if sl[0].stop is None else sl[0].stop
             for sl in idx_map.values()]
    return min(starts), max(stops)


def _put_process_local(tree, shardings, s: int, s_pad: int):
    """make_array_from_process_local_data over an UNPADDED global tree:
    axis-0-sharded leaves are sliced to this process's rows first and
    only the tail shard's zero padding is materialized (padding the full
    global array first would transiently hold ~2x the visibility volume
    on every host)."""

    def put(arr, sharding):
        arr = np.asarray(arr)
        spec = sharding.spec
        if len(spec) and spec[0] is not None:
            lo, hi = _local_rows(sharding, s_pad)
            local = arr[lo:min(hi, s)]
            if hi > s:
                pad = np.zeros((hi - max(lo, s),) + arr.shape[1:], arr.dtype)
                local = np.concatenate([local, pad]) if local.size else pad
        else:
            local = arr
        return jax.make_array_from_process_local_data(sharding, local)

    return jax.tree.map(
        put, tree, shardings,
        is_leaf=lambda x: isinstance(x, (np.ndarray, jax.Array)),
    )


def distribute_observation(
    params: IDGParams, sobs: SplitObservation, mesh: Mesh
):
    """Multi-process-aware sharding of a GLOBAL observation.

    Single process: equivalent to sharded.shard_observation. Multi-process:
    every process passes the same global arrays; each keeps only its local
    rows via jax.make_array_from_process_local_data (no cross-host data
    movement — the analogue of each host generating its own subgrid batch).

    Returns (sharded_sobs, padded_S).
    """
    from .sharded import _obs_specs, _pad_observation

    n_dev = mesh.devices.size
    axes = data_axes(mesh)
    s = np.shape(sobs.uvw)[0]
    shardings = jax.tree.map(
        lambda spec: NamedSharding(mesh, spec), _obs_specs(axes),
        is_leaf=lambda x: isinstance(x, P),
    )
    if jax.process_count() == 1:
        padded, s_pad = _pad_observation(params, sobs, n_dev)
        return jax.device_put(padded, shardings), s_pad

    s_pad = pad_to_multiple(s, n_dev)
    t = params.nr_timesteps_subgrid
    md = sobs.metadata
    if s_pad != s:
        # metadata is small — pad it globally (the padded tail needs its
        # canonical time offsets); the big per-subgrid arrays are sliced
        # locally and zero-padded per shard in _put_process_local
        extra_offsets = (np.arange(s, s_pad, dtype=np.int32)) * t
        md = Metadata(
            time_offset=np.concatenate(
                [np.asarray(md.time_offset), extra_offsets]
            ),
            nr_timesteps=pad_axis0(md.nr_timesteps, s_pad),
            aterm_index=pad_axis0(md.aterm_index, s_pad),
            station1=pad_axis0(md.station1, s_pad),
            station2=pad_axis0(md.station2, s_pad),
            coord_x=pad_axis0(md.coord_x, s_pad),
            coord_y=pad_axis0(md.coord_y, s_pad),
            coord_z=pad_axis0(md.coord_z, s_pad),
        )
    global_tree = dataclasses.replace(sobs, metadata=md)
    out = _put_process_local(global_tree, shardings, s, s_pad)
    return out, s_pad


def distribute_subgrid_pair(pair, mesh: Mesh, s_pad: int):
    """Shard a split subgrid pair [S, P, N, N]x2 over the mesh's subgrid
    axis, padded to s_pad rows — the degridder-input companion of
    distribute_observation (multi-process aware the same way)."""
    axes = data_axes(mesh)
    sharding = NamedSharding(mesh, P(axes))
    s = np.shape(pair[0])[0]
    if jax.process_count() == 1:
        if s_pad != s:
            pair = tuple(pad_axis0(v, s_pad) for v in pair)
        return jax.device_put(tuple(pair), (sharding, sharding))
    return _put_process_local(
        tuple(pair), (sharding, sharding), s, s_pad
    )
