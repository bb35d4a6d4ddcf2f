"""shard_map wrappers: subgrid-batch data parallelism + grid collectives.

Design (SURVEY.md §2.7): the subgrid axis is embarrassingly parallel (the
reference maps it to `blockIdx.x`); here it shards over the mesh's "data"
axis. Every per-subgrid array (uvw, visibilities, metadata, subgrids) splits
on axis 0; wavenumbers/spheroidal/aterms replicate. The master-grid
accumulation — absent from the reference — is a local scatter-add followed by
a `psum` (replicated grid) or `psum_scatter` (row-sharded grid), which XLA
hands to NCCL on the cards.

Guard contract: the builders here are benchmark internals and do NOT apply
the ops.api._resolve correctness guards themselves (resolution needs the
global host-side observation, which the builders never see). Callers that
accept user-chosen versions (cli._perf_one --mesh, cli.cmd_scaling) resolve
(version, w_rank) through ops.api._resolve first and pass the result down.
`kernel_kw` passes kernel options (the CPU tests' interpret mode).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..config import IDGParams
from ..types import Metadata, SplitObservation
from ..ops.grid import grid_to_subgrids, subgrids_to_grid
from .distributed import flat_axis_index, hierarchical_psum
from .mesh import pad_axis0, pad_to_multiple


def _obs_specs(axes) -> SplitObservation:
    """SplitObservation pytree of PartitionSpecs: subgrid axis sharded over
    `axes` (a name or tuple of names — multi-axis meshes shard the subgrid
    batch over the axis product, hosts-major)."""
    s = P(axes)
    r = P()
    md = Metadata(*([s] * len(dataclasses.fields(Metadata))))
    return SplitObservation(
        uvw=s, wavenumbers=r, vis_re=s, vis_im=s,
        spheroidal=r, at_re=r, at_im=r, metadata=md,
    )


def _localize_time_offset(sobs: SplitObservation, params: IDGParams, axes):
    """Rebase global flat-time offsets to this shard's local buffer.

    time_offset indexes the flat (subgrid*T) axis of uvw/visibilities
    (types.Metadata docstring); sharding splits that buffer, so subtract the
    shard's first global row. Valid because each subgrid's timesteps live in
    its own rows (the in-tree layout, init.cpp:134-159).
    """
    if isinstance(axes, str):
        axes = (axes,)
    s_loc = sobs.uvw.shape[0]
    start = flat_axis_index(axes) * s_loc * params.nr_timesteps_subgrid
    md = sobs.metadata
    md = dataclasses.replace(md, time_offset=md.time_offset - start)
    return dataclasses.replace(sobs, metadata=md)


def _pad_observation(params: IDGParams, sobs: SplitObservation,
                     n_dev: int):
    """Zero-pad the subgrid axis to a multiple of n_dev (host)."""
    s = sobs.uvw.shape[0]
    s_pad = pad_to_multiple(s, n_dev)
    t = params.nr_timesteps_subgrid
    md = sobs.metadata
    if s_pad != s:
        extra_offsets = (np.arange(s, s_pad, dtype=np.int32)) * t
        md = Metadata(
            time_offset=np.concatenate([np.asarray(md.time_offset), extra_offsets]),
            nr_timesteps=pad_axis0(md.nr_timesteps, s_pad),
            aterm_index=pad_axis0(md.aterm_index, s_pad),
            station1=pad_axis0(md.station1, s_pad),
            station2=pad_axis0(md.station2, s_pad),
            coord_x=pad_axis0(md.coord_x, s_pad),
            coord_y=pad_axis0(md.coord_y, s_pad),
            coord_z=pad_axis0(md.coord_z, s_pad),
        )
    padded = SplitObservation(
        uvw=pad_axis0(sobs.uvw, s_pad),
        wavenumbers=np.asarray(sobs.wavenumbers),
        vis_re=pad_axis0(sobs.vis_re, s_pad),
        vis_im=pad_axis0(sobs.vis_im, s_pad),
        spheroidal=np.asarray(sobs.spheroidal),
        at_re=np.asarray(sobs.at_re),
        at_im=np.asarray(sobs.at_im),
        metadata=md,
    )
    return padded, s_pad


def _put_observation(padded: SplitObservation, mesh: Mesh):
    axis = tuple(mesh.axis_names)
    shardings = jax.tree.map(
        lambda spec: NamedSharding(mesh, spec), _obs_specs(axis),
        is_leaf=lambda x: isinstance(x, P),
    )
    return jax.device_put(padded, shardings)


def shard_observation(params: IDGParams, sobs: SplitObservation, mesh: Mesh):
    """Pad the subgrid axis to the mesh size and device_put with the
    distributed sharding. Returns (sharded_sobs, padded_S).

    Single-process only; the multi-host path is
    parallel.distributed.distribute_observation (same layout)."""
    padded, s_pad = _pad_observation(params, sobs, mesh.devices.size)
    return _put_observation(padded, mesh), s_pad


def _kernel_fn(workload: str, version: str, w_rank: int | None,
               kernel_kw: dict | None):
    """Kernel fn with the resolved w_rank and kernel options bound."""
    from ..ops.api import kernel_fn

    return kernel_fn(workload, version, w_rank, **(kernel_kw or {}))


def sharded_gridder(params: IDGParams, mesh: Mesh, version: str = "xla_v2",
                    w_rank: int | None = None, kernel_kw: dict | None = None):
    """jitted fn(sobs_sharded) -> (re, im) subgrids, sharded on axis 0."""
    axis = tuple(mesh.axis_names)
    kernel = _kernel_fn("gridder", version, w_rank, kernel_kw)
    specs = _obs_specs(axis)

    @partial(
        jax.shard_map, mesh=mesh, in_specs=(specs,),
        out_specs=(P(axis), P(axis)), check_vma=False,
    )
    def local(sobs):
        return kernel(params, _localize_time_offset(sobs, params, axis))

    return jax.jit(local)


def sharded_degridder(params: IDGParams, mesh: Mesh, version: str = "xla_v2",
                      w_rank: int | None = None, kernel_kw: dict | None = None):
    """jitted fn(sobs_sharded, sub_pair) -> (re, im) visibilities."""
    axis = tuple(mesh.axis_names)
    kernel = _kernel_fn("degridder", version, w_rank, kernel_kw)
    specs = _obs_specs(axis)

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(specs, (P(axis), P(axis))),
        out_specs=(P(axis), P(axis)), check_vma=False,
    )
    def local(sobs, sub):
        return kernel(params, _localize_time_offset(sobs, params, axis), sub)

    return jax.jit(local)


def sharded_gridder_to_grid(
    params: IDGParams,
    mesh: Mesh,
    version: str = "xla_v2",
    apply_fft: bool = True,
    grid_sharded: bool = False,
    w_rank: int | None = None,
    kernel_kw: dict | None = None,
):
    """jitted fn(sobs_sharded) -> [P, G, G] grid pair.

    Full adjoint pipeline across the mesh: local gridder → local subgrid
    iFFT + scatter-add → collective reduction. `grid_sharded=False` returns
    the grid replicated via psum (on a multi-host mesh staged inner axis
    first, distributed.hierarchical_psum); `grid_sharded=True` returns each
    device's row block via `psum_scatter` over the innermost axis, reduced
    across outer axes by psum.
    """
    axis = tuple(mesh.axis_names)
    inner = axis[-1]
    n_inner = mesh.shape[inner]
    kernel = _kernel_fn("gridder", version, w_rank, kernel_kw)
    specs = _obs_specs(axis)
    g = params.grid_size
    if grid_sharded and g % n_inner:
        raise ValueError(
            f"psum_scatter needs the innermost mesh axis ({n_inner}) to "
            f"divide the grid rows ({g})"
        )
    out_spec = (P(None, inner, None),) * 2 if grid_sharded else (P(), P())

    @partial(
        jax.shard_map, mesh=mesh, in_specs=(specs,), out_specs=out_spec,
        check_vma=False,
    )
    def local(sobs):
        sobs = _localize_time_offset(sobs, params, axis)
        sub = kernel(params, sobs)
        grid = subgrids_to_grid(
            sub, sobs.metadata.coord_x, sobs.metadata.coord_y, g, apply_fft,
        )
        if grid_sharded:
            def scatter(x):
                x = jax.lax.psum_scatter(
                    x.reshape(x.shape[0], n_inner, g // n_inner, g),
                    inner, scatter_dimension=1, tiled=False,
                ).reshape(x.shape[0], g // n_inner, g)
                for name in axis[:-1]:   # outer (between-host) reduction
                    x = jax.lax.psum(x, name)
                return x

            return tuple(scatter(x) for x in grid)
        return tuple(hierarchical_psum(x, mesh) for x in grid)

    return jax.jit(local)


def sharded_grid_to_degridder(
    params: IDGParams,
    mesh: Mesh,
    version: str = "xla_v2",
    apply_fft: bool = True,
    w_rank: int | None = None,
    kernel_kw: dict | None = None,
):
    """jitted fn(sobs_sharded, grid_pair_replicated) -> (re, im) visibilities.

    Forward pipeline: replicated grid → local tile gather + FFT → local
    degridder. The grid gather is local (no collective) because the grid is
    replicated; the sharded-grid variant (sharded_grid_to_degridder_gather)
    all-gathers the row blocks first.
    """
    axis = tuple(mesh.axis_names)
    kernel = _kernel_fn("degridder", version, w_rank, kernel_kw)
    specs = _obs_specs(axis)

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(specs, (P(), P())),
        out_specs=(P(axis), P(axis)), check_vma=False,
    )
    def local(sobs, grid):
        sobs = _localize_time_offset(sobs, params, axis)
        sub = grid_to_subgrids(
            grid, sobs.metadata.coord_x, sobs.metadata.coord_y,
            params.subgrid_size, apply_fft,
        )
        return kernel(params, sobs, sub)

    return jax.jit(local)


def sharded_grid_to_degridder_gather(
    params: IDGParams,
    mesh: Mesh,
    version: str = "xla_v2",
    apply_fft: bool = True,
    w_rank: int | None = None,
    kernel_kw: dict | None = None,
):
    """jitted fn(sobs_sharded, grid_pair_row_sharded) -> visibilities.

    Forward pipeline for a grid that STAYS row-sharded over the innermost
    mesh axis (the layout sharded_gridder_to_grid(grid_sharded=True)
    produces): all_gather the row blocks, then gather tiles + FFT +
    local degridder. The all_gather is the exact adjoint collective of the
    gridder direction's psum_scatter.
    """
    axis = tuple(mesh.axis_names)
    inner = axis[-1]
    kernel = _kernel_fn("degridder", version, w_rank, kernel_kw)
    specs = _obs_specs(axis)
    g = params.grid_size

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(specs, (P(None, inner, None), P(None, inner, None))),
        out_specs=(P(axis), P(axis)), check_vma=False,
    )
    def local(sobs, grid):
        sobs = _localize_time_offset(sobs, params, axis)
        full = tuple(
            jax.lax.all_gather(x, inner, axis=1, tiled=True) for x in grid
        )
        sub = grid_to_subgrids(
            full, sobs.metadata.coord_x, sobs.metadata.coord_y,
            params.subgrid_size, apply_fft,
        )
        return kernel(params, sobs, sub)

    return jax.jit(local)
