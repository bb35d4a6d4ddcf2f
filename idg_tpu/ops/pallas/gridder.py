"""Gridder as one Pallas kernel on the Triton route (visibilities → subgrids).

One program per subgrid. For each tile of V = tile_t·C visibilities the
program builds Φx, Φy in registers (2·V·N sincos), forms
W[v, (p, y)] = ṽ_r[v, p]·Φy[v, y] for each Taylor rank r, and accumulates
pixels_r[x, (p, y)] += Φxᵀ·W as four real [N, V]×[V, P·N] dots (Φx is
built x-major, so no operand is transposed inside the loop). The epilogue
applies the n^r weights, the Jones terms A1ᴴ·P·A2 and the spheroidal
(ops/common.py: finish_gridder) and writes the [P, N, N] subgrid.

Compared with xla_v4 (ops/xla/separable.py), which writes W to device memory
for every subgrid and rank and reads it back, only the visibilities are read
and only the subgrids are written.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...config import IDGParams
from ...types import SplitObservation
from ..registry import register
from .common import (
    TF32_X3,
    axis_phasors,
    check_shapes,
    full_spec,
    jones_herm,
    jones_mul,
    lmn,
    load_jones,
    load_tile,
    n_powers,
    rank_coefficients,
    subgrid_spec,
    subgrid_tables,
    tile_timesteps,
)

# Visibilities per loop tile and warps per program: the fastest settings of
# the sweep on the card (PERF.md); larger tiles hold more live registers
# and ran several times slower.
TILE_V = 16
NUM_WARPS = 4


def _kernel(meta_ref, pos_ref, uvw_ref, vre_ref, vim_ref, k_ref, l_ref,
            m_ref, n_ref, sph_ref, are_ref, aim_ref, ore_ref, oim_ref, *,
            nr_timesteps: int, tile_t: int, w_rank: int, precision):
    nr_pols, n_pix = ore_ref.shape[0], l_ref.shape[0]
    off = meta_ref[0]
    k, l, m = k_ref[...], l_ref[...], m_ref[...]
    po_x, po_y, w_off = pos_ref[0, :], pos_ref[1, :], pos_ref[2, 0]
    t_iota = jnp.arange(tile_t, dtype=jnp.int32)
    dot = functools.partial(pl.dot, precision=precision)

    def body(i, acc):
        t0 = i * tile_t
        valid = t0 + t_iota < nr_timesteps
        rows = pl.ds(off + t0, tile_t)
        u, v, w = (load_tile(uvw_ref, valid, rows, c) for c in range(3))
        (cx, sx), (cy, sy), mu = axis_phasors(
            u, v, w, k, l, m, po_x, po_y, w_off, x_major=True)
        tv = mu.shape[0]
        vr = load_tile(vre_ref, valid, rows).reshape(tv, nr_pols)
        vi = load_tile(vim_ref, valid, rows).reshape(tv, nr_pols)
        acc = list(acc)
        for r, (cr, ci) in enumerate(rank_coefficients(mu, w_rank)):
            a = (vr * cr[:, None] - vi * ci[:, None])[:, :, None]
            b = (vr * ci[:, None] + vi * cr[:, None])[:, :, None]
            # W[v, (p, y)] = ṽ_r[v, p]·Φy[v, y]                 [V, P·N]
            wr = (cy[:, None, :] * a - sy[:, None, :] * b).reshape(tv, -1)
            wi = (cy[:, None, :] * b + sy[:, None, :] * a).reshape(tv, -1)
            acc[2 * r] = acc[2 * r] + dot(cx, wr) - dot(sx, wi)  # [N(x), P·N]
            acc[2 * r + 1] = acc[2 * r + 1] + dot(sx, wr) + dot(cx, wi)
        return tuple(acc)

    zero = jnp.zeros((n_pix, nr_pols * n_pix), jnp.float32)
    n_tiles = -(-nr_timesteps // tile_t)
    acc = lax.fori_loop(0, n_tiles, body, (zero,) * (2 * w_rank))

    # pixels_p[y, x] = Σ_r n^r[y, x]·acc_r[x, (p, y)]
    powers = n_powers(n_ref[...], w_rank)
    pol = jnp.arange(nr_pols, dtype=jnp.int32)[:, None, None]
    pix = [[0.0, 0.0] for _ in range(nr_pols)]
    for r in range(w_rank):
        for c in range(2):
            planes = acc[2 * r + c].T.reshape(nr_pols, n_pix, n_pix)
            for p in range(nr_pols):
                plane = jnp.sum(jnp.where(pol == p, planes, 0.0), axis=0)
                pix[p][c] = pix[p][c] + powers[r] * plane
    slot = meta_ref[1]
    a1 = load_jones(are_ref, aim_ref, slot, meta_ref[2])
    a2 = load_jones(are_ref, aim_ref, slot, meta_ref[3])
    out = jones_mul(jones_mul(jones_herm(a1), pix), a2)
    sph = sph_ref[...]
    for p in range(nr_pols):
        ore_ref[p, :, :] = out[p][0] * sph
        oim_ref[p, :, :] = out[p][1] * sph


@register(
    "gridder",
    "pallas_triton",
    "one program per subgrid, separable phasor in registers, TF32x3 dots, "
    "Jones + taper epilogue (Pallas, Triton route)",
    family="pallas",
)
def gridder_pallas_triton(params: IDGParams, sobs: SplitObservation,
                          w_rank: int = 1, precision=TF32_X3,
                          interpret: bool = False):
    """Subgrids pair f32[S, P, N, N]. `w_rank` is the Taylor rank of
    e^{iμ·n}; rank 1 is exact for w ≡ 0 data and the API guard raises it
    when the observation's w range needs more (ops/api.py)."""
    check_shapes(params)
    md = sobs.metadata
    s_count = md.time_offset.shape[0]
    n_pix, nr_pols = params.subgrid_size, params.nr_correlations
    c = params.nr_channels
    meta, pos = subgrid_tables(params, md)
    l, m, n = lmn(params)
    uvw = sobs.uvw.reshape(-1, 3)
    vre = sobs.vis_re.reshape(-1, c, nr_pols)
    vim = sobs.vis_im.reshape(-1, c, nr_pols)
    args = (meta, pos, uvw, vre, vim, sobs.wavenumbers, l, m, n,
            sobs.spheroidal, sobs.at_re, sobs.at_im)
    in_specs = [subgrid_spec(meta.shape[1:]), subgrid_spec(pos.shape[1:])]
    in_specs += [full_spec(a.shape) for a in args[2:]]
    out_shape = jax.ShapeDtypeStruct((s_count, nr_pols, n_pix, n_pix),
                                     jnp.float32)
    kernel = functools.partial(
        _kernel, nr_timesteps=params.nr_timesteps_subgrid,
        tile_t=tile_timesteps(params, TILE_V), w_rank=w_rank,
        precision=precision)
    return pl.pallas_call(
        kernel,
        grid=(s_count,),
        in_specs=in_specs,
        out_specs=[subgrid_spec(out_shape.shape[1:])] * 2,
        out_shape=[out_shape, out_shape],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="idg_gridder",
    )(*args)
