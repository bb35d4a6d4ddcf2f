"""Degridder as one Pallas kernel on the Triton route (subgrids → visibilities).

One program per subgrid. The prologue tapers the subgrid, applies the Jones
terms A1·P·A2ᴴ (ops/common.py: prepare_degridder_pixels) and the n^r
weights once. Then, for each tile of V = tile_t·C visibilities, it builds
conj Φx, conj Φy in registers, contracts y on the tensor cores
(R_p[v, x] = Σ_y conj Φy[v, y]·Q_{r,p}[y, x], a K = N dot) and x on the
CUDA cores (Σ_x conj Φx[v, x]·R_p[v, x]), and stores the tile.

xla_v4 (ops/xla/separable.py) writes R to device memory for every subgrid
and rank and reads it back; here only the subgrids are read and only the
visibilities are written.
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
from ..complexpair import Pair
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
# the sweep on the card (PERF.md).
TILE_V = 64
NUM_WARPS = 4


def _kernel(meta_ref, pos_ref, sre_ref, sim_ref, uvw_ref, k_ref, l_ref,
            m_ref, n_ref, sph_ref, are_ref, aim_ref, ore_ref, oim_ref, *,
            nr_timesteps: int, tile_t: int, w_rank: int, precision):
    nr_pols = sre_ref.shape[0]
    off = meta_ref[0]
    k, l, m = k_ref[...], l_ref[...], m_ref[...]
    po_x, po_y, w_off = pos_ref[0, :], pos_ref[1, :], pos_ref[2, 0]
    c = k.shape[0]
    t_iota = jnp.arange(tile_t, dtype=jnp.int32)
    dot = functools.partial(pl.dot, precision=precision)

    sph = sph_ref[...]
    pix = [(sre_ref[p, :, :] * sph, sim_ref[p, :, :] * sph)
           for p in range(nr_pols)]
    slot = meta_ref[1]
    a1 = load_jones(are_ref, aim_ref, slot, meta_ref[2])
    a2 = load_jones(are_ref, aim_ref, slot, meta_ref[3])
    pix = jones_mul(jones_mul(a1, pix), jones_herm(a2))
    powers = n_powers(n_ref[...], w_rank)
    q = [[(pw * re, pw * im) for re, im in pix] for pw in powers]

    def body(i, carry):
        t0 = i * tile_t
        valid = t0 + t_iota < nr_timesteps
        rows = pl.ds(off + t0, tile_t)
        u, v, w = (load_tile(uvw_ref, valid, rows, j) for j in range(3))
        (cx, sx), (cy, sy), mu = axis_phasors(
            u, v, w, k, l, m, po_x, po_y, w_off)
        coefs = rank_coefficients(mu, w_rank)
        out_rows = pl.ds(t0, tile_t)
        for p in range(nr_pols):
            vis_re = vis_im = jnp.zeros_like(mu)
            for r, (cr, ci) in enumerate(coefs):
                qr, qi = q[r][p]
                rr = dot(cy, qr) + dot(sy, qi)          # conj Φy · Q  [V, N(x)]
                ri = dot(cy, qi) - dot(sy, qr)
                gr = jnp.sum(cx * rr + sx * ri, axis=1)  # conj Φx · R  [V]
                gi = jnp.sum(cx * ri - sx * rr, axis=1)
                vis_re = vis_re + gr * cr + gi * ci      # · conj (iμ)^r/r!
                vis_im = vis_im + gi * cr - gr * ci
            ore_ref[out_rows, :, p] = vis_re.reshape(tile_t, c)
            oim_ref[out_rows, :, p] = vis_im.reshape(tile_t, c)
        return carry

    lax.fori_loop(0, -(-nr_timesteps // tile_t), body, 0)


@register(
    "degridder",
    "pallas_triton",
    "one program per subgrid, Jones + taper prologue, separable phasor in "
    "registers, TF32x3 dots (Pallas, Triton route)",
    family="pallas",
)
def degridder_pallas_triton(params: IDGParams, sobs: SplitObservation,
                            subgrids: Pair, w_rank: int = 1,
                            precision=TF32_X3, interpret: bool = False):
    """Visibilities pair f32[S, T, C, P] (see gridder_pallas_triton for
    `w_rank` and `precision`)."""
    check_shapes(params)
    md = sobs.metadata
    s_count = md.time_offset.shape[0]
    t, c = params.nr_timesteps_subgrid, params.nr_channels
    nr_pols = params.nr_correlations
    tile_t = tile_timesteps(params, TILE_V)
    t_pad = -(-t // tile_t) * tile_t
    meta, pos = subgrid_tables(params, md)
    l, m, n = lmn(params)
    sub_shape = subgrids[0].shape[1:]
    args = (meta, pos, subgrids[0], subgrids[1], sobs.uvw.reshape(-1, 3),
            sobs.wavenumbers, l, m, n, sobs.spheroidal, sobs.at_re,
            sobs.at_im)
    in_specs = [subgrid_spec(meta.shape[1:]), subgrid_spec(pos.shape[1:]),
                subgrid_spec(sub_shape), subgrid_spec(sub_shape)]
    in_specs += [full_spec(a.shape) for a in args[4:]]
    out_shape = jax.ShapeDtypeStruct((s_count, t_pad, c, nr_pols), jnp.float32)
    kernel = functools.partial(
        _kernel, nr_timesteps=t, tile_t=tile_t, w_rank=w_rank,
        precision=precision)
    re, im = pl.pallas_call(
        kernel,
        grid=(s_count,),
        in_specs=in_specs,
        out_specs=[subgrid_spec(out_shape.shape[1:])] * 2,
        out_shape=[out_shape, out_shape],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="idg_degridder",
    )(*args)
    if t_pad != t:
        re, im = re[:, :t], im[:, :t]
    return re, im
