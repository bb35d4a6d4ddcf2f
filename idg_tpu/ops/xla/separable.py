"""Separable-phasor kernels (xla_v4) — the math restructured for dots.

The reference's ladder tops out at a phasor *recurrence* (gridder_v8.cu:
135-186): sincos twice per (pixel, time), a complex multiply per channel —
still O(V·N²) elementwise work for V = T·C effective visibilities. This
family restructures the math so the work becomes dense dots:

  phase[v, y, x] = po_x[x] + po_y[y] + μ_v·n[y,x] − u'_v·l[x] − v'_v·m[y]

with u' = u·k_c, v' = v·k_c (channels folded into uvw: each channel is a
rescaled uvw sample), μ_v = w_off − w·k_c, and po split exactly per axis
(ops/common.py: phase_offset_parts). Therefore

  phasor = Φx[v,x] · Φy[v,y] · e^{iμ_v·n[y,x]},

where only the LAST factor is non-separable — and its argument is tiny
(|μ·n| ≲ 1e-3 rad at reference scales since n ≤ (image_size/2)²), so a
w_rank-term Taylor expansion e^{iμn} = Σ_r (iμ)^r n^r / r! makes the whole
phasor a sum of w_rank separable terms. The gridder MAC then factors as

  pixels[x, y, p] = Σ_r n^r[y,x] ⊙ ( Φxᵀ[x, v] @ (Φy[v,y] ⊛ ṽ_r[v,p]) )

— a dense [N, V] × [V, N·P] matmul per rank plus O(V·N) sincos
instead of O(V·N²) sincos. The degridder is the exact adjoint: a
[V, N] × [N, N·P] matmul per rank then an O(V·N·P) contraction with Φx*.

Error budget: rank-r truncation error ≤ |μn|^r / r!; at the reference's
w = 0 data every rank is exact, so the default is rank 1, and the API guard
(ops/api.py) raises the rank until the bound is inside W_TAYLOR_TOL (rank 2
holds the general small-w case to ≲1e-6, well inside the 1e-5 comparator
gate, tests/test_util.hpp:84).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ...config import IDGParams
from ...types import SplitObservation
from ..common import (
    finish_gridder,
    gather_time,
    lmn_grids,
    n_powers,
    phase_offset_parts,
    prepare_degridder_pixels,
    w_offset_scalar,
)
from ..complexpair import Pair, cexp_i, cmatmul
from ..registry import register

# Exact for w ≡ 0; the API guard raises it for the observation's w range —
# the same default as the Pallas kernels, so the two run the same rank.
DEFAULT_W_RANK = 1


def _rank_coefficients(mu, w_rank: int):
    """[(re, im)] per rank r: (iμ)^r / r! as split scalars over v."""
    coefs = [(jnp.ones_like(mu), jnp.zeros_like(mu))]
    re, im = coefs[0]
    for r in range(1, w_rank):
        # multiply by iμ/r:  (re + i·im)·(iμ/r) = (−im·μ/r, re·μ/r)
        re, im = (-im * mu / r, re * mu / r)
        coefs.append((re, im))
    return coefs


def _axis_phasors(uvw_s, k, po_x, po_y, l, m):
    """Φx[v, x], Φy[v, y] pairs + μ[v] for one subgrid.

    uvw_s f32[T,3]; po_x/po_y f32[N]; returns V = T·C rows.
    """
    u_s = (uvw_s[:, 0, None] * k).reshape(-1)   # [V]
    v_s = (uvw_s[:, 1, None] * k).reshape(-1)
    w_s = (uvw_s[:, 2, None] * k).reshape(-1)
    phix = cexp_i(po_x[None, :] - u_s[:, None] * l[None, :])   # [V, N]
    phiy = cexp_i(po_y[None, :] - v_s[:, None] * m[None, :])
    return phix, phiy, w_s


def _gridder_subgrid(uvw_s, vis_s, po_x, po_y, w_off, k, l, m, n,
                     w_rank: int, precision):
    """Accumulated pixels pair [N(y), N(x), P] for one subgrid."""
    N = l.shape[0]
    P = vis_s[0].shape[-1]
    phix, phiy, w_scaled = _axis_phasors(uvw_s, k, po_x, po_y, l, m)
    mu = w_off - w_scaled                                # [V]
    vis_flat = tuple(v.reshape(-1, P) for v in vis_s)    # [V, P]
    lhs = (phix[0].T, phix[1].T)                         # [N(x), V]
    powers = n_powers(n, w_rank)                         # each [N(y), N(x)]

    pix_re = jnp.zeros((N, N, P), jnp.float32)           # [y, x, p]
    pix_im = jnp.zeros((N, N, P), jnp.float32)
    for r, (cr, ci) in enumerate(_rank_coefficients(mu, w_rank)):
        vr = (
            vis_flat[0] * cr[:, None] - vis_flat[1] * ci[:, None],
            vis_flat[0] * ci[:, None] + vis_flat[1] * cr[:, None],
        )
        # W[v, y, p] = Φy[v,y] ⊛ ṽ_r[v,p]  (complex outer over (y,p))
        w_re = phiy[0][:, :, None] * vr[0][:, None, :] - phiy[1][:, :, None] * vr[1][:, None, :]
        w_im = phiy[0][:, :, None] * vr[1][:, None, :] + phiy[1][:, :, None] * vr[0][:, None, :]
        rhs = (w_re.reshape(-1, N * P), w_im.reshape(-1, N * P))
        out = cmatmul(lhs, rhs, precision=precision)     # [x, y·p]
        out = tuple(o.reshape(N, N, P).swapaxes(0, 1) for o in out)  # [y, x, p]
        npow = powers[r][:, :, None]
        pix_re = pix_re + out[0] * npow
        pix_im = pix_im + out[1] * npow
    return pix_re, pix_im


def _degridder_subgrid(uvw_s, pixels, po_x, po_y, w_off, k, l, m, n,
                       w_rank: int, precision):
    """Visibilities pair [T, C, P] for one subgrid (adjoint direction).

    pixels: prepared (tapered+Jones) pair [N(y), N(x), P]. Degridder phase is
    the conjugate of the gridder phase (degridder_reference.cpp:107-113).
    """
    N = l.shape[0]
    P = pixels[0].shape[-1]
    T = uvw_s.shape[0]
    C = k.shape[0]
    phix, phiy, w_scaled = _axis_phasors(uvw_s, k, po_x, po_y, l, m)
    mu = w_off - w_scaled
    powers = n_powers(n, w_rank)

    vis_re = jnp.zeros((T * C, P), jnp.float32)
    vis_im = jnp.zeros((T * C, P), jnp.float32)
    phiy_conj = (phiy[0], -phiy[1])                      # [V, N(y)]
    for r, (cr, ci) in enumerate(_rank_coefficients(mu, w_rank)):
        # conj coefficient: (−iμ)^r/r! = conj((iμ)^r/r!)
        cr_c, ci_c = cr, -ci
        p_r = tuple((p * powers[r][:, :, None]).reshape(N, N * P) for p in pixels)
        # R[v, x·p] = Σ_y conj(Φy)[v,y] · (n^r ⊙ pixels)[y, x·p]
        rr = cmatmul(phiy_conj, p_r, precision=precision)   # [V, N(x)·P]
        rr = tuple(x.reshape(-1, N, P) for x in rr)         # [V, x, p]
        # vis_r[v, p] = Σ_x conj(Φx)[v,x] · R[v,x,p]   (elementwise contraction)
        vr_re = jnp.sum(phix[0][:, :, None] * rr[0] + phix[1][:, :, None] * rr[1], axis=1)
        vr_im = jnp.sum(phix[0][:, :, None] * rr[1] - phix[1][:, :, None] * rr[0], axis=1)
        vis_re = vis_re + vr_re * cr_c[:, None] - vr_im * ci_c[:, None]
        vis_im = vis_im + vr_re * ci_c[:, None] + vr_im * cr_c[:, None]
    return vis_re.reshape(T, C, P), vis_im.reshape(T, C, P)


@register(
    "gridder",
    "xla_v4",
    "separable phasor Φx·Φy + rank-w Taylor: [N,V]×[V,N·P] matmuls, O(V·N) sincos",
    family="xla",
)
def gridder_xla_v4(
    params: IDGParams,
    sobs: SplitObservation,
    batch_size: int = 32,
    w_rank: int = DEFAULT_W_RANK,
    precision: str = "highest",
):
    md = sobs.metadata
    T = params.nr_timesteps_subgrid
    C, P = params.nr_channels, params.nr_correlations
    uvw_flat = sobs.uvw.reshape(-1, 3)
    vis_re_flat = sobs.vis_re.reshape(-1, C, P)
    vis_im_flat = sobs.vis_im.reshape(-1, C, P)
    k = sobs.wavenumbers
    sph = sobs.spheroidal
    l, m, n = lmn_grids(params.subgrid_size, params.image_size)
    po_x, po_y = phase_offset_parts(params, md)
    w_off = w_offset_scalar(params, md)

    def one(args):
        time_offset, pox_s, poy_s, woff_s, a_idx, st1, st2 = args
        uvw_s = gather_time(uvw_flat, time_offset[None], T)[0]
        vis_s = (
            gather_time(vis_re_flat, time_offset[None], T)[0],
            gather_time(vis_im_flat, time_offset[None], T)[0],
        )
        pixels = _gridder_subgrid(
            uvw_s, vis_s, pox_s, poy_s, woff_s, k, l, m, n,
            w_rank, precision,
        )
        a1 = (sobs.at_re[a_idx, st1], sobs.at_im[a_idx, st1])
        a2 = (sobs.at_re[a_idx, st2], sobs.at_im[a_idx, st2])
        return finish_gridder(pixels, a1, a2, sph)

    xs = (md.time_offset, po_x, po_y, w_off, md.aterm_index, md.station1, md.station2)
    return lax.map(one, xs, batch_size=batch_size)


@register(
    "degridder",
    "xla_v4",
    "separable phasor adjoint: [V,N]×[N,N·P] matmuls, O(V·N) sincos",
    family="xla",
)
def degridder_xla_v4(
    params: IDGParams,
    sobs: SplitObservation,
    subgrids: Pair,
    batch_size: int = 32,
    w_rank: int = DEFAULT_W_RANK,
    precision: str = "highest",
):
    md = sobs.metadata
    T = params.nr_timesteps_subgrid
    uvw_flat = sobs.uvw.reshape(-1, 3)
    k = sobs.wavenumbers
    sph = sobs.spheroidal
    l, m, n = lmn_grids(params.subgrid_size, params.image_size)
    po_x, po_y = phase_offset_parts(params, md)
    w_off = w_offset_scalar(params, md)

    def one(args):
        time_offset, pox_s, poy_s, woff_s, a_idx, st1, st2, sub_re, sub_im = args
        uvw_s = gather_time(uvw_flat, time_offset[None], T)[0]
        a1 = (sobs.at_re[a_idx, st1], sobs.at_im[a_idx, st1])
        a2 = (sobs.at_re[a_idx, st2], sobs.at_im[a_idx, st2])
        pixels = prepare_degridder_pixels((sub_re, sub_im), a1, a2, sph)
        return _degridder_subgrid(
            uvw_s, pixels, pox_s, poy_s, woff_s, k, l, m, n,
            w_rank, precision,
        )

    xs = (
        md.time_offset, po_x, po_y, w_off,
        md.aterm_index, md.station1, md.station2,
        subgrids[0], subgrids[1],
    )
    return lax.map(one, xs, batch_size=batch_size)
