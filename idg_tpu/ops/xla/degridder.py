"""XLA-path degridder kernels (pure jax.numpy, complex-free).

Mirrors the gridder family; the degridder is the adjoint direction
(subgrid pixels → predicted visibilities, degridder_reference.cpp:6-129):

  xla_reference — one subgrid at a time, full phase materialization.
  xla_v1        — subgrid-batched.
  xla_v2        — sum-over-pixels as [T·C, N²] × [N², P] real matrix products.
  xla_v3        — channel-recurrence phasor (assumes uniform channel spacing).

Degridder phase sign: phase = phase_index·k − phase_offset
(degridder_reference.cpp:107-113) = −(gridder phase).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ...config import IDGParams
from ...types import SplitObservation
from ..common import (
    gather_time,
    lmn_grids,
    phase_index,
    phase_offset_exact,
    prepare_degridder_pixels,
)
from ..complexpair import Pair, ceinsum, cexp_i, cmatmul, cmul
from ..registry import register


def _degridder_mapped(params, sobs: SplitObservation, subgrids: Pair, batch_size, body):
    md = sobs.metadata
    T = params.nr_timesteps_subgrid
    uvw_flat = sobs.uvw.reshape(-1, 3)
    k = sobs.wavenumbers
    sph = sobs.spheroidal
    l, m, n = lmn_grids(params.subgrid_size, params.image_size)
    po = phase_offset_exact(params, md)

    def one(args):
        time_offset, po_s, a_idx, st1, st2, sub_re, sub_im = args
        uvw_s = gather_time(uvw_flat, time_offset[None], T)[0]
        a1 = (sobs.at_re[a_idx, st1], sobs.at_im[a_idx, st1])
        a2 = (sobs.at_re[a_idx, st2], sobs.at_im[a_idx, st2])
        pixels = prepare_degridder_pixels((sub_re, sub_im), a1, a2, sph)  # [N,N,P]
        return body(uvw_s, pixels, po_s, k, l, m, n)

    xs = (
        md.time_offset,
        po,
        md.aterm_index,
        md.station1,
        md.station2,
        subgrids[0],
        subgrids[1],
    )
    re, im = lax.map(one, xs, batch_size=batch_size)
    return re, im


def _phasor(uvw_s, po_s, k, l, m, n) -> Pair:
    """Degridder phasor e^{i(pi·k − po)} as a [T,C,N,N] pair."""
    pi = phase_index(uvw_s, l, m, n)
    phase = pi[:, None] * k[None, :, None, None] - po_s[None, None]
    return cexp_i(phase)


def _body_full_phase(uvw_s, pixels, po_s, k, l, m, n) -> Pair:
    phasor = _phasor(uvw_s, po_s, k, l, m, n)
    return ceinsum("tcyx,yxp->tcp", phasor, pixels)


def _body_mxu(uvw_s, pixels, po_s, k, l, m, n) -> Pair:
    N = po_s.shape[-1]
    T = uvw_s.shape[0]
    C = k.shape[0]
    P = pixels[0].shape[-1]
    phasor = _phasor(uvw_s, po_s, k, l, m, n)
    phasor_mat = tuple(p.reshape(-1, N * N) for p in phasor)   # [T·C, N²]
    pix_mat = tuple(p.reshape(N * N, P) for p in pixels)       # [N², P]
    vis = cmatmul(phasor_mat, pix_mat)
    return tuple(v.reshape(T, C, P) for v in vis)


def _body_channel_recurrence(uvw_s, pixels, po_s, k, l, m, n) -> Pair:
    pi = phase_index(uvw_s, l, m, n)
    phasor0 = cexp_i(pi * k[0] - po_s[None])
    dk = k[1] - k[0] if k.shape[0] > 1 else jnp.float32(0.0)
    delta = cexp_i(pi * dk)

    def chan_step(phasor, _):
        vis_c = ceinsum("tyx,yxp->tp", phasor, pixels)
        return cmul(phasor, delta), vis_c

    _, (vis_re, vis_im) = lax.scan(chan_step, phasor0, None, length=k.shape[0])
    return jnp.moveaxis(vis_re, 0, 1), jnp.moveaxis(vis_im, 0, 1)  # [T,C,P]


@register(
    "degridder",
    "xla_reference",
    "naive: one subgrid at a time, full phase materialization",
    family="xla",
)
def degridder_xla_reference(params: IDGParams, sobs: SplitObservation, subgrids: Pair):
    return _degridder_mapped(params, sobs, subgrids, 1, _body_full_phase)


@register("degridder", "xla_v1", "subgrid-batched vectorization", family="xla")
def degridder_xla_v1(
    params: IDGParams, sobs: SplitObservation, subgrids: Pair, batch_size: int = 16
):
    return _degridder_mapped(params, sobs, subgrids, batch_size, _body_full_phase)


@register(
    "degridder",
    "xla_v2",
    "pixel sum as [TC,N²]×[N²,P] real matrix products",
    family="xla",
)
def degridder_xla_v2(
    params: IDGParams, sobs: SplitObservation, subgrids: Pair, batch_size: int = 16
):
    return _degridder_mapped(params, sobs, subgrids, batch_size, _body_mxu)


@register(
    "degridder",
    "xla_v3",
    "channel-recurrence phasor (2 sincos per pixel-time)",
    family="xla", uniform_channels=True, fallback="xla_v2",
)
def degridder_xla_v3(
    params: IDGParams, sobs: SplitObservation, subgrids: Pair, batch_size: int = 16
):
    # Uniform channel spacing assumed (reference v8-style recurrence); the
    # API boundary falls back to xla_v2 when violated (ops/api.py).
    return _degridder_mapped(params, sobs, subgrids, batch_size, _body_channel_recurrence)
