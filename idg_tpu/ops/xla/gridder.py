"""XLA-path gridder kernels (pure jax.numpy, compiler-lowered, complex-free).

The compiler-baseline family of the ladder: what XLA achieves without
hand-written kernels. Versions (optimization deltas, mirroring how the
reference documents its ladder app/CUDA/kernels/gridder_v*.cu):

  xla_reference — one subgrid at a time (lax.map, batch 1), full [T,C,N,N]
                  phase materialization. The naive baseline
                  (≈ gridder_reference.cu: 1 thread-block, serial pixels).
  xla_v1        — subgrid-batched (vmap via lax.map batch_size): vectorizes
                  the whole subgrid batch (≈ v1's thread-parallel pixels).
  xla_v2        — MAC restructured as [N², T·C] × [T·C, P] real matrix
                  products so the accumulation is a dense dot (≈ v3's
                  register FMA restructuring).
  xla_v3        — channel-recurrence phasor: sincos only at channel 0 plus a
                  per-(pixel,time) delta; channels advance by one complex
                  multiply (gridder_v8.cu:135-186 idea), assuming uniform
                  channel spacing (true of init.cpp:27-36 frequencies).

All data is split-complex f32 (ops/complexpair.py) and every version uses the
framework-wide exact integer mod-2π phase-offset reduction (ops/common.py).
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
    phase_index,
    phase_offset_exact,
)
from ..complexpair import Pair, ceinsum, cexp_i, cmatmul, cmul
from ..registry import register


def _gridder_mapped(params: IDGParams, sobs: SplitObservation, batch_size: int, body):
    """Shared driver: lax.map `body` over subgrids with the given batching.

    body(uvw_s [T,3], vis_s Pair[T,C,P], po_s [N,N], k, l, m, n) -> Pair[N,N,P]
    (pixels accumulated before Jones/taper).
    """
    md = sobs.metadata
    T = params.nr_timesteps_subgrid
    C, P = params.nr_channels, params.nr_correlations
    uvw_flat = sobs.uvw.reshape(-1, 3)
    vis_re_flat = sobs.vis_re.reshape(-1, C, P)
    vis_im_flat = sobs.vis_im.reshape(-1, C, P)
    k = sobs.wavenumbers
    sph = sobs.spheroidal
    l, m, n = lmn_grids(params.subgrid_size, params.image_size)
    po = phase_offset_exact(params, md)

    def one(args):
        time_offset, po_s, a_idx, st1, st2 = args
        uvw_s = gather_time(uvw_flat, time_offset[None], T)[0]
        vis_s = (
            gather_time(vis_re_flat, time_offset[None], T)[0],
            gather_time(vis_im_flat, time_offset[None], T)[0],
        )
        pixels = body(uvw_s, vis_s, po_s, k, l, m, n)
        a1 = (sobs.at_re[a_idx, st1], sobs.at_im[a_idx, st1])
        a2 = (sobs.at_re[a_idx, st2], sobs.at_im[a_idx, st2])
        return finish_gridder(pixels, a1, a2, sph)

    xs = (md.time_offset, po, md.aterm_index, md.station1, md.station2)
    re, im = lax.map(one, xs, batch_size=batch_size)
    return re, im


def _phasor(uvw_s, po_s, k, l, m, n) -> Pair:
    """Full phasor e^{i(po − pi·k)} as a [T,C,N,N] pair."""
    pi = phase_index(uvw_s, l, m, n)                       # [T,N,N]
    phase = po_s[None, None] - pi[:, None] * k[None, :, None, None]
    return cexp_i(phase)


def _body_full_phase(uvw_s, vis_s, po_s, k, l, m, n) -> Pair:
    """Materialize the [T,C,N,N] phasor, contract (the naive formulation)."""
    phasor = _phasor(uvw_s, po_s, k, l, m, n)
    return ceinsum("tcyx,tcp->yxp", phasor, vis_s)


def _body_mxu(uvw_s, vis_s, po_s, k, l, m, n) -> Pair:
    """MAC as [N², T·C] × [T·C, P] real matrix products."""
    N = po_s.shape[-1]
    P = vis_s[0].shape[-1]
    phasor = _phasor(uvw_s, po_s, k, l, m, n)
    phasor_mat = tuple(p.reshape(-1, N * N).T for p in phasor)   # [N², T·C]
    vis_mat = tuple(v.reshape(-1, P) for v in vis_s)             # [T·C, P]
    pixels = cmatmul(phasor_mat, vis_mat)
    return tuple(p.reshape(N, N, P) for p in pixels)


def _body_channel_recurrence(uvw_s, vis_s, po_s, k, l, m, n) -> Pair:
    """sincos twice per (pixel,time); channels advance by complex multiply."""
    pi = phase_index(uvw_s, l, m, n)                       # [T,N,N]
    phasor0 = cexp_i(po_s[None] - pi * k[0])
    dk = k[1] - k[0] if k.shape[0] > 1 else jnp.float32(0.0)
    delta = cexp_i(-pi * dk)

    def chan_step(carry, vis_c):
        (acc_re, acc_im), phasor = carry
        upd = ceinsum("tyx,tp->yxp", phasor, vis_c)
        acc = (acc_re + upd[0], acc_im + upd[1])
        return (acc, cmul(phasor, delta)), None

    P = vis_s[0].shape[-1]
    acc0 = (
        jnp.zeros((*po_s.shape, P), jnp.float32),
        jnp.zeros((*po_s.shape, P), jnp.float32),
    )
    vis_by_chan = tuple(jnp.moveaxis(v, 1, 0) for v in vis_s)    # [C,T,P]
    (pixels, _), _ = lax.scan(chan_step, (acc0, phasor0), vis_by_chan)
    return pixels


@register(
    "gridder",
    "xla_reference",
    "naive: one subgrid at a time, full phase materialization",
    family="xla",
)
def gridder_xla_reference(params: IDGParams, sobs: SplitObservation):
    return _gridder_mapped(params, sobs, 1, _body_full_phase)


@register(
    "gridder",
    "xla_v1",
    "subgrid-batched vectorization (vmap over subgrid chunks)",
    family="xla",
)
def gridder_xla_v1(params: IDGParams, sobs: SplitObservation, batch_size: int = 16):
    return _gridder_mapped(params, sobs, batch_size, _body_full_phase)


@register(
    "gridder",
    "xla_v2",
    "MAC as [N²,TC]×[TC,P] real matrix products",
    family="xla",
)
def gridder_xla_v2(params: IDGParams, sobs: SplitObservation, batch_size: int = 16):
    return _gridder_mapped(params, sobs, batch_size, _body_mxu)


@register(
    "gridder",
    "xla_v3",
    "channel-recurrence phasor (2 sincos per pixel-time, complex-mul per channel)",
    family="xla", uniform_channels=True, fallback="xla_v2",
)
def gridder_xla_v3(params: IDGParams, sobs: SplitObservation, batch_size: int = 16):
    # Assumes uniform channel spacing, exactly like the reference's v8
    # (gridder_v8.cu computes one per-channel delta phase); init.cpp:27-36
    # frequencies always are. The API boundary (ops/api.py:_guard_channels)
    # checks the assumption and falls back to xla_v2 when it is violated.
    return _gridder_mapped(params, sobs, batch_size, _body_channel_recurrence)
