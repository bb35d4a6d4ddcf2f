"""Shared pieces of the Pallas (Triton route) gridder and degridder.

Both kernels run one program per subgrid — the reference's "one thread
block per subgrid" (SURVEY.md §2.4) — and loop over the subgrid's
visibilities in tiles of `tile_t` timesteps × all channels. Each program
loads its own metadata row (time offset, a-term slot, stations) and reads
uvw and visibilities straight from the flat [rows, ...] arrays at that
offset, so nothing is gathered or re-laid-out in device memory first.

The phasor is the separable form of ops/xla/separable.py: with channels
folded into uvw (u' = u·k_c), e^{i·phase} = Φx[v,x]·Φy[v,y]·e^{iμ_v·n[y,x]},
and the last factor is a rank-`w_rank` Taylor sum whose n^r weights are
applied once per subgrid, outside the visibility loop.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from ...config import IDGParams
from ..common import lmn_grids, phase_offset_parts, w_offset_scalar

# The card's dot algorithm: three TF32 tensor-core products per dot (split
# hi/lo operands), accurate to about f32. One TF32 or bf16 pass misses the
# 1e-5 gate. Interpret mode on the CPU cannot run this preset, so CPU
# callers pass lax.Precision.HIGHEST.
TF32_X3 = lax.DotAlgorithmPreset.TF32_TF32_F32_X3

def is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def check_shapes(params: IDGParams) -> None:
    """The Triton route needs power-of-two tensors of at least 16 along
    every dot dimension."""
    n, c = params.subgrid_size, params.nr_channels
    if not is_pow2(n) or n < 16:
        raise ValueError(f"pallas kernels need a power-of-two subgrid size "
                         f">= 16 (got {n})")
    if not is_pow2(c):
        raise ValueError(f"pallas kernels need a power-of-two channel count "
                         f"(got {c})")
    if params.nr_correlations != 4:
        raise ValueError("pallas kernels need 4 correlations")


def tile_timesteps(params: IDGParams, tile_v: int) -> int:
    """Timesteps per loop tile: tile_v visibilities, at least one
    timestep (all channels)."""
    return max(tile_v // params.nr_channels, 1)


def full_spec(shape):
    """Whole-array block: the kernel indexes it itself."""
    return pl.BlockSpec(tuple(shape), lambda s: (0,) * len(shape))


def subgrid_spec(shape):
    """One row of a per-subgrid [S, ...] array per program."""
    return pl.BlockSpec((None, *shape), lambda s: (s,) + (0,) * len(shape))


def subgrid_tables(params: IDGParams, md):
    """Per-subgrid rows each program loads itself.

    meta i32[S, 4]: time_offset, aterm_index, station1, station2.
    pos  f32[S, 3, N]: the exact mod-2π phase-offset parts po_x, po_y, and
    the w-plane offset w_off (broadcast along the row)."""
    meta = jnp.stack([
        md.time_offset.astype(jnp.int32), md.aterm_index.astype(jnp.int32),
        md.station1.astype(jnp.int32), md.station2.astype(jnp.int32),
    ], axis=-1)
    po_x, po_y = phase_offset_parts(params, md)
    w_off = w_offset_scalar(params, md)
    pos = jnp.stack([po_x, po_y, jnp.broadcast_to(w_off[:, None], po_x.shape)],
                    axis=1).astype(jnp.float32)
    return meta, pos


def lmn(params: IDGParams):
    l, m, n = lmn_grids(params.subgrid_size, params.image_size)
    return l, m, n


def load_tile(ref, valid, *idx):
    """Masked load of ref[idx] whose leading index is a tile of timestep
    rows; rows past the subgrid's last timestep (`valid` False) read 0."""
    from jax.experimental.pallas import triton as plgpu

    view = ref.at[idx]
    mask = jnp.broadcast_to(
        valid.reshape(valid.shape + (1,) * (len(view.shape) - 1)), view.shape)
    return plgpu.load(view, mask=mask, other=0.0)


def axis_phasors(u, v, w, k, l, m, po_x, po_y, w_off, x_major=False):
    """Φx, Φy as (cos, sin) and μ[V] for one tile of V = Tt·C visibilities.

    u, v, w: [Tt]; k: [C]; channels fold into v = t·C + c. Φy is [V, N];
    Φx is [V, N], or [N, V] with `x_major` (the gridder contracts V with
    Φx on the left of its dots, and building it in that orientation keeps
    a transpose out of the loop)."""
    tv = u.shape[0] * k.shape[0]
    up = (u[:, None] * k[None, :]).reshape(tv)
    vp = (v[:, None] * k[None, :]).reshape(tv)
    wp = (w[:, None] * k[None, :]).reshape(tv)
    if x_major:
        phx = po_x[:, None] - l[:, None] * up[None, :]
    else:
        phx = po_x[None, :] - up[:, None] * l[None, :]
    phy = po_y[None, :] - vp[:, None] * m[None, :]
    return (jnp.cos(phx), jnp.sin(phx)), (jnp.cos(phy), jnp.sin(phy)), w_off - wp


def rank_coefficients(mu, w_rank: int):
    """(iμ)^r / r! for r < w_rank as (re, im) pairs."""
    coefs = [(jnp.ones_like(mu), jnp.zeros_like(mu))]
    re, im = coefs[0]
    for r in range(1, w_rank):
        re, im = (-im * mu / r, re * mu / r)
        coefs.append((re, im))
    return coefs


def n_powers(n, w_rank: int):
    powers = [jnp.ones_like(n)]
    for _ in range(1, w_rank):
        powers.append(powers[-1] * n)
    return powers


# ---- 2×2 Jones algebra on lists of 4 (re, im) tiles (xx, xy, yx, yy) ----

def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def jones_mul(a, b):
    """C = A·B (app/common/math.hpp:26-36)."""
    return [
        _cadd(_cmul(a[0], b[0]), _cmul(a[1], b[2])),
        _cadd(_cmul(a[0], b[1]), _cmul(a[1], b[3])),
        _cadd(_cmul(a[2], b[0]), _cmul(a[3], b[2])),
        _cadd(_cmul(a[2], b[1]), _cmul(a[3], b[3])),
    ]


def jones_herm(a):
    """Aᴴ (math.hpp:57-62)."""
    return [(a[q][0], -a[q][1]) for q in (0, 2, 1, 3)]


def load_jones(are_ref, aim_ref, slot, station):
    """The four [N, N] correlation planes of one station's a-term."""
    return [(are_ref[slot, station, :, :, q], aim_ref[slot, station, :, :, q])
            for q in range(4)]


__all__ = [
    "TF32_X3", "axis_phasors", "check_shapes", "full_spec",
    "jones_herm", "jones_mul", "lmn", "load_jones", "load_tile", "n_powers",
    "rank_coefficients", "subgrid_spec", "subgrid_tables", "tile_timesteps",
]
