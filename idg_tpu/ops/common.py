"""Shared device-kernel math (jax.numpy, complex-free).

The analogue of the reference's device math header (app/CUDA/math.cuh,
app/common/math.hpp): l/m/n grids, per-subgrid uv offsets, time-axis gathers
driven by metadata, and Jones/taper staging — all on split-complex (re, im)
f32 pairs (see ops/complexpair.py for why).

Numerical design (differs from the reference on purpose):
the phase split  phase = phase_offset − phase_index·k  has a large
subgrid-constant part: phase_offset = u_off·l + v_off·m + w_off·n can reach
~1.6e3 radians, which costs ~1e-4 rad of f32 sincos accuracy. But
  u_off·l_x = 2π · ix · (x + 0.5 − N/2) / N,   ix = coord_x + N/2 − G/2 ∈ ℤ
so (for the w=0 part) phase_offset mod 2π is EXACTLY
  π · ((ix·(2x−N+1) + iy·(2y−N+1)) mod 2N) / N.
We reduce it in integer arithmetic and keep every f32 sincos argument small
(|phase_index·k| ≲ 35 rad at reference scales), making our f32 kernels *more*
accurate than the reference's GPU kernels (which pay the full-magnitude f32
sincos error and rely on the CPU oracle making the same correlated error).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import IDGParams
from ..types import Metadata
from .complexpair import Pair, apply_aterm_degridder, apply_aterm_gridder, cscale

TWO_PI = 2.0 * jnp.pi


def lmn_grids(subgrid_size: int, image_size: float):
    """l[N] (x axis), m[N] (y axis), n[N(y), N(x)] in f32 (math.hpp:9-24)."""
    xy = jnp.arange(subgrid_size, dtype=jnp.float32)
    l = (xy + jnp.float32(0.5) - subgrid_size // 2) * jnp.float32(
        image_size / subgrid_size
    )
    m = l
    tmp = l[None, :] ** 2 + m[:, None] ** 2
    n = jnp.where(
        tmp > 1.0, 1.0, tmp / (1.0 + jnp.sqrt(jnp.maximum(0.0, 1.0 - tmp)))
    ).astype(jnp.float32)
    return l, m, n


def phase_offset_exact(params: IDGParams, metadata: Metadata):
    """Subgrid-constant phase offset, reduced mod 2π exactly.

    Returns f32[S, N, N] (y, x). Covers the u/v part via integer arithmetic;
    the w part (zero at the reference's W_STEP=0) is added in f32 after its
    own mod-2π reduction.
    """
    N, G = params.subgrid_size, params.grid_size
    ix = metadata.coord_x.astype(jnp.int32) + (N // 2 - G // 2)
    iy = metadata.coord_y.astype(jnp.int32) + (N // 2 - G // 2)
    span = 2 * jnp.arange(N, dtype=jnp.int32) - (N - 1)  # 2x − N + 1
    q = ix[:, None, None] * span[None, None, :] + iy[:, None, None] * span[None, :, None]
    q = jnp.remainder(q, 2 * N)
    po = q.astype(jnp.float32) * jnp.float32(jnp.pi / N)
    if params.w_step != 0.0:
        # w part added un-reduced: reducing w_off mod 2π BEFORE multiplying
        # by the non-integer n would shift the phase by 2πk·n ≢ 0 (mod 2π).
        # |w_off·n| is small at IDG scales (n ≤ (image_size/2)²), so the f32
        # product loses no meaningful accuracy.
        _, _, n = lmn_grids(N, params.image_size)
        w_off = TWO_PI * params.w_step * (metadata.coord_z.astype(jnp.float32) + 0.5)
        po = po + w_off[:, None, None] * n[None, :, :]
    return po


def gather_time(flat, time_offset, nr_timesteps: int):
    """[S, T, ...] gather of a flat time axis via metadata offsets.

    Matches the reference's ``uvw[time_offset + time]`` indexing
    (gridder_reference.cpp:55-58); a pure reshape in the standard layout.
    """
    idx = time_offset[:, None].astype(jnp.int32) + jnp.arange(
        nr_timesteps, dtype=jnp.int32
    )
    return jnp.take(flat, idx, axis=0)


def phase_index(uvw, l, m, n):
    """phase_index[..., T, N, N] = u·l + v·m + w·n from uvw[..., T, 3]
    (gridder_reference.cpp:61)."""
    return (
        uvw[..., 0, None, None] * l[None, None, :]
        + uvw[..., 1, None, None] * m[None, :, None]
        + uvw[..., 2, None, None] * n[None, :, :]
    )


def finish_gridder(pixels: Pair, a1: Pair, a2: Pair, spheroidal) -> Pair:
    """Jones correction + spheroidal taper on accumulated pixels.

    pixels/a1/a2: pairs of f32[..., N, N, 4]; spheroidal f32[N, N].
    Returns pair of f32[..., 4, N, N] (reference subgrid layout, pol-major).
    """
    corrected = apply_aterm_gridder(pixels, a1, a2)
    corrected = cscale(corrected, spheroidal[..., :, :, None])
    return tuple(jnp.moveaxis(c, -1, -3) for c in corrected)


def prepare_degridder_pixels(subgrids: Pair, a1: Pair, a2: Pair, spheroidal) -> Pair:
    """Taper + Jones staging of the degridder input
    (degridder_reference.cpp:35-74). subgrids pair of f32[..., 4, N, N] →
    pixels pair of f32[..., N, N, 4]."""
    pixels = tuple(jnp.moveaxis(s, -3, -1) for s in subgrids)
    pixels = cscale(pixels, spheroidal[..., :, :, None])
    return apply_aterm_degridder(pixels, a1, a2)


def phase_offset_parts(params: IDGParams, metadata: Metadata):
    """Separable split of the exact phase offset: po ≡ po_x[s,x] + po_y[s,y]
    (mod 2π), each part reduced mod 2π in integer arithmetic.

    e^{i·po} = e^{i·po_x}·e^{i·po_y} regardless of where the mod falls, so
    this factorization is exact — the basis of the separable-phasor kernels.
    The w_step part (w_off·n) is NOT included here; it rides in the same
    low-rank n-expansion as the w·k·n phase (see `w_offset_scalar`).
    """
    N, G = params.subgrid_size, params.grid_size
    ix = metadata.coord_x.astype(jnp.int32) + (N // 2 - G // 2)
    iy = metadata.coord_y.astype(jnp.int32) + (N // 2 - G // 2)
    span = 2 * jnp.arange(N, dtype=jnp.int32) - (N - 1)  # 2x − N + 1
    qx = jnp.remainder(ix[:, None] * span[None, :], 2 * N)
    qy = jnp.remainder(iy[:, None] * span[None, :], 2 * N)
    scale = jnp.float32(jnp.pi / N)
    return qx.astype(jnp.float32) * scale, qy.astype(jnp.float32) * scale


def w_offset_scalar(params: IDGParams, metadata: Metadata):
    """Per-subgrid w offset 2π·w_step·(z+0.5) (gridder_reference.cpp:38),
    f32[S]. Zero at the reference's compile-time W_STEP=0."""
    return (
        jnp.float32(TWO_PI * params.w_step)
        * (metadata.coord_z.astype(jnp.float32) + 0.5)
    )


def n_powers(n, w_rank: int):
    """[1, n, n²/…] prefactors for the e^{iμ·n} Taylor ranks (f32[N,N] each).

    Rank r term of the separable kernels: (iμ)^r/r! · n^r; the 1/r! lives in
    the per-visibility coefficient, so powers here are plain n^r.
    """
    powers = [jnp.ones_like(n)]
    for _ in range(1, w_rank):
        powers.append(powers[-1] * n)
    return powers


def uniform_channel_spacing(wavenumbers) -> bool:
    """True if the wavenumbers are uniformly spaced up to f32 quantization
    (host-side check; the synthetic observations always are, init.cpp:27-46).

    A genuinely uniform frequency grid stored in f32 deviates from the ideal
    line by ~1 ulp(k) per point — which the recurrence kernels' 1e-5 gate
    absorbs (phase error ≈ |phase_index|·dev ≲ 1e-6 rad). The check accepts
    deviations up to 4 ulp(max|k|) from the best uniform fit and rejects
    anything larger (real non-uniform spacing)."""
    import numpy as np

    k = np.asarray(wavenumbers, dtype=np.float64).ravel()
    if k.size < 3:
        return True
    c = np.arange(k.size, dtype=np.float64)
    dbar = (k[-1] - k[0]) / (k.size - 1)
    dev = float(np.abs(k - (k[0] + c * dbar)).max())
    ulp = float(np.spacing(np.float32(np.abs(k).max())))
    return dev <= 4.0 * ulp
