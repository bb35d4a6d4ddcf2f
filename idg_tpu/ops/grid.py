"""Grid stage: batched subgrid FFT + subgrid<->grid scatter-add/gather.

The reference benchmark stops at subgrids (the FFT + grid-add lives in
upstream production IDG, not in-tree — see README.md:78-80); BASELINE.json's
north star asks for "batched subgrid FFTs, subgrid→grid scatter-add" as an
extension stage. Design:

- FFT as DFT matmuls on split-complex pairs, with both fftshifts folded
  into the DFT matrices (fft2_shift_pair): subgrids are tiny (N = 32), so
  one [N, N] matmul per axis is the whole transform. Whether batched cuFFT
  beats it on the card is an open measurement (ROADMAP).
- scatter-add / gather with N×N WINDOWS (lax.scatter_add update windows,
  vmapped dynamic_slice) over a wrap-padded grid. On the GPU the scatter
  is one kernel of atomic adds.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .complexpair import Pair


@lru_cache(maxsize=None)
def _dft_factors(n: int, inverse: bool):
    j = np.arange(n)
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * np.outer(j, j) / n)
    if inverse:
        w = w / n
    return (
        np.ascontiguousarray(w.real, dtype=np.float32),
        np.ascontiguousarray(w.imag, dtype=np.float32),
    )


def _dft_pair(n: int, inverse: bool) -> Pair:
    re, im = _dft_factors(n, inverse)
    return jnp.asarray(re), jnp.asarray(im)


def _apply_last_axis(x: Pair, w: Pair) -> Pair:
    """y[..., k] = sum_j x[..., j] · w[j, k] (complex, split)."""
    kw = dict(precision="highest", preferred_element_type=jnp.float32)
    rr = jnp.matmul(x[0], w[0], **kw) - jnp.matmul(x[1], w[1], **kw)
    ii = jnp.matmul(x[0], w[1], **kw) + jnp.matmul(x[1], w[0], **kw)
    return rr, ii


def fft2_pair(x: Pair, inverse: bool = False) -> Pair:
    """2-D DFT over the last two axes of a split-complex pair via matmuls."""
    n_last = x[0].shape[-1]
    n_prev = x[0].shape[-2]
    y = _apply_last_axis(x, _dft_pair(n_last, inverse))
    y = tuple(jnp.swapaxes(v, -1, -2) for v in y)
    y = _apply_last_axis(y, _dft_pair(n_prev, inverse))
    return tuple(jnp.swapaxes(v, -1, -2) for v in y)


@lru_cache(maxsize=None)
def _dft_shift_factors(n: int, inverse: bool):
    """DFT matrix with BOTH fftshifts folded in as index permutations:
    Wf[k, y] = Wdft[σ_out(k), σ_in(y)] with σ_in(y) = (y + n//2) % n
    (the pre-shift) and σ_out(k) = (k − n//2) % n (the post-shift, the
    inverse permutation — identical for even n) — so fftshift2 →
    (i)DFT2 → fftshift2 collapses to two plain matmul passes with Wf
    (each jnp.roll shift pass costs a full read+write of the batch:
    ~5 ms at the default grid stage)."""
    re, im = _dft_factors(n, inverse)
    j = np.arange(n)
    s_in = (j + n // 2) % n
    s_out = (j - n // 2) % n
    # _apply_last_axis contracts x[..., j]·w[j, k]: rows are the INPUT
    # index (pre-shift permutation), columns the OUTPUT (post-shift)
    sel = np.ix_(s_in, s_out)
    return (
        np.ascontiguousarray(re[sel]),
        np.ascontiguousarray(im[sel]),
    )


def fft2_shift_pair(x: Pair, inverse: bool = False) -> Pair:
    """fftshift2_pair → fft2_pair → fftshift2_pair as two matmul passes
    (shift permutations folded into the DFT matrices)."""
    n_last = x[0].shape[-1]
    n_prev = x[0].shape[-2]
    wl = _dft_shift_factors(n_last, inverse)
    wp = _dft_shift_factors(n_prev, inverse)
    y = _apply_last_axis(x, (jnp.asarray(wl[0]), jnp.asarray(wl[1])))
    y = tuple(jnp.swapaxes(v, -1, -2) for v in y)
    y = _apply_last_axis(y, (jnp.asarray(wp[0]), jnp.asarray(wp[1])))
    return tuple(jnp.swapaxes(v, -1, -2) for v in y)


def fftshift2_pair(x: Pair) -> Pair:
    """fftshift over the last two axes (production IDG shifts subgrids
    before the grid add; the cost model's +6 flops/pixel 'shift' term,
    app/common/common.cpp:104)."""
    n1, n0 = x[0].shape[-1], x[0].shape[-2]
    return tuple(
        jnp.roll(v, shift=(n0 // 2, n1 // 2), axis=(-2, -1)) for v in x
    )


def _scatter_add_tiles(tiles, cy, cx, grid_size: int):
    """Windowed scatter-add of [S, P, N, N] tiles at rows cy / cols cx into
    a padded [G+N, G+N] grid per polarization, then fold the wrap margins.

    Coordinates are taken mod G, so every window lands in-bounds of the
    padded grid; the N-wide right/bottom margins are then added onto the
    opposite edges, which is exactly periodic wrap. One single-pol plane
    at a time bounds the transient memory to one padded plane."""
    g = grid_size
    idx = jnp.stack([cy % g, cx % g], axis=-1)       # [S, 2]
    planes = [_scatter_plane(tiles[:, pol], idx, g)
              for pol in range(tiles.shape[1])]
    return jnp.stack(planes)


def _scatter_plane(tiles_p, idx, grid_size: int):
    """One [S, N, N] plane scattered into a wrap-folded [G, G] grid."""
    n = tiles_p.shape[-1]
    g = grid_size
    dn = lax.ScatterDimensionNumbers(
        update_window_dims=(1, 2),
        inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0, 1),
    )
    padded = jnp.zeros((g + n, g + n), tiles_p.dtype)
    padded = lax.scatter_add(
        padded, idx, tiles_p, dn,
        indices_are_sorted=False, unique_indices=False,
    )
    # fold x margin, then y margin (periodic wrap)
    main = padded[:, :g].at[:, :n].add(padded[:, g:])
    return main[:g, :].at[:n, :].add(main[g:, :])


def subgrids_to_grid(
    sub: Pair, coord_x, coord_y, grid_size: int, apply_fft: bool = True,
    grid_in: Pair | None = None,
) -> Pair:
    """Batched subgrid iFFT + scatter-add into a [P, G, G] grid pair.

    sub: pair of f32[S, P, N, N]; coords are the subgrid's top-left grid
    corner (metadata coordinate, app/common/types.hpp:19-26). Tiles that
    overhang the grid edge WRAP periodically — consistent with the grid
    being one period of the FFT image (the synthetic metadata draws coords
    in [0, grid_size), init.cpp:148-150, so edge tiles do overhang).
    With `grid_in`, the tiles are added onto that grid.
    """
    if apply_fft:
        sub = fft2_shift_pair(sub, inverse=True)
    cy = coord_y.astype(jnp.int32)
    cx = coord_x.astype(jnp.int32)
    out = tuple(_scatter_add_tiles(v, cy, cx, grid_size) for v in sub)
    if grid_in is not None:
        out = (out[0] + grid_in[0], out[1] + grid_in[1])
    return out


def grid_to_subgrids(
    grid: Pair, coord_x, coord_y, subgrid_size: int, apply_fft: bool = True
) -> Pair:
    """Gather [S, P, N, N] subgrid tiles from a [P, G, G] grid pair and FFT
    them to image space (the degridding direction's grid stage). Edge tiles
    wrap periodically (the gather adjoint of subgrids_to_grid).

    Implemented as a vmapped dynamic_slice over a wrap-padded grid — a
    windowed batched gather, matching the scatter side's formulation."""
    n = subgrid_size
    g = grid[0].shape[-1]
    cy = coord_y.astype(jnp.int32) % g
    cx = coord_x.astype(jnp.int32) % g

    def gather_one(gp, y, x):
        return lax.dynamic_slice(
            gp, (jnp.int32(0), y, x), (gp.shape[0], n, n)
        )

    out = []
    for v in grid:
        padded = jnp.pad(v, ((0, 0), (0, n), (0, n)), mode="wrap")
        out.append(jax.vmap(gather_one, in_axes=(None, 0, 0))(padded, cy, cx))
    sub = tuple(out)  # [S, P, N, N]
    if apply_fft:
        sub = fft2_shift_pair(sub, inverse=False)
    return sub
