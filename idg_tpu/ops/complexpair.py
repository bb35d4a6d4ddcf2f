"""Split-complex arithmetic on (re, im) array pairs.

The device path is complex-free by design: complex data travels as pairs
of float32 arrays, so every complex product becomes real dots (tensor-core
or CUDA-core) and the Pallas kernels see only real tensors. complex64
exists only at the host boundary (types.Observation, the NumPy oracle, the
comparator).

A pair is a 2-tuple ``(re, im)`` of same-shape arrays. All helpers are
jit/Pallas-safe (pure jnp ops).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

Pair = Tuple[jnp.ndarray, jnp.ndarray]


def pair(re, im) -> Pair:
    return (re, im)


def czero(shape, dtype=jnp.float32) -> Pair:
    z = jnp.zeros(shape, dtype)
    return (z, z)


def cadd(a: Pair, b: Pair) -> Pair:
    return (a[0] + b[0], a[1] + b[1])


def csub(a: Pair, b: Pair) -> Pair:
    return (a[0] - b[0], a[1] - b[1])


def cmul(a: Pair, b: Pair) -> Pair:
    """(a·b) — 4 real multiplies (Karatsuba's 3 would trade one multiply
    for extra adds and rounding)."""
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def cmulj(a: Pair, b: Pair) -> Pair:
    """a · conj(b)."""
    return (a[0] * b[0] + a[1] * b[1], a[1] * b[0] - a[0] * b[1])


def cconj(a: Pair) -> Pair:
    return (a[0], -a[1])


def cscale(a: Pair, s) -> Pair:
    """Multiply by a real scalar/array."""
    return (a[0] * s, a[1] * s)


def cexp_i(phase) -> Pair:
    """e^{i·phase} as (cos, sin)."""
    return (jnp.cos(phase), jnp.sin(phase))


def ceinsum(subscripts: str, a: Pair, b: Pair, **kw) -> Pair:
    """Complex einsum over pairs: 4 real einsums.

    Defaults to HIGHEST precision: a single reduced-precision pass (bf16 or
    TF32) fails the 1e-5 correctness gate (measured 1.2e-3 normalized RMS
    for bf16); full f32 passes at ~2e-6.
    """
    kw.setdefault("precision", "highest")
    rr = jnp.einsum(subscripts, a[0], b[0], **kw)
    ii = jnp.einsum(subscripts, a[1], b[1], **kw)
    ri = jnp.einsum(subscripts, a[0], b[1], **kw)
    ir = jnp.einsum(subscripts, a[1], b[0], **kw)
    return (rr - ii, ri + ir)


def cmatmul(a: Pair, b: Pair, **kw) -> Pair:
    """Complex matmul over pairs: 4 real matmuls.
    HIGHEST precision by default — see ceinsum."""
    kw.setdefault("precision", "highest")
    kw.setdefault("preferred_element_type", jnp.float32)
    rr = jnp.matmul(a[0], b[0], **kw)
    ii = jnp.matmul(a[1], b[1], **kw)
    ri = jnp.matmul(a[0], b[1], **kw)
    ir = jnp.matmul(a[1], b[0], **kw)
    return (rr - ii, ri + ir)


def cstack(a: Pair, axis: int = -1):
    """Pack a pair into one array with a trailing re/im axis."""
    return jnp.stack(a, axis=axis)


def to_pair(x) -> Pair:
    """Split a complex array (host side allowed) into an f32 pair."""
    return (jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32))


# ---- 2x2 Jones algebra on pairs of [..., 4] arrays (xx,xy,yx,yy) ----------

def mat2x2_mul(a: Pair, b: Pair) -> Pair:
    """C = A·B (app/common/math.hpp:26-36) on [..., 4] pairs."""
    ar, ai = a
    br, bi = b

    # c0 = a0·b0 + a1·b2 ; c1 = a0·b1 + a1·b3 ; c2 = a2·b0 + a3·b2 ; c3 = a2·b1 + a3·b3
    def cm(j, k):
        re = ar[..., j] * br[..., k] - ai[..., j] * bi[..., k]
        im = ar[..., j] * bi[..., k] + ai[..., j] * br[..., k]
        return re, im

    c0 = tuple(x + y for x, y in zip(cm(0, 0), cm(1, 2)))
    c1 = tuple(x + y for x, y in zip(cm(0, 1), cm(1, 3)))
    c2 = tuple(x + y for x, y in zip(cm(2, 0), cm(3, 2)))
    c3 = tuple(x + y for x, y in zip(cm(2, 1), cm(3, 3)))
    re = jnp.stack([c0[0], c1[0], c2[0], c3[0]], axis=-1)
    im = jnp.stack([c0[1], c1[1], c2[1], c3[1]], axis=-1)
    return (re, im)


def mat2x2_hermitian(a: Pair) -> Pair:
    """Aᴴ (math.hpp:57-62): conjugate-transpose in xx,xy,yx,yy layout."""
    ar, ai = a
    perm = jnp.array([0, 2, 1, 3])
    return (jnp.take(ar, perm, axis=-1), -jnp.take(ai, perm, axis=-1))


def apply_aterm_gridder(pixels: Pair, a1: Pair, a2: Pair) -> Pair:
    """P ← A1ᴴ·P·A2 (math.hpp:64-77)."""
    return mat2x2_mul(mat2x2_mul(mat2x2_hermitian(a1), pixels), a2)


def apply_aterm_degridder(pixels: Pair, a1: Pair, a2: Pair) -> Pair:
    """P ← A1·P·A2ᴴ (math.hpp:79-92)."""
    return mat2x2_mul(mat2x2_mul(a1, pixels), mat2x2_hermitian(a2))
