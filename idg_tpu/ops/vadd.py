"""vadd: the copy-bandwidth reference benchmark.

The reference declares a vadd benchmark (app/lib-cpu.hpp:6-7, README.md:65)
and commits V100 results (res/vadd/*.csv) but ships no kernel source —
SURVEY.md §2.4 recommends reviving it as a cheap bandwidth validator for the
harness: what XLA's copy reaches on the card is the bandwidth a
memory-bound kernel can be held to. z = x + y over N floats; bytes moved =
3·4·N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DEFAULT_N = 256 * 1024 * 1024  # 1 GiB per operand, matches V100 CSV scale


@jax.jit
def vadd(x, y):
    return x + y


def make_vadd_inputs(n: int = DEFAULT_N):
    x = jnp.arange(n, dtype=jnp.float32) * jnp.float32(1e-6)
    y = jnp.ones((n,), jnp.float32)
    return x, y


def vadd_gbytes(n: int) -> float:
    """3 streams (2 read + 1 write) of f32."""
    return 3 * 4 * n * 1e-9
