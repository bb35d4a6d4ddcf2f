#!/usr/bin/env bash
# Environment setup (the reference's share/setup-env.sh analogue): put the
# framework on PYTHONPATH. The persistent compile cache goes to
# $JAX_COMPILATION_CACHE_DIR when set, else to .jax_cache/ in the checkout
# (idg_tpu/config.py).
export PYTHONPATH="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd):${PYTHONPATH:-}"
