"""Image Domain Gridding benchmark framework in JAX, run on an NVIDIA GPU.

Capability-parity re-design of ska-telescope/ska-sdp-idg-bench (CUDA/HIP GPU
kernel benchmark): JAX/XLA + Pallas (Triton route) kernels, golden NumPy
oracle, dual perf/correctness harness, and (beyond the reference) multi-card
sharding via jax.sharding / shard_map.
"""

from .config import HarnessConfig, IDGParams
from .data import make_observation, make_perf_observation, make_w_observation
from .types import Metadata, Observation

__version__ = "0.2.0"

__all__ = [
    "HarnessConfig",
    "IDGParams",
    "Metadata",
    "Observation",
    "make_observation",
    "make_perf_observation",
    "make_w_observation",
]
