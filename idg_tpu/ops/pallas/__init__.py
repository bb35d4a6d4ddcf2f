"""Hand-written Pallas kernels on the Triton route (the card's kernels).

Modules register their kernels on import. Each kernel compiles for the GPU;
tests on the CPU run it with `interpret=True` and `precision=HIGHEST`.
"""

from . import degridder, gridder  # noqa: F401  (registers kernels)
