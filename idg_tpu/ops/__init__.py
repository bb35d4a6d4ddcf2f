"""Device kernels: the benchmark subjects.

Two programming-model families (the analogue of the reference's CUDA/HIP
axis):
  - ``xla``    — pure jax.numpy formulations lowered by XLA (compiler baseline)
  - ``pallas`` — hand-written Pallas kernels on the Triton route

Kernels register themselves in ``registry`` under (workload, version).
"""
