"""Roofline context for perf reports (new vs the reference, SURVEY.md §5).

One table of published peaks keyed by `device_kind` as JAX reports it. The
bound for a kernel with arithmetic intensity I is min(peak_flops, I·peak_bw),
where peak_flops is the rate of the unit the kernel's dots run on: "tf32"
for tensor-core TF32 products (the Pallas kernels' TF32x3 dots), "fp32" for
the CUDA cores (XLA dots at precision HIGHEST). A device that is not in the
table is an error, not a default.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32": 67e12,
        "tf32": 495e12,
        "bf16": 989e12,
        "hbm": 3.35e12,
    },
}

DEFAULT_BOUND = "fp32"


def device_peaks(device_kind: str, bound: str = DEFAULT_BOUND
                 ) -> Tuple[float, float]:
    """(peak FLOP/s of `bound`, peak device-memory bytes/s)."""
    try:
        peaks = PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None
    return peaks[bound], peaks["hbm"]


def roofline_fraction(
    gflops_achieved: float, gflops_total: float, gbytes_total: float,
    device_kind: str, bound: str = DEFAULT_BOUND,
) -> float:
    """Achieved FLOP/s over the roofline bound at this kernel's intensity.

    gflops_achieved: measured GFLOP/s; gflops_total/gbytes_total: the
    analytic cost model for one pass (utils/costs.py)."""
    peak_flops, peak_bw = device_peaks(device_kind, bound)
    if gbytes_total <= 0 or gflops_total <= 0:
        raise ValueError("roofline needs positive FLOP and byte counts")
    intensity = gflops_total / gbytes_total  # FLOP/byte
    return gflops_achieved * 1e9 / min(peak_flops, intensity * peak_bw)
