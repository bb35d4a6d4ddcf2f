"""Roofline helper: peak lookup and bound math."""

import pytest

from idg_tpu.utils.roofline import PEAKS, device_peaks, roofline_fraction

H100 = "NVIDIA H100 80GB HBM3"


def test_known_device_kinds():
    assert device_peaks(H100) == (67e12, 3.35e12)
    assert device_peaks(H100, "tf32") == (495e12, 3.35e12)
    assert device_peaks(H100, "bf16") == (989e12, 3.35e12)


def test_fraction_compute_bound():
    # intensity 1000 FLOP/B -> bound = min(495e12, 3350e12) = 495 TF (TF32)
    frac = roofline_fraction(
        gflops_achieved=49500.0, gflops_total=1000.0, gbytes_total=1.0,
        device_kind=H100, bound="tf32",
    )
    assert abs(frac - 0.1) < 1e-9


def test_fraction_bandwidth_bound():
    # intensity 0.1 FLOP/B -> bound = 0.1 * 3.35e12 = 335 GFLOP/s
    frac = roofline_fraction(
        gflops_achieved=33.5, gflops_total=0.1, gbytes_total=1.0,
        device_kind=H100,
    )
    assert abs(frac - 0.1) < 1e-6


@pytest.mark.parametrize("kind", ["GeForce", "cpu", "NVIDIA H100"])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        roofline_fraction(1.0, 1.0, 1.0, kind)


def test_every_entry_has_all_bounds():
    for peaks in PEAKS.values():
        assert set(peaks) == {"fp32", "tf32", "bf16", "hbm"}
