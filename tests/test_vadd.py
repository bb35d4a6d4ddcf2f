"""vadd copy-bandwidth reference kernel."""

import numpy as np

import pytest

from idg_tpu.ops.vadd import make_vadd_inputs, vadd, vadd_gbytes


def test_vadd_correct():
    x, y = make_vadd_inputs(1024 * 1024)
    out = np.asarray(vadd(x, y))
    np.testing.assert_allclose(out, np.asarray(x) + np.asarray(y))


@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_vadd_inputs_shapes(n):
    x, y = make_vadd_inputs(n)
    assert x.shape == y.shape == (n,)
    assert x.dtype == y.dtype == np.float32


def test_vadd_gbytes():
    assert vadd_gbytes(256 * 1024 * 1024) == 3 * 4 * 256 * 1024 * 1024 * 1e-9
