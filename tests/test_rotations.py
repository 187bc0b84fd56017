"""Rotation-matrix constructors (Hadamard / DCT / identity).

The reference loads square rotation matrices at runtime
(README.md:59-73: Hadamard, DCT, identity; sizes 16/32/64/128) and its
tests build Hadamard via scipy (tests/mxfp4_test.py:39-42).  These
utilities are the in-repo equivalents; any orthonormal square matrix
of a supported size works with the fused quantizers.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import qutlass_tpu as Q
from qutlass_tpu.ops import emulation as E


@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_hadamard_orthonormal_and_pm1(n):
    # f32 storage (x64 stays off in the suite); verify at f64 math
    h = np.asarray(Q.hadamard_matrix(n, jnp.float32), np.float64)
    np.testing.assert_allclose(h @ h.T, np.eye(n), atol=1e-5)
    np.testing.assert_allclose(np.abs(h * n ** 0.5), np.ones((n, n)),
                               atol=1e-6)


@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_dct_orthonormal(n):
    d = np.asarray(Q.dct_matrix(n, jnp.float32), np.float64)
    np.testing.assert_allclose(d @ d.T, np.eye(n), atol=1e-4)
    # first row is the constant vector (DC component)
    np.testing.assert_allclose(d[0], np.full(n, n ** -0.5), atol=1e-6)


@pytest.mark.parametrize("make", [Q.hadamard_matrix, Q.dct_matrix,
                                  Q.identity_matrix])
def test_rotations_drive_quantizer(make):
    # Any orthonormal rotation is a valid ``h``: dequantize(quantize(x))
    # must stay within one abs-max quantization step of the rotated input.
    rng = np.random.default_rng(0)
    rows, k = 8, 128
    x = jnp.asarray(rng.standard_normal((rows, k)), jnp.bfloat16)
    h = make(32)
    q, s = E.fused_quantize_mx(x, h, rot_size=32, method="abs_max")
    assert q.shape == (rows, k // 2) and q.dtype == jnp.uint8
    sb = s[:rows, : k // 32]
    deq = np.asarray(E._dequant_fp4(q, sb, 32), np.float64) / 3.0
    xr = (np.asarray(x, np.float64).reshape(-1, 32)
          @ np.asarray(h, np.float64)).reshape(rows, k)
    # abs-max: |err| <= scale/2 per element; scale >= |group amax| / 4
    amax = np.abs(xr.reshape(rows, -1, 32)).max(-1, keepdims=True)
    bound = np.broadcast_to(amax, xr.reshape(rows, -1, 32).shape
                            ).reshape(rows, k) / 3.0 + 1e-6
    assert (np.abs(deq - xr) <= bound).all()
