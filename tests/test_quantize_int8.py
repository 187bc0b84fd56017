"""The fused rotate+quantize+int8 kernel (kernels/quantize_int8.py).

* interpret mode (CPU) against the XLA twin, over fmt x method x rot x
  rows: bitwise equal — the interpreter sums the rotation and the group
  statistics in the same order as XLA on the CPU, so no value can land
  on the other side of a rounding boundary;
* the block-size chooser over a grid of M x K;
* the compiled kernel on a GPU (``gpu`` marker; run by chip_smoke.py):
  within the golden's budget of the twin, since the tensor-core rotation
  sums in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from qutlass_tpu.kernels import quantize_int8 as K
from qutlass_tpu.ops import emulation as E
from helpers import bf16_hadamard, randn_bf16

FMTS = ["mx", "nv"]
METHODS = ["quest", "abs_max"]
ROTS = [16, 32, 64, 128]
ROWS = [1, 7, 128, 300]


def _both(fmt, method, rot, rows, k, interpret, seed=0):
    rng = np.random.default_rng(seed)
    x = randn_bf16(rng, rows, k, scale=3.0)
    h = bf16_hadamard(rot)
    if fmt == "mx":
        got = K.quantize_int8(x, h, fmt="mx", method=method,
                              interpret=interpret)
        want = E.fused_quantize_mx_int8(x, h, rot_size=rot, method=method)
    else:
        gs = jnp.float32(448.0 * 6.0 / 40.0)
        got = K.quantize_int8(x, h, gs, fmt="nv", method=method,
                              interpret=interpret)
        want = E.fused_quantize_nv_int8(x, h, gs, rot_size=rot,
                                        method=method)
    return [np.asarray(a) for a in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("rot", ROTS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fmt", FMTS)
def test_interpret_matches_xla(fmt, method, rot, rows):
    (a, s, sb), (ea, es, esb) = _both(fmt, method, rot, rows, 256, True)
    gsz = 32 if fmt == "mx" else 16
    assert a.shape == (rows, 256) and a.dtype == np.int8
    assert s.shape == (rows,) and sb.shape == (rows, 256 // gsz)
    np.testing.assert_array_equal(sb, esb)
    np.testing.assert_array_equal(s, es)
    np.testing.assert_array_equal(a, ea)


MS = [1, 7, 8, 16, 64, 128, 200, 256, 504, 1024, 2048, 65536]
KS = [256, 512, 4096, 5120, 10752, 11008, 12288, 25600, 51200, 57344, 8192]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m", MS)
def test_block_config(m, k):
    bm, ks, ns = K.block_config(m, k)
    assert bm >= 16 and bm & (bm - 1) == 0, bm           # tensor-core dot
    assert K.smem_estimate(bm) <= K.SMEM_BYTES, bm
    nb = -(-m // bm)
    assert nb * bm >= m and (nb - 1) * bm < m           # rows + remainder
    nchunks = k // K.CHUNK
    assert ks >= 1 and ns * ks >= nchunks               # every chunk
    assert (ns - 1) * ks < nchunks                      # no empty slice
    # enough programs to spread over the card (or one per chunk)
    assert nb * ns >= min(nb * nchunks, K._TARGET_PROGRAMS // 2)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 300])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fmt", FMTS)
def test_compiled_matches_xla(fmt, method, rows):
    """Compiled on the card at K=4096: scale bytes equal, int8 values
    differ in at most 1e-4 of the elements (rounding-boundary values
    under the tensor-core summation order)."""
    (a, s, sb), (ea, es, esb) = _both(fmt, method, 32, rows, 4096, False)
    assert np.mean(sb != esb) <= 1e-4
    assert np.mean(a != ea) <= 1e-4
    np.testing.assert_allclose(s, es, rtol=1e-6)
