"""The XLA quantizers against the fp64 golden, and the int8 route of the
production linear against the fp4-decode GEMM.

Golden budget (reference mxfp4_test.py:176-178): scale bytes exact; a
quantized value may differ from the fp64 golden only where the fp32
rotation lands a value on a rounding boundary — at most 1e-4 of the
values, and at most one value in the smallest (one-row) cases.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import qutlass_tpu as q
from qutlass_tpu.formats import golden as G
from qutlass_tpu.models.transformer import _linear, quantize_weight
from helpers import bf16_hadamard, randn_bf16, to_np64

FMTS = ["mx", "nv"]
METHODS = ["quest", "abs_max"]
ROTS = [16, 32, 64, 128]
ROWS = [1, 7, 128, 300]
K = 512


def _budget(n: int) -> float:
    return max(1.0, 1e-4 * n)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("rot", ROTS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fmt", FMTS)
def test_xla_quantizer_vs_golden(fmt, method, rot, rows):
    rng = np.random.default_rng(rows * 131 + rot)
    x = randn_bf16(rng, rows, K, scale=3.0)
    h = bf16_hadamard(rot)
    x64, h64 = to_np64(x), to_np64(h)
    if fmt == "mx":
        packed, sbytes = q.fusedQuantizeMx(x, h, method=method)
        ref = G.quantize_mx(x64, h64, rot, method)
        np.testing.assert_array_equal(np.asarray(sbytes)[:rows, :K // 32],
                                      ref["e8m0"])
    else:
        amax = np.abs(x64.reshape(rows, K // rot, rot) @ h64).max()
        gs = 448.0 * 6.0 / amax
        packed, sbytes = q.fusedQuantizeNv(x, h, jnp.float32(gs),
                                           method=method)
        ref = G.quantize_nv(x64, h64, rot, np.float32(gs), method)
        np.testing.assert_array_equal(np.asarray(sbytes)[:rows, :K // 16],
                                      ref["e4m3"])
    vals = G.unpack_fp4(np.asarray(packed))
    assert (vals != ref["values"]).sum() <= _budget(vals.size)


@pytest.mark.parametrize("m", [1, 7, 16, 200])
@pytest.mark.parametrize("rot", ROTS)
@pytest.mark.parametrize("method", METHODS)
def test_linear_int8_route_matches_fp4_decode(method, rot, m):
    """The production linear's int8 evaluator equals the fp4-decode GEMM
    on the same quantized operands (bitwise on the CPU: the int8
    contraction is exact, and so is the f32 sum of the decode GEMM at
    these sizes)."""
    rng = np.random.default_rng(m * 7 + rot)
    h = bf16_hadamard(rot)
    w = randn_bf16(rng, 256, K, scale=0.05)
    x = randn_bf16(rng, m, K, scale=2.0)
    both = quantize_weight(w, h=h, method=method, weight_format="both")
    assert "wi8" in both and "wqt" in both
    fp4 = {kk: v for kk, v in both.items() if kk not in ("wi8", "wsb")}
    y8 = _linear(x, both, h, method, True)
    y4 = _linear(x, fp4, h, method, True)
    assert y8.shape == (m, 256) and y8.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(y8, np.float32),
                                  np.asarray(y4, np.float32))
