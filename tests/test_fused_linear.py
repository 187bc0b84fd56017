"""The W4A4 linear against a pre-quantized weight: must match the
quantize + GEMM composition."""
import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest

import qutlass_tpu as q
from helpers import bf16_hadamard, randn_bf16


@pytest.mark.parametrize("method", ["quest", "abs_max"])
@pytest.mark.parametrize("m", [1, 16, 200])
def test_fused_matches_composed(method, m):
    rng = np.random.default_rng(0)
    n, k = 512, 1024
    x = randn_bf16(rng, m, k, scale=2.0)
    w = randn_bf16(rng, n, k, scale=0.05)
    h = bf16_hadamard(32)

    wqt, wst = q.fusedQuantizeMx(w, h, method=method, layout="kmajor")
    y_fused = q.fused_linear_mxf4(x, wqt, wst, h, method=method)

    xq, xs = q.fusedQuantizeMx(x, h, method=method)
    wq, ws = q.fusedQuantizeMx(w, h, method=method)
    alpha = jnp.full((1,), 1.0 if method == "quest" else 1.0 / 9.0, jnp.float32)
    y_ref = q.matmul_mxf4_bf16_tn(xq, wq, xs[:m, :k // 32], ws[:n, :k // 32],
                                  alpha)
    a = np.asarray(y_fused, np.float32)
    b = np.asarray(y_ref, np.float32)
    # abs-max folds /9 differently (alpha vs per-operand /3): one-ulp slack
    np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-3)
    mismatch = (np.asarray(y_fused).astype(ml_dtypes.bfloat16)
                != np.asarray(y_ref).astype(ml_dtypes.bfloat16)).mean()
    assert mismatch <= (0.0 if method == "quest" else 2e-2), mismatch


def test_fused_linear_batched_input_shapes():
    """fused_linear_* must preserve leading batch dims, with the same
    values as the flattened 2-D call."""
    rng = np.random.default_rng(5)
    x = randn_bf16(rng, 2, 3, 256)                  # [B, T, K]
    w = randn_bf16(rng, 128, 256, scale=0.05)
    h = bf16_hadamard(32)
    wqt, wst = q.fusedQuantizeMx(w, h, layout="kmajor")
    y = q.fused_linear_mxf4(x, wqt, wst, h)
    assert y.shape == (2, 3, 128), y.shape
    y2 = q.fused_linear_mxf4(x.reshape(6, 256), wqt, wst, h)
    np.testing.assert_array_equal(np.asarray(y).reshape(6, 128),
                                  np.asarray(y2))

    gs = jnp.asarray(2.0, jnp.float32)
    h16 = bf16_hadamard(16)
    wq2, ws2 = q.fusedQuantizeNv(w, h16, gs, layout="kmajor")
    yn = q.fused_linear_nvf4(x, wq2, ws2, h16, gs)
    assert yn.shape == (2, 3, 128), yn.shape


def test_emulation_kmajor_codes_mask_arity():
    """fusedQuantizeMx(layout='kmajor_codes', return_mask=True) returns
    a 3-tuple: codes, scale bytes and mask, all K-major."""
    from qutlass_tpu.ops import emulation as E
    rng = np.random.default_rng(6)
    x = randn_bf16(rng, 64, 256)
    h = bf16_hadamard(32)
    ck, sb, mask = E.fused_quantize_mx(x, h, rot_size=32, method="quest",
                                       return_mask=True,
                                       layout="kmajor_codes")
    assert ck.shape == (256, 64) and sb.shape == (8, 64)
    assert mask.shape == (32, 64)
    # mask agrees with the rowmajor emission
    _, _, mrow = E.fused_quantize_mx(x, h, rot_size=32, method="quest",
                                     return_mask=True)
    np.testing.assert_array_equal(np.asarray(mask),
                                  np.asarray(mrow).reshape(64, 32).T)
