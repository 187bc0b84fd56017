"""QuantizedLinear / quartet_linear QAT tests: jax.grad end-to-end."""
import ml_dtypes
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qutlass_tpu as q
from qutlass_tpu.nn import QuantizedLinear, quartet_linear
from helpers import bf16_hadamard, randn_bf16


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)


def test_quantized_linear_forward():
    rng = np.random.default_rng(0)
    m, n, k = 64, 256, 512
    x = randn_bf16(rng, m, k, scale=1.0)
    w = randn_bf16(rng, n, k, scale=0.05)
    h = bf16_hadamard(32)

    lin = QuantizedLinear.create(w, h)
    y = lin(x)
    assert y.shape == (m, n) and y.dtype == jnp.bfloat16
    y_ref = x.astype(jnp.float32) @ w.astype(jnp.float32).T
    assert _cos(y, y_ref) > 0.97


def test_quantized_linear_batched_input():
    rng = np.random.default_rng(0)
    x = randn_bf16(rng, 2, 32, 512, scale=1.0)
    w = randn_bf16(rng, 256, 512, scale=0.05)
    lin = QuantizedLinear.create(w, bf16_hadamard(32))
    y = lin(x)
    assert y.shape == (2, 32, 256)


@pytest.mark.parametrize("method", ["quest", "abs_max"])
def test_quartet_linear_grad(method):
    """jax.grad through the quantized linear: gradients must align with
    the bf16 linear's gradients (quantization noise bounded)."""
    rng = np.random.default_rng(0)
    m, n, k = 128, 256, 512
    x = randn_bf16(rng, m, k, scale=1.0)
    w = randn_bf16(rng, n, k, scale=0.05)
    t = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
    h = bf16_hadamard(32)

    def loss_q(x, w):
        y = quartet_linear(x, w, h, method)
        return jnp.sum(y.astype(jnp.float32) * t)

    def loss_ref(x, w):
        y = x.astype(jnp.float32) @ w.astype(jnp.float32).T
        return jnp.sum(y * t)

    gx, gw = jax.grad(loss_q, argnums=(0, 1))(x, w)
    rx, rw = jax.grad(loss_ref, argnums=(0, 1))(x, w)

    assert gx.shape == x.shape and gw.shape == w.shape
    assert _cos(gx, rx) > 0.93, _cos(gx, rx)
    assert _cos(gw, rw) > 0.93, _cos(gw, rw)


def test_quartet_linear_value():
    rng = np.random.default_rng(0)
    m, n, k = 64, 128, 256
    x = randn_bf16(rng, m, k, scale=1.0)
    w = randn_bf16(rng, n, k, scale=0.05)
    h = bf16_hadamard(32)
    y = quartet_linear(x, w, h, "quest")
    y_ref = x.astype(jnp.float32) @ w.astype(jnp.float32).T
    assert _cos(y, y_ref) > 0.97


def test_quartet_linear_jit_grad():
    """The whole training step must be jittable."""
    rng = np.random.default_rng(0)
    m, n, k = 128, 128, 256
    x = randn_bf16(rng, m, k, scale=1.0)
    w = randn_bf16(rng, n, k, scale=0.05)
    h = bf16_hadamard(32)

    @jax.jit
    def step(x, w):
        return jax.grad(lambda w: jnp.sum(
            quartet_linear(x, w, h, "quest").astype(jnp.float32) ** 2))(w)

    g = step(x, w)
    assert g.shape == w.shape
    assert np.isfinite(np.asarray(g, np.float32)).all()


@pytest.mark.parametrize("grad_mode", ["bf16", "int8"])
def test_quartet_linear_grad_modes(grad_mode):
    """The bf16 and int8 backward modes align with the reference-flow
    grads."""
    rng = np.random.default_rng(1)
    m, n, k = 128, 256, 512
    x = randn_bf16(rng, m, k, scale=1.0)
    w = randn_bf16(rng, n, k, scale=0.05)
    t = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
    h = bf16_hadamard(32)

    def loss(mode):
        def f(x, w):
            y = quartet_linear(x, w, h, "quest", mode)
            return jnp.sum(y.astype(jnp.float32) * t)
        return f

    gx, gw = jax.grad(loss(grad_mode), argnums=(0, 1))(x, w)
    rx, rw = jax.grad(loss("mxfp8"), argnums=(0, 1))(x, w)
    # all modes share the STE structure; they differ only in how dY is
    # quantized (not at all / 8-bit rows / mxfp8), so alignment must be
    # much tighter than against the unquantized linear
    assert _cos(gx, rx) > 0.98, _cos(gx, rx)
    assert _cos(gw, rw) > 0.98, _cos(gw, rw)


def test_quartet_bf16_grad_matches_natural_order_golden():
    """grad_mode='bf16' == the explicit natural-order STE formula:
    dX = unrotate(mask * (dY @ dq(w))), dW = unrotate((dY' )^T @ dq(x)).
    Verifies the plane-major mask unpack and the folded de-interleave
    unrotation against the straightforward construction."""
    import qutlass_tpu as q
    from qutlass_tpu.nn.linear import _unrotate, _unpack_mask_bits

    rng = np.random.default_rng(2)
    m, n, k = 64, 128, 256
    x = randn_bf16(rng, m, k, scale=1.0)
    w = randn_bf16(rng, n, k, scale=0.05)
    t = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
    h = bf16_hadamard(32)

    def loss(x, w):
        y = quartet_linear(x, w, h, "quest", "bf16")
        return jnp.sum(y.astype(jnp.float32) * t)

    gx, gw = jax.grad(loss, argnums=(0, 1))(x, w)

    # golden: natural-order construction from the byte-level ops
    xqt, xst, mask_t = q.fusedQuantizeMx(x, h, method="quest",
                                         return_mask=True, layout="kmajor")
    wqt, wst = q.fusedQuantizeMx(w, h, method="quest", layout="kmajor")
    wdq = q.mxfp4_transpose_scaled_kmajor(wqt, wst)   # [K, N] bf16 exact
    xdq = q.mxfp4_transpose_scaled_kmajor(xqt, xst)   # [K, M] bf16 exact
    gy = t.astype(jnp.bfloat16)
    dxh = jax.lax.dot_general(gy, wdq, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
    dxh = dxh.astype(jnp.bfloat16) * _unpack_mask_bits(
        mask_t.T, k).astype(jnp.bfloat16)
    rx = _unrotate(dxh, h)
    dwh = jax.lax.dot_general(gy, xdq, (((0,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
    rw = _unrotate(dwh.astype(jnp.bfloat16), h)

    # gx/gw carry one final bf16 cast the f32 golden lacks: compare at
    # bf16 ulp resolution
    np.testing.assert_allclose(np.asarray(gx, np.float32),
                               np.asarray(rx, np.float32),
                               rtol=8e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gw, np.float32),
                               np.asarray(rw, np.float32),
                               rtol=8e-3, atol=1e-4)


def test_quartet_linear_grad_modes_abs_max_alpha():
    """abs_max backward carries the GEMM's 1/9 alpha consistently: all
    three grad modes (which differ only in how dY is quantized) must
    produce the same gradient magnitude and direction.  (The absolute
    scale follows the reference's STE convention — quantizer treated as
    identity, GEMM alpha differentiated — so it is NOT pinned to the
    unquantized linear's; see _quartet_bwd.)"""
    rng = np.random.default_rng(3)
    m, n, k = 64, 128, 256
    x = randn_bf16(rng, m, k, scale=1.0)
    w = randn_bf16(rng, n, k, scale=0.05)
    t = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
    h = bf16_hadamard(32)

    norms, cosines = {}, {}
    for mode in ["mxfp8", "bf16", "int8"]:
        gx = jax.grad(lambda x: jnp.sum(
            quartet_linear(x, w, h, "abs_max", mode).astype(jnp.float32)
            * t))(x)
        norms[mode] = np.linalg.norm(np.asarray(gx, np.float64).ravel())
        cosines[mode] = np.asarray(gx, np.float64).ravel()
    for mode in ["bf16", "int8"]:
        assert 0.9 < norms[mode] / norms["mxfp8"] < 1.1, (mode, norms)
        c = (cosines[mode] @ cosines["mxfp8"]
             / (norms[mode] * norms["mxfp8"]))
        assert c > 0.98, (mode, c)
