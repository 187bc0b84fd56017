"""Quantized linear layers: MXFP4 W4A4 inference + Quartet QAT training.

The training flow wires the reference's op graph (SURVEY.md §3.4,
assembled from qutlass/__init__.py ops and tests/quartet_test.py):

    forward:  xq, xs, mask = fusedQuantizeMx(x,  H, quest, mask)
              wq, ws       = fusedQuantizeMx(w,  H, quest)
              y  = matmul_mxf4_bf16_tn(xq, wq, xs, ws, 1.0)
    backward: gq' = backward_square_double_scaled(dY)      # MXFP8 pts, bf16
              w8' = mxfp4_transpose_scaled(wq, ws)         # W^T -> MXFP8 pts
              dXh = gq' @ w8'^T            (bf16 dot == mxf8 TN GEMM)
              dX  = (dXh * clip_mask) @ H_blockdiag^T        # Quartet STE
              x8' = mxfp4_transpose_scaled(xq, xs)         # X^T -> MXFP8 pts
              dWh = gq'^T @ x8'^T          (bf16 dot == mxf8 NN GEMM)
              dW  = dWh @ H_blockdiag^T

    The primed operands are the reference's MXFP8 tensors pre-decoded to
    bf16 (e4m3 x pow2 is exact in bf16), so the backward GEMMs run at
    full bf16 rate; the public byte-level ops
    (backward_bf16_square_double_mxfp8 / mxfp4_transpose_mxfp8 /
    matmul_mxf8_bf16_{tn,nn}) remain the reference-parity surface.

Both weight and activation gradients flow through ``jax.grad`` with a
single ``custom_vjp``; everything quantized stays in uint8 on device.
"""
from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp

import qutlass_tpu as q
from ..ops import int8path as _i8
from ..utils import block_diag_128, round_up


def _unrotate(g: jax.Array, h: jax.Array) -> jax.Array:
    """Apply the inverse (transpose) rotation per contiguous gs-chunk.

    When K is 128-divisible the rotation is lifted to the 128x128
    block-diagonal bf16 operand (kron(I, H^T)) — one full-width bf16
    tensor-core product instead of a contraction-``rot`` fp32 dot (the
    same lift the quantizer kernel uses, utils.block_diag_128).  The
    gradient is rounded to bf16 first (an explicit cast; the callers
    pass bf16 already), so every product is exact and the sum is f32.
    The fp32 fallback asks for full f32 (``HIGHEST``): on a GPU the
    default may be TF32, which would round a gradient that is not
    bf16-exact.
    """
    rot = h.shape[-1]
    k = g.shape[-1]
    if k % 128 == 0:
        ht128 = block_diag_128(h).T                # bf16 [128, 128]
        gr = g.reshape(-1, 128).astype(jnp.bfloat16)
        out = jax.lax.dot_general(gr, ht128, (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)
        return out.reshape(g.shape)
    gr = g.reshape(-1, rot).astype(jnp.float32)
    ht = h.reshape(rot, rot).astype(jnp.float32).T
    out = jax.lax.dot_general(gr, ht, (((1,), (0,)), ((), ())),
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)
    return out.reshape(g.shape)


def _unpack_mask_bits(mask: jax.Array, k: int) -> jax.Array:
    """uint8 [..., K/8] -> f32 0/1 [..., K] (bit i of byte j = elem 8j+i)."""
    m = mask.astype(jnp.int32)
    bits = jnp.stack([(m >> i) & 1 for i in range(8)], axis=-1)
    return bits.reshape(*mask.shape[:-1], k).astype(jnp.float32)


def _unpack_mask_planes(mask_t: jax.Array, k: int) -> jax.Array:
    """K-major mask bytes [K/8, M] -> plane-major 0/1 bf16 [M, K].

    Plane-major column order (ops/int8path.py:encode_int8_planes):
    column p holds natural element 2p, column K/2 + p holds 2p + 1.
    Byte j's bits {0,2,4,6} are natural elements {8j, 8j+2, ...} ->
    plane columns {4j .. 4j+3}; bits {1,3,5,7} feed the odd half."""
    b = mask_t.T.astype(jnp.int32)                       # [M, K/8]

    def half(bits):
        parts = [(b >> i) & 1 for i in bits]
        return jnp.stack(parts, axis=-1).reshape(b.shape[0], k // 2)

    return jnp.concatenate([half((0, 2, 4, 6)), half((1, 3, 5, 7))],
                           axis=-1).astype(jnp.bfloat16)


def _unrotate_planes(v_p: jax.Array, h: jax.Array) -> jax.Array:
    """Unrotate a tensor whose K axis is in PLANE-MAJOR order, returning
    natural order — with the de-interleave folded into the matmul.

    ``v_p`` [R, K] has column p = natural element 2p, column K/2 + p =
    natural element 2p+1 (the layout the int8-plane contraction emits).
    Instead of re-interleaving [R, K] (an expensive lane relayout) and
    then multiplying by the 128-wide block-diagonal H^T, split H^T into
    its even and odd rows: natural 128-block b draws its even elements
    from contiguous plane columns [64b, 64b+64) and its odd elements
    from the same range of the second half, so

        dX_b = v_even_b @ H^T[0::2, :] + v_odd_b @ H^T[1::2, :]

    — two half-contraction matmuls, same total FLOPs as the
    natural-order unrotation, zero relayout."""
    rot = h.shape[-1]
    r, k = v_p.shape
    if k % 128 == 0:
        ht = block_diag_128(h).T                        # bf16 [128, 128]
        he, ho = ht[0::2, :], ht[1::2, :]               # [64, 128] each
        ve = v_p[:, :k // 2].reshape(-1, 64).astype(jnp.bfloat16)
        vo = v_p[:, k // 2:].reshape(-1, 64).astype(jnp.bfloat16)
        out = (jax.lax.dot_general(ve, he, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)
               + jax.lax.dot_general(vo, ho, (((1,), (0,)), ((), ())),
                                     preferred_element_type=jnp.float32))
        return out.reshape(r, k)
    # small-K fallback: explicit de-interleave, then the standard path
    v = jnp.stack([v_p[:, :k // 2], v_p[:, k // 2:]], axis=-1).reshape(r, k)
    return _unrotate(v, h)


def _int8_quantize_rows(v: jax.Array, axis: int):
    """Per-slice symmetric int8 quantization of f32 ``v`` along ``axis``
    complement: returns (int8 codes, f32 scale per output slice).

    Used by the ``grad_mode="int8"`` backward: 8-bit mantissas against
    the slice max — tighter than MXFP8's 3-bit e4m3 mantissa — and the
    contraction runs on the int8 tensor cores at 2x the bf16 rate."""
    a = jnp.max(jnp.abs(v), axis=axis)
    s = a / 127.0
    inv = jnp.where(s > 0, 1.0 / s, 0.0)
    inv = jnp.expand_dims(inv, axis)
    q = jnp.round(v * inv).astype(jnp.int8)
    return q, s


def quantize_weights_mx(w: jax.Array, h: jax.Array, method: str = "quest"):
    """Quantize a weight matrix [N, K] once (cache for inference/training)."""
    wq, ws = q.fusedQuantizeMx(w, h, method=method)
    return wq, ws


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def quartet_linear(x: jax.Array, w: jax.Array, h: jax.Array,
                   method: str = "quest",
                   grad_mode: str = "int8") -> jax.Array:
    """y = q(x·H) @ q(w·H)^T with Quartet MXFP4 W4A4 quantization.

    x: [M, K] bf16, w: [N, K] bf16, h: [gs, gs] rotation.
    Differentiable in x and w; clip-mask STE (quest).  ``grad_mode``
    picks the backward arithmetic (all three share the clip-mask STE
    and differentiate through the SAME dequantized forward operands):

    - ``"int8"`` (default): dY is quantized per output row to 8-bit
      integers (tighter than MXFP8's 3-bit mantissa) and ALL THREE
      GEMMs of the training step are int8 contractions.
    - ``"mxfp8"``: reference-parity Quartet — dY is
      square-double-quantized to MXFP8 per 32x32 tile
      (quartet_bwd_sm120.cu flow) and the GEMMs run at bf16 rate on
      operands pre-decoded to exact bf16 (docs/NUMERICS.md).
    - ``"bf16"``: exact STE — dY enters the backward GEMMs unquantized
      in bf16.  More accurate than the reference's scheme, same speed
      class as ``mxfp8`` minus the square-double pass.
    """
    y, _ = _quartet_fwd_impl(x, w, h, method)
    return y


def _quartet_fwd_impl(x, w, h, method):
    """Forward on the kmajor composed path (zero layout transforms);
    residuals are the forward's own int8 planes + pow2 row scales
    (exact dequantization: |mantissa| <= 96 with a 4-bit significand
    times a power of two is exact in bf16), so the backward needs no
    re-decode or transpose kernels."""
    if method == "quest":
        xqt, xst, mask_t = q.fusedQuantizeMx(x, h, method=method,
                                             return_mask=True,
                                             layout="kmajor")
    else:
        xqt, xst = q.fusedQuantizeMx(x, h, method=method, layout="kmajor")
        mask_t = None
    wqt, wst = q.fusedQuantizeMx(w, h, method=method, layout="kmajor")
    alpha = jnp.full((1,), 1.0 if method == "quest" else 1.0 / 9.0, jnp.float32)
    # forward contraction in int8 (bit-exact for quantizer-produced
    # operands — ops/int8path.py)
    xi, sx, _ = _i8.encode_int8_planes(xqt, xst)
    wi, sw, _ = _i8.encode_int8_planes(wqt, wst)
    y = _i8.matmul_mxf4_bf16_int8_kk(xi, wi, sx, sw, alpha)
    return y, (xi, sx, wi, sw, mask_t)


def _quartet_fwd(x, w, h, method, grad_mode):
    y, res = _quartet_fwd_impl(x, w, h, method)
    return y, (res, h, x.shape, w.shape)


def _quartet_bwd(method, grad_mode, carry, gy):
    """Quartet backward from the forward's int8-plane residuals.

    The dequantized operands are rebuilt as ``plane * 2^(E-4)`` — the
    row scale is a pure power of two, so the bf16 product is EXACT and
    equals the reference's MXFP8-transposed operand values
    (mxfp4_transpose_mxfp8 output decoded; e2m1 x e8m0 fits e4m3 x e8m0
    losslessly).  Contracting in the plane-major layout keeps the whole
    backward relayout-free: the dgrad/wgrad outputs come out with K in
    plane order and `_unrotate_planes` folds the de-interleave into the
    block-diagonal unrotation for free.

    grad_mode selects how dY enters the GEMMs — see quartet_linear.
    Reference flow: SURVEY.md §3.4, quartet_bwd_sm120.cu:417-496.
    """
    (xi, sx, wi, sw, mask_t), h, xshape, wshape = carry
    m, k = xshape
    al = 1.0 if method == "quest" else 1.0 / 9.0
    gy32 = gy.astype(jnp.float32)

    if grad_mode == "mxfp8":
        # reference-parity: square-double MXFP8 quantization of dY
        # (pre-decoded to exact bf16), bf16-rate GEMMs
        gq_s = q.backward_square_double_scaled(gy.astype(jnp.bfloat16))
        gq_s = gq_s[:m]                                  # [M, N] bf16
        # fold the pow2 row scales of the dequantized operands into the
        # (row-quantized) gradient side: exact in bf16
        gyw = (gq_s.astype(jnp.float32) * (sw[None, :] * al)
               ).astype(jnp.bfloat16)
        gyx = (gq_s.astype(jnp.float32) * (sx[:m, None] * al)
               ).astype(jnp.bfloat16)
        dxh = jax.lax.dot_general(gyw, wi.astype(jnp.bfloat16),
                                  (((1,), (1,)), ((), ())),
                                  preferred_element_type=jnp.float32)
        dwh = jax.lax.dot_general(gyx, xi[:, :m].astype(jnp.bfloat16),
                                  (((0,), (1,)), ((), ())),
                                  preferred_element_type=jnp.float32)
    elif grad_mode == "bf16":
        gyw = (gy32 * (sw[None, :] * al)).astype(jnp.bfloat16)
        gyx = (gy32 * (sx[:m, None] * al)).astype(jnp.bfloat16)
        dxh = jax.lax.dot_general(gyw, wi.astype(jnp.bfloat16),
                                  (((1,), (1,)), ((), ())),
                                  preferred_element_type=jnp.float32)
        dwh = jax.lax.dot_general(gyx, xi[:, :m].astype(jnp.bfloat16),
                                  (((0,), (1,)), ((), ())),
                                  preferred_element_type=jnp.float32)
    elif grad_mode == "int8":
        # all-int8 step: per-row 8-bit gradient quantization
        # (int32-safe: |g| <= 127, |plane| <= 96 -> K < 176k)
        gyw = gy32 * (sw[None, :] * al)
        gq_d, sg_d = _int8_quantize_rows(gyw, axis=1)    # [M, N], [M]
        dxh = jax.lax.dot_general(gq_d, wi, (((1,), (1,)), ((), ())),
                                  preferred_element_type=jnp.int32
                                  ).astype(jnp.float32) * sg_d[:, None]
        gyx = gy32 * (sx[:m, None] * al)
        gq_w, sg_w = _int8_quantize_rows(gyx, axis=0)    # [M, N], [N]
        dwh = jax.lax.dot_general(gq_w, xi[:, :m], (((0,), (1,)), ((), ())),
                                  preferred_element_type=jnp.int32
                                  ).astype(jnp.float32) * sg_w[:, None]
    else:
        raise ValueError(f"unknown grad_mode {grad_mode!r}")

    dxh = dxh.astype(jnp.bfloat16)
    if method == "quest":
        # 0/1 mask in bf16 (exact multiply), unpacked straight into the
        # plane-major column order the contraction emitted
        dxh = dxh * _unpack_mask_planes(mask_t, k)
    dx = _unrotate_planes(dxh, h).astype(jnp.bfloat16)
    dw = _unrotate_planes(dwh.astype(jnp.bfloat16), h).astype(jnp.bfloat16)

    return dx, dw, jnp.zeros_like(h)


quartet_linear.defvjp(_quartet_fwd, _quartet_bwd)


def quartet_linear_reference_flow(x, w, h, method: str = "quest"):
    """Non-differentiable forward (inference): pre-quantized weight path."""
    xq, xs = q.fusedQuantizeMx(x, h, method=method)
    wq, ws = q.fusedQuantizeMx(w, h, method=method)
    return q.matmul_mxf4_bf16_tn(xq, wq, xs, ws, jnp.ones((1,), jnp.float32))


class QuantizedLinear:
    """Functional MXFP4 W4A4 linear with a cached quantized weight.

    Usage:
        lin = QuantizedLinear.create(w, h)        # quantize once
        y = lin(x)                                # prefill/decode
    This is the inference-path analogue of the reference's HF-integration
    layer swap (README.md:50-51).  Weights and activations travel in the
    K-major layout.
    """

    def __init__(self, wqt, wst, h, n, k, method="quest"):
        self.wqt, self.wst, self.h = wqt, wst, h
        self.n, self.k = n, k
        self.method = method

    @classmethod
    def create(cls, w: jax.Array, h: jax.Array, method: str = "quest"):
        n, k = w.shape
        wqt, wst = q.fusedQuantizeMx(w, h, method=method, layout="kmajor")
        return cls(wqt, wst, h, n, k, method)

    def __call__(self, x: jax.Array) -> jax.Array:
        shape = x.shape
        x2 = x.reshape(-1, self.k)
        xqt, xst = q.fusedQuantizeMx(x2, self.h, method=self.method,
                                     layout="kmajor")
        y = q.matmul_mxf4_bf16_kmajor(xqt, self.wqt, xst, self.wst,
                                      jnp.ones((1,), jnp.float32))
        return y.reshape(*shape[:-1], self.n)


jax.tree_util.register_pytree_node(
    QuantizedLinear,
    lambda l: ((l.wqt, l.wst, l.h), (l.n, l.k, l.method)),
    lambda aux, ch: QuantizedLinear(ch[0], ch[1], ch[2], aux[0], aux[1], aux[2]),
)
