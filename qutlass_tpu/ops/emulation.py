"""XLA implementations of every op.

Runs on any JAX platform and is the production path of every op except
the GPU's fused rotate+quantize+int8 encode (kernels/quantize_int8.py),
whose twin lives here too.  Uses the shared codecs in
``qutlass_tpu.formats.codecs`` (fp32 device semantics).

Reference call-signature parity: qutlass/__init__.py:34-310.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..formats import codecs as C
from ..utils import round_up


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _rotate(x: jax.Array, h: jax.Array, rot_size: int) -> jax.Array:
    """Apply the per-``rot_size``-chunk rotation: view [..., G, r] @ h.

    ``HIGHEST`` keeps the f32 product in full f32 on a GPU (whose
    default may be TF32): the quantizer's rounding points depend on it.
    """
    xr = x.reshape(-1, rot_size).astype(jnp.float32)
    hh = h.reshape(rot_size, rot_size)
    out = jax.lax.dot_general(
        xr, hh.astype(x.dtype).astype(jnp.float32),
        (((1,), (0,)), ((), ())), precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return out.reshape(x.shape)


def _pack_codes(codes: jax.Array) -> jax.Array:
    """int32 e2m1 codes [..., K] -> packed uint8 [..., K/2] (2i low nibble)."""
    even = codes[..., 0::2]
    odd = codes[..., 1::2]
    return (even | (odd << 4)).astype(jnp.uint8)


def _unpack_codes(packed: jax.Array) -> jax.Array:
    """packed uint8 [..., K/2] -> int32 codes [..., K]."""
    p = packed.astype(jnp.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    return jnp.stack([lo, hi], axis=-1).reshape(*p.shape[:-1], -1)


def _pack_mask(bits: jax.Array) -> jax.Array:
    """bool [..., K] -> uint8 [..., K/8] (bit i of byte j = element 8j+i)."""
    b = bits.astype(jnp.int32).reshape(*bits.shape[:-1], -1, 8)
    w = (1 << jnp.arange(8, dtype=jnp.int32))
    return jnp.sum(b * w, axis=-1).astype(jnp.uint8)


def _padded_scales(bytes2d: jax.Array, rows: int, cols: int) -> jax.Array:
    """Place [rows, cols] scale bytes into the x128/x4 padded buffer."""
    pr, pc = round_up(rows, 128), round_up(cols, 4)
    if (pr, pc) == (rows, cols):
        return bytes2d
    out = jnp.zeros((pr, pc), dtype=bytes2d.dtype)
    return lax.dynamic_update_slice(out, bytes2d, (0, 0))


# ---------------------------------------------------------------------------
# fused quantize
# ---------------------------------------------------------------------------

def _mx_quantize(a, h, rot_size: int, method: str):
    """Rotate + MXFP4-quantize the rows of ``a`` [..., K].

    Returns (codes int32 [rows, K], e8m0 bytes int32 [rows, K/32],
    pre-rounding values q f32 [rows, K]).
    """
    k = a.shape[-1]
    g = _rotate(a, h, rot_size).reshape(-1, k // 32, 32)
    if method == "quest":
        scale = C.mx_scale_quest(jnp.sum(g, axis=-1),
                                 jnp.sum(g * g, axis=-1), 32.0)
    else:
        scale = C.mx_scale_absmax(jnp.max(jnp.abs(g), axis=-1))
    scale_f, byte = C.pow2_floor_e8m0(scale)
    q = g / scale_f[..., None]
    if method != "quest":
        q = q * 3.0
    q = q.reshape(-1, k)
    return C.e2m1_rtne_codes(q), byte, q


def _nv_quantize(a, h, global_scale, rot_size: int, method: str):
    """Rotate + NVFP4-quantize the rows of ``a`` [..., K].

    Returns (codes int32 [rows, K], e4m3 bytes int32 [rows, K/16]).
    """
    k = a.shape[-1]
    gsv = jnp.asarray(global_scale, jnp.float32).reshape(())
    g = _rotate(a, h, rot_size).reshape(-1, k // 16, 16)
    if method == "abs_max":
        byte, mul = C.nv_absmax_scale_bytes(jnp.max(jnp.abs(g), axis=-1), gsv)
    else:
        byte, mul = C.nv_quest_scale_bytes(jnp.sum(g, axis=-1),
                                           jnp.sum(g * g, axis=-1))
    return C.e2m1_rtne_codes((g * mul[..., None]).reshape(-1, k)), byte


@partial(jax.jit, static_argnames=("rot_size", "method", "return_mask",
                                   "layout"))
def fused_quantize_mx(a: jax.Array, h: jax.Array, *, rot_size: int,
                      method: str = "quest", return_mask: bool = False,
                      layout: str = "rowmajor"):
    """Rotate + quantize to MXFP4 (group 32, e8m0 scales).

    Returns (packed_e2m1 u8 [..., K/2], scale_bytes u8 [pad_rows, pad_cols]
    [, clip_mask u8 [..., K/8]]).  Reference: fusedQuantizeMx
    (qutlass/__init__.py:149-180) with the epilogue math of
    epilogue_quant.h:462-575.
    """
    k = a.shape[-1]
    rows = a.size // k
    codes, byte, q = _mx_quantize(a, h, rot_size, method)
    codes, q = codes.reshape(a.shape), q.reshape(a.shape)
    packed = _pack_codes(codes)
    sbytes = byte.reshape(rows, k // 32).astype(jnp.uint8)
    if layout == "kmajor_codes":
        ck = codes.reshape(rows, k).T.astype(jnp.uint8)
        if return_mask:
            return ck, sbytes.T, _pack_mask(jnp.abs(q) < 6.0).reshape(
                rows, k // 8).T
        return ck, sbytes.T
    if layout == "kmajor":
        pk = packed.reshape(rows, k // 2).T
        if return_mask:
            return pk, sbytes.T, _pack_mask(jnp.abs(q) < 6.0).reshape(
                rows, k // 8).T
        return pk, sbytes.T
    scales_out = _padded_scales(sbytes, rows, k // 32)
    if return_mask:
        mask = _pack_mask(jnp.abs(q) < 6.0)
        return packed, scales_out, mask
    return packed, scales_out


@partial(jax.jit, static_argnames=("rot_size", "method", "layout"))
def fused_quantize_nv(a: jax.Array, h: jax.Array, global_scale: jax.Array, *,
                      rot_size: int, method: str = "abs_max",
                      layout: str = "rowmajor"):
    """Rotate + quantize to NVFP4 (group 16, e4m3 scales).

    Reference: fusedQuantizeNv (qutlass/__init__.py:183-203),
    epilogue_quant.h:1570-1693.  ``layout="kmajor"`` emits the
    GEMM-native layout (packed [K/2, rows], scale bytes [K/16, rows]).
    """
    k = a.shape[-1]
    rows = a.size // k
    codes, byte = _nv_quantize(a, h, global_scale, rot_size, method)
    packed = _pack_codes(codes.reshape(a.shape))
    sbytes = byte.reshape(rows, k // 16).astype(jnp.uint8)
    if layout == "kmajor":
        return packed.reshape(rows, k // 2).T, sbytes.T
    return packed, _padded_scales(sbytes, rows, k // 16)


# ---------------------------------------------------------------------------
# block-scaled GEMMs
# ---------------------------------------------------------------------------

def _dequant_fp4(packed: jax.Array, scale_bytes: jax.Array, gs: int) -> jax.Array:
    """packed u8 [R, K/2] + scale bytes [R, K/gs] -> bf16 [R, K] (exact)."""
    codes = _unpack_codes(packed)
    sb = scale_bytes.astype(jnp.int32)
    sexp = jnp.broadcast_to(sb[:, :, None], (*sb.shape, gs)).reshape(codes.shape)
    return C.e2m1_decode_scaled_bf16(codes, sexp)


def _dequant_fp8(data: jax.Array, scale_bytes: jax.Array, gs: int = 32) -> jax.Array:
    d = data.astype(jnp.int32)
    sb = scale_bytes.astype(jnp.int32)
    sexp = jnp.broadcast_to(sb[:, :, None], (*sb.shape, gs)).reshape(d.shape)
    return C.e4m3_decode_scaled_bf16(d, sexp)


@partial(jax.jit, static_argnames=("out_dtype",))
def matmul_mxf4_bf16_tn(a, b, a_sf, b_sf, alpha, out_dtype=jnp.bfloat16):
    """W4A4 block-scaled GEMM: out = (dq(a) @ dq(b)^T) * alpha, bf16 out.

    a/b: packed u8 [M, K/2] / [N, K/2]; a_sf/b_sf: e8m0 bytes [M, K/32] /
    [N, K/32] (row-major — no swizzle).
    Reference: matmul_mxf4_bf16_tn (gemm.cu:174-248).
    """
    av = _dequant_fp4(a, a_sf, 32)
    bv = _dequant_fp4(b, b_sf, 32)
    out = jax.lax.dot_general(av, bv, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return (out * jnp.asarray(alpha, jnp.float32).reshape(())).astype(out_dtype)


@partial(jax.jit, static_argnames=("out_dtype",))
def matmul_mxf4_bf16_kmajor(at, bt, a_sft, b_sft, alpha, out_dtype=jnp.bfloat16):
    """K-major variant (operands from layout='kmajor' quantization)."""
    return matmul_mxf4_bf16_tn(at.T, bt.T, a_sft.T, b_sft.T, alpha,
                               out_dtype=out_dtype)


@partial(jax.jit, static_argnames=("out_dtype",))
def matmul_mxf4_bf16_kmajor_codes(at, bt, a_sft, b_sft, alpha, out_dtype=jnp.bfloat16):
    """Unpacked-activation-codes variant (layout='kmajor_codes')."""
    a = _pack_codes(at.T.astype(jnp.int32))
    return matmul_mxf4_bf16_tn(a, bt.T, a_sft.T, b_sft.T, alpha,
                               out_dtype=out_dtype)


@partial(jax.jit, static_argnames=("rot_size", "method"))
def fused_linear_mxf4(x, wqt, wst, h, alpha, *, rot_size: int,
                      method: str = "quest"):
    """Composed emulation of the fused quantize+GEMM linear.

    The abs-max dequant constant (1/3 per
    operand) is folded into alpha so the result is the true linear
    output for both methods.
    """
    al = jnp.asarray(alpha, jnp.float32)
    if method != "quest":
        al = al * (1.0 / 9.0)
    xq, xs = fused_quantize_mx(x, h, rot_size=rot_size, method=method,
                               layout="kmajor")
    return matmul_mxf4_bf16_kmajor(xq, wqt, xs, wst, al)


@partial(jax.jit, static_argnames=("out_dtype",))
def matmul_nvf4_bf16_kmajor(at, bt, a_sft, b_sft, alpha, out_dtype=jnp.bfloat16):
    """K-major NVFP4 GEMM (operands from layout='kmajor' quantization)."""
    return matmul_nvf4_bf16_tn(at.T, bt.T, a_sft.T, b_sft.T, alpha,
                               out_dtype=out_dtype)


@partial(jax.jit, static_argnames=("rot_size", "method"))
def fused_linear_nvf4(x, wqt, wst, h, global_scale, alpha, *, rot_size: int,
                      method: str = "abs_max"):
    """Composed emulation of the fused NVFP4 quantize+GEMM linear.

    ``global_scale`` applies to the activation quantization; the weight
    global scale (and both dequant normalizations) live in ``alpha``,
    exactly as in the reference's two-level vLLM scheme
    (epilogue_quant.h:1650-1693).
    """
    xq, xs = fused_quantize_nv(x, h, global_scale, rot_size=rot_size,
                               method=method, layout="kmajor")
    return matmul_nvf4_bf16_kmajor(xq, wqt, xs, wst, alpha)


@partial(jax.jit, static_argnames=("out_dtype",))
def matmul_nvf4_bf16_tn(a, b, a_sf, b_sf, alpha, out_dtype=jnp.bfloat16):
    """NVFP4 GEMM (group 16, e4m3 scales). Reference: gemm.cu:250-326."""
    codes_a = _unpack_codes(a)
    codes_b = _unpack_codes(b)
    sa = C.e4m3_decode_f32(a_sf.astype(jnp.int32))
    sb = C.e4m3_decode_f32(b_sf.astype(jnp.int32))
    av = C.e2m1_decode_f32(codes_a).reshape(a.shape[0], -1, 16) * sa[..., None]
    bv = C.e2m1_decode_f32(codes_b).reshape(b.shape[0], -1, 16) * sb[..., None]
    av = av.reshape(a.shape[0], -1).astype(jnp.float32)
    bv = bv.reshape(b.shape[0], -1).astype(jnp.float32)
    out = jax.lax.dot_general(av, bv, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return (out * jnp.asarray(alpha, jnp.float32).reshape(())).astype(out_dtype)


@partial(jax.jit, static_argnames=("out_dtype",))
def matmul_mxf8_bf16_tn(a, b, a_sf, b_sf, alpha, out_dtype=jnp.bfloat16):
    """MXFP8 GEMM, TN: a [M, K] e4m3 bytes, b [N, K]. gemm.cu:328-386."""
    av = _dequant_fp8(a, a_sf)
    bv = _dequant_fp8(b, b_sf)
    out = jax.lax.dot_general(av, bv, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return (out * jnp.asarray(alpha, jnp.float32).reshape(())).astype(out_dtype)


@partial(jax.jit, static_argnames=("out_dtype",))
def matmul_mxf8_bf16_nn(a, b, a_sf, b_sf, alpha, out_dtype=jnp.bfloat16):
    """MXFP8 GEMM, NN: a stored [K, M] (column-major logical [M, K]).

    a_sf is [M, K/32] row-major for the *logical* A.  Used by the QAT
    wgrad (gemm.cu:388-434).
    """
    at = a.T  # logical [M, K]
    av = _dequant_fp8(at, a_sf)
    bv = _dequant_fp8(b, b_sf)
    out = jax.lax.dot_general(av, bv, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return (out * jnp.asarray(alpha, jnp.float32).reshape(())).astype(out_dtype)


# ---------------------------------------------------------------------------
# QAT backward ops
# ---------------------------------------------------------------------------

def _absmax_quantize_g32(xh: jax.Array):
    """Abs-max g32 quantizer of the backward kernels (no +1e-8).

    quartet_bwd_sm120.cu:311-321: scale = pow2floor(absmax), q = x*3/scale.
    """
    g = xh.reshape(*xh.shape[:-1], -1, 32)
    amax = jnp.max(jnp.abs(g), axis=-1)
    scale_f, byte = C.pow2_floor_e8m0(amax)
    q = (g / scale_f[..., None] * 3.0).reshape(xh.shape)
    return C.e2m1_rtne_codes(q), byte


@partial(jax.jit, static_argnames=("rot_size",))
def backward_t_bf16(x: jax.Array, h: jax.Array, *, rot_size: int = 32):
    """Transpose + rotate + abs-max g32 quantize (QAT wgrad operand).

    x: [..., N, K] bf16 -> (packed u8 [..., K, N/2], e8m0 u8 [..., K, N/32]).
    Reference: quartet_bwd_sm120.cu:237-325 / __init__.py:206-243.
    """
    xt = jnp.swapaxes(x, -2, -1)
    xh = _rotate(xt, h, rot_size)
    codes, byte = _absmax_quantize_g32(xh)
    return _pack_codes(codes), byte.astype(jnp.uint8)


@partial(jax.jit, static_argnames=("rot_size",))
def backward_qt_bf16(x_e2m1: jax.Array, x_e8m0: jax.Array, h: jax.Array,
                     alpha: jax.Array, *, rot_size: int = 32):
    """Dequant MXFP4 -> transpose -> rotate -> abs-max requantize.

    Alpha semantics per quartet_bwd_sm120.cu:415-424: the input is
    dequantized *without* alpha; the output scale is
    pow2floor(absmax/alpha) and values are multiplied by
    3/(scale*alpha).
    """
    al = jnp.asarray(alpha, jnp.float32).reshape(())
    codes = _unpack_codes(x_e2m1)
    sexp = jnp.broadcast_to(x_e8m0.astype(jnp.int32)[..., None],
                            (*x_e8m0.shape, 32)).reshape(codes.shape)
    xdq = C.e2m1_decode_scaled_bf16(codes, sexp)       # no /alpha
    xt = jnp.swapaxes(xdq, -2, -1)
    xh = _rotate(xt, h, rot_size)
    g = xh.reshape(*xh.shape[:-1], -1, 32)
    amax = jnp.max(jnp.abs(g), axis=-1)
    scale_f, byte = C.pow2_floor_e8m0(amax / al)
    q = (g * (3.0 / (scale_f[..., None] * al))).reshape(xh.shape)
    return _pack_codes(C.e2m1_rtne_codes(q)), byte.astype(jnp.uint8)


@jax.jit
def backward_bf16_square_double_mxfp8(x: jax.Array):
    """32x32-tile double quantization to MXFP8 with both scale orientations.

    x: [M, N] bf16 (M already padded to 128 by the caller).  Returns
    (fp8 bytes [M, N], row_scales [M, N/32], col_scales [N, M/32]).
    Reference: quartet_bwd_sm120.cu:496-624.
    """
    m, n = x.shape
    t = x.astype(jnp.float32).reshape(m // 32, 32, n // 32, 32)
    amax = jnp.max(jnp.abs(t), axis=(1, 3))
    ebyte = C.mxfp8_shared_exp_bytes(amax)             # [M/32, N/32]
    # divide in bf16 (exact for pow2 scales), cast to e4m3
    inv = C.e8m0_decode_f32(ebyte)
    q = (x.astype(jnp.float32).reshape(m // 32, 32, n // 32, 32)
         / inv[:, None, :, None])
    fp8 = C.e4m3_rtne_bytes(q.astype(jnp.bfloat16).astype(jnp.float32))
    fp8 = fp8.astype(jnp.uint8).reshape(m, n)
    row_scales = jnp.repeat(ebyte, 32, axis=0).astype(jnp.uint8)
    col_scales = jnp.repeat(ebyte.T, 32, axis=0).astype(jnp.uint8)
    return fp8, row_scales, col_scales


@jax.jit
def backward_square_double_scaled(x: jax.Array):
    """Scaled-bf16 twin of :func:`backward_bf16_square_double_mxfp8`.

    Returns ``decode(fp8) * 2^(scale-127)`` as bf16 [M, N] — the same
    quantization points, pre-decoded so the QAT backward matmuls run as
    plain bf16 dots (an extension; no reference analogue).
    Defined by composition so it is bit-consistent with the public op.
    """
    fp8, row_scales, _ = backward_bf16_square_double_mxfp8(x)
    vals = C.e4m3_decode_f32(fp8.astype(jnp.int32))
    sc = C.e8m0_decode_f32(jnp.repeat(row_scales.astype(jnp.int32), 32,
                                      axis=1))
    return (vals * sc).astype(jnp.bfloat16)


@jax.jit
def mxfp4_transpose_scaled(x_fp4: jax.Array, scales: jax.Array):
    """Scaled-bf16 twin of :func:`mxfp4_transpose_mxfp8` (bf16 [N, M])."""
    fp8, ebyte = mxfp4_transpose_mxfp8(x_fp4, scales)
    vals = C.e4m3_decode_f32(fp8.astype(jnp.int32))
    sc = C.e8m0_decode_f32(jnp.repeat(ebyte.astype(jnp.int32), 32, axis=1))
    return (vals * sc).astype(jnp.bfloat16)


@jax.jit
def mxfp4_transpose_scaled_kmajor(qt: jax.Array, st: jax.Array):
    """K-major-input twin of :func:`mxfp4_transpose_scaled`.

    qt u8 [K/2, rows] (row 2k in the low nibble), st u8 [K/32, rows] ->
    dequant-scaled bf16 [K, rows].  Defined by repacking to the
    row-major form and composing the public ops (bit-consistent by
    construction); rows are padded to 256 internally and sliced back.
    """
    k2, rows = qt.shape
    k = k2 * 2
    q32 = qt.astype(jnp.int32)
    codes = jnp.stack([q32 & 0xF, (q32 >> 4) & 0xF], axis=1).reshape(k, rows)
    codes_r = codes.T                                   # [rows, K]
    packed_r = (codes_r[:, 0::2] | (codes_r[:, 1::2] << 4)).astype(jnp.uint8)
    scales_r = st.T                                     # [rows, K/32]
    rp = (rows + 255) // 256 * 256
    if rp != rows:
        packed_r = jnp.pad(packed_r, ((0, rp - rows), (0, 0)))
        scales_r = jnp.pad(scales_r, ((0, rp - rows), (0, 0)),
                           constant_values=127)
    return mxfp4_transpose_scaled(packed_r, scales_r)[:, :rows]


@jax.jit
def mxfp4_transpose_mxfp8(x_fp4: jax.Array, scales: jax.Array):
    """Dequant MXFP4 -> transpose -> abs-max g32 requantize to MXFP8.

    x_fp4: packed u8 [M, N/2]; scales e8m0 u8 [M, N/32] (M padded to 256
    by the caller, pad scales forced to 1.0).  Returns
    (fp8 bytes [N, M], e8m0 [N, M/32]).
    Reference: quartet_bwd_sm120.cu:626-734.
    """
    m = x_fp4.shape[0]
    n = x_fp4.shape[1] * 2
    codes = _unpack_codes(x_fp4)
    sexp = jnp.broadcast_to(scales.astype(jnp.int32)[..., None],
                            (m, n // 32, 32)).reshape(m, n)
    xdq = C.e2m1_decode_scaled_bf16(codes, sexp)       # bf16 [M, N]
    xt = xdq.T.astype(jnp.float32)                     # [N, M]
    g = xt.reshape(n, m // 32, 32)
    amax = jnp.max(jnp.abs(g), axis=-1)
    ebyte = C.mxfp8_shared_exp_bytes(amax)             # [N, M/32]
    inv = C.e8m0_decode_f32(ebyte)
    q = g / inv[..., None]
    fp8 = C.e4m3_rtne_bytes(q.astype(jnp.bfloat16).astype(jnp.float32))
    return fp8.astype(jnp.uint8).reshape(n, m), ebyte.astype(jnp.uint8)


@partial(jax.jit, static_argnames=("rot_size", "method"))
def fused_quantize_mx_int8(a: jax.Array, h: jax.Array, *, rot_size: int,
                           method: str = "quest"):
    """XLA twin of the fused rotate+quantize+int8 kernel
    (kernels/quantize_int8.py): the codes of :func:`fused_quantize_mx`
    encoded by ``int8path.encode_int8``.  a: [rows, K].  Returns
    (a' int8 [rows, K], row_scale f32 [rows], e8m0 bytes u8
    [rows, K/32])."""
    from . import int8path as I8
    codes, byte, _ = _mx_quantize(a, h, rot_size, method)
    ai, sa, _ = I8.encode_int8(codes, byte)
    return ai, sa, byte.astype(jnp.uint8)


@partial(jax.jit, static_argnames=("rot_size", "method"))
def fused_quantize_nv_int8(a: jax.Array, h: jax.Array,
                           global_scale: jax.Array, *, rot_size: int,
                           method: str = "abs_max"):
    """XLA twin of the fused NV kernel: the codes of
    :func:`fused_quantize_nv` encoded by ``int8path.encode_nv_int8_rows``.
    a: [rows, K].  Returns (a' int8 [rows, K], sigma f32 [rows], e4m3
    bytes u8 [rows, K/16])."""
    from . import int8path as I8
    codes, byte = _nv_quantize(a, h, global_scale, rot_size, method)
    ai, sg = I8.encode_nv_int8_rows(codes, byte)
    return ai, sg, byte.astype(jnp.uint8)
