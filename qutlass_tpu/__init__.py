"""qutlass_tpu — microscaling (MX/NV FP4, MXFP8) quantized BLAS in JAX.

A JAX rebuild of the capabilities of IST-DASLab/qutlass: fused
rotation+quantization, block-scaled GEMMs and the Quartet QAT backward
ops, plus quantized linear layers, model integration and sharding
utilities.  The ops are plain XLA programs; on an NVIDIA GPU the
production activation quantizer of the int8 evaluator is a fused Pallas
kernel (kernels/quantize_int8.py).

Public API mirrors the reference (qutlass/__init__.py) with the same
names and call shapes; snake_case aliases are provided.  On-device
storage for sub-byte formats:

  * e2m1 data: ``uint8``, two values per byte, element 2i in the low nibble
  * e8m0 scales: ``uint8`` exponent bytes
  * e4m3 data/scales: ``uint8`` bit patterns

(On host these bytes can be viewed with ``ml_dtypes``.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import io, profiling, utils
from .formats import codecs, golden
from .kernels import quantize_int8 as _qi8
from .ops import emulation as _emu
from .ops import validation as _val
from .utils import (ceil_div, dct_matrix, from_blocked, get_padded_shape_mx,
                    get_padded_shape_nv, hadamard_matrix, identity_matrix,
                    pad_to_block, round_up, to_blocked, to_blocked_swizzled)

__version__ = "0.1.0"

__all__ = [
    "fusedQuantizeMx", "fusedQuantizeNv",
    "matmul_mxf4_bf16_tn", "matmul_mxf4_bf16_kmajor", "fused_linear_mxf4",
    "matmul_ada_mxf4_bf16_tn", "matmul_nvf4_bf16_tn",
    "matmul_nvf4_bf16_kmajor", "fused_linear_nvf4",
    "matmul_mxf4_bf16_kmajor_codes",
    "matmul_mxf8_bf16_tn", "matmul_mxf8_bf16_nn",
    "backward_t_bf16", "backward_qt_bf16",
    "backward_bf16_square_double_mxfp8", "mxfp4_transpose_mxfp8",
    "backward_square_double_scaled", "mxfp4_transpose_scaled",
    "mxfp4_transpose_scaled_kmajor",
    "fused_quantize_mx", "fused_quantize_nv",
    "fusedQuantizeMxInt8", "fusedQuantizeNvInt8",
    "fused_quantize_mx_int8", "fused_quantize_nv_int8",
    "to_blocked", "to_blocked_swizzled", "pad_to_block",
    "get_padded_shape_mx", "get_padded_shape_nv",
    "hadamard_matrix", "dct_matrix", "identity_matrix",
]


def _as_bytes(x: jax.Array) -> jax.Array:
    """Accept fp8/fp4 ml_dtypes arrays on host and view them as uint8."""
    if x.dtype == jnp.uint8:
        return x
    if x.dtype in (jnp.dtype("float8_e8m0fnu"), jnp.dtype("float8_e4m3fn")):
        return jax.lax.bitcast_convert_type(x, jnp.uint8)
    if x.dtype == jnp.int32:
        return x.astype(jnp.uint8)
    raise TypeError(f"expected uint8 byte tensor, got {x.dtype}")


def _norm_scales(sf: jax.Array, rows: int, cols: int) -> jax.Array:
    """Normalize a scale argument to exact row-major [rows, cols] bytes.

    Accepts the flattened padded layout produced by :func:`to_blocked`,
    the padded 2-D buffer from the quantizers, or an exact [rows, cols]
    matrix.
    """
    sf = _as_bytes(sf)
    if sf.ndim == 1:
        # flattened padded buffer: infer the padded column width from
        # the total size (to_blocked pads cols to x4 and rows to x128,
        # but accept any whole-row padding >= cols)
        for pc in (round_up(cols, 4), cols):
            if sf.size % pc == 0 and sf.size >= rows * pc:
                sf = sf.reshape(-1, pc)
                break
        else:
            raise ValueError(
                f"flattened scale buffer of {sf.size} bytes cannot cover "
                f"[{rows}, {cols}] (expected row padding to a multiple of "
                f"{round_up(cols, 4)} or {cols} columns)")
    if sf.ndim != 2:
        raise ValueError(f"scales must be 1-D or 2-D, got shape {sf.shape}")
    if sf.shape[0] > rows or sf.shape[1] > cols:
        sf = sf[:rows, :cols]
    if sf.shape != (rows, cols):
        raise ValueError(
            f"scale buffer shape {sf.shape} does not cover the required "
            f"[{rows}, {cols}] (pass the quantizer's padded buffer, a "
            f"to_blocked flattening, or the exact matrix)")
    return sf


def _gpu_int8_kernel(k: int) -> bool:
    """Whether the fused rotate+quantize+int8 kernel takes this call:
    on a GPU, for K a multiple of its 128-wide chunk."""
    return jax.default_backend() == "gpu" and k % 128 == 0


# ---------------------------------------------------------------------------
# fused quantization
# ---------------------------------------------------------------------------

def fusedQuantizeMx(a: jax.Array, h: jax.Array, *, method: str = "quest",
                    return_mask: bool = False, layout: str = "rowmajor"):
    """Fused rotation + MXFP4 quantization.

    a: [..., K] bf16; h: [r, r] rotation (Hadamard/identity), r in
    {16,32,64,128}, K % r == 0, K % 32 == 0.
    Returns (e2m1 u8 [..., K/2], e8m0 u8 [pad_rows, pad_cols]
    [, clip_mask u8 [..., K/8]]).  Reference: qutlass/__init__.py:149-180.

    ``layout="kmajor"`` returns the K-major layout instead:
    (e2m1 u8 [K/2, rows], e8m0 u8 [K/32, rows][, mask u8 [K/8, rows]]),
    unpadded — feed directly to :func:`matmul_mxf4_bf16_kmajor`.
    """
    if method not in ("quest", "abs_max"):
        raise ValueError(f"invalid method {method!r}, must be 'quest' or 'abs_max'")
    if return_mask and method != "quest":
        raise ValueError("return_mask is only supported for method 'quest'")
    _val.check_bf16("a", a)
    k = a.shape[-1]
    rot = _val.check_rotation(h, k)
    _val.check_group_dim("fusedQuantizeMx", k, 32)
    return _emu.fused_quantize_mx(
        a, h, rot_size=rot, method=method, return_mask=return_mask,
        layout=layout)


def fusedQuantizeNv(a: jax.Array, h: jax.Array, global_scale: jax.Array, *,
                    method: str = "abs_max", layout: str = "rowmajor"):
    """Fused rotation + NVFP4 quantization (group 16, e4m3 scales).

    Reference: qutlass/__init__.py:183-203.  ``layout="kmajor"``
    returns (e2m1 u8 [K/2, rows], e4m3 u8 [K/16, rows]) for
    :func:`matmul_nvf4_bf16_kmajor`.
    """
    if method not in ("quest", "abs_max"):
        raise ValueError(f"invalid method {method!r}, must be 'quest' or 'abs_max'")
    _val.check_bf16("a", a)
    k = a.shape[-1]
    rot = _val.check_rotation(h, k)
    _val.check_group_dim("fusedQuantizeNv", k, 16)
    return _emu.fused_quantize_nv(
        a, h, global_scale, rot_size=rot, method=method, layout=layout)


def fusedQuantizeMxInt8(a: jax.Array, h: jax.Array, *,
                        method: str = "quest"):
    """Fused rotation + MXFP4 quantization + int8 encode — the
    activation path of the int8 evaluator (ops/int8path.py).

    a: bf16 [rows, K].  Returns (a' int8 [rows, K], row_scale f32
    [rows] = 2^(E-4), e8m0 scale bytes u8 [rows, K/32]).  Feed (a',
    row_scale) with a :func:`~qutlass_tpu.ops.int8path.prepare_weight_int8`
    weight to ``int8path.matmul_mxf4_bf16_int8``.  On a GPU with
    K % 128 == 0 this runs the fused kernel (kernels/quantize_int8.py);
    elsewhere its XLA twin, with the same results.  No reference
    counterpart: the reference's fp4 tensor cores need no int8 bridge.
    """
    if method not in ("quest", "abs_max"):
        raise ValueError(f"invalid method {method!r}, must be 'quest' or 'abs_max'")
    _val.check_bf16("a", a)
    k = a.shape[-1]
    rot = _val.check_rotation(h, k)
    _val.check_group_dim("fusedQuantizeMxInt8", k, 32)
    if _gpu_int8_kernel(k):
        return _qi8.quantize_int8(a, h, fmt="mx", method=method)
    return _emu.fused_quantize_mx_int8(a, h, rot_size=rot, method=method)


def fusedQuantizeNvInt8(a: jax.Array, h: jax.Array, global_scale: jax.Array,
                        *, method: str = "abs_max"):
    """Fused rotation + NVFP4 quantization + int8 encode.

    a: bf16 [rows, K].  Returns (a' int8 [rows, K], sigma f32 [rows],
    e4m3 scale bytes u8 [rows, K/16]); the encode carries the documented
    bounded rounding (<= rowmax/254 per element — ops/int8path.py).
    Kernel choice as :func:`fusedQuantizeMxInt8`.
    """
    if method not in ("quest", "abs_max"):
        raise ValueError(f"invalid method {method!r}, must be 'quest' or 'abs_max'")
    _val.check_bf16("a", a)
    k = a.shape[-1]
    rot = _val.check_rotation(h, k)
    _val.check_group_dim("fusedQuantizeNvInt8", k, 16)
    if _gpu_int8_kernel(k):
        return _qi8.quantize_int8(a, h, global_scale, fmt="nv", method=method)
    return _emu.fused_quantize_nv_int8(a, h, global_scale, rot_size=rot,
                                       method=method)


# snake_case aliases
fused_quantize_mx = fusedQuantizeMx
fused_quantize_nv = fusedQuantizeNv
fused_quantize_mx_int8 = fusedQuantizeMxInt8
fused_quantize_nv_int8 = fusedQuantizeNvInt8


# ---------------------------------------------------------------------------
# block-scaled GEMMs
# ---------------------------------------------------------------------------

def matmul_mxf4_bf16_tn(a, b, a_sf, b_sf, alpha):
    """out[M,N] = (dq(a) @ dq(b)^T) * alpha in bf16.

    a: u8 [M, K/2], b: u8 [N, K/2]; scales row-major (or the flattened
    padded layout from :func:`to_blocked`).  Reference gemm.cu:174-248.
    """
    m, n, k = _val.check_matmul_tn(a, b, 32)
    a_sf = _norm_scales(a_sf, m, k // 32)
    b_sf = _norm_scales(b_sf, n, k // 32)
    a, b = _as_bytes(a), _as_bytes(b)
    return _emu.matmul_mxf4_bf16_tn(a, b, a_sf, b_sf, alpha)


def matmul_mxf4_bf16_kmajor(at, bt, a_sft, b_sft, alpha,
                            out_dtype=jnp.bfloat16):
    """K-major MXFP4 GEMM (the fp4-weight path of quantized linears).

    Operands come from ``fusedQuantizeMx(..., layout="kmajor")``:
    at u8 [K/2, M], bt u8 [K/2, N], scales u8 [K/32, M] / [K/32, N].
    """
    return _emu.matmul_mxf4_bf16_kmajor(
        _as_bytes(at), _as_bytes(bt), _as_bytes(a_sft), _as_bytes(b_sft),
        alpha, out_dtype=out_dtype)


def matmul_mxf4_bf16_kmajor_codes(at, bt, a_sft, b_sft, alpha):
    """K-major MXFP4 GEMM with UNPACKED activation codes.

    at: u8 e2m1 codes [K, M] from ``fusedQuantizeMx(...,
    layout="kmajor_codes")`` (the quantizer skips nibble packing — the
    activation-side fast path; weights stay packed).  Bit-identical to
    :func:`matmul_mxf4_bf16_kmajor`.
    """
    return _emu.matmul_mxf4_bf16_kmajor_codes(
        _as_bytes(at), _as_bytes(bt), _as_bytes(a_sft), _as_bytes(b_sft),
        alpha)


def fused_linear_mxf4(x, wqt, wst, h, alpha=None, *, method: str = "quest"):
    """W4A4 linear against a pre-quantized K-major weight.

    Runs as the composed quantize + GEMM pipeline.
    """
    rot = h.shape[-1]
    k = x.shape[-1]
    if alpha is None:
        alpha = jnp.ones((1,), jnp.float32)
    y = _emu.fused_linear_mxf4(
        x.reshape(-1, k), _as_bytes(wqt), _as_bytes(wst), h, alpha,
        rot_size=rot, method=method)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def matmul_ada_mxf4_bf16_tn(a, b, a_sf, b_sf, alpha):
    """Small-batch variant — the same op here.

    The reference needs a second kernel for this regime
    (gemm_ada.cu:29-135) because of the Blackwell scale swizzle; the
    row-major scale layout here needs none (SURVEY.md §2.6 note).
    """
    return matmul_mxf4_bf16_tn(a, b, a_sf, b_sf, alpha)


def matmul_nvf4_bf16_tn(a, b, a_sf, b_sf, alpha):
    """NVFP4 GEMM (group 16, e4m3 scales). Reference gemm.cu:250-326."""
    m, n, k = _val.check_matmul_tn(a, b, 16)
    a_sf = _norm_scales(a_sf, m, k // 16)
    b_sf = _norm_scales(b_sf, n, k // 16)
    a, b = _as_bytes(a), _as_bytes(b)
    return _emu.matmul_nvf4_bf16_tn(a, b, a_sf, b_sf, alpha)


def matmul_nvf4_bf16_kmajor(at, bt, a_sft, b_sft, alpha,
                            out_dtype=jnp.bfloat16):
    """K-major NVFP4 GEMM — operands from
    ``fusedQuantizeNv(..., layout="kmajor")``."""
    return _emu.matmul_nvf4_bf16_kmajor(
        _as_bytes(at), _as_bytes(bt), _as_bytes(a_sft), _as_bytes(b_sft),
        alpha, out_dtype=out_dtype)


def fused_linear_nvf4(x, wqt, wst, h, global_scale, alpha=None, *,
                      method: str = "abs_max"):
    """NVFP4 linear: rotate+quantize x (group 16, e4m3 scales) and GEMM
    against a pre-quantized K-major weight.  ``global_scale`` is the
    activation-side global scale; fold the weight-side global scale
    into ``alpha``.
    """
    rot = h.shape[-1]
    k = x.shape[-1]
    if alpha is None:
        alpha = jnp.ones((1,), jnp.float32)
    y = _emu.fused_linear_nvf4(x.reshape(-1, k), _as_bytes(wqt),
                               _as_bytes(wst), h, global_scale, alpha,
                               rot_size=rot, method=method)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def matmul_mxf8_bf16_tn(a, b, a_sf, b_sf, alpha):
    """MXFP8 GEMM TN: a u8(e4m3) [M,K], b u8 [N,K]. Reference gemm.cu:328-386."""
    m, n, k = a.shape[0], b.shape[0], a.shape[1]
    a_sf = _norm_scales(a_sf, m, k // 32)
    b_sf = _norm_scales(b_sf, n, k // 32)
    a, b = _as_bytes(a), _as_bytes(b)
    return _emu.matmul_mxf8_bf16_tn(a, b, a_sf, b_sf, alpha)


def matmul_mxf8_bf16_nn(a, b, a_sf, b_sf, alpha):
    """MXFP8 GEMM NN: a stored [K, M] (logical A^T). Reference gemm.cu:388-434."""
    k, m = a.shape
    n = b.shape[0]
    a_sf = _norm_scales(a_sf, m, k // 32)
    b_sf = _norm_scales(b_sf, n, k // 32)
    a, b = _as_bytes(a), _as_bytes(b)
    return _emu.matmul_mxf8_bf16_nn(a, b, a_sf, b_sf, alpha)


# ---------------------------------------------------------------------------
# QAT backward ops
# ---------------------------------------------------------------------------

def backward_t_bf16(x, h):
    """Rotate-transpose-quantize to MXFP4 (QAT wgrad operand).

    x: [..., N, K] bf16 -> (e2m1 u8 [..., K, N/2], e8m0 u8 [..., K, N/32]).
    Reference: __init__.py:206-243 / quartet_bwd_sm120.cu:237-325.
    """
    rot = h.shape[-1]
    return _emu.backward_t_bf16(x, h, rot_size=rot)


def backward_qt_bf16(x_e2m1, x_e8m0, h, alpha):
    """Dequant-rotate-transpose-requantize MXFP4 (QAT dgrad-side operand).

    Reference: __init__.py:246-282 / quartet_bwd_sm120.cu:327-493.
    """
    rot = h.shape[-1]
    x_e2m1, x_e8m0 = _as_bytes(x_e2m1), _as_bytes(x_e8m0)
    n = x_e2m1.shape[-1] * 2
    if x_e8m0.ndim == x_e2m1.ndim and x_e8m0.shape[-1] != n // 32:
        x_e8m0 = x_e8m0[..., : x_e2m1.shape[-2], : n // 32]
    return _emu.backward_qt_bf16(x_e2m1, x_e8m0, h, alpha, rot_size=rot)


def backward_bf16_square_double_mxfp8(x_bf16):
    """32x32-tile double quantization to MXFP8, both scale orientations.

    Pads M to 128 like the reference (__init__.py:284-293).
    """
    x = pad_to_block(x_bf16, [0], 128)
    return _emu.backward_bf16_square_double_mxfp8(x)


def backward_square_double_scaled(x_bf16):
    """Square-double quantization emitting dequant-scaled bf16 [Mp, N].

    An extension with no reference analogue: identical
    quantization points to :func:`backward_bf16_square_double_mxfp8`,
    returned as ``e4m3_value * 2^(scale-127)`` in bf16 (exact — a 4-bit
    significand times a power of two).  The QAT backward consumes this
    with plain bf16 matmuls instead of decode-bound MXFP8 GEMMs.
    """
    x = pad_to_block(x_bf16, [0], 128)
    return _emu.backward_square_double_scaled(x)


def mxfp4_transpose_scaled(x_fp4, scales):
    """Dequant-transpose-requant emitting dequant-scaled bf16 [N, Mp].

    Scaled-bf16 twin of :func:`mxfp4_transpose_mxfp8` (same pad-to-256
    semantics; pad rows quantize to zeros).
    """
    x_fp4 = _as_bytes(x_fp4)
    m = x_fp4.shape[0]
    n = x_fp4.shape[1] * 2
    scales = _norm_scales(scales, min(m, scales.shape[0] if scales.ndim == 2 else m),
                          n // 32)
    mp = round_up(m, 256)
    if mp != m:
        x_fp4 = pad_to_block(x_fp4, [0], 256)
    if scales.shape[0] < mp:
        pad = jnp.full((mp - scales.shape[0], n // 32), 127, jnp.uint8)
        scales = jnp.concatenate([scales, pad], axis=0)
    return _emu.mxfp4_transpose_scaled(x_fp4, scales)


def mxfp4_transpose_scaled_kmajor(qt, st):
    """K-major-input scaled transpose (the QAT fast path).

    qt u8 [K/2, rows], st u8 [K/32, rows] — the layout emitted by
    ``fusedQuantizeMx(..., layout="kmajor")`` — to dequant-scaled bf16
    [K, rows]; same quantization points as :func:`mxfp4_transpose_scaled`
    on the row-major operand.
    """
    qt, st = _as_bytes(qt), _as_bytes(st)
    return _emu.mxfp4_transpose_scaled_kmajor(qt, st)


def mxfp4_transpose_mxfp8(x_fp4, scales):
    """Dequant MXFP4, transpose, requantize to MXFP8.

    Pads M to 256 with unit scales like the reference
    (__init__.py:295-310).
    """
    x_fp4 = _as_bytes(x_fp4)
    m = x_fp4.shape[0]
    n = x_fp4.shape[1] * 2
    scales = _norm_scales(scales, min(m, scales.shape[0] if scales.ndim == 2 else m),
                          n // 32)
    mp = round_up(m, 256)
    if mp != m:
        x_fp4 = pad_to_block(x_fp4, [0], 256)
    if scales.shape[0] < mp:
        pad = jnp.full((mp - scales.shape[0], n // 32), 127, jnp.uint8)
        scales = jnp.concatenate([scales, pad], axis=0)
    return _emu.mxfp4_transpose_mxfp8(x_fp4, scales)
