"""Int8 evaluator for MXFP4 GEMMs.

The reference runs its W4A4 GEMMs on Blackwell's fp4 tensor cores.
Hopper has none, but its int8 tensor cores run at twice the bf16 rate
(1,979 against 989 TOP/s dense on an H100), and MXFP4 maps onto them
exactly in the common case:

  e2m1 value  v = m * 2^(se_g - 1),  m in {0,..,+-12}, se_g the group's
  unbiased e8m0 exponent.  Per row take E = max_g se_g and the deficit
  d_g = E - se_g.  With int8 range +-127 and |m| <= 12 there are 3 bits
  of shift headroom:

      a'[k] = m << (3 - d_g)            (EXACT while d_g <= 3)
            = rtne(m / 2^(d_g-3))       (bounded rounding otherwise)
      v     = a' * 2^(E - 4)

  so one whole-K int8 contraction plus a rank-1 fp32 fixup evaluates
  the GEMM:

      C = (a' @ b'^T)_int32 * 2^(Ea-4)[m] * 2^(Eb-4)[n] * alpha

Exactness contract (docs/NUMERICS.md): bit-identical to the decode GEMM
whenever every row's group-exponent spread is <= 3 — which holds for
the rotated, QuEST/abs-max-quantized tensors this library itself
produces (Gaussian rows spread 0-2 binades).  :func:`encode_int8` returns each
tensor's max deficit so callers/loaders can verify statically; rows
beyond the budget get absolutely-bounded rounding (|err| <= 2^(E-5)
per element) instead of failure.

Accumulator safety: |a'| <= 96 so |sum| <= K * 9216 — int32-safe to
K = 233k, far past any model geometry.

Reference counterpart: the fp4 tensor-core GEMMs (gemm.cu:174-248);
this module maps them onto int8 tensor cores, not a translation.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

def nv_row_scale(amax):
    """NV int8 row scale sigma = rowmax|v| / 127 and its reciprocal (0
    for an all-zero row).

    One XLA computation shared by the XLA encode and the GPU kernel
    (kernels/quantize_int8.py): many v / sigma land exactly on a .5 tie
    (v = rowmax/2 gives 63.5), so the last bit of the reciprocal decides
    the rounding, and both paths must take it from the same code.
    """
    sigma = amax * (1.0 / 127.0)
    return sigma, jnp.where(sigma > 0, 1.0 / sigma, 0.0)


def _codes_to_m2(codes):
    """e2m1 codes u8 -> signed integer 2*value, int32.

    Gather-free (two selects): mag codes 0..4 are the value itself;
    5,6,7 map to 6,8,12 = (2*mag-4, 2*mag-4, 12).
    """
    from ..formats import codecs as C
    return C.e2m1_codes_to_m2(codes)


def _pow2_f32(n):
    """EXACT fp32 2^n (bit-constructed — ``jnp.exp2`` is a 1-ulp-off
    approximation at many integer args, and the approximation differs
    between lowerings; see codecs.pow2_f32)."""
    from ..formats import codecs as C
    return C.pow2_f32(n)


def _unpack(packed):
    """packed u8 [..., K/2] -> codes u8 [..., K] (low nibble first)."""
    lo = packed & 0xF
    hi = packed >> 4
    return jnp.stack([lo, hi], axis=-1).reshape(*packed.shape[:-1], -1)


def _unpack_rows(packed):
    """packed u8 [K/2, R] -> codes u8 [K, R], interleaving on dim 0.

    Row-axis variant (no transposes)."""
    lo = packed & 0xF
    hi = packed >> 4
    k2, r = packed.shape
    return jnp.stack([lo, hi], axis=1).reshape(k2 * 2, r)


@functools.partial(jax.jit, static_argnames=("kmajor",))
def encode_int8(codes_or_packed, scale_bytes, *, kmajor: bool = False):
    """MXFP4 -> per-row-exponent int8 operand.

    Row-major: codes/packed [R, K or K/2], scales [R, K/32] ->
    (a' int8 [R, K], row_scale f32 [R] = 2^(E-4), max_deficit int32 []).
    ``kmajor=True`` takes the quantizer's K-major layout (codes [K, R]
    or packed [K/2, R], scales [K/32, R]) and returns a' [K, R].
    """
    # single formula covers both regimes: m * 2^(3-d) is EXACT for
    # d <= 3 (pure shift of a 4-bit integer) and RTNE-rounds the rare
    # over-deficit groups; the group multiplier broadcasts through a
    # [G, 32, R] view instead of a materialized repeat.  The pow2 is
    # BIT-CONSTRUCTED (exact) — jnp.exp2 approximations differ between
    # dtypes and lowerings and would break the fused==composed
    # contract at deficit > 3.
    if kmajor:
        packed_k, rows = codes_or_packed.shape
        k = scale_bytes.shape[0] * 32
        codes = (codes_or_packed if packed_k == k
                 else _unpack_rows(codes_or_packed))
        m = _codes_to_m2(codes).astype(jnp.bfloat16)  # [K, R], exact
        se = scale_bytes.astype(jnp.int32) - 127      # [K/32, R]
        e = jnp.max(se, axis=0)                       # [R]
        d = e[None, :] - se                           # [K/32, R]
        # m (4-bit significand) times an exact pow2 never rounds; the
        # f32-promoted product + RTNE round matches the kernel bitwise
        mult = _pow2_f32(3 - d)
        q = m.reshape(k // 32, 32, rows) * mult[:, None, :]
        a = jnp.round(q).astype(jnp.int8).reshape(k, rows)
    else:
        k = scale_bytes.shape[-1] * 32
        codes = (codes_or_packed if codes_or_packed.shape[-1] == k
                 else _unpack(codes_or_packed))
        m = _codes_to_m2(codes).astype(jnp.bfloat16)
        se = scale_bytes.astype(jnp.int32) - 127
        e = jnp.max(se, axis=-1)
        d = e[..., None] - se
        mult = _pow2_f32(3 - d)
        q = m.reshape(*m.shape[:-1], k // 32, 32) * mult[..., None]
        a = jnp.round(q).astype(jnp.int8).reshape(m.shape)
    scale = _pow2_f32(e - 4)
    return a, scale, jnp.max(d)


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def matmul_mxf4_bf16_int8(a_i8, b_i8, sa, sb, alpha, out_dtype=jnp.bfloat16):
    """C = (a' @ b'^T) * sa[m] * sb[n] * alpha, bf16 out.

    a_i8 [M, K] int8, b_i8 [N, K] int8 (both from :func:`encode_int8`),
    sa [M] / sb [N] f32 row scales.  The int8 contraction runs on the
    int8 tensor cores at 2x the bf16 rate; XLA fuses the fp32 rank-1
    epilogue.
    """
    o = jax.lax.dot_general(a_i8, b_i8, (((1,), (1,)), ((), ())),
                            preferred_element_type=jnp.int32)
    al = jnp.asarray(alpha, jnp.float32).reshape(())
    return (o.astype(jnp.float32) * (sa[:, None] * al) * sb[None, :]
            ).astype(out_dtype)


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def matmul_mxf4_bf16_int8_kmajor(at_i8, b_i8, sa, sb, alpha,
                                 out_dtype=jnp.bfloat16):
    """K-major activation variant: at_i8 [K, M] (as the K-major
    quantizer emits), b_i8 [N, K] weights."""
    o = jax.lax.dot_general(at_i8, b_i8, (((0,), (1,)), ((), ())),
                            preferred_element_type=jnp.int32)
    al = jnp.asarray(alpha, jnp.float32).reshape(())
    return (o.astype(jnp.float32) * (sa[:, None] * al) * sb[None, :]
            ).astype(out_dtype)


def prepare_weight_int8(wqt, wst):
    """One-time weight prep: K-major packed fp4 weight (wqt u8 [K/2, N],
    wst u8 [K/32, N]) -> (w_i8 [N, K] int8, sb [N] f32, max_deficit).

    ``max_deficit <= 3`` certifies the int8 evaluation of this weight is
    bit-exact; loaders should check it once at load time (it is a host
    decision — weights are static).
    """
    w_k, sb_row, dmax = encode_int8(wqt, wst, kmajor=True)
    return w_k.T, sb_row, dmax


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def matmul_mxf4_bf16_int8_kk(at_i8, bt_i8, sa, sb, alpha,
                             out_dtype=jnp.bfloat16):
    """Both operands K-major: at_i8 [K, M], bt_i8 [K, N] (as
    encode_int8(kmajor=True) emits them) — no transposes anywhere."""
    o = jax.lax.dot_general(at_i8, bt_i8, (((0,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    al = jnp.asarray(alpha, jnp.float32).reshape(())
    return (o.astype(jnp.float32) * (sa[:, None] * al) * sb[None, :]
            ).astype(out_dtype)


@jax.jit
def encode_int8_planes(packed, scale_bytes):
    """Packed K-major MXFP4 -> plane-major int8 operand (no interleave).

    The int8 contraction is order-invariant over K, so the nibble
    planes need not be re-interleaved into natural K order.  Layout: row p holds
    element 2p, row K/2 + p holds element 2p+1.  Dot two operands in
    THIS SAME layout and the int32 result is bit-identical to the
    natural-order dot (integer adds commute).

    packed u8 [K/2, R], scales u8 [K/32, R] ->
    (a' int8 [K, R] plane-major, row_scale f32 [R], max_deficit).
    """
    k2, rows = packed.shape
    g = scale_bytes.shape[0]
    se = scale_bytes.astype(jnp.int32) - 127
    e = jnp.max(se, axis=0)
    d = e[None, :] - se
    mult = _pow2_f32(3 - d)

    def enc(nib):
        m = _codes_to_m2(nib).astype(jnp.bfloat16)
        qv = m.reshape(g, 16, rows) * mult[:, None, :]
        return jnp.round(qv).astype(jnp.int8).reshape(k2, rows)

    a = jnp.concatenate([enc(packed & 0xF), enc(packed >> 4)], axis=0)
    return a, _pow2_f32(e - 4), jnp.max(d)


@jax.jit
def encode_nv_int8_planes(packed, scale_bytes):
    """Packed K-major NVFP4 -> plane-major int8 operand + f32 row scale.

    NVFP4 (group 16, e4m3 scales) has no pow2-only scale structure, so
    unlike the MX encode there is no exactness regime; instead the
    dequantized contribution v = (m2/2) * s_g is computed EXACTLY in
    f32 (both factors have 4-bit significands) and symmetric-quantized
    per row to int8:  a' = rtne(v / sigma), sigma = rowmax|v| / 127.

    Bound: |a' * sigma - v| <= sigma/2 = rowmax/254 per element — an
    order below e2m1's own quantization step (1/2 grid step ~ rowmax/24
    at the grid top), and far inside the reference's NV tolerance.

    Layout matches :func:`encode_int8_planes` (row p = element 2p, row
    K/2+p = element 2p+1); dot two such operands with
    :func:`matmul_mxf4_bf16_int8_kk` (the rank-1 epilogue is format
    agnostic) and pass alpha = 1/(gs_a * gs_b).

    packed u8 [K/2, R], scales u8 (e4m3) [K/16, R] ->
    (a' int8 [K, R] plane-major, row_scale f32 [R]).

    Reference counterpart: the NVFP4 tensor-core GEMM
    (gemm.cu:250-326); this is its int8 mapping, with a documented
    rounding bound instead of fp4-exactness.
    """
    from ..formats import codecs as C

    k2, rows = packed.shape
    g = scale_bytes.shape[0]
    s = C.e4m3_decode_f32(scale_bytes.astype(jnp.int32))     # [K/16, R]
    s = jnp.where(jnp.isnan(s), 0.0, s)                      # NaN byte -> dead group

    def dq(nib):
        m = _codes_to_m2(nib).astype(jnp.float32)            # exact
        return (m.reshape(g, 8, rows) * (0.5 * s)[:, None, :]
                ).reshape(k2, rows)                          # exact f32

    v = jnp.concatenate([dq(packed & 0xF), dq(packed >> 4)], axis=0)
    sigma, inv = nv_row_scale(jnp.max(jnp.abs(v), axis=0))   # [R]
    a = jnp.round(v * inv[None, :]).astype(jnp.int8)
    return a, sigma


def prepare_weight_nv_int8(wqt, wst):
    """One-time NVFP4 weight prep: kmajor packed (wqt u8 [K/2, N], wst
    e4m3 u8 [K/16, N]) -> (w_i8 [K, N] NATURAL-K-order int8, sb [N]
    f32).

    Pair with an activation from the fused quantize+encode kernel
    (or :func:`encode_nv_int8`) in :func:`matmul_mxf4_bf16_int8_kk`;
    fold the two global scales into alpha.  Natural order shards
    contiguously under tensor-parallel K-splits."""
    return encode_nv_int8(wqt, wst)


@jax.jit
def encode_nv_int8_rows(codes, scale_bytes):
    """Row-major NVFP4 -> int8 operand + f32 row scale.

    codes [R, K] (e2m1, any int dtype), scales u8/int32 (e4m3)
    [R, K/16] -> (a' int8 [R, K], sigma f32 [R]).  The dequantized
    value v = (m2/2) * s_g is exact in f32; a' = rtne(v / sigma) with
    sigma = rowmax|v| / 127 (see :func:`encode_nv_int8_planes`).
    """
    from ..formats import codecs as C

    rows, k = codes.shape
    s = C.e4m3_decode_f32(scale_bytes.astype(jnp.int32))     # [R, K/16]
    s = jnp.where(jnp.isnan(s), 0.0, s)                      # NaN byte -> dead group
    m = _codes_to_m2(codes).astype(jnp.float32)              # exact
    v = (m.reshape(rows, k // 16, 16) * (0.5 * s)[..., None]).reshape(rows, k)
    sigma, inv = nv_row_scale(jnp.max(jnp.abs(v), axis=1))   # [R]
    a = jnp.round(v * inv[:, None]).astype(jnp.int8)
    return a, sigma


@jax.jit
def encode_nv_int8(packed, scale_bytes):
    """Packed K-major NVFP4 -> NATURAL-K-order int8 operand + f32 row
    scale: :func:`encode_nv_int8_rows` in the K-major layout.

    This is the layout NV int8 WEIGHTS are stored in — natural order
    shards contiguously under tensor-parallel K-splits
    (models/serving_tp.py) with no reorder.

    packed u8 [K/2, R], scales u8 (e4m3) [K/16, R] ->
    (a' int8 [K, R], row_scale f32 [R]).
    """
    a, sigma = encode_nv_int8_rows(_unpack_rows(packed).T, scale_bytes.T)
    return a.T, sigma
