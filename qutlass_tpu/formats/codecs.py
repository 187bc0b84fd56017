"""Shared low-precision codecs (device semantics, fp32/int32 arithmetic).

These functions are the single source of truth for the microscaling number
formats used across the library.  They are written in plain ``jax.numpy`` so
the *same code* runs in three contexts:

  * inside Pallas TPU kernels (Mosaic-lowered),
  * in the XLA "emulation" backend (any platform, used on CPU and as a
    fallback for shapes the kernels do not cover),
  * under ``jax.jit`` on CPU for the test-suite.

Numerics contract (reference: IST-DASLab/qutlass):
  * e2m1 RTNE with even-code tie-break — mirrors the PTX
    ``cvt.rn.satfinite.e2m1x2.f32`` used by the reference
    (qutlass/csrc/include/cutlass_extensions/epilogue/threadblock/
    epilogue_quant.h:77-97) and the fp64 golden model
    (tests/mxfp4_test.py:45-81).
  * e8m0 power-of-two floor via fp32 exponent-bit masking
    (``& 0x7f800000``) — epilogue_quant.h:537-539.
  * e4m3 saturating RTNE cast — mirrors ``__nv_fp8_e4m3`` conversion
    (epilogue_quant.h:1634-1640).

All "byte" values are carried as ``int32`` (TPU vectors ops prefer i32;
uint8<->float casts are not supported by Mosaic) and only converted to
``uint8`` at kernel output boundaries.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# fp4 e2m1 value grid, code order 0..7 (positive half).
E2M1_GRID = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
E2M1_MAX = 6.0
E4M3_MAX = 448.0

_RTNE = lax.RoundingMethod.TO_NEAREST_EVEN


def _bitcast(x, dtype):
    return lax.bitcast_convert_type(x, dtype)


def rint_small(y: jax.Array) -> jax.Array:
    """Round-to-nearest-even of finite fp32 ``y`` with ``|y| < 2^23``.

    Truncate, then step away from zero when the (exact) remainder is
    above one half, or exactly one half with an odd integer part.
    Bitwise equal to ``lax.round(y, TO_NEAREST_EVEN)`` in that range,
    and built from converts and compares only, so it also lowers inside
    Pallas kernels on the Triton route, which has no rounding primitive.
    (The ``(y + 1.5*2^23) - 1.5*2^23`` trick is not safe here: compilers
    may fold it back to ``y``.)
    """
    t = y.astype(jnp.int32)
    f = jnp.abs(y - t.astype(jnp.float32))
    up = (f > 0.5) | ((f == 0.5) & ((t & 1) == 1))
    return jnp.where(up, t + jnp.where(y < 0, -1, 1), t).astype(jnp.float32)


# ---------------------------------------------------------------------------
# e2m1 (fp4)
# ---------------------------------------------------------------------------

def e2m1_rtne_codes_float(q: jax.Array) -> jax.Array:
    """Round fp32 ``q`` to the nearest e2m1 value; return int32 codes 0..15.

    Tie-break is to the even *code*, which coincides with IEEE
    round-to-nearest-even on the e2m1 grid.  Saturates to ±6
    (``satfinite``); NaN maps to +0 (code 0).

    The grid {0, .5, 1, 1.5, 2, 3, 4, 6} is piecewise uniform, so RTNE on
    it decomposes into three integer RTNE roundings:
      |q| in [0, 2]: step 0.5 → codes 0..4
      |q| in (2, 4]: step 1.0 → codes 4..6
      |q| in (4, 6]: step 2.0 → codes 6..7

    Reference implementation — kept as the readable spec and as a second
    oracle; ``e2m1_rtne_codes`` (the bit-domain twin, proven equal over
    every fp32 in [-8, 8] plus specials) is the production encoder.
    """
    sign = jnp.signbit(q).astype(jnp.int32)
    a = jnp.abs(q)
    a = jnp.where(jnp.isnan(a), 0.0, jnp.minimum(a, E2M1_MAX))
    c1 = lax.round(a * 2.0, _RTNE)
    c2 = 2.0 + lax.round(a, _RTNE)
    c3 = 4.0 + lax.round(a * 0.5, _RTNE)
    code = jnp.where(a <= 2.0, c1, jnp.where(a <= 4.0, c2, c3)).astype(jnp.int32)
    return code | (sign << 3)


def e2m1_rtne_codes_bits(q: jax.Array) -> jax.Array:
    """Integer-domain twin of :func:`e2m1_rtne_codes` (same contract).

    Works on the fp32 bit pattern: saturation and the [0.25, 1) band are
    integer compares (positive floats order as their bit patterns); the
    [1, 6] band uses the classic round-to-1-mantissa-bit trick
    ``r = a + 0x1FFFFF + lsb`` whose carry walks the exponent, after
    which ``r >> 22 == 2*E + m`` maps affinely to the code.  Avoids the
    three ``lax.round`` + fp->int converts of the float version.
    """
    b = _bitcast(q.astype(jnp.float32), jnp.int32)
    sign = (b >> 28) & 8
    a = b & 0x7FFFFFFF
    a = jnp.where(a > 0x7F800000, 0, jnp.minimum(a, 0x40C00000))  # NaN->+0, sat 6
    # below 1.0: grid {0, 0.5, 1}; ties 0.25 -> 0, 0.75 -> 1.0
    cl = (a > 0x3E800000).astype(jnp.int32) + (a >= 0x3F400000)
    # 1.0 and above: RTNE to one mantissa bit, code = (2E + m) - 252
    r = a + 0x1FFFFF + ((a >> 22) & 1)
    code = jnp.where(a < 0x3F800000, cl, (r >> 22) - 252)
    return code | sign


# Production encoder: the integer-domain version (fewer VPU ops on TPU —
# no fp rounds, no fp->int converts).
e2m1_rtne_codes = e2m1_rtne_codes_bits


def e2m1_codes_to_m2(codes: jax.Array) -> jax.Array:
    """e2m1 codes -> signed integer 2*value, int32 (the int8-MXU
    evaluator's mantissa domain — ops/int8path.py).

    Gather-free (two selects): mag codes 0..4 are the value itself;
    5, 6, 7 map to 6, 8, 12 = (2*mag-4, 2*mag-4, 12).
    """
    c = codes.astype(jnp.int32)
    mag = c & 7
    m = jnp.where(mag < 5, mag, jnp.where(mag < 7, 2 * mag - 4, 12))
    return jnp.where(c >= 8, -m, m)


def e2m1_rtne_m2_f32(q: jax.Array) -> jax.Array:
    """fp32 -> the RTNE e2m1 value DOUBLED (m2), directly as fp32.

    Bitwise-equal to ``e2m1_codes_to_m2(e2m1_rtne_codes(q))`` promoted
    to f32 (exhaustively checked against the code path over a dense
    [-8, 8] sweep + specials in tests/test_codecs.py) but skips the
    code representation entirely: the piecewise-uniform grid decomposes
    into three integer RTNE roundings on the VALUE, each a single VPU
    round — for the fused quantize+int8 kernels, where only m2 is
    needed, this drops ~10 integer ops per element vs the
    encode->decode round trip.

      |q| <= 2:     m2 = roundeven(2q)        (ints 0..4, ties-to-even
                    m2 == ties-to-even code: codes 0..4 ARE m2)
      2 < |q| <= 4: m2 = 2*roundeven(q)       (4, 6, 8; tie 2.5 -> even
                    q 2 -> m2 4 == even code 4; tie 3.5 -> 8 == code 6)
      4 < |q| <= 6: m2 = 4*roundeven(q/2)     (8, 12; tie 5 -> m2 8 ==
                    even code 6)
    Saturates to +-6 (satfinite) via the clamp; NaN maps to +0.
    """
    a = jnp.abs(q)
    qc = jnp.clip(q, -E2M1_MAX, E2M1_MAX)
    r1 = lax.round(qc * 2.0, _RTNE)
    r2 = 2.0 * lax.round(qc, _RTNE)
    r3 = 4.0 * lax.round(qc * 0.5, _RTNE)
    m2 = jnp.where(a <= 2.0, r1, jnp.where(a <= 4.0, r2, r3))
    return jnp.where(jnp.isnan(q), 0.0, m2)


def e2m1_decode_f32(codes: jax.Array) -> jax.Array:
    """int32 e2m1 codes (0..15) -> exact fp32 values."""
    mag = codes & 7
    sign = (codes >> 3) & 1
    e = mag >> 1
    m = mag & 1
    # fp32 bit pattern: e==0 -> {0, 0.5}; else (1 + m/2) * 2^(e-1).
    bits = jnp.where(e == 0, m * jnp.int32(0x3F000000),
                     ((126 + e) << 23) | (m << 22))
    bits = bits | (sign << 31)
    return _bitcast(bits, jnp.float32)


def e2m1_decode_scaled_bf16(codes: jax.Array, scale_bytes: jax.Array) -> jax.Array:
    """Decode e2m1 codes and multiply by e8m0 scales in one integer pass.

    ``scale_bytes`` is the e8m0 exponent byte (int32, broadcastable against
    ``codes``).  Because the scale is a power of two, multiplying is an add
    on the bf16 exponent field, which keeps the whole dequant in int ops
    until one final bitcast — exact, and fast on the VPU.

    Exponent-field underflow produces the exact bf16 SUBNORMAL (the
    2-bit e2m1 significand shifts without loss down to scale byte 0);
    exponent-field overflow (scale byte 254 with |code| >= 4 — only
    reachable via imported scale bytes) saturates to inf like the
    fp64 oracle's bf16 cast.
    """
    # bf16 bits of grid[mag] * 2^(scale-127):
    #   mag==0          -> 0
    #   mag==1 (0.5)    -> (scale-1) << 7          [2^(scale-128)]
    #   mag>=2          -> ((e+scale-1) << 7) | (m << 6)
    # The mag==1 case coincides with the mag>=2 formula at e=0, m'=0, so
    # a single expression covers everything nonzero with
    # m' = m & (e != 0):
    mag = codes & 7
    e = mag >> 1
    mant = ((codes & 1) & jnp.minimum(e, 1)) << 6
    x = e + scale_bytes - 1                        # bf16 exponent field
    norm = (x << 7) | mant
    # x <= 0: subnormal — significand 1.m (bits 0x80|mant, point at bit
    # 7) shifted right by 1-x with RTNE on shifted-out bits (exact for
    # all e2m1 codes down to x >= -6; ties only deeper)
    s = jnp.clip(1 - x, 1, 15)
    sig = 0x80 | mant
    shifted = sig >> s
    rem = sig & ((1 << s) - 1)
    half = 1 << (s - 1)
    subn = shifted + ((rem > half) | ((rem == half) & (shifted & 1))
                      ).astype(jnp.int32)
    hi = jnp.where(x >= 255, 255 << 7, norm)       # overflow -> inf
    bits = jnp.where(mag == 0, 0, jnp.where(x > 0, hi, subn))
    bits = bits | ((codes & 8) << 12)              # sign -> bit 15
    # e8m0 byte 255 is NaN (MX spec; golden e8m0_to_f64) — every code
    # of the group decodes to NaN, matching code * NaN in the oracle
    bits = jnp.where(scale_bytes == 255, 0x7FC0, bits)
    return _bitcast(bits.astype(jnp.uint16), jnp.bfloat16)


# ---------------------------------------------------------------------------
# e8m0 (power-of-two block scales)
# ---------------------------------------------------------------------------

def pow2_floor_e8m0(scale: jax.Array) -> tuple[jax.Array, jax.Array]:
    """fp32 scale -> (pow2-floored fp32 scale, int32 e8m0 byte).

    Masks the mantissa bits of the fp32 representation
    (``& 0x7f800000``), exactly like the reference epilogue
    (epilogue_quant.h:537-539).  Subnormal inputs floor to byte 0
    (2^-127); the reference's ``+1e-8`` offsets keep real data out of
    that regime.
    """
    bits = _bitcast(scale, jnp.int32) & jnp.int32(0x7F800000)
    return _bitcast(bits, jnp.float32), bits >> 23


def pow2_f32(n: jax.Array) -> jax.Array:
    """EXACT fp32 2^n for integer ``n`` (clamped to [-127, 127]).

    ``jnp.exp2`` is an APPROXIMATION: measured 1 ulp off at many
    integer arguments (bf16: even at +2; f32: most args <= -14), and
    the approximation differs between lowerings (XLA CPU vs TPU vs
    Mosaic) — a d=7 deficit group rounded m2=8 to 0 through the f32
    kernel but to 1 through the bf16 XLA encode, breaking the bitwise
    oneshot == two-pass contract.  Bit-construct the power instead.
    ``n <= -127`` clamps to 2^-127; callers multiply small integers
    where the product rounds to 0 either way.
    """
    b = jnp.clip(n.astype(jnp.int32) + 127, 0, 254)
    return e8m0_decode_f32(b)


def e8m0_recip_f32(byte: jax.Array) -> jax.Array:
    """int32 e8m0 byte -> exact fp32 reciprocal 2^(127-byte).

    1/2^(b-127) = 2^((254-b)-127); exact for bytes 0..254 (255 = NaN is
    never emitted by the quantizers).  Replaces an fp32 divide by a
    power-of-two scale with one subtract + multiply.
    """
    return e8m0_decode_f32(254 - byte.astype(jnp.int32))


def e8m0_decode_f32(byte: jax.Array) -> jax.Array:
    """int32 e8m0 byte -> fp32 2^(byte-127).  Byte 0 -> 2^-127, 255 -> NaN."""
    byte = byte.astype(jnp.int32)
    f = _bitcast(byte << 23, jnp.float32)
    # byte 0 is 2^-127 (fp32 subnormal), not zero; scalar constant — a
    # scalar bitcast would not lower in Mosaic
    f = jnp.where(byte == 0, jnp.float32(5.877471754111438e-39), f)
    return jnp.where(byte == 255, jnp.float32(jnp.nan), f)


# ---------------------------------------------------------------------------
# e4m3 (fp8 block scales / data)
# ---------------------------------------------------------------------------

def _e4m3_round_mag(a: jax.Array) -> jax.Array:
    """|x| (fp32, NaN already cleared, clamped to 448) -> exact e4m3-rounded
    magnitude.  Normal range rounds by fp32 bit manipulation (RTNE to 3
    mantissa bits); the subnormal range (|x| < 2^-6) rounds on the fixed
    2^-9-step grid."""
    bits = _bitcast(a, jnp.int32)
    lsb = (bits >> 20) & 1
    rbits = (bits + lsb + jnp.int32(0x7FFFF)) & jnp.int32(~0xFFFFF)
    rn = _bitcast(rbits, jnp.float32)
    rn = jnp.minimum(rn, E4M3_MAX)  # 448 + eps rounds up to 512; clamp back
    sub = rint_small(a * 512.0) * (1.0 / 512.0)
    return jnp.where(a < 2.0 ** -6, sub, rn)


def e4m3_rtne_value_f32(x: jax.Array) -> jax.Array:
    """fp32 -> the exact e4m3fn-rounded value (satfinite), as fp32.

    Same rounding core as :func:`e4m3_rtne_bytes`; NaN passes through as
    NaN (the byte form's 0x7F).  Used by the scaled-bf16 QAT fast path,
    which stores ``e4m3_value * pow2_scale`` (exactly representable in
    bf16) instead of the (byte, scale) pair.
    """
    sign = jnp.signbit(x)
    a = jnp.where(jnp.isnan(x), jnp.float32(jnp.nan),
                  _e4m3_round_mag(jnp.minimum(jnp.abs(x), E4M3_MAX)))
    return jnp.where(sign, -a, a)


def e4m3_rtne_bytes(x: jax.Array) -> jax.Array:
    """fp32 -> e4m3fn byte (int32), RTNE with saturation to ±448.

    NaN maps to 0x7F (e4m3fn NaN), matching ``__nv_fp8_e4m3``.
    """
    sign = jnp.signbit(x).astype(jnp.int32)
    isnan = jnp.isnan(x)
    a = jnp.where(isnan, 0.0, jnp.minimum(jnp.abs(x), E4M3_MAX))
    v = _e4m3_round_mag(a)

    # Assemble the byte from the exact value ``v``.
    vbits = _bitcast(v, jnp.int32)
    exp32 = (vbits >> 23) & 0xFF
    mant3 = (vbits >> 20) & 7
    is_sub = exp32 < (127 - 6)
    sub_mant = rint_small(v * 512.0).astype(jnp.int32)
    byte = jnp.where(v == 0.0, 0,
                     jnp.where(is_sub, sub_mant,
                               ((exp32 - 127 + 7) << 3) | mant3))
    byte = jnp.where(isnan, 0x7F, byte)
    return byte | (sign << 7)


def e4m3_decode_f32(byte: jax.Array) -> jax.Array:
    """int32 e4m3fn byte -> exact fp32.  0x7F/0xFF decode to NaN."""
    byte = byte.astype(jnp.int32)
    sign = (byte >> 7) & 1
    e = (byte >> 3) & 0xF
    m = byte & 7
    # normal: (1 + m/8) * 2^(e-7); subnormal (e==0): m * 2^-9
    norm_bits = ((e + 120) << 23) | (m << 20)
    norm = _bitcast(norm_bits, jnp.float32)
    sub = m.astype(jnp.float32) * (2.0 ** -9)
    v = jnp.where(e == 0, sub, norm)
    v = jnp.where((e == 15) & (m == 7), jnp.float32(jnp.nan), v)
    return jnp.where(sign == 1, -v, v)


def e4m3_decode_scaled_bf16(bytes_: jax.Array, scale_bytes: jax.Array) -> jax.Array:
    """Decode e4m3 data bytes and apply e8m0 scales, integer-only.

    e4m3 values have a 4-bit significand, exactly representable in bf16;
    the power-of-two scale is an exponent-field add.  Subnormal e4m3
    values (exp field 0) are normalized arithmetically first.
    """
    b = bytes_.astype(jnp.int32)
    sign = (b >> 7) & 1
    e = (b >> 3) & 0xF
    m = b & 7
    # Subnormal e4m3 (e == 0): value m*2^-9 — normalize the 3-bit
    # mantissa (t = position of its top bit) so both cases share one
    # (exponent-field, mantissa7) encoding below.  Normal: bf16 exp
    # field = e - 7 + 127 + (scale-127); mant7 = m << 4.
    t = jnp.where(m > 3, 2, jnp.where(m > 1, 1, 0))
    mant_sub = (m - (1 << t)) << (7 - t)
    x_sub = t + scale_bytes - 9
    x = jnp.where(e == 0, x_sub, e + 120 + scale_bytes - 127)
    mant = jnp.where(e == 0, mant_sub, m << 4)
    # x <= 0 -> bf16 subnormal with RTNE on the shifted-out significand
    # bits (matches the fp64 oracle's bf16 cast, integer-only — an f32
    # product here would hit flush-to-zero on subnormal intermediates);
    # x >= 255 -> inf (saturating).  Both are unreachable from the
    # quantizers' own scale bytes, guarded for imported data.
    s = jnp.clip(1 - x, 1, 15)
    sig = 0x80 | mant
    shifted = sig >> s
    rem = sig & ((1 << s) - 1)
    half = 1 << (s - 1)
    subn = shifted + ((rem > half) | ((rem == half) & (shifted & 1))
                      ).astype(jnp.int32)
    hi = jnp.where(x >= 255, 255 << 7, (x << 7) | mant)
    bits = jnp.where((e == 0) & (m == 0), 0,
                     jnp.where(x > 0, hi, subn))
    # NaN inputs (only reachable via imported bytes): e4m3fn NaN is
    # S.1111.111, e8m0 byte 255 is NaN — both decode to NaN like the
    # fp64 oracle (golden e4m3_to_f64 / e8m0_to_f64)
    bits = jnp.where(((e == 15) & (m == 7)) | (scale_bytes == 255),
                     0x7FC0, bits)
    v = _bitcast(bits.astype(jnp.uint16), jnp.bfloat16)
    return jnp.where(sign == 1, -v, v)


# ---------------------------------------------------------------------------
# Block-scale computation (the quantizer cores)
# ---------------------------------------------------------------------------

QUEST_CONST = 2.92247856 / 6.0


def mx_scale_quest(s1: jax.Array, s2: jax.Array, n: float) -> jax.Array:
    """Quest/Quartet scale from group moments (pre pow2-floor).

    ``s1`` = group sum, ``s2`` = group sum of squares, ``n`` = group size.
    Mirrors epilogue_quant.h:520-535: population variance, guarded
    against negative round-off, sqrt * (2.92247856/6) + 1e-8.
    """
    mean = s1 * (1.0 / n)
    var = s2 * (1.0 / n) - mean * mean
    return jnp.where(var >= 0.0, jnp.sqrt(jnp.maximum(var, 0.0)) * QUEST_CONST + 1e-8, 1.0)


def mx_scale_absmax(amax: jax.Array) -> jax.Array:
    """Abs-max scale (pre pow2-floor): amax + 1e-8 (epilogue_quant.h:548-570)."""
    return amax + jnp.float32(1e-8)


def nv_scale_quest(s1: jax.Array, s2: jax.Array) -> jax.Array:
    """NVFP4 quest scale (group of 16), pre e4m3 cast.

    epilogue_quant.h:1621-1649.  No negative-variance guard in the
    reference: var < 0 yields NaN, whose e4m3 cast is NaN and zeros the
    output group.
    """
    mean = s1 * (1.0 / 16.0)
    var = s2 * (1.0 / 16.0) - mean * mean
    return jnp.sqrt(var) * QUEST_CONST + 1e-8


def nv_absmax_scale_bytes(amax: jax.Array, global_scale: jax.Array,
                          div=jnp.divide):
    """NVFP4 abs-max (vLLM-compatible) scale: byte and output multiplier.

    epilogue_quant.h:1650-1693:
        SF      = e4m3(global_scale * amax / 6)
        out_mul = SF != 0 ? 1 / (SF / global_scale) : 0
    Returns (scale_byte int32, out_mul fp32).  ``div`` is the
    correctly rounded fp32 division of the calling context (a GPU kernel
    passes its own, since the Triton route's ``/`` is approximate).
    """
    sf = global_scale * (amax * (1.0 / 6.0))
    byte = e4m3_rtne_bytes(sf)
    return byte, nv_absmax_mul(byte, global_scale, div)


def nv_absmax_mul(byte: jax.Array, global_scale: jax.Array, div=jnp.divide):
    """The abs-max output multiplier of an e4m3 scale byte."""
    sfq = e4m3_decode_f32(byte)
    out_mul = jnp.where(sfq != 0.0, div(global_scale, sfq), 0.0)
    return jnp.where(jnp.isnan(sfq), 0.0, out_mul)


def nv_quest_scale_bytes(s1: jax.Array, s2: jax.Array, div=jnp.divide):
    """NVFP4 quest scale byte and output multiplier (1/scale or 0)."""
    byte = e4m3_rtne_bytes(nv_scale_quest(s1, s2))
    return byte, nv_quest_mul(byte, div)


def nv_quest_mul(byte: jax.Array, div=jnp.divide):
    """The quest output multiplier of an e4m3 scale byte."""
    sq = e4m3_decode_f32(byte)
    out_mul = jnp.where(sq > 0.0, div(1.0, sq), 0.0)
    return jnp.where(jnp.isnan(sq), 0.0, out_mul)


def mxfp8_shared_exp_bytes(amax: jax.Array, shift: int = 7) -> jax.Array:
    """MXFP8 double-quant shared exponent: floor(log2(amax)) - shift + 127.

    quartet_bwd_sm120.cu:503-509 (``encode_e8m0_shiftm8`` semantics with
    the -7 shift); amax == 0 maps to byte 127 (scale 1.0).  The
    subtraction wraps mod 256 like the reference's uint8 store (and the
    fp64 golden): a tile with amax < 2^-120 gets a huge wrapped scale
    and quantizes to 0 — same bytes as quartet_test.py's oracle.
    """
    _, byte = pow2_floor_e8m0(amax)
    return jnp.where(amax > 0.0, (byte - shift) % 256, 127)
