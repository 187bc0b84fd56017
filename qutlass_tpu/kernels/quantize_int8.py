"""Fused rotate + quantize + int8 encode for NVIDIA Hopper (Pallas, Triton route).

The activation side of the int8 evaluator (ops/int8path.py): bf16
``x [M, K]`` in; the row-major int8 operand ``a' [M, K]``, its f32 row
scale ``[M]`` and the scale bytes ``[M, K/gs]`` out.  Nothing else
touches device memory.  The design follows the reference's quantizing
epilogue (epilogue_quant.h:462-575): the rotation is a tensor-core
product, and the group statistics, scale bytes and codes are computed
while the rotated tile is still on chip.

The int8 encode needs a statistic of the whole row (MX: the largest
group exponent E; NV: the largest dequantized magnitude), so the work is
two launches over the same grid of (row block, K slice):

1. ``scales``: rotate each 128-wide chunk of the slice by the 128x128
   block-diagonal rotation (bf16 in, f32 accumulate), compute the group
   scale bytes and write them, plus the slice's partial row statistic.
2. ``encode``: reduce the partials to the row statistic (for NV, XLA
   does this between the launches), rotate the chunk again, re-derive
   the codes from the stored scale bytes and write the int8 operand.

Rotating twice is cheaper than holding a row of K in shared memory, and
splitting K over programs keeps the card busy when M is small (decode).

Numerics: the same codecs (formats/codecs.py) as the XLA twin
(ops/emulation.fused_quantize_mx_int8 / _nv_int8).  Two things the
Triton route does differently are made explicit here: its fp32 ``/`` is
approximate, so divisions go through ``div.rn.f32``; and it has no
rounding primitive, so RTNE is ``cvt.rni.f32.f32``.  The NV row scale
is computed by XLA between the launches (int8path.nv_row_scale), since
ties make its last bit matter.  The tensor-core
rotation and the in-block reductions sum in another order than XLA, so
a value on a rounding boundary can land on the other side (tests state
the budget per case).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..formats import codecs as C
from ..ops.int8path import nv_row_scale
from ..utils import block_diag_128

CHUNK = 128                 # K columns per rotation product
SMEM_BYTES = 227 * 1024     # shared memory a block may use (H100)
_TARGET_PROGRAMS = 4 * 132  # four programs per SM of an H100


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def smem_estimate(bm: int, stages: int = 3) -> int:
    """Upper bound on one program's shared memory: the pipelined x tiles,
    the rotation, and an f32 tile for the group reshape."""
    return bm * CHUNK * 2 * stages + CHUNK * CHUNK * 2 + bm * CHUNK * 4


def block_config(m: int, k: int) -> tuple[int, int, int]:
    """(bm, ks, ns): rows per program, 128-chunks per K slice, slices.

    bm is a power of two >= 16 (the tensor-core dot's minimum), so a
    decode batch of 1-16 rows is one row block.  K is split into ns
    slices of ks chunks until there are about four programs per SM,
    which is what lets a one-row decode use the whole card.
    """
    bm = 16 if m <= 256 else 32 if m <= 1024 else 64
    nb = -(-m // bm)
    nchunks = k // CHUNK
    ks = max(1, min(nchunks, (nb * nchunks) // _TARGET_PROGRAMS))
    ns = -(-nchunks // ks)
    return bm, ks, ns


def _div(x, y, interpret):
    """Correctly rounded fp32 division."""
    x, y = jnp.broadcast_arrays(jnp.asarray(x, jnp.float32),
                                jnp.asarray(y, jnp.float32))
    if interpret:
        return x / y
    return plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;", args=[x, y], constraints="=r,r,r",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape,
                                                          jnp.float32)])[0]


def _rint(y, interpret):
    """fp32 round-to-nearest-even (the XLA twin's ``jnp.round``)."""
    if interpret:
        return C.rint_small(y)
    return plgpu.elementwise_inline_asm(
        "cvt.rni.f32.f32 $0, $1;", args=[y], constraints="=r,r", pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(y.shape, jnp.float32)])[0]


def _rotated_chunk(x_ref, hb, rows, rmask, chunk):
    cols = chunk * CHUNK + jnp.arange(CHUNK)
    x = plgpu.load(x_ref.at[rows[:, None], cols[None, :]],
                   mask=jnp.broadcast_to(rmask[:, None], (rows.size, CHUNK)),
                   other=0.0)
    return pl.dot(x, hb)                                  # f32 [bm, 128]


def _mx_bytes(g, method):
    if method == "quest":
        scale = C.mx_scale_quest(jnp.sum(g, axis=-1),
                                 jnp.sum(g * g, axis=-1), 32.0)
    else:
        scale = C.mx_scale_absmax(jnp.max(jnp.abs(g), axis=-1))
    return C.pow2_floor_e8m0(scale)[1]                    # int32 [bm, G]


def _mx_m2(g, byte, method):
    q = g * C.e8m0_recip_f32(byte)[..., None]
    if method != "quest":
        q = q * 3.0
    return C.e2m1_codes_to_m2(C.e2m1_rtne_codes(q)).astype(jnp.float32)


def _nv_mul(byte, gs, method, interpret):
    div = functools.partial(_div, interpret=interpret)
    if method == "abs_max":
        return C.nv_absmax_mul(byte, gs, div)
    return C.nv_quest_mul(byte, div)


def _nv_values(g, byte, gs, method, interpret):
    """Dequantized e2m1 values m2 * s/2 (exact fp32), as the NV encode."""
    mul = _nv_mul(byte, gs, method, interpret)
    m2 = C.e2m1_codes_to_m2(C.e2m1_rtne_codes(g * mul[..., None]))
    s = C.e4m3_decode_f32(byte)
    s = jnp.where(jnp.isnan(s), 0.0, s)
    return m2.astype(jnp.float32) * (0.5 * s)[..., None]


def _nv_bytes(g, gs, method, interpret):
    if method == "abs_max":
        sf = gs * (jnp.max(jnp.abs(g), axis=-1) * (1.0 / 6.0))
    else:
        sf = C.nv_scale_quest(jnp.sum(g, axis=-1), jnp.sum(g * g, axis=-1))
    return C.e4m3_rtne_bytes(sf)


def _slice_bounds(ks, nchunks):
    j = pl.program_id(1)
    first = j * ks
    return first, jnp.minimum(ks, nchunks - first)


def _scales_kernel(x_ref, h_ref, gs_ref, sb_ref, part_ref, *, fmt, method,
                   m, bm, ks, ns, nchunks, interpret):
    gsz = 32 if fmt == "mx" else 16
    ng = CHUNK // gsz
    rows = pl.program_id(0) * bm + jnp.arange(bm)
    rmask = rows < m
    hb = h_ref[...]
    gs = gs_ref[...].reshape(1, 1)
    first, count = _slice_bounds(ks, nchunks)
    smask = jnp.broadcast_to(rmask[:, None], (bm, ng))

    def body(c, acc):
        chunk = first + c
        g = _rotated_chunk(x_ref, hb, rows, rmask, chunk).reshape(bm, ng, gsz)
        if fmt == "mx":
            byte = _mx_bytes(g, method)
            stat = jnp.max(byte - 127, axis=-1)
        else:
            byte = _nv_bytes(g, gs, method, interpret)
            v = _nv_values(g, byte, gs, method, interpret)
            stat = jnp.max(jnp.abs(v).reshape(bm, CHUNK), axis=-1)
        gcols = chunk * ng + jnp.arange(ng)
        plgpu.store(sb_ref.at[rows[:, None], gcols[None, :]],
                    byte.astype(jnp.uint8), mask=smask)
        return jnp.maximum(acc, stat)

    init = (jnp.full((bm,), -127, jnp.int32) if fmt == "mx"
            else jnp.zeros((bm,), jnp.float32))
    stat = lax.fori_loop(0, count, body, init)
    plgpu.store(part_ref.at[rows * ns + pl.program_id(1)], stat, mask=rmask)


def _encode_kernel(x_ref, h_ref, gs_ref, sb_ref, stat_ref, a_ref, *rs_ref,
                   fmt, method, m, bm, ks, ns, nchunks, interpret):
    """``stat_ref``: MX — the scales pass's partial row exponents
    [M * ns], reduced here, and ``rs_ref`` receives the row scale; NV —
    the reciprocal row scale [M] (int8path.nv_row_scale, computed by XLA
    between the launches)."""
    gsz = 32 if fmt == "mx" else 16
    ng = CHUNK // gsz
    rows = pl.program_id(0) * bm + jnp.arange(bm)
    rmask = rows < m
    hb = h_ref[...]
    gs = gs_ref[...].reshape(1, 1)
    first, count = _slice_bounds(ks, nchunks)

    if fmt == "mx":
        nsp = _next_pow2(ns)
        pcols = jnp.arange(nsp)
        pmask = rmask[:, None] & (pcols < ns)[None, :]
        part = plgpu.load(stat_ref.at[rows[:, None] * ns + pcols[None, :]],
                          mask=pmask, other=-127)
        e = jnp.max(part, axis=-1)                       # [bm] int32

        @pl.when(pl.program_id(1) == 0)
        def _():
            plgpu.store(rs_ref[0].at[rows], C.pow2_f32(e - 4), mask=rmask)
    else:
        inv = plgpu.load(stat_ref.at[rows], mask=rmask, other=0.0)

    bmask = jnp.broadcast_to(rmask[:, None], (bm, ng))
    amask = jnp.broadcast_to(rmask[:, None], (bm, CHUNK))

    @pl.loop(0, count)
    def _(c):
        chunk = first + c
        g = _rotated_chunk(x_ref, hb, rows, rmask, chunk).reshape(bm, ng, gsz)
        gcols = chunk * ng + jnp.arange(ng)
        byte = plgpu.load(sb_ref.at[rows[:, None], gcols[None, :]],
                          mask=bmask, other=127).astype(jnp.int32)
        if fmt == "mx":
            m2 = _mx_m2(g, byte, method)
            mult = C.pow2_f32(3 - (e[:, None] - (byte - 127)))
            q = m2 * mult[..., None]
        else:
            v = _nv_values(g, byte, gs, method, interpret)
            q = v * inv[:, None, None]
        a = _rint(q.reshape(bm, CHUNK), interpret).astype(jnp.int8)
        cols = chunk * CHUNK + jnp.arange(CHUNK)
        plgpu.store(a_ref.at[rows[:, None], cols[None, :]], a, mask=amask)


@functools.partial(jax.jit, static_argnames=("fmt", "method", "interpret"))
def quantize_int8(x, h, global_scale=None, *, fmt: str, method: str,
                  interpret: bool = False):
    """Rotate + quantize + int8 encode, row-major.

    x bf16 [M, K] with K % 128 == 0; h [r, r] with r dividing 128;
    ``global_scale`` (NV only) the activation's global scale.
    Returns (a' int8 [M, K], row scale f32 [M], scale bytes u8
    [M, K/gs]) — MX: row scale 2^(E-4), e8m0 bytes; NV: sigma, e4m3
    bytes.  ``interpret=True`` runs the kernels in the Pallas
    interpreter (tests on the CPU).
    """
    m, k = x.shape
    if k % CHUNK:
        raise ValueError(f"K={k} must be a multiple of {CHUNK}")
    gsz = 32 if fmt == "mx" else 16
    bm, ks, ns = block_config(m, k)
    nchunks = k // CHUNK
    grid = (-(-m // bm), ns)
    gs = jnp.asarray(1.0 if global_scale is None else global_scale,
                     jnp.float32).reshape(1)
    hb = block_diag_128(h)
    kw = dict(fmt=fmt, method=method, m=m, bm=bm, ks=ks, ns=ns,
              nchunks=nchunks, interpret=interpret)
    params = plgpu.CompilerParams(num_warps=4, num_stages=3)
    stat_dt = jnp.int32 if fmt == "mx" else jnp.float32
    sb, part = pl.pallas_call(
        functools.partial(_scales_kernel, **kw),
        out_shape=(jax.ShapeDtypeStruct((m, k // gsz), jnp.uint8),
                   jax.ShapeDtypeStruct((m * ns,), stat_dt)),
        grid=grid, backend="triton", compiler_params=params,
        interpret=interpret,
        name=f"rotate_quantize_scales_{fmt}",
    )(x, hb, gs)
    if fmt == "mx":
        stat = part
        outs = (jax.ShapeDtypeStruct((m, k), jnp.int8),
                jax.ShapeDtypeStruct((m,), jnp.float32))
    else:
        rs, stat = nv_row_scale(jnp.max(part.reshape(m, ns), axis=1))
        outs = (jax.ShapeDtypeStruct((m, k), jnp.int8),)
    res = pl.pallas_call(
        functools.partial(_encode_kernel, **kw),
        out_shape=outs, grid=grid, backend="triton", compiler_params=params,
        interpret=interpret,
        name=f"rotate_quantize_encode_{fmt}",
    )(x, hb, gs, sb, stat)
    a = res[0]
    if fmt == "mx":
        rs = res[1]
    return a, rs, sb
