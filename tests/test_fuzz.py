"""Differential fuzzing: random (shape, rot, method, layout, batch)
draws across the quantizers, GEMMs and backward ops (VERDICT r1 #6).

Three oracles, mirroring the reference tests' self-checking design
(mxfp4_test.py:176-178):
  * emulation vs fp64 golden — scales exact, dequantized values up to
    the 1e-4 tie-break rate, GEMM bit-exact vs the fp64 dequantized
    matmul;
  * layout self-consistency — kmajor / kmajor_codes / rowmajor of the
    same input must agree bitwise;
  * the fused int8 quantize kernel in interpret mode vs its XLA twin —
    bitwise, on a random subsample (interpret mode is slow; the dense
    grid lives in test_quantize_int8.py).

Shapes draw from a small pool so jit caching keeps the suite fast; data
is fresh per draw.  Every case is seeded — failures reproduce.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow

import qutlass_tpu as q
from qutlass_tpu.formats import golden as G
from qutlass_tpu.ops import emulation as E
from helpers import bf16_hadamard, randn_bf16, to_np64

ROWS_POOL = [8, 16, 33, 64, 96]
K_POOL = [128, 256, 384, 512]
ROTS = [32, 64, 128]


def _draw_mx(rng):
    rows = int(rng.choice(ROWS_POOL))
    k = int(rng.choice(K_POOL))
    rot = int(rng.choice([r for r in ROTS if k % r == 0]))
    method = str(rng.choice(["quest", "abs_max"]))
    batch = int(rng.choice([0, 2]))
    return rows, k, rot, method, batch


@pytest.mark.parametrize("seed", range(40))
def test_fuzz_quantize_mx_vs_golden(seed):
    rng = np.random.default_rng(1000 + seed)
    rows, k, rot, method, batch = _draw_mx(rng)
    shape = (batch, rows, k) if batch else (rows, k)
    x = randn_bf16(rng, *shape)
    h = bf16_hadamard(rot)
    ref = G.quantize_mx(to_np64(x), to_np64(h), rot, method)

    e2m1, e8m0 = q.fusedQuantizeMx(x, h, method=method)
    n_rows = x.size // k
    scales = np.asarray(e8m0)[:n_rows, : k // 32].reshape(ref["e8m0"].shape)
    np.testing.assert_array_equal(scales, ref["e8m0"])
    alpha = 1.0 if method == "quest" else 3.0
    dq = G.dq_fp4(np.asarray(e2m1), scales, 32, alpha)
    assert (dq != ref["dq"]).mean() <= 1e-4, (rows, k, rot, method, batch)

    # layout self-consistency (2-D only: kmajor is a 2-D layout)
    if not batch:
        kq, ks = q.fusedQuantizeMx(x, h, method=method, layout="kmajor")
        np.testing.assert_array_equal(np.asarray(kq), np.asarray(e2m1).T)
        np.testing.assert_array_equal(np.asarray(ks), scales.T)
        cq, cs = q.fusedQuantizeMx(x, h, method=method, layout="kmajor_codes")
        codes = np.asarray(cq)
        repacked = (codes[0::2] | (codes[1::2] << 4)).astype(np.uint8)
        np.testing.assert_array_equal(repacked, np.asarray(kq))
        np.testing.assert_array_equal(np.asarray(cs), scales.T)


@pytest.mark.parametrize("seed", range(20))
def test_fuzz_quantize_mx_mask(seed):
    rng = np.random.default_rng(2000 + seed)
    rows, k, rot, _, _ = _draw_mx(rng)
    x = randn_bf16(rng, rows, k)
    h = bf16_hadamard(rot)
    ref = G.quantize_mx(to_np64(x), to_np64(h), rot, "quest")
    _, _, mask = q.fusedQuantizeMx(x, h, method="quest", return_mask=True)
    got = G.unpack_mask(np.asarray(mask))[:, : k].reshape(ref["mask_bits"].shape)
    # count bound, not rate: small draws make one fp32-vs-fp64 tie at
    # the |q| = 6.0 boundary exceed a 1e-4 rate
    assert (got != ref["mask_bits"]).sum() <= max(2, 1e-4 * got.size)


@pytest.mark.parametrize("seed", range(20))
def test_fuzz_quantize_nv_vs_golden(seed):
    rng = np.random.default_rng(3000 + seed)
    rows = int(rng.choice(ROWS_POOL))
    k = int(rng.choice(K_POOL))
    rot = int(rng.choice([r for r in ROTS if k % r == 0]))
    method = str(rng.choice(["abs_max", "quest"]))
    gs = float(rng.uniform(0.5, 8.0))
    x = randn_bf16(rng, rows, k)
    h = bf16_hadamard(rot)
    ref = G.quantize_nv(to_np64(x), to_np64(h), rot, gs, method)
    e2m1, e4m3 = q.fusedQuantizeNv(x, h, jnp.float32(gs), method=method)
    sc = np.asarray(e4m3)[:rows, : k // 16].reshape(ref["e4m3"].shape)
    np.testing.assert_array_equal(sc, ref["e4m3"])
    vals = G.unpack_fp4(np.asarray(e2m1))
    assert (vals != ref["values"]).mean() <= 1e-3, (rows, k, rot, method, gs)


@pytest.mark.parametrize("seed", range(15))
def test_fuzz_gemm_mx_bit_exact(seed):
    """Emulation GEMM == bf16(fp64 dequantized matmul), random shapes."""
    rng = np.random.default_rng(4000 + seed)
    m = int(rng.choice([8, 24, 56, 96]))
    n = int(rng.choice([8, 48, 96]))
    k = int(rng.choice(K_POOL))
    rot = int(rng.choice([r for r in ROTS if k % r == 0]))
    method = str(rng.choice(["quest", "abs_max"]))
    alpha = float(rng.choice([1.0, 0.5, 2.0]))
    a, b = randn_bf16(rng, m, k), randn_bf16(rng, n, k)
    h = bf16_hadamard(rot)
    aq, asf = q.fusedQuantizeMx(a, h, method=method)
    bq, bsf = q.fusedQuantizeMx(b, h, method=method)
    out = q.matmul_mxf4_bf16_tn(aq, bq, asf, bsf,
                                jnp.full((1,), alpha, jnp.float32))
    adq = G.dq_fp4(np.asarray(aq), np.asarray(asf)[:m, : k // 32], 32, 1.0)
    bdq = G.dq_fp4(np.asarray(bq), np.asarray(bsf)[:n, : k // 32], 32, 1.0)
    ref = (alpha * adq @ bdq.T).astype(jnp.bfloat16.dtype)
    np.testing.assert_array_equal(np.asarray(out, np.float32),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_backward_t_vs_golden(seed):
    rng = np.random.default_rng(5000 + seed)
    # the backward quantizer rotates the TRANSPOSE, so rot must divide N
    n = int(rng.choice([64, 128, 192]))
    k = int(rng.choice([128, 256]))
    rot = int(rng.choice([r for r in ROTS if n % r == 0]))
    x = randn_bf16(rng, n, k)
    h = bf16_hadamard(rot)
    e2m1, e8m0 = q.backward_t_bf16(x, h)
    ref = G.backward_quantize(np.swapaxes(to_np64(x), -2, -1), to_np64(h))
    np.testing.assert_array_equal(np.asarray(e8m0), ref["e8m0"])
    dq = G.dq_fp4(np.asarray(e2m1), np.asarray(e8m0), 32, 3.0)
    assert (dq != ref["dq"]).mean() <= 1e-4


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_int8_evaluator(seed):
    """Random pipeline draws through the int8 evaluator: must be
    bit-identical to the emulation decode GEMM (deficit budget holds by
    construction for quantizer-produced tensors)."""
    from qutlass_tpu.ops import int8path as I8

    rng = np.random.default_rng(7000 + seed)
    m = int(rng.choice([8, 33, 64]))
    n = int(rng.choice([16, 96]))
    k = int(rng.choice(K_POOL))
    rot = int(rng.choice([r for r in ROTS if k % r == 0]))
    method = str(rng.choice(["quest", "abs_max"]))
    a, b = randn_bf16(rng, m, k), randn_bf16(rng, n, k, scale=0.05)
    h = bf16_hadamard(rot)
    one = jnp.ones((1,), jnp.float32)
    aq, asf = E.fused_quantize_mx(a, h, rot_size=rot, method=method,
                                  layout="kmajor")
    bq, bsf = E.fused_quantize_mx(b, h, rot_size=rot, method=method,
                                  layout="kmajor")
    ai, sa, da = I8.encode_int8(aq, asf, kmajor=True)
    wi8, wsb, db = I8.prepare_weight_int8(bq, bsf)
    assert int(da) <= 3 and int(db) <= 3
    ref = E.matmul_mxf4_bf16_kmajor(aq, bq, asf, bsf, one)
    out = I8.matmul_mxf4_bf16_int8_kmajor(ai, wi8, sa, wsb, one)
    np.testing.assert_array_equal(np.asarray(out, np.float32),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_fused_int8_quantize(seed):
    """Random draws through the fused quantize+int8-encode kernel
    (interpret mode): bitwise equal to the XLA twins for operand, row
    scale, and scale bytes, across row counts that force partial blocks
    and Ks that force several K chunks."""
    from qutlass_tpu.kernels import quantize_int8 as KQ

    rng = np.random.default_rng(8000 + seed)
    rows = int(rng.choice([8, 33, 64, 129, 256]))
    k = int(rng.choice([128, 256, 384, 512]))
    rot = int(rng.choice([r for r in ROTS if k % r == 0]))
    method = str(rng.choice(["quest", "abs_max"]))
    x = randn_bf16(rng, rows, k)
    h = bf16_hadamard(rot)
    pa, psa, psb = KQ.quantize_int8(x, h, fmt="mx", method=method,
                                    interpret=True)
    ea, esa, esb = E.fused_quantize_mx_int8(x, h, rot_size=rot,
                                            method=method)
    np.testing.assert_array_equal(np.asarray(pa), np.asarray(ea))
    np.testing.assert_array_equal(np.asarray(psa), np.asarray(esa))
    np.testing.assert_array_equal(np.asarray(psb), np.asarray(esb))

    if rot >= 16 and k % 16 == 0:
        h16 = bf16_hadamard(16)
        gs = jnp.asarray(float(rng.uniform(0.5, 4.0)), jnp.float32)
        na, nsg, nsb = KQ.quantize_int8(x, h16, gs, fmt="nv", method=method,
                                        interpret=True)
        ma, msg, msb = E.fused_quantize_nv_int8(x, h16, gs, rot_size=16,
                                                method=method)
        np.testing.assert_array_equal(np.asarray(na), np.asarray(ma))
        np.testing.assert_array_equal(np.asarray(nsg), np.asarray(msg))
        np.testing.assert_array_equal(np.asarray(nsb), np.asarray(msb))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_nv_int8_evaluator_bound(seed):
    """Random NV pipeline draws through the int8 evaluator: the GEMM
    error vs the fp64 dequant matmul stays within the accumulated
    documented bound (sigma/2 per element per operand)."""
    from qutlass_tpu.ops import int8path as I8

    rng = np.random.default_rng(9000 + seed)
    m = int(rng.choice([8, 33, 64]))
    n = int(rng.choice([16, 96]))
    k = int(rng.choice([256, 512]))
    a, b = randn_bf16(rng, m, k), randn_bf16(rng, n, k, scale=0.05)
    h = bf16_hadamard(16)
    gsa = jnp.asarray(float(rng.uniform(0.5, 4.0)), jnp.float32)
    gsb = jnp.asarray(float(rng.uniform(4.0, 40.0)), jnp.float32)
    aq, asf = E.fused_quantize_nv(a, h, gsa, rot_size=16, method="abs_max",
                                  layout="kmajor")
    bq, bsf = E.fused_quantize_nv(b, h, gsb, rot_size=16, method="abs_max",
                                  layout="kmajor")
    ai, sa = I8.encode_nv_int8(aq, asf)
    bi, sb = I8.prepare_weight_nv_int8(bq, bsf)
    alpha = (1.0 / (gsa * gsb)).reshape(1)
    y = np.asarray(I8.matmul_mxf4_bf16_int8_kk(ai, bi, sa, sb, alpha,
                                               out_dtype=jnp.float32),
                   np.float64)
    ra = G.quantize_nv(to_np64(a), to_np64(h), 16, float(gsa), "abs_max")
    rb = G.quantize_nv(to_np64(b), to_np64(h), 16, float(gsb), "abs_max")
    yref = (ra["dq"] @ rb["dq"].T) / (float(gsa) * float(gsb))
    sa64, sb64 = np.asarray(sa, np.float64), np.asarray(sb, np.float64)
    va = np.abs(ra["dq"]).sum(axis=1)
    vb = np.abs(rb["dq"]).sum(axis=1)
    bound = (va[:, None] * sb64[None, :] / 2 + vb[None, :] * sa64[:, None] / 2
             + k * sa64[:, None] * sb64[None, :] / 4
             ) / (float(gsa) * float(gsb)) * (1 + 1e-4) + 1e-9
    assert (np.abs(y - yref) <= bound).all(), \
        (seed, float((np.abs(y - yref) / bound).max()))


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_interop_roundtrip(seed):
    """Random export -> import roundtrips of the reference row-major
    layout: stored operands reproduce bitwise for random shapes, both
    formats, and all three scale-argument spellings (exact, padded
    buffer, to_blocked flattening)."""
    from qutlass_tpu import io as qio
    from qutlass_tpu.models.transformer import quantize_weight
    from qutlass_tpu.utils import round_up

    rng = np.random.default_rng(11000 + seed)
    n = int(rng.choice([16, 64, 96, 200]))
    k = int(rng.choice([128, 256, 512]))
    fmt = str(rng.choice(["mx", "nv"]))
    method = "abs_max" if fmt == "nv" else str(rng.choice(["quest",
                                                           "abs_max"]))
    w = randn_bf16(rng, n, k, scale=float(rng.uniform(0.01, 0.5)))
    h = bf16_hadamard(32)
    d = quantize_weight(w, h=h, method=method, fmt=fmt,
                        weight_format="both")
    if fmt == "mx" and method == "abs_max":
        # 3x-scaled codes have no on-disk expression — descriptive reject,
        # then roundtrip the quest spelling of the same draw
        with pytest.raises(ValueError, match="abs_max"):
            qio.export_quantized_weight(d)
        d = quantize_weight(w, h=h, method="quest", fmt=fmt,
                            weight_format="both")
    out = qio.export_quantized_weight(d)
    packed, scales = out[0], out[1]
    gs = out[2] if fmt == "nv" else None

    variants = [scales]
    pr, pc = round_up(n, 128), round_up(scales.shape[1], 4)
    padded = np.zeros((pr, pc), np.uint8)
    padded[:n, : scales.shape[1]] = np.asarray(scales)
    variants += [padded, padded.reshape(-1)]

    for sv in variants:
        if fmt == "nv":
            imp = qio.import_nvfp4_weight(packed, sv, gs,
                                          weight_format="both")
        else:
            imp = qio.import_mxfp4_weight(packed, sv, weight_format="both")
        assert set(imp) == set(d), (seed, set(imp), set(d))
        for key in d:
            np.testing.assert_array_equal(np.asarray(imp[key]),
                                          np.asarray(d[key]),
                                          err_msg=f"{seed}:{key}")


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_continuous_batching_schedule(seed):
    """Random continuous-batching schedules: prompt lengths, step
    counts, slot-pool sizes, chunked-vs-bucketed admission, and an EOS
    id that fires for some prompts — every prompt's stream output must
    equal its solo generation bitwise (the scheduler can change WHEN
    rows compute, never WHAT they compute)."""
    from qutlass_tpu.models import generate, init_params, tiny_config
    from qutlass_tpu.models.continuous import ContinuousBatcher

    cfg = tiny_config()
    params = init_params(cfg, jax.random.PRNGKey(3))
    h = bf16_hadamard(32)
    rng = np.random.default_rng(12000 + seed)
    n_prompts = int(rng.integers(3, 8))
    prompts = [(rng.integers(0, cfg.vocab_size, int(rng.integers(1, 21))),
                int(rng.integers(1, 9))) for _ in range(n_prompts)]
    n_slots = int(rng.integers(1, 4))
    chunk = int(rng.choice([0, 4, 8]))
    eos = int(rng.integers(0, cfg.vocab_size)) if rng.random() < 0.5 else None

    cb = ContinuousBatcher(cfg, params, h, n_slots=n_slots, max_len=64,
                           chunk=chunk or None)
    outs = cb.run(prompts, eos_id=eos)

    for i, (ids, steps) in enumerate(prompts):
        prompt = jnp.asarray(np.asarray(ids, np.int32)[None])
        ref = np.asarray(generate(cfg, params, prompt, h, steps=steps,
                                  max_len=64, eos_id=eos, pad_id=-1))[0]
        keep = []
        for t in ref:
            if t == -1:
                break
            keep.append(t)
            if eos is not None and t == eos:
                break
        np.testing.assert_array_equal(
            outs[i], np.asarray(keep, np.int32),
            err_msg=f"seed {seed} prompt {i} (slots={n_slots}, "
                    f"chunk={chunk}, eos={eos})")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_scaled_decoders_full_byte_range(seed):
    """Scaled decoders over the FULL byte range (including imported-only
    values: NaN scale byte 255, e4m3fn NaN data, overflow, deep
    subnormals) vs the fp64 golden cast to bf16."""
    import ml_dtypes
    from qutlass_tpu.formats import codecs as C
    from qutlass_tpu.formats import golden as G

    rng = np.random.default_rng(13000 + seed)
    n = 4096
    codes = jnp.asarray(rng.integers(0, 16, size=n), jnp.int32)
    sb = jnp.asarray(rng.integers(0, 256, size=n), jnp.int32)
    got = np.asarray(C.e2m1_decode_scaled_bf16(codes, sb), np.float64)
    want = (np.asarray(C.e2m1_decode_f32(codes), np.float64)
            * G.e8m0_to_f64(np.asarray(sb))
            ).astype(ml_dtypes.bfloat16).astype(np.float64)
    nan = np.isnan(want)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(got[nan]).all()

    data = jnp.asarray(rng.integers(0, 256, size=n), jnp.int32)
    got = np.asarray(C.e4m3_decode_scaled_bf16(data, sb), np.float64)
    want = (G.e4m3_to_f64(np.asarray(data))
            * G.e8m0_to_f64(np.asarray(sb))
            ).astype(ml_dtypes.bfloat16).astype(np.float64)
    nan = np.isnan(want)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(got[nan]).all()
