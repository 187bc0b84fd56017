"""Decoder-only transformer family (Qwen3 / Llama-3.1 geometries) with
MXFP4 W4A4 quantized linear layers.

This is the end-to-end integration layer the reference delegates to HF
Transformers / vLLM (README.md:50-51, 152-168): every linear projection
(q/k/v/o, gate/up/down, lm head) can run through the fused
quantize + block-scaled GEMM path, giving the Qwen3-8B-style prefill
benchmark a first-class in-repo harness.

Design: plain functional JAX (params = pytree of bf16 arrays), static
config, jit/pjit friendly.  Qwen3 enables per-head QK-RMSNorm; Llama
does not.  Weight layout matches HF naming conventions to ease
checkpoint import.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

import qutlass_tpu as q
from ..ops import int8path as _i8


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 151_936
    hidden_size: int = 4096
    intermediate_size: int = 12_288
    num_layers: int = 36
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    qk_norm: bool = True           # Qwen3 style; False for Llama
    tie_embeddings: bool = False
    # Mistral-family sliding-window attention: each query attends only
    # the last ``sliding_window`` positions (None = full causal).  The
    # KV cache stays full-length (masked attention, not a ring buffer).
    sliding_window: int | None = None


QWEN3_8B = ModelConfig()
QWEN3_14B = ModelConfig(hidden_size=5120, intermediate_size=17_408,
                        num_layers=40, num_heads=40)
QWEN3_32B = ModelConfig(hidden_size=5120, intermediate_size=25_600,
                        num_layers=64, num_heads=64)
LLAMA31_8B = ModelConfig(vocab_size=128_256, hidden_size=4096,
                         intermediate_size=14_336, num_layers=32,
                         num_heads=32, num_kv_heads=8, head_dim=128,
                         rope_theta=500_000.0, qk_norm=False)
LLAMA31_70B = ModelConfig(vocab_size=128_256, hidden_size=8192,
                          intermediate_size=28_672, num_layers=80,
                          num_heads=64, num_kv_heads=8, head_dim=128,
                          rope_theta=500_000.0, qk_norm=False)


def tiny_config(**kw) -> ModelConfig:
    """Small config for tests / dry runs (shapes stay kernel-legal)."""
    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                qk_norm=True)
    base.update(kw)
    return ModelConfig(**base)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, key: jax.Array, dtype=jnp.bfloat16):
    """Random-initialized parameter pytree (HF-style naming)."""
    keys = jax.random.split(key, cfg.num_layers + 2)

    def dense(k, out_dim, in_dim):
        return (jax.random.normal(k, (out_dim, in_dim), jnp.float32)
                * (in_dim ** -0.5)).astype(dtype)

    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    layers = []
    for i in range(cfg.num_layers):
        ks = jax.random.split(keys[i], 8)
        layer = {
            "input_norm": jnp.ones((cfg.hidden_size,), dtype),
            "post_attn_norm": jnp.ones((cfg.hidden_size,), dtype),
            "q_proj": dense(ks[0], qd, cfg.hidden_size),
            "k_proj": dense(ks[1], kvd, cfg.hidden_size),
            "v_proj": dense(ks[2], kvd, cfg.hidden_size),
            "o_proj": dense(ks[3], cfg.hidden_size, qd),
            "gate_proj": dense(ks[4], cfg.intermediate_size, cfg.hidden_size),
            "up_proj": dense(ks[5], cfg.intermediate_size, cfg.hidden_size),
            "down_proj": dense(ks[6], cfg.hidden_size, cfg.intermediate_size),
        }
        if cfg.qk_norm:
            layer["q_norm"] = jnp.ones((cfg.head_dim,), dtype)
            layer["k_norm"] = jnp.ones((cfg.head_dim,), dtype)
        layers.append(layer)

    params = {
        "embed": (jax.random.normal(keys[-2], (cfg.vocab_size, cfg.hidden_size),
                                    jnp.float32) * 0.02).astype(dtype),
        "final_norm": jnp.ones((cfg.hidden_size,), dtype),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(keys[-1], cfg.vocab_size, cfg.hidden_size)
    return params


def quantize_weight(w, *, h, method: str = "quest", fmt: str = "mx",
                    weight_format: str = "int8"):
    """Quantize one [N, K] weight to its stored evaluator dict.

    Shared by the dense and MoE families (see
    :func:`quantize_model_weights` for the fmt / weight_format
    contract)."""
    from ..ops import int8path as I8

    if fmt == "nv":
        m = "abs_max" if method == "quest" else method
        wh = _rotate_rows(w, h)
        # vLLM convention: global_scale = 448*6/amax puts the largest
        # group's e4m3 scale factor AT the e4m3 max (448) instead of at
        # 1.0 — groups down to amax/2^-11 of the tensor max keep normal
        # e4m3 scales (6/amax silently zeroed groups below ~2^-11)
        gsw = (448.0 * 6.0) / jnp.maximum(
            jnp.max(jnp.abs(wh)).astype(jnp.float32), 1e-6)
        wqt, wst = q.fusedQuantizeNv(w, h, gsw, method=m, layout="kmajor")
        if weight_format in ("int8", "both"):
            # int8 NV evaluator: natural-K-order int8 + f32 row
            # scale (bounded rounding <= rowmax/254 — no exactness
            # regime exists for e4m3 scales; ops/int8path.py); natural
            # order shards contiguously under TP K-splits
            nvi8, nvsb = I8.prepare_weight_nv_int8(wqt, wst)
            d = {"nvi8": nvi8, "nvsb": nvsb, "gs": gsw}
            if weight_format == "both":
                d.update(wqt=wqt, wst=wst)
            return d
        return {"wqt": wqt, "wst": wst, "gs": gsw}
    wqt, wst = q.fusedQuantizeMx(w, h, method=method, layout="kmajor")
    # abs_max stores 3x-scaled codes; the marker leaf records the
    # weight-side 1/3 dequant factor IN the stored dict so _linear
    # cannot silently mis-scale when called with a different runtime
    # method (the runtime method only governs activation quantization)
    mark = {"am": jnp.int8(1)} if method == "abs_max" else {}
    if weight_format in ("int8", "both"):
        wi8, wsb, dmax = I8.prepare_weight_int8(wqt, wst)
        if int(dmax) <= 3:               # int8 evaluation exact
            d = {"wi8": wi8, "wsb": wsb, **mark}
            if weight_format == "both":
                d.update(wqt=wqt, wst=wst)
            return d
    return {"wqt": wqt, "wst": wst, **mark}


def quantize_model_weights(cfg: ModelConfig, params, h: jax.Array,
                           method: str = "quest", fmt: str = "mx",
                           weight_format: str = "int8"):
    """Pre-quantize every linear weight to MXFP4 or NVFP4.

    ``fmt="nv"`` uses the vLLM-compatible two-level NVFP4 scheme
    (method defaults make sense per format: quest for MX, abs_max for
    NV); the per-weight global scale 6/amax(w·H) is stored alongside.
    The lm head stays bf16 (standard practice).

    ``weight_format`` selects the stored evaluator operand (both
    formats; for NV the int8 operand is natural-K-order [K, N] with an
    f32 row scale and carries a bounded rounding instead of MX's
    exactness-by-deficit contract):
      "int8"  per-row-exponent int8 mantissas (ops/int8path.py) — the
              int8 tensor-core path (1 byte/param).
              Falls back to fp4 per tensor when the row exponent spread
              exceeds the 3-bit budget (checked here, host-side — the
              int8 evaluation is bit-exact whenever stored).
      "fp4"   packed nibbles + e8m0 bytes (0.5 byte/param) — the
              decode-GEMM path; choose under HBM pressure.
      "both"  store the two side by side.
    """
    quant = functools.partial(quantize_weight, h=h, method=method, fmt=fmt,
                              weight_format=weight_format)
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        ql = dict(layer)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj",
                     "gate_proj", "up_proj", "down_proj"):
            ql[name] = quant(layer[name])
        out["layers"].append(ql)
    return out


# Eager-calibration recorder: {id(weight dict): max rotated amax seen}.
# Active (a dict) only inside calibrate_nv_gsx's eager forward; _linear
# records into it when the value is concrete (never under jit tracing).
_NV_CALIB = None


def calibrate_nv_gsx(cfg: ModelConfig, params, tokens: jax.Array,
                     h: jax.Array, *, margin: float = 1.0,
                     method: str = "quest", mlp=None):
    """Calibrate STATIC activation global scales for NVFP4 linears.

    Runs one EAGER forward over ``tokens`` (a representative sample
    batch), records each NV linear's rotated activation amax, and
    stores ``gsx = 448*6 / (margin * amax)`` into the weight dicts
    (leaf ``"gsx"``) — from then on ``_linear`` skips the per-call
    exact-amax pass (a full extra rotation of the activation at every
    projection).  This is the vLLM/modelopt ``input_scale`` convention;
    the reference's NVFP4 benches likewise use a caller-provided
    constant global scale (bench_nvfp4_sm120.py:57).

    ``margin`` > 1 widens the calibrated window to absorb activations
    larger than the sample's (values beyond it clip at the e2m1 grid
    edge).  With ``margin == 1`` and the calibration batch itself, the
    static path is bitwise-identical to the exact path under the same
    (eager) execution mode — under whole-model jit the agreement is
    cosine-level like every cross-program comparison here
    (docs/NUMERICS.md fusion-context sensitivity).  Mutates ``params``
    in place and returns it.  MoE expert stacks are left on the exact
    path (their linears run under the mlp hook's own batching).
    """
    global _NV_CALIB
    ids = {}
    for layer in params["layers"]:
        for name in ("q_proj", "k_proj", "v_proj", "o_proj",
                     "gate_proj", "up_proj", "down_proj"):
            w = layer.get(name)
            if isinstance(w, dict) and "gs" in w and "gsx" not in w:
                ids[id(w)] = w
    if not ids:
        return params
    _NV_CALIB = {}
    try:
        # the UNJITTED forward: _linear runs at the Python level so
        # xh_amax is concrete, while the ops it calls stay jitted —
        # NOT jax.disable_jit(), which would run the @jax.jit ops
        # unfused and shift deep-layer activations by ~1 ulp, enough
        # to flip e4m3 scale bytes vs the exact path (the documented
        # fusion-context chaos, docs/NUMERICS.md)
        forward.__wrapped__(cfg, params, tokens, h, quantized=True,
                            method=method, mlp=mlp)
    finally:
        calib, _NV_CALIB = dict(_NV_CALIB), None
    for wid, amax in calib.items():
        w = ids.get(wid)
        if w is not None:
            # the division runs in eager jnp so the stored gsx is the
            # same f32 value the exact path computes on-device
            w["gsx"] = (448.0 * 6.0) / jnp.maximum(
                jnp.float32(margin * amax), 1e-6)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _rotate_rows(x, h):
    """Apply the per-rot_size-chunk rotation along the last axis (f32,
    full precision: it sets the NVFP4 global scales)."""
    rot = h.shape[-1]
    xr = x.reshape(-1, rot).astype(jnp.float32)
    out = jax.lax.dot_general(xr, h.astype(jnp.float32),
                              (((1,), (0,)), ((), ())),
                              precision=jax.lax.Precision.HIGHEST,
                              preferred_element_type=jnp.float32)
    return out.reshape(x.shape)


def _pinned(x):
    """Fusion pin: wrap a value in ``optimization_barrier`` so XLA
    cannot fuse across it.

    Whole-model numerics are fusion-context sensitive (docs/NUMERICS.md):
    XLA schedules the f32 reductions (rms-norm mean, softmax) differently
    depending on what surrounds them (a custom call vs an XLA int8
    dot), flipping 1-ulp quantizer inputs; W4A4 amplifies any such seed
    difference chaotically (a flipped bf16 tie flips an fp4 code — a
    ~6% value step).  Pinning the reduction between barriers isolates it
    into its own fusion, compiled identically in every surrounding
    context, which restores bitwise agreement between the int8 and
    fp4-decode evaluators (benchmarks/agreement_gate.py).  Enabled by
    ``QUTLASS_TPU_PIN_NORMS`` (read at trace time).
    """
    if os.environ.get("QUTLASS_TPU_PIN_NORMS", "0") != "0":
        return jax.lax.optimization_barrier(x)
    return x


def _rms_norm(x, w, eps):
    xf = _pinned(x).astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return _pinned((xf * jax.lax.rsqrt(var + eps)).astype(x.dtype) * w)


def _rope(x, positions, theta):
    """Rotary embedding over the last dim of [B, T, H, D].

    ``positions``: [T] (shared across the batch) or [B, T] (per-row,
    for ragged serving).
    """
    d = x.shape[-1]
    inv = 1.0 / (theta ** (np.arange(0, d, 2) / d))
    ang = positions[..., None].astype(jnp.float32) * inv
    if positions.ndim == 1:
        ang = ang[None]
    cos = jnp.cos(ang)[:, :, None, :]
    sin = jnp.sin(ang)[:, :, None, :]
    x1, x2 = jnp.split(x.astype(jnp.float32), 2, axis=-1)
    return jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           axis=-1).astype(x.dtype)


def _linear(x, w, h, method, quantized: bool, out_dtype=None):
    """Apply a (possibly quantized) linear to [..., K].

    ``out_dtype`` (default: x.dtype) — tensor-parallel callers request
    fp32 so shard partial sums cross the psum unrounded and the result
    matches single-device execution near-bitwise (one bf16 rounding at
    the end instead of one per shard).
    """
    od = out_dtype or x.dtype
    if not quantized:
        return jax.lax.dot_general(
            x, w, (((x.ndim - 1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32).astype(od)
    # under QUTLASS_TPU_PIN_NORMS the quantized linear is isolated
    # between barriers as well: its XLA-expressed pieces (the int8 dot
    # epilogue, encode composition) then compile exactly like the
    # eager op they were bitwise-tested against, instead of being
    # re-fused/re-associated into the surrounding graph (see _pinned)
    x = _pinned(x)
    if "nvi8" in w:
        k, n = w["nvi8"].shape
        wqt = wst = None
    elif "wi8" in w:
        n, k = w["wi8"].shape
        wqt = wst = None
    else:
        wqt, wst = w["wqt"], w["wst"]
        k, n = wqt.shape[0] * 2, wqt.shape[1]
    x2 = x.reshape(-1, k)
    if "gs" in w:   # NVFP4 weight (two-level scheme)
        # vLLM-style two-level NVFP4: per-tensor global scales on both
        # operands, folded out via alpha = 1/(gs_x * gs_w)
        # QUTLASS_TPU_NV_GSX=bound replaces the exact rotated amax (a
        # second full rotation matmul) with its L2 chunk-norm BOUND —
        # H is orthonormal per rot-chunk, so max|(x @ H)| <=
        # max_chunk ||x_chunk||_2, one fused square-sum reduction over
        # x.  alpha folds 1/gsx back out exactly, so only the e4m3
        # group-scale window moves — down by at most sqrt(rot_size)
        # (~2.5 binades of the ~11-binade headroom), which raises the
        # underflow floor for the tiniest groups; measured as a small
        # TP-vs-single-device cosine drop on the tiny MoE config, so
        # the EXACT amax stays the default until the bound's perf win
        # is measured on the card.
        # 1.004 slack covers bf16 rounding of H's entries (<= 2^-9 per
        # column norm) + f32 accumulation.  The env var is read at
        # TRACE time: set it before the first compile of each shape —
        # flipping it later leaves already-compiled programs on the
        # old mode.
        if "gsx" in w:
            # STATIC calibrated activation global scale (the vLLM /
            # modelopt input_scale convention — the reference's NVFP4
            # benches likewise take a caller-provided constant,
            # bench_nvfp4_sm120.py:57): skips the per-call rotated-amax
            # pass entirely (a full extra rotation of x at every
            # linear).  Set by calibrate_nv_gsx or imported from a
            # pre-quantized checkpoint's input_scale.  Activations
            # whose rotated amax exceeds the calibrated window clip at
            # the e2m1 +-6 grid edge — standard static-quant behavior;
            # calibrate with margin > 1 for headroom.
            gsx = jnp.asarray(w["gsx"], jnp.float32).reshape(())
        else:
            if os.environ.get("QUTLASS_TPU_NV_GSX", "exact") == "bound":
                xf = x2.astype(jnp.float32).reshape(-1, h.shape[-1])
                xh_amax = (jnp.sqrt(jnp.max(jnp.sum(xf * xf, axis=-1)))
                           * 1.004)
            else:
                xh_amax = jnp.max(jnp.abs(_rotate_rows(x2, h)))
            if _NV_CALIB is not None and not isinstance(
                    xh_amax, jax.core.Tracer):      # eager calibration
                _NV_CALIB[id(w)] = max(float(xh_amax),
                                       _NV_CALIB.get(id(w), 0.0))
            # 448*6/amax: vLLM global-scale convention (quantize_weight)
            gsx = (448.0 * 6.0) / jnp.maximum(
                xh_amax.astype(jnp.float32), 1e-6)
        alpha = (1.0 / (gsx * w["gs"])).reshape(1)
        if "nvi8" in w:
            # int8 NV evaluator (bounded rounding <= rowmax/254 per
            # operand — ops/int8path.py)
            xi, sx, _ = q.fusedQuantizeNvInt8(x2, h, gsx, method="abs_max")
            y = _i8.matmul_mxf4_bf16_int8_kk(xi.T, w["nvi8"], sx,
                                             w["nvsb"], alpha, out_dtype=od)
        else:
            xqt, xst = q.fusedQuantizeNv(x2, h, gsx, method="abs_max",
                                         layout="kmajor")
            y = q.matmul_nvf4_bf16_kmajor(xqt, wqt, xst, wst, alpha,
                                          out_dtype=od)
        return _pinned(y).reshape(*x.shape[:-1], n)
    # abs_max stores 3x-scaled codes: 1/3 per operand — the WEIGHT-side
    # factor comes from the stored "am" marker (set at quantize time),
    # the activation-side from the runtime method; a method mismatch
    # therefore composes correctly instead of silently scaling by ~3x
    a_mx = (1.0 if method == "quest" else 1 / 3) * \
        (1 / 3 if "am" in w else 1.0)
    if "wi8" in w:
        # int8 evaluator (ops/int8path.py): quantize straight to the
        # row-major int8 operand, then one whole-K int8 dot with both
        # operands K-contiguous and a rank-1 fixup
        ai, sa, _ = q.fusedQuantizeMxInt8(x2, h, method=method)
        y = _i8.matmul_mxf4_bf16_int8(ai, w["wi8"], sa, w["wsb"],
                                      jnp.float32(a_mx), out_dtype=od)
        return _pinned(y).reshape(*x.shape[:-1], n)
    # composed kmajor quantize + decode GEMM (the fp4-weight path)
    xqt, xst = q.fusedQuantizeMx(x2, h, method=method, layout="kmajor")
    y = q.matmul_mxf4_bf16_kmajor(xqt, wqt, xst, wst,
                                  jnp.full((1,), a_mx, jnp.float32),
                                  out_dtype=od)
    return _pinned(y).reshape(*x.shape[:-1], n)


def _prefill_attention(cfg: ModelConfig, qh, kh, vh, causal):
    """Grouped-query causal attention for prefill, [b, t, h, d] layout:
    fp32 scores, no materialized KV repeat."""
    b, t = qh.shape[0], qh.shape[1]
    rep = cfg.num_heads // cfg.num_kv_heads
    q5 = qh.reshape(b, t, cfg.num_kv_heads, rep, cfg.head_dim)
    scores = jnp.einsum("btgrd,bsgd->bgrts", q5.astype(jnp.float32),
                        kh.astype(jnp.float32)) * (cfg.head_dim ** -0.5)
    scores = jnp.where(causal[None, None, None], scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1)
    attn = jnp.einsum("bgrts,bsgd->btgrd", probs, vh.astype(jnp.float32))
    return attn.reshape(b, t, cfg.num_heads * cfg.head_dim)


@functools.partial(jax.jit, static_argnames=("cfg", "quantized", "method",
                                             "mlp"))
def forward(cfg: ModelConfig, params, tokens: jax.Array, h: jax.Array = None,
            *, quantized: bool = False, method: str = "quest", mlp=None):
    """Prefill forward: tokens [B, T] int32 -> logits [B, T, vocab].

    ``quantized=True`` expects params from :func:`quantize_model_weights`
    and runs every projection through the MXFP4 W4A4 path.  ``mlp``
    (optional, static) replaces the dense gate/up/down branch — same
    hook signature as serving._block: ``mlp(cfg, layer, xin, h, method,
    quantized) -> [B, T, D]`` (the MoE family plugs in here).
    """
    b, t = tokens.shape
    x = params["embed"][tokens]
    positions = jnp.arange(t)
    causal = jnp.tril(jnp.ones((t, t), bool))
    if cfg.sliding_window:
        qp, sp_ = jnp.arange(t)[:, None], jnp.arange(t)[None, :]
        causal = causal & (sp_ > qp - cfg.sliding_window)

    for layer in params["layers"]:
        xin = _rms_norm(x, layer["input_norm"], cfg.rms_eps)
        qh = _linear(xin, layer["q_proj"], h, method, quantized)
        kh = _linear(xin, layer["k_proj"], h, method, quantized)
        vh = _linear(xin, layer["v_proj"], h, method, quantized)
        qh = qh.reshape(b, t, cfg.num_heads, cfg.head_dim)
        kh = kh.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        vh = vh.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            qh = _rms_norm(qh, layer["q_norm"], cfg.rms_eps)
            kh = _rms_norm(kh, layer["k_norm"], cfg.rms_eps)
        qh = _rope(qh, positions, cfg.rope_theta)
        kh = _rope(kh, positions, cfg.rope_theta)

        attn = _prefill_attention(cfg, qh, kh, vh, causal).astype(x.dtype)
        x = x + _linear(attn, layer["o_proj"], h, method, quantized)

        xin = _rms_norm(x, layer["post_attn_norm"], cfg.rms_eps)
        if mlp is not None:
            x = x + mlp(cfg, layer, xin, h, method, quantized).astype(x.dtype)
        else:
            gate = _linear(xin, layer["gate_proj"], h, method, quantized)
            up = _linear(xin, layer["up_proj"], h, method, quantized)
            act = (jax.nn.silu(gate.astype(jnp.float32))
                   * up.astype(jnp.float32)).astype(x.dtype)
            x = x + _linear(act, layer["down_proj"], h, method, quantized)

    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params.get("lm_head", params["embed"])
    logits = jax.lax.dot_general(x, head, (((2,), (1,)), ((), ())),
                                 preferred_element_type=jnp.float32)
    return logits
