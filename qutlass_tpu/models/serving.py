"""Serving harness: KV-cache prefill + autoregressive decode.

The reference's end-to-end numbers come from its vLLM / HF Transformers
integrations (README.md:50-51,152-168) — inference servers the library
plugs into.  This module is the in-repo equivalent: a static-shape
KV cache, a jitted prefill that fills it, and a jitted greedy decode
loop (`lax.scan`) whose every projection runs the MXFP4 W4A4 path
(M = batch).

All shapes are static (max_len fixed up front); positions are traced
scalars, so the whole generate loop compiles once.
"""
from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .transformer import ModelConfig, _linear, _rms_norm, _rope


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               fmt: str = "bf16"):
    """Per-layer KV cache pytree: k/v [B, max_len, kv_heads, head_dim].

    ``fmt="int8"`` stores K/V as int8 with a per-(position, head) f32
    scale (``ks``/``vs`` [B, max_len, kv_heads]) — HALF the cache bytes,
    so the decode attention (bandwidth-bound on the cache stream) reads
    half the HBM traffic; the dequant multiply fuses into the attention
    einsum's loads.  Values carry a bounded symmetric-quantization
    rounding (|err| <= rowmax/254 per element); the vLLM fp8-KV-cache
    role.
    """
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if fmt == "int8":
        return [{"k": jnp.zeros(shape, jnp.int8),
                 "ks": jnp.zeros(shape[:3], jnp.float32),
                 "v": jnp.zeros(shape, jnp.int8),
                 "vs": jnp.zeros(shape[:3], jnp.float32)}
                for _ in range(cfg.num_layers)]
    if fmt != "bf16":
        raise ValueError(f"unknown KV cache format {fmt!r} "
                         "(expected 'bf16' or 'int8')")
    return [{"k": jnp.zeros(shape, jnp.bfloat16),
             "v": jnp.zeros(shape, jnp.bfloat16)} for _ in range(cfg.num_layers)]


def _kv_quantize(x):
    """bf16 [B, T, H, D] -> (int8 values, f32 per-(pos, head) scales)."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    s = amax / 127.0
    q = jnp.round(xf / jnp.maximum(s, 1e-30)[..., None])
    return jnp.clip(q, -127, 127).astype(jnp.int8), s


def _kv_dequantize(q, s):
    return q.astype(jnp.float32) * s[..., None]


def _attend(cfg, qh, kc, vc, pos_limit, ks=None, vs=None):
    """q [B, T, H, D] against cache k/v [B, L, KVH, D], masked to
    positions < pos_limit + per-query causality offset (and, with
    ``cfg.sliding_window``, to the window's last W positions).

    ``pos_limit``: scalar, or [B] for ragged batches (per-row decode
    positions).

    ``ks``/``vs`` (optional, [B, L, KVH]): per-(position, head) int8
    KV-cache scales.  The dequant is NOT applied to the cache — both
    scale indices survive the contractions, so it factors out:
    ``q . (k_i8 * ks) == (q . k_i8) * ks`` on the scores and
    ``(probs) . (v_i8 * vs) == (probs * vs) . v_i8`` on the output.
    The int8 cache therefore streams at half the bf16 bytes with only
    the int8->f32 convert fused into the dot loads; scaling happens on
    scores/probs, which are rep*t/head_dim times smaller than the
    cache at decode (a materialized dequantized cache would write and
    read a full fp32 copy, twice the bf16 traffic)."""
    b, t, _, _ = qh.shape
    l = kc.shape[1]
    rep = cfg.num_heads // cfg.num_kv_heads
    # grouped-query attention WITHOUT materializing the rep-fold KV
    # repeat: the cache (the dominant decode read) streams once; query
    # heads of a group batch against their shared KV head
    q5 = qh.reshape(b, t, cfg.num_kv_heads, rep, cfg.head_dim)
    scores = jnp.einsum("btgrd,bsgd->bgrts", q5.astype(jnp.float32),
                        kc.astype(jnp.float32)) * (cfg.head_dim ** -0.5)
    if ks is not None:
        scores = scores * ks.transpose(0, 2, 1)[:, :, None, None, :]
    pl = jnp.asarray(pos_limit)
    qpos = pl[..., None] - t + jnp.arange(t)      # [t] or [B, t] abs pos
    qpos = jnp.broadcast_to(qpos, (b, t))
    spos = jnp.arange(l)
    mask = spos[None, None, :] <= qpos[:, :, None]  # [b, t, l]
    if cfg.sliding_window:
        mask = mask & (spos[None, None, :]
                       > qpos[:, :, None] - cfg.sliding_window)
    scores = jnp.where(mask[:, None, None], scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1)
    if vs is not None:
        probs = probs * vs.transpose(0, 2, 1)[:, :, None, None, :]
    out = jnp.einsum("bgrts,bsgd->btgrd", probs, vc.astype(jnp.float32))
    return out.reshape(b, t, cfg.num_heads, cfg.head_dim).astype(jnp.bfloat16)


def _block(cfg, layer, x, cache_l, start_pos, h, method, quantized,
           reduce=None, mlp=None):
    """One transformer block over x [B, T, D], updating the KV cache at
    positions [start_pos, start_pos + T).

    ``reduce`` (optional) is applied to the attention-output and MLP
    branch outputs before their residual adds — the Megatron
    tensor-parallel hook: with heads and intermediate columns sharded,
    those projections produce partial sums and ``reduce = psum(axis)``
    restores the replicated activations (models/serving_tp.py).

    ``mlp`` (optional) replaces the dense gate/up/down MLP branch —
    signature ``mlp(cfg, layer, xin, h, method, quantized) -> [B, T, D]``
    (used by the MoE family, models/moe.py).
    """
    b, t, _ = x.shape
    # TP: the reduced projections run in fp32 so shard partials cross
    # the psum unrounded — one bf16 rounding at the end, like a single
    # device (near-bitwise TP/single-device token equality)
    red_dt = None if reduce is None else jnp.float32
    if reduce is None:
        reduce = lambda y: y
    red = lambda y: reduce(y).astype(x.dtype)
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
    sp = jnp.asarray(start_pos)
    positions = sp[..., None] + jnp.arange(t)      # [t] or [B, t]
    if sp.ndim == 0:
        positions = positions.reshape(t)
    qh = _rope(qh, positions, cfg.rope_theta)
    kh = _rope(kh, positions, cfg.rope_theta)

    if "ks" in cache_l:        # int8 KV cache (see init_cache)
        kh, ks_ = _kv_quantize(kh)
        vh, vs_ = _kv_quantize(vh)
    if sp.ndim == 0:
        kc = jax.lax.dynamic_update_slice(cache_l["k"], kh,
                                          (0, start_pos, 0, 0))
        vc = jax.lax.dynamic_update_slice(cache_l["v"], vh,
                                          (0, start_pos, 0, 0))
    else:
        # ragged decode: per-row write position (t must be 1)
        kc = cache_l["k"].at[jnp.arange(b), sp].set(kh[:, 0])
        vc = cache_l["v"].at[jnp.arange(b), sp].set(vh[:, 0])
    new_cache_l = {"k": kc, "v": vc}
    ka, va = kc, vc
    ksc = vsc = None
    if "ks" in cache_l:
        if sp.ndim == 0:
            ksc = jax.lax.dynamic_update_slice(cache_l["ks"], ks_,
                                               (0, start_pos, 0))
            vsc = jax.lax.dynamic_update_slice(cache_l["vs"], vs_,
                                               (0, start_pos, 0))
        else:
            ksc = cache_l["ks"].at[jnp.arange(b), sp].set(ks_[:, 0])
            vsc = cache_l["vs"].at[jnp.arange(b), sp].set(vs_[:, 0])
        new_cache_l.update(ks=ksc, vs=vsc)
        # the dequant factors out of the attention contractions — see
        # _attend's ks/vs doc; the int8 cache streams at half bytes

    attn = _attend(cfg, qh, ka, va, sp + t, ks=ksc, vs=vsc)
    attn = attn.reshape(b, t, cfg.num_heads * cfg.head_dim)
    x = x + red(_linear(attn, layer["o_proj"], h, method, quantized,
                        out_dtype=red_dt))

    xin = _rms_norm(x, layer["post_attn_norm"], cfg.rms_eps)
    if mlp is not None:
        branch = mlp(cfg, layer, xin, h, method, quantized)
    else:
        gate = _linear(xin, layer["gate_proj"], h, method, quantized)
        up = _linear(xin, layer["up_proj"], h, method, quantized)
        act = (jax.nn.silu(gate.astype(jnp.float32))
               * up.astype(jnp.float32)).astype(x.dtype)
        branch = _linear(act, layer["down_proj"], h, method, quantized,
                         out_dtype=red_dt)
    x = x + red(branch)
    return x, new_cache_l


def _logits(cfg, params, x):
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params.get("lm_head", params["embed"])
    return jax.lax.dot_general(x, head, (((x.ndim - 1,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "quantized", "method", "max_len",
                                    "mlp", "cache_format"))
def prefill(cfg: ModelConfig, params, tokens, h=None, *, max_len: int,
            quantized: bool = False, method: str = "quest", mlp=None,
            lengths=None, cache_format: str = "bf16"):
    """Prefill [B, T] prompt -> (last-position logits [B, vocab], cache).

    ``lengths`` [B] enables ragged batches: prompts are right-padded to
    T and each row's logits are read at ``lengths[b] - 1``.  Causality
    already keeps pad positions out of every valid query's attention;
    the garbage cache slots past each row's length are overwritten by
    subsequent decode steps before they ever become visible.
    """
    b, t = tokens.shape
    cache = init_cache(cfg, b, max_len, cache_format)
    x = params["embed"][tokens]
    new_cache = []
    for layer, cache_l in zip(params["layers"], cache):
        x, cl = _block(cfg, layer, x, cache_l, 0, h, method, quantized,
                       mlp=mlp)
        new_cache.append(cl)
    last = x[:, -1] if lengths is None else x[jnp.arange(b), lengths - 1]
    return _logits(cfg, params, last), new_cache


@functools.partial(jax.jit,
                   static_argnames=("cfg", "quantized", "method", "mlp"))
def prefill_step(cfg: ModelConfig, params, cache, tokens, start_pos, h=None,
                 *, quantized: bool = False, method: str = "quest", mlp=None):
    """Prefill one chunk [B, C] into an EXISTING cache at traced
    ``start_pos`` (a multiple of nothing in particular — any offset).

    Returns (hidden states x [B, C, D] after all blocks, updated cache).
    The building block of :func:`prefill_chunked`; because ``start_pos``
    is traced, every chunk of a prompt reuses one compiled program.
    """
    x = params["embed"][tokens]
    new_cache = []
    for layer, cache_l in zip(params["layers"], cache):
        x, cl = _block(cfg, layer, x, cache_l, start_pos, h, method,
                       quantized, mlp=mlp)
        new_cache.append(cl)
    return x, new_cache


def _chunked_loop(step, cache, tokens, *, max_len: int, chunk: int,
                  lengths=None, start: int = 0):
    """Host loop shared by single-device and TP chunked prefill.

    ``step(cache, chunk_tokens [B, C], start_pos) -> (x [B, C, D],
    cache)``.  Returns (last-position hidden states [B, D], cache).
    Validates the constraints documented on :func:`prefill_chunked`.
    ``start`` offsets every write/attend position — the prefix-cache
    continuation path (``tokens`` are then the suffix, positions
    [start, start + T)).
    """
    b, t = tokens.shape
    lnp = (np.full((b,), t, np.int64) if lengths is None
           else np.asarray(lengths))
    if lnp.min() < 1 or lnp.max() > t:
        raise ValueError(
            f"lengths must satisfy 1 <= lengths <= T({t}); got range "
            f"[{int(lnp.min())}, {int(lnp.max())}]")
    nch = -(-t // chunk)
    if start + nch * chunk > max_len:
        raise ValueError(
            f"chunked prefill needs start + ceil(T/chunk)*chunk <= "
            f"max_len: {start} + {nch}*{chunk} > {max_len}")
    padded = jnp.pad(tokens, ((0, 0), (0, nch * chunk - t)))
    last = None
    for i in range(nch):
        x, cache = step(cache, padded[:, i * chunk:(i + 1) * chunk],
                        jnp.int32(start + i * chunk))
        # keep each row's hidden state at its own last prompt position
        idx = lnp - 1 - i * chunk
        rows = (idx >= 0) & (idx < chunk)
        if rows.any():
            sel = x[jnp.arange(b), jnp.clip(jnp.asarray(idx), 0, chunk - 1)]
            last = sel if last is None else jnp.where(
                jnp.asarray(rows)[:, None], sel, last)
    return last, cache


def _engine_prefill_chunked(step, cache, tokens, lengths, *, max_len: int,
                            chunk: int, cfg, params):
    """Shared body of the engines' chunked ``prefill`` (LocalEngine and
    TPEngine differ only in the ``step`` closure): ragged batch in,
    (logits at lengths-1, cache) out."""
    lnp = np.asarray(lengths)
    t = int(lnp.max())
    last, cache = _chunked_loop(step, cache, tokens[:, :t],
                                max_len=max_len, chunk=chunk,
                                lengths=jnp.asarray(lnp, jnp.int32))
    return _logits_jit(cfg, params, last), cache


def _engine_prefill_from(step, cache, tokens, start: int, *, max_len: int,
                         chunk, cfg, params, bucket):
    """Shared body of the engines' ``prefill_from`` (prefix-cache
    continuation of a suffix [1, T'] at offset ``start``)."""
    ts = tokens.shape[1]
    cw = chunk or bucket(ts)
    if start + -(-ts // cw) * cw > max_len:
        cw = ts      # padding won't fit the cache: exact-width step
    last, cache = _chunked_loop(step, cache, tokens, max_len=max_len,
                                chunk=cw, start=start)
    return _logits_jit(cfg, params, last), cache


def prefill_chunked(cfg: ModelConfig, params, tokens, h=None, *,
                    max_len: int, chunk: int, quantized: bool = False,
                    method: str = "quest", mlp=None, lengths=None,
                    cache_format: str = "bf16"):
    """Chunked prefill: identical results to :func:`prefill`, one
    ``chunk``-wide compiled program instead of a per-length compile.

    The prompt is right-padded to a multiple of ``chunk`` and fed
    through :func:`prefill_step` chunk by chunk (causal attention reads
    earlier chunks from the cache, so the hidden states equal the
    one-shot prefill's bit-for-bit on CPU; on a GPU the chunk-wide
    programs are a different fusion context than the T-wide one —
    ulp-level drift, docs/NUMERICS.md — the padded tail positions
    compute garbage that decode overwrites before any query can attend
    to it, the same argument as ragged prefill).  Serving stacks chunk prefill
    for exactly this reason: one compiled program covers every prompt
    length, and very long prompts never materialize a [T, T] score
    block.  Returns (logits [B, vocab] at each row's last position,
    cache), like :func:`prefill`.

    Constraints (validated host-side): ``lengths`` must be concrete,
    and the padded length ``ceil(T/chunk)*chunk`` must fit ``max_len``
    (the cache write of the final chunk would otherwise be clamped
    backwards onto valid positions).
    """
    def step(cache, toks, pos):
        return prefill_step(cfg, params, cache, toks, pos, h,
                            quantized=quantized, method=method, mlp=mlp)

    last, cache = _chunked_loop(step, init_cache(cfg, tokens.shape[0],
                                                 max_len, cache_format),
                                tokens, max_len=max_len, chunk=chunk,
                                lengths=lengths)
    return _logits_jit(cfg, params, last), cache


@functools.partial(jax.jit, static_argnames=("cfg",))
def _logits_jit(cfg: ModelConfig, params, x):
    return _logits(cfg, params, x)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "quantized", "method", "mlp"))
def decode_step(cfg: ModelConfig, params, cache, token, pos, h=None, *,
                quantized: bool = False, method: str = "quest", mlp=None):
    """One decode step: token [B] int32 at position ``pos`` (traced).

    ``pos`` is a scalar, or a [B] vector for ragged batches (each row
    decodes at its own position).  Returns (logits [B, vocab], updated
    cache).
    """
    x = params["embed"][token][:, None]            # [B, 1, D]
    new_cache = []
    for layer, cache_l in zip(params["layers"], cache):
        x, cl = _block(cfg, layer, x, cache_l, pos, h, method, quantized,
                       mlp=mlp)
        new_cache.append(cl)
    return _logits(cfg, params, x[:, 0]), new_cache


def sample_logits(logits, key, *, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Sample token ids [B] from logits [B, V].

    Standard serving controls (the vLLM-analogue surface):
      temperature  0 -> greedy argmax; else logits / temperature
      top_k        keep the k highest logits (0 = all)
      top_p        nucleus: keep the smallest prefix of the sorted
                   distribution with cumulative probability >= top_p
    All branches are trace-time decisions (static args), so each
    combination compiles once.
    """
    if temperature == 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    logits = logits.astype(jnp.float32) / temperature
    if top_k and top_k > 0:
        # clamp to vocab (vLLM/HF semantics; lax.top_k errors past it)
        top_k = min(top_k, logits.shape[-1])
        kth = jax.lax.top_k(logits, top_k)[0][..., -1:]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if top_p < 1.0:
        sort = jnp.sort(logits, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(sort, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        # keep entries whose prefix (exclusive) is still < top_p
        keep = cum - probs < top_p
        cutoff = jnp.min(jnp.where(keep, sort, jnp.inf), axis=-1,
                         keepdims=True)
        logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    return jax.random.categorical(key, logits, axis=-1).astype(jnp.int32)


def generate(cfg: ModelConfig, params, prompt, h=None, *, steps: int,
             max_len: int, lengths=None, **kw):
    """Autoregressive generation: prompt [B, T] -> tokens [B, steps].

    Host-side validation wrapper: the KV cache writes use scatter
    semantics whose out-of-bounds stores are silently dropped, so an
    undersized ``max_len`` would return wrong tokens instead of
    failing.  Checked here while shapes are still concrete.

    Prefill and the ``lax.scan`` decode loop run as ONE compiled
    program (no per-token dispatch).
    """
    t = prompt.shape[1]
    if lengths is None:
        if t + steps > max_len:
            raise ValueError(
                f"max_len={max_len} < prompt_len({t}) + steps({steps}): "
                "the KV cache cannot hold the generated positions")
    else:
        try:                       # concrete at top-level dispatch
            lnp = np.asarray(lengths)
        except Exception:          # traced (called under an outer jit)
            lnp = None
        if lnp is not None:
            # gather indices clamp silently under jit: lengths-1 reads
            # position 0 for lengths == 0, T-1 for lengths > T — wrong
            # tokens with no error.  Validate while concrete.
            if int(lnp.min()) < 1 or int(lnp.max()) > t:
                raise ValueError(
                    f"lengths must satisfy 1 <= lengths <= T({t}); got "
                    f"range [{int(lnp.min())}, {int(lnp.max())}]")
            if int(lnp.max()) + steps > max_len:
                raise ValueError(
                    f"max_len={max_len} < max(lengths)({int(lnp.max())}) "
                    f"+ steps({steps}): ragged cache writes would be "
                    "dropped")
    return _generate(cfg, params, prompt, h, steps=steps, max_len=max_len,
                     lengths=lengths, **kw)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "steps", "quantized", "method",
                                    "max_len", "temperature", "top_k",
                                    "top_p", "eos_id", "pad_id", "mlp",
                                    "cache_format", "return_logprobs"))
def _generate(cfg: ModelConfig, params, prompt, h=None, *, steps: int,
              max_len: int, quantized: bool = False, method: str = "quest",
              key=None, temperature: float = 0.0, top_k: int = 0,
              top_p: float = 1.0, eos_id: int | None = None,
              pad_id: int = 0, mlp=None, lengths=None,
              cache_format: str = "bf16", return_logprobs: bool = False):
    """Jitted generation loop: prompt [B, T] -> tokens [B, steps].

    One compiled dispatch: prefill + ``steps`` decode iterations under
    ``lax.scan``.  Greedy by default; pass ``key`` plus ``temperature``
    / ``top_k`` / ``top_p`` for sampled decoding, and ``eos_id`` to pad
    each sequence with ``pad_id`` after its first end-of-sequence
    token (shapes stay static — the reference serving stacks' stopping
    semantics on a fixed-length loop).  ``lengths`` [B]
    enables ragged prompts (right-padded to T; each row generates from
    its own position; ``max_len`` must cover max(lengths) + steps).

    ``return_logprobs=True`` additionally returns each emitted token's
    log-probability under the model's (untempered) softmax at the
    position that produced it — ``(tokens [B, steps], logprobs
    [B, steps] f32)``, the serving-stack ``logprobs`` surface; padded
    positions after EOS carry 0.0.
    """
    b, t = prompt.shape
    if key is None:
        key = jax.random.PRNGKey(0)

    def pick(logits, k):
        return sample_logits(logits, k, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    def lp_of(logits, token):
        return jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)[
            jnp.arange(b), token]

    logits, cache = prefill(cfg, params, prompt, h, max_len=max_len,
                            quantized=quantized, method=method, mlp=mlp,
                            lengths=lengths, cache_format=cache_format)
    key, k0 = jax.random.split(key)
    first = pick(logits, k0)
    lp0 = lp_of(logits, first) if return_logprobs else jnp.zeros((b,))
    done0 = jnp.zeros((b,), bool)
    # scalar position for dense prompts (keeps the cache write a
    # dynamic_update_slice); per-row vector only when ragged
    pos0 = jnp.int32(t) if lengths is None else lengths.astype(jnp.int32)

    def step(carry, k):
        token, lp, pos, cache, done = carry
        logits, cache = decode_step(cfg, params, cache, token, pos, h,
                                    quantized=quantized, method=method,
                                    mlp=mlp)
        nxt = pick(logits, k)
        nlp = lp_of(logits, nxt) if return_logprobs else lp
        out = (jnp.where(done, pad_id, token),
               jnp.where(done, 0.0, lp))
        if eos_id is not None:
            done = done | (token == eos_id)
        return (nxt, nlp, pos + 1, cache, done), out

    keys = jax.random.split(key, steps)
    _, (toks, lps) = jax.lax.scan(step, (first, lp0, pos0, cache, done0),
                                  keys)
    toks = jnp.swapaxes(toks, 0, 1)               # [B, steps]
    if return_logprobs:
        return toks, jnp.swapaxes(lps, 0, 1)
    return toks
