"""Continuous batching: slot reuse/eviction over the ragged serving path.

The reference delegates serving to vLLM (README.md:50); its in-repo
equivalent here is a fixed-shape slot scheduler: a batch of ``n_slots``
rows with a shared static KV cache, per-row decode positions (the
ragged path in models/serving.py), admission of new prompts into rows
freed by EOS/finish, and host-side output collection.

Every device computation has a static shape — the
[n_slots] decode step and the bucketed B=1 prefill each compile once;
admission/eviction is host-side bookkeeping.  A freed row's stale cache
contents are harmless: a new tenant's prefill overwrites positions
[0, len), decode writes position p before the attention mask can see
it, and the mask never admits positions beyond the tenant's own
history.

Bit-equality contract (test_continuous.py): each prompt's greedy tokens
equal its solo ``generate`` run exactly on CPU — rows of a batched
decode are computed independently, so batching cannot change per-row
numerics (on a GPU, shape-dependent kernel choices may introduce
reduction-order ties, same as the ragged test).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .serving import (decode_step, init_cache, prefill, prefill_chunked,
                      sample_logits)
from .transformer import ModelConfig


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


@functools.partial(jax.jit, static_argnames=("cfg", "quantized", "method",
                                             "max_len", "mlp",
                                             "cache_format"))
def _prefill_one(cfg, params, tokens, length, h, *, max_len, quantized,
                 method, mlp=None, cache_format="bf16"):
    """Prefill a single padded prompt [1, T]; returns (logits, cache)."""
    return prefill(cfg, params, tokens, h, max_len=max_len,
                   quantized=quantized, method=method, mlp=mlp,
                   lengths=length, cache_format=cache_format)


@dataclass
class _Slot:
    prompt_id: int = -1
    remaining: int = 0
    done: bool = False


class LocalEngine:
    """Single-device prefill/decode backend for the batcher (default).

    ``chunk`` switches admission to :func:`serving.prefill_chunked`:
    ONE compiled ``chunk``-wide program serves every prompt length
    (the default bucket ladder compiles one program per bucket), at
    identical outputs — the right trade when prompt lengths vary widely
    or compiles are expensive.
    """

    def __init__(self, cfg: ModelConfig, params, h=None, *,
                 quantized: bool = False, method: str = "quest", mlp=None,
                 chunk: int | None = None, cache_format: str = "bf16"):
        self.cfg, self.params, self.h = cfg, params, h
        self.chunk = chunk
        self.cache_format = cache_format
        self.kw = dict(quantized=quantized, method=method, mlp=mlp)

    def init_cache(self, n: int, max_len: int):
        return init_cache(self.cfg, n, max_len, self.cache_format)

    def _step_fn(self):
        from .serving import prefill_step

        def step(c, toks, pos):
            return prefill_step(self.cfg, self.params, c, toks, pos,
                                self.h, **self.kw)
        return step

    def prefill(self, tokens, length, max_len: int):
        if self.chunk:
            from .serving import _engine_prefill_chunked
            return _engine_prefill_chunked(
                self._step_fn(), self.init_cache(tokens.shape[0], max_len),
                tokens, length, max_len=max_len, chunk=self.chunk,
                cfg=self.cfg, params=self.params)
        return _prefill_one(self.cfg, self.params, tokens, length, self.h,
                            max_len=max_len,
                            cache_format=self.cache_format, **self.kw)

    def prefill_from(self, cache, tokens, start: int, max_len: int):
        """Continue prefill of a suffix [1, T'] from position ``start``
        into an existing 1-row cache (prefix-cache continuation);
        returns (logits [1, V], cache)."""
        from .serving import _engine_prefill_from
        return _engine_prefill_from(
            self._step_fn(), cache, tokens, start, max_len=max_len,
            chunk=self.chunk, cfg=self.cfg, params=self.params,
            bucket=_bucket)

    def decode(self, cache, token, pos):
        return decode_step(self.cfg, self.params, cache, token, pos, self.h,
                           **self.kw)


class ContinuousBatcher:
    """Fixed-slot continuous batching scheduler (host-side control).

    >>> cb = ContinuousBatcher(cfg, qparams, h, n_slots=4, max_len=128,
    ...                        quantized=True)
    >>> outs = cb.run([(ids1, 32), (ids2, 16), ...], eos_id=2)
    outs[i] == the generated tokens for prompt i (trimmed at EOS).

    ``engine`` swaps the device backend while the slot scheduler stays
    identical: the default :class:`LocalEngine` runs single-device;
    :class:`serving_tp.TPEngine` runs every dispatch tensor-parallel
    over a mesh (sharded slot cache included).  An engine provides
    ``init_cache(n, max_len)``, ``prefill(tokens [1,T], length [1],
    max_len) -> (logits [1,V], cache)`` and ``decode(cache, token [B],
    pos [B]) -> (logits [B,V], cache)``.
    """

    def __init__(self, cfg: ModelConfig = None, params=None, h=None, *,
                 n_slots: int, max_len: int, quantized: bool = False,
                 method: str = "quest", mlp=None, engine=None,
                 chunk: int | None = None, cache_format: str | None = None,
                 admit_batch: bool = False):
        if engine is not None:
            # LocalEngine-only knobs are silently dead with a custom
            # engine — reject them so a user configuring e.g. the int8
            # cache on the batcher gets an error instead of a bf16 cache
            dead = [n for n, bad in (
                ("cfg", cfg is not None), ("params", params is not None),
                ("h", h is not None), ("quantized", quantized is not False),
                ("method", method != "quest"), ("mlp", mlp is not None),
                ("chunk", chunk is not None),
                ("cache_format", cache_format is not None)) if bad]
            if dead:
                raise ValueError(
                    f"{dead} configure the default LocalEngine and are "
                    "ignored when engine= is passed — set them on the "
                    "engine's own constructor (e.g. TPEngine(..., "
                    "chunk=N, cache_format='int8'))")
        self.engine = engine if engine is not None else LocalEngine(
            cfg, params, h, quantized=quantized, method=method, mlp=mlp,
            chunk=chunk, cache_format=cache_format or "bf16")
        self.n = n_slots
        self.max_len = max_len
        self.cache = self.engine.init_cache(n_slots, max_len)
        self.token = jnp.zeros((n_slots,), jnp.int32)
        self.pos = jnp.zeros((n_slots,), jnp.int32)
        self.slots = [_Slot() for _ in range(n_slots)]
        self._prefix = None
        self.admit_batch = admit_batch
        # run() resets this; see run()'s docstring
        self.metrics = {"decode_steps": 0, "prefill_dispatches": 0,
                        "prefix_hits": 0, "tokens_out": 0,
                        "occupancy_sum": 0, "wall_s": 0.0,
                        "tokens_per_s": 0.0, "mean_occupancy": 0.0}

    # ---------------------------------------------------------- prefix cache
    def set_prefix(self, ids) -> None:
        """Prefill a shared prompt PREFIX once; admissions whose prompt
        starts with it reuse the cached KV rows and only prefill their
        suffix (the vLLM prefix-caching role).  Outputs are identical
        to prefilling the full prompt — the prefix cache rows ARE the
        full prefill's rows for those positions.  Pass ``None`` to
        clear."""
        if ids is None:
            self._prefix = None
            return
        ids = np.asarray(ids, np.int32)
        chunk = getattr(self.engine, "chunk", None)
        padded = -(-len(ids) // chunk) * chunk if chunk else len(ids)
        if padded >= self.max_len:
            raise ValueError(
                f"prefix of {len(ids)} tokens"
                + (f" (chunk-padded to {padded})" if chunk else "")
                + f" leaves no room in max_len={self.max_len} for a "
                "suffix or generated tokens")
        logits, cache = self.engine.prefill(
            jnp.asarray(ids[None]), jnp.asarray([len(ids)], jnp.int32),
            self.max_len)
        self._prefix = (ids, logits, cache)

    def _matches_prefix(self, ids: np.ndarray) -> bool:
        if self._prefix is None:
            return False
        pids = self._prefix[0]
        return len(ids) >= len(pids) and np.array_equal(ids[: len(pids)],
                                                        pids)

    def _install(self, slots_idx, pids, lens, steps, logits, cache, rows):
        """Splice ``rows`` of a prefill's cache/logits into ``slots_idx``
        (one scatter per cache leaf, however many prompts admitted)."""
        idx = jnp.asarray(slots_idx, jnp.int32)
        rsel = jnp.asarray(rows, jnp.int32)
        firsts = jnp.argmax(logits[rsel], axis=-1).astype(jnp.int32)
        # splice the tenants' cache rows into the batch cache (every
        # leaf — the int8 cache format carries ks/vs scale planes too)
        for l, (cl, c1) in enumerate(zip(self.cache, cache)):
            self.cache[l] = {kk: cl[kk].at[idx].set(c1[kk][rsel])
                             for kk in cl}
        self.token = self.token.at[idx].set(firsts)
        self.pos = self.pos.at[idx].set(jnp.asarray(lens, jnp.int32))
        for slot, pid, st in zip(slots_idx, pids, steps):
            self.slots[slot] = _Slot(pid, st, False)

    # ------------------------------------------------------------- admission
    def _admit_batch(self, admits):
        """Admit ``[(slot, prompt_id, ids, steps), ...]``.  Prefix-cache
        hits continue individually from the shared rows.  With
        ``admit_batch=True`` everything else prefills as ONE ragged
        batch — a single device dispatch however many slots freed
        together; the batch-shaped final logits dot rounds
        differently at the fp32 ulp level than a solo run's, so greedy
        first tokens can flip where the top-2 margin is below ~1e-6 —
        hence OPT-IN, the default admits per prompt and keeps stream
        outputs bitwise-equal to solo generation."""
        plain = []
        for slot, pid, ids, steps in admits:
            if not self.admit_batch and not self._matches_prefix(ids):
                # bitwise mode (default): each prompt prefills alone, so
                # its logits come from the same-M program as a solo run
                plain.append((slot, pid, ids, steps))
                continue
            if self._matches_prefix(ids):
                self.metrics["prefix_hits"] += 1
                pids, plogits, pcache = self._prefix
                L = len(pids)
                if len(ids) == L:
                    logits, cache1 = plogits, pcache
                else:
                    self.metrics["prefill_dispatches"] += 1
                    logits, cache1 = self.engine.prefill_from(
                        pcache, jnp.asarray(ids[None, L:]), L, self.max_len)
                self._install([slot], [pid], [len(ids)], [steps], logits,
                              cache1, rows=[0])
            else:
                plain.append((slot, pid, ids, steps))
        if not plain:
            return
        if not self.admit_batch:
            for item in plain:
                self._admit_plain([item])
            return
        self._admit_plain(plain)

    def _admit_plain(self, plain):
        self.metrics["prefill_dispatches"] += 1
        k = len(plain)
        # the prefill block may not exceed the cache length (the slice
        # update in serving._block requires update <= operand)
        tb = min(_bucket(max(len(i) for _, _, i, _ in plain)), self.max_len)
        toks = np.zeros((k, tb), np.int32)
        lens = np.zeros((k,), np.int32)
        for r, (_, _, ids, _) in enumerate(plain):
            toks[r, : len(ids)] = ids
            lens[r] = len(ids)
        logits, cache = self.engine.prefill(
            jnp.asarray(toks), jnp.asarray(lens), self.max_len)
        self._install([p[0] for p in plain], [p[1] for p in plain], lens,
                      [p[3] for p in plain], logits, cache, rows=range(k))

    # ------------------------------------------------------------------ step
    def _step(self):
        logits, self.cache = self.engine.decode(self.cache, self.token,
                                                self.pos)
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out = np.asarray(self.token)
        self.token = nxt
        self.pos = self.pos + 1
        return out

    # ------------------------------------------------------------------- run
    def run(self, prompts, *, eos_id: int | None = None):
        """Drive a stream of ``(token_ids, steps)`` prompts to completion.

        Returns a list of np arrays, one per prompt, each the generated
        tokens (including the EOS token, truncated after it).

        Every prompt is validated against the cache geometry BEFORE any
        admission, so a bad prompt rejects the whole call up front
        instead of raising mid-stream after earlier prompts already
        ran.
        """
        chunk = getattr(self.engine, "chunk", None)
        for pid, (ids, steps) in enumerate(prompts):
            if len(ids) + steps > self.max_len:
                raise ValueError(
                    f"prompt {pid}: len {len(ids)} + steps {steps} "
                    f"exceeds max_len {self.max_len}")
            if chunk and -(-len(ids) // chunk) * chunk > self.max_len:
                raise ValueError(
                    f"prompt {pid}: chunked admission pads len "
                    f"{len(ids)} to {-(-len(ids) // chunk) * chunk} "
                    f"(> max_len {self.max_len}); use a chunk that "
                    f"divides max_len or a longer cache")
        import time

        queue = list(enumerate(prompts))
        outputs: dict[int, list] = {i: [] for i in range(len(prompts))}
        t0 = time.perf_counter()
        m = self.metrics = {"decode_steps": 0, "prefill_dispatches": 0,
                            "prefix_hits": 0, "tokens_out": 0,
                            "occupancy_sum": 0, "wall_s": 0.0,
                            "tokens_per_s": 0.0, "mean_occupancy": 0.0,
                            "ttft_s": [0.0] * len(prompts)}
        # (per-run counters: dispatches, prefix hits, tokens/s, mean
        # slot occupancy, each prompt's time to first token from the
        # start of the run — read self.metrics after run() returns)
        while queue or any(s.remaining > 0 for s in self.slots):
            # fill free slots — all of this round's admissions prefill
            # as one batched dispatch
            admits = []
            for i, s in enumerate(self.slots):
                if s.remaining <= 0 and queue:
                    pid, (ids, steps) = queue.pop(0)
                    admits.append((i, pid, np.asarray(ids, np.int32), steps))
            if admits:
                self._admit_batch(admits)
            tokens = self._step()
            m["decode_steps"] += 1
            m["occupancy_sum"] += sum(s.remaining > 0 and not s.done
                                      for s in self.slots)
            for i, s in enumerate(self.slots):
                if s.remaining > 0:
                    if not s.done:
                        if not outputs[s.prompt_id]:
                            m["ttft_s"][s.prompt_id] = (time.perf_counter()
                                                        - t0)
                        outputs[s.prompt_id].append(int(tokens[i]))
                        m["tokens_out"] += 1
                        if eos_id is not None and tokens[i] == eos_id:
                            s.done = True
                    s.remaining -= 1 if not s.done else s.remaining
        m["wall_s"] = time.perf_counter() - t0
        m["tokens_per_s"] = m["tokens_out"] / max(m["wall_s"], 1e-9)
        m["mean_occupancy"] = (m["occupancy_sum"]
                               / max(m["decode_steps"], 1)) / self.n
        return [np.asarray(outputs[i], np.int32) for i in range(len(prompts))]
