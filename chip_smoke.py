"""On-card smoke test: the main path of qutlass-tpu on one NVIDIA GPU.

    python chip_smoke.py          # one card: device, ops, gpu tests,
                                  # serving, QAT
    python chip_smoke.py --four   # four cards: TP serving and the
                                  # sharded QAT step, nothing else

Phases (each prints PASS or FAIL with its numbers; any FAIL makes the
exit code non-zero):

* device   — JAX must find a GPU; prints the card's name and power limit
             (nvidia-smi), the JAX version, XLA_FLAGS and the compile
             cache directory.
* ops      — the quantizers and the int8 linear at the reference's
             Qwen3-32B widths, against the fp64 golden
             (formats/golden.py), each check with its tolerance.
* gpu_tests — the tests marked ``gpu`` (compiled kernels), in-process.
* serving  — Qwen3-8B at full width and depth, random weights from a
             seed, MXFP4 W4A4 with int8 weights, served through
             ContinuousBatcher: every request answered in full, streams
             against each request served alone and against solo
             ``serving.generate``, last-position logits against the bf16
             twin, tokens/s and time to first token.
* qat      — the quartet MLP of examples/qat_training.py at 4096 wide
             with 4096 tokens: loss finite and falling; gradients against
             ``grad_mode="bf16"``.

``--four`` runs, on four cards: Qwen3-8B at full width (4 layers) served
tensor-parallel (TPEngine, tp=4) through ContinuousBatcher against the
same model on one card, and the sharded QAT step of
``__graft_entry__._dryrun_impl(4)``; each checks that every card holds
its own shard.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances (each with its reason; docs/NUMERICS.md)
CODE_MISMATCH_MAX = 1e-4     # reference budget (mxfp4_test.py:176-178):
                             # fp64-vs-fp32 ties at rounding boundaries
SCALE_MISMATCH_MAX = 5e-5    # golden scale bytes: a group scale computed
                             # from fp32 moments that sits within an ulp of
                             # a power of two (or an e4m3 rounding point)
                             # floors the other way than the fp64 golden's;
                             # measured 1 byte in 204,800 (4.9e-6) at
                             # K=25600, M=2048 on the H100
KERNEL_TWIN_MISMATCH_MAX = 1e-3  # kernel vs XLA twin: the tensor-core
                             # rotation sums in another order, so a group
                             # statistic on a rounding boundary may land
                             # either side: 32 (MX) or 16 (NV) values per
                             # flipped group, a whole row when the row's
                             # largest group flips (1/M of the values)
LINEAR_ULP_SHARE_MAX = 1e-4  # int8 linear vs the fp4-decode GEMM: the
                             # decode GEMM's fp32 sum rounds, so an output
                             # near cancellation may land one bf16 step
                             # off; every output stays within one bf16
                             # ulp of its row's largest output
TWIN_COSINE_MIN = 0.4        # W4A4 vs bf16 logits of a RANDOM-weight model:
                             # random weights carry no signal above the
                             # W4A4 noise floor (the CPU gives 0.62-0.72 at
                             # 2-36 layers; tests/test_models.py holds
                             # random models to 0.6); a trained checkpoint
                             # sits far above
TP_COSINE_MIN = 0.9          # TP=4 vs one card, prefill logits: the
                             # sharded attention contracts over another
                             # batch of heads, which rounds differently on
                             # the GPU (benchmarks/batch_invariance.py)
QAT_GRAD_COSINE_MIN = {"int8": 0.99, "mxfp8": 0.98}   # dY keeps 8 bits per
                             # row (int8) or a 3-bit e4m3 mantissa (mxfp8)

# (K, N, M, had): the reference's Qwen3-32B table (K, N) at M = 1, 16,
# 2048, had=32, and had=128 once
OPS_SHAPES = [(k, n, m, 32) for k, n in ((5120, 5120), (25600, 5120))
              for m in (1, 16, 2048)] + [(5120, 5120, 2048, 128)]
QAT_WIDTH, QAT_TOKENS, QAT_STEPS = 4096, 4096, 6
TP_LAYERS = 4        # --four: full width, depth cut to keep 4-card time short


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    """The card's name and power limit, read by a child that stays off
    JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


class Phases:
    """Runs each phase, records PASS/FAIL, never hides a failure."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            fn(*args)
        except Exception:   # noqa: BLE001 — a phase boundary: record, go on
            traceback.print_exc(file=sys.stdout)
            self.failed.append(name)
            log(f"== phase {name}: FAIL ({time.perf_counter() - t0:.1f} s)")
            return
        log(f"== phase {name}: PASS ({time.perf_counter() - t0:.1f} s)")


def check(cond: bool, msg: str) -> None:
    log(("  ok   " if cond else "  FAIL ") + msg)
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- ops


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (the spacing of bf16 values there)."""
    ax = np.maximum(np.abs(x), np.float64(2.0 ** -126))
    return np.exp2(np.floor(np.log2(ax)) - 7)


def phase_ops():
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    import qutlass_tpu as q
    from qutlass_tpu.formats import golden as G
    from qutlass_tpu.ops import emulation as E
    from qutlass_tpu.ops import int8path as I8
    from qutlass_tpu.utils import hadamard_matrix

    rng = np.random.default_rng(0)
    sub = 256            # golden rows at M=2048 (rows are independent)
    one = jnp.ones((1,), jnp.float32)
    for k, n, m, had in OPS_SHAPES:
        tag = f"K={k} N={n} M={m} had={had}"
        h = hadamard_matrix(had)
        h64 = np.asarray(h, np.float64)
        x = jnp.asarray((rng.standard_normal((m, k)) * 2.0
                         ).astype(ml_dtypes.bfloat16))
        w = jnp.asarray((rng.standard_normal((n, k)) * 0.05
                         ).astype(ml_dtypes.bfloat16))
        r = min(m, sub)
        x64 = np.asarray(x[:r], np.float64)

        # MX quest: XLA quantizer and the fused int8 kernel vs golden
        xq, xs = q.fusedQuantizeMx(x, h, method="quest")
        gold = G.quantize_mx(x64, h64, had, "quest")
        sb = np.asarray(xs)[:r, :k // 32]
        smm = float(np.mean(sb != gold["e8m0"]))
        check(smm <= SCALE_MISMATCH_MAX, f"{tag} MX scale bytes vs golden: "
              f"mismatch {smm:.2e} <= {SCALE_MISMATCH_MAX:g}")
        cm = float(np.mean(G.unpack_fp4(np.asarray(xq)[:r])
                           != gold["values"]))
        check(cm <= CODE_MISMATCH_MAX, f"{tag} MX code mismatch {cm:.2e} "
              f"<= {CODE_MISMATCH_MAX:g}")

        ai, sa, asb = q.fusedQuantizeMxInt8(x, h, method="quest")
        ei, esa, esb = E.fused_quantize_mx_int8(x, h, rot_size=had,
                                                method="quest")
        ksm = float(np.mean(np.asarray(asb)[:r] != gold["e8m0"]))
        check(ksm <= SCALE_MISMATCH_MAX, f"{tag} MX int8 kernel scale bytes "
              f"vs golden: mismatch {ksm:.2e} <= {SCALE_MISMATCH_MAX:g}")
        km = float(np.mean(np.asarray(ai) != np.asarray(ei)))
        rsm = float(np.mean(np.asarray(sa) != np.asarray(esa)))
        check(km <= KERNEL_TWIN_MISMATCH_MAX,
              f"{tag} MX int8 kernel vs XLA twin: int8 mismatch {km:.2e} <= "
              f"{KERNEL_TWIN_MISMATCH_MAX:g} (row scales differ in "
              f"{rsm:.2e} of rows)")

        # NV abs_max vs golden
        gs = float(448.0 * 6.0 / np.abs(
            x64.reshape(r, k // had, had) @ h64).max())
        nq, ns = q.fusedQuantizeNv(x, h, jnp.float32(gs), method="abs_max")
        ngold = G.quantize_nv(x64, h64, had, gs, "abs_max")
        nsb = np.asarray(ns)[:r, :k // 16]
        nsm = float(np.mean(nsb != ngold["e4m3"]))
        check(nsm <= SCALE_MISMATCH_MAX, f"{tag} NV scale bytes vs golden: "
              f"mismatch {nsm:.2e} <= {SCALE_MISMATCH_MAX:g}")
        ncm = float(np.mean(G.unpack_fp4(np.asarray(nq)[:r])
                            != ngold["values"]))
        check(ncm <= CODE_MISMATCH_MAX,
              f"{tag} NV code mismatch {ncm:.2e} <= {CODE_MISMATCH_MAX:g}")
        ni, nsg, nsb8 = q.fusedQuantizeNvInt8(x, h, jnp.float32(gs))
        mi, msg, _ = E.fused_quantize_nv_int8(x, h, jnp.float32(gs),
                                              rot_size=had)
        nkm = float(np.mean(np.asarray(ni) != np.asarray(mi)))
        nksm = float(np.mean(np.asarray(nsb8)[:r] != ngold["e4m3"]))
        check(nkm <= KERNEL_TWIN_MISMATCH_MAX and nksm <= SCALE_MISMATCH_MAX,
              f"{tag} NV int8 kernel vs XLA twin: int8 mismatch {nkm:.2e}; "
              f"scale bytes vs golden: mismatch {nksm:.2e}")

        # int8 linear vs the fp4-decode GEMM on the same operands, and vs
        # bf16(fp64 dequant matmul)
        wqt, wst = q.fusedQuantizeMx(w, h, layout="kmajor")
        wi8, wsb, dmax = I8.prepare_weight_int8(wqt, wst)
        xsb = np.asarray(xs)[:m, :k // 32]
        xai, xsa, _ = I8.encode_int8(xq, jnp.asarray(xsb))
        y8 = np.asarray(I8.matmul_mxf4_bf16_int8(xai, wi8, xsa, wsb, one),
                        np.float64)
        y4 = np.asarray(q.matmul_mxf4_bf16_tn(xq, wqt.T, xsb, wst.T, one),
                        np.float64)
        d = np.abs(y8 - y4)
        beyond = float(np.mean(d > bf16_ulp(y4)))
        rowmax = np.max(np.abs(y4), axis=1, keepdims=True)
        check(beyond <= LINEAR_ULP_SHARE_MAX and bool(
            np.all(d <= bf16_ulp(rowmax))),
            f"{tag} int8 linear vs fp4-decode GEMM: {np.mean(d > 0):.2e} "
            f"differ, {beyond:.2e} by more than 1 bf16 ulp (max deficit "
            f"{int(dmax)})")
        adq = G.dq_fp4(np.asarray(xq)[:r], xsb[:r], 32, 1.0)
        wdq = G.dq_fp4(np.asarray(wqt.T), np.asarray(wst.T), 32, 1.0)
        ref = (adq @ wdq.T).astype(ml_dtypes.bfloat16).astype(np.float64)
        d64 = np.abs(y8[:r] - ref)
        check(bool(np.all(d64 <= bf16_ulp(ref))),
              f"{tag} int8 linear vs bf16(fp64 dequant matmul): "
              f"{np.mean(d64 > 0):.2e} differ, all within 1 bf16 ulp "
              f"({r} rows)")
        del x, w, xq, xs, ai, ei, wqt, wst, wi8
    jax.clear_caches()


# ---------------------------------------------------------------- gpu tests


def phase_gpu_tests():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_quantize_int8.py")])
    check(rc == 0, f"pytest -m gpu exit code {rc}")


# ---------------------------------------------------------------- serving


def serving_requests(rng, n, lo, hi, new_lo, new_hi, vocab):
    reqs = []
    for _ in range(n):
        t = int(rng.integers(lo, hi + 1))
        reqs.append((rng.integers(0, vocab, t).astype(np.int32),
                     int(rng.integers(new_lo, new_hi + 1))))
    return reqs


def prefix_agreement(a: np.ndarray, b: np.ndarray) -> float:
    eq = a == b
    return float(len(a) if eq.all() else int(np.argmax(~eq))) / len(a)


def build_model(seed: int = 0, layers: int | None = None):
    """Qwen3-8B (__graft_entry__'s geometry; full depth unless
    ``layers``), random weights from ``seed``: (cfg, h, bf16 params,
    W4A4 params)."""
    import dataclasses

    import jax

    from qutlass_tpu.models import (QWEN3_8B, init_params,
                                    quantize_model_weights)
    from qutlass_tpu.utils import hadamard_matrix

    cfg = QWEN3_8B
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    h = hadamard_matrix(32)
    t0 = time.perf_counter()
    params = init_params(cfg, jax.random.PRNGKey(seed))
    qparams = quantize_model_weights(cfg, params, h)
    jax.block_until_ready(qparams)
    log(f"  model ({cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"vocab {cfg.vocab_size}): random bf16 weights + MXFP4/int8 "
        f"weights in {time.perf_counter() - t0:.1f} s")
    return cfg, h, params, qparams


def phase_serving(smi: str):
    import jax
    import jax.numpy as jnp

    from qutlass_tpu.models import ContinuousBatcher, generate
    from qutlass_tpu.models.continuous import LocalEngine, _bucket

    cfg, h, params, qparams = build_model()
    rng = np.random.default_rng(1)
    reqs = serving_requests(rng, 16, 64, 1024, 32, 128, cfg.vocab_size)
    max_len = 2048

    cb = ContinuousBatcher(cfg, qparams, h, n_slots=8, max_len=max_len,
                           quantized=True)
    t0 = time.perf_counter()
    cb.run(reqs)                                  # compiles every shape
    log(f"  warm-up run (compiles included): "
        f"{time.perf_counter() - t0:.1f} s")
    outs = cb.run(reqs)
    met = cb.metrics
    full = all(len(o) == s for o, (_, s) in zip(outs, reqs))
    check(full, "every request answered with its full count of tokens "
          f"({sum(len(o) for o in outs)} tokens)")
    ttft = np.asarray(met["ttft_s"])
    log(f"  serving: {met['tokens_per_s']:.1f} tokens/s over "
        f"{met['wall_s']:.2f} s, {met['decode_steps']} decode steps, "
        f"mean slot occupancy {met['mean_occupancy']:.3f} [{smi}]")
    log(f"  time to first token (16 requests queued at t=0, 8 slots): "
        f"median {np.median(ttft):.3f} s, max {ttft.max():.3f} s [{smi}]")

    # 1. batching changes nothing a row computes: each request served
    # alone by the same batcher (same programs, 7 idle slots) gives the
    # same stream bit for bit
    alone = [ContinuousBatcher(cfg, qparams, h, n_slots=8, max_len=max_len,
                               quantized=True).run([r])[0] for r in reqs]
    same = sum(np.array_equal(a, b) for a, b in zip(outs, alone))
    check(same == len(reqs), f"batched streams == each request served "
          f"alone by the batcher: {same}/{len(reqs)} identical")

    # 2. against solo serving.generate (prompt padded to the batcher's
    # bucket, with lengths, as the batcher prefills it).  Its prefill has
    # the batcher's shapes, so the first token must agree; its decode
    # runs at batch 1, and the GPU's attention contractions round
    # differently at batch 1 and 8 (benchmarks/batch_invariance.py),
    # which W4A4 amplifies into other greedy tokens later on.
    steps = max(s for _, s in reqs)
    agree, first = [], 0
    for i, (ids, s) in enumerate(reqs):
        tb = _bucket(len(ids))
        prompt = np.zeros((1, tb), np.int32)
        prompt[0, :len(ids)] = ids
        solo = np.asarray(generate(
            cfg, qparams, jnp.asarray(prompt), h, steps=steps,
            max_len=max_len, quantized=True,
            lengths=jnp.asarray([len(ids)], jnp.int32)))[0, :s]
        agree.append(prefix_agreement(outs[i], solo))
        first += int(outs[i][0] == solo[0])
    log(f"  vs solo generate: {sum(a == 1.0 for a in agree)}/16 streams "
        f"identical, mean prefix agreement {np.mean(agree):.4f}; tokens "
        f"equal before the first difference, per request: "
        f"{[int(round(a * s)) for a, (_, s) in zip(agree, reqs)]}")
    check(first == len(reqs), f"first token == solo generate's for "
          f"{first}/{len(reqs)} requests")

    # quantized vs bf16 twin, last-position prefill logits
    ids, _ = reqs[0]
    tb = _bucket(len(ids))
    prompt = np.zeros((1, tb), np.int32)
    prompt[0, :len(ids)] = ids
    length = jnp.asarray([len(ids)], jnp.int32)
    lq, _ = LocalEngine(cfg, qparams, h, quantized=True).prefill(
        jnp.asarray(prompt), length, max_len)
    lb, _ = LocalEngine(cfg, params, h, quantized=False).prefill(
        jnp.asarray(prompt), length, max_len)
    a = np.asarray(lq, np.float64).ravel()
    b = np.asarray(lb, np.float64).ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    check(np.all(np.isfinite(a)) and cos >= TWIN_COSINE_MIN,
          f"W4A4 vs bf16 last-position logits cosine {cos:.4f} >= "
          f"{TWIN_COSINE_MIN} (random weights)")
    del params, qparams, cb
    jax.clear_caches()


# ---------------------------------------------------------------- QAT


def load_qat_example():
    spec = importlib.util.spec_from_file_location(
        "qat_training", os.path.join(REPO, "examples", "qat_training.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_qat():
    import jax
    import jax.numpy as jnp

    ex = load_qat_example()
    d, tokens, steps = QAT_WIDTH, QAT_TOKENS, QAT_STEPS
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((tokens, d)), jnp.bfloat16)
    grads = {}
    for mode in ("bf16", "int8", "mxfp8"):
        params, teacher, loss_fn = ex.mlp_problem(d, d, d, mode)
        t = x.astype(jnp.float32) @ teacher.T
        grads[mode] = jax.jit(jax.grad(loss_fn))(params, x, t)
    for mode in ("int8", "mxfp8"):
        for name in ("w1", "w2"):
            a = np.asarray(grads[mode][name], np.float64).ravel()
            b = np.asarray(grads["bf16"][name], np.float64).ravel()
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            check(cos >= QAT_GRAD_COSINE_MIN[mode],
                  f"QAT {mode} grad {name} vs grad_mode=bf16 cosine "
                  f"{cos:.5f} >= {QAT_GRAD_COSINE_MIN[mode]}")
        t0 = time.perf_counter()
        losses = ex.train(mode, steps, d, d, d, tokens, log_every=0)
        log(f"  QAT {mode} {d}x{d}, {tokens} tokens: losses "
            + " ".join(f"{v:.4f}" for v in losses)
            + f" ({time.perf_counter() - t0:.1f} s incl. compile)")
        check(bool(np.all(np.isfinite(losses))) and losses[-1] < losses[0],
              f"QAT {mode}: loss finite and falling")


# ---------------------------------------------------------------- four cards


def phase_tp_serving(smi: str):
    import jax.numpy as jnp

    from qutlass_tpu.models import ContinuousBatcher, TPEngine
    from qutlass_tpu.models import serving_tp
    from qutlass_tpu.models.continuous import LocalEngine, _bucket
    from qutlass_tpu.parallel.sharding import make_mesh

    cfg, h, params, qparams = build_model(layers=TP_LAYERS)
    del params
    rng = np.random.default_rng(2)
    reqs = serving_requests(rng, 8, 64, 512, 32, 64, cfg.vocab_size)
    max_len = 1024
    single = ContinuousBatcher(cfg, qparams, h, n_slots=4, max_len=max_len,
                               quantized=True).run(reqs)
    mesh = make_mesh({"tp": 4})
    sparams = serving_tp.shard_params(cfg, qparams, mesh)
    w = sparams["layers"][0]["q_proj"]["wi8"]
    devs = {s.device for s in w.addressable_shards}
    check(len(devs) == 4 and all(s.data.shape[0] == w.shape[0] // 4
                                 for s in w.addressable_shards),
          f"q_proj int8 weight {w.shape}: one {w.shape[0] // 4}-row shard "
          f"on each of {len(devs)} cards")
    engine = TPEngine(cfg, sparams, h, mesh, quantized=True)
    cos = []
    for ids, _ in reqs:
        prompt = np.zeros((1, _bucket(len(ids))), np.int32)
        prompt[0, :len(ids)] = ids
        length = jnp.asarray([len(ids)], jnp.int32)
        lt, _ = engine.prefill(jnp.asarray(prompt), length, max_len)
        ls, _ = LocalEngine(cfg, qparams, h, quantized=True).prefill(
            jnp.asarray(prompt), length, max_len)
        a = np.asarray(lt, np.float64).ravel()
        b = np.asarray(ls, np.float64).ravel()
        cos.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
    check(min(cos) >= TP_COSINE_MIN, f"TP=4 vs one card, prefill logits "
          f"cosine min {min(cos):.4f} >= {TP_COSINE_MIN} over {len(cos)} "
          f"prompts")
    cb = ContinuousBatcher(n_slots=4, max_len=max_len, engine=engine)
    cb.run(reqs)                                   # compiles
    outs = cb.run(reqs)
    met = cb.metrics
    check(all(len(o) == s for o, (_, s) in zip(outs, reqs)),
          "TP: every request answered with its full count of tokens")
    agree = [prefix_agreement(o, s) for o, s in zip(outs, single)]
    log(f"  TP=4 vs one card: {sum(a == 1.0 for a in agree)}/{len(agree)} "
        f"streams identical, mean prefix agreement {np.mean(agree):.4f}")
    log(f"  TP=4 serving ({cfg.num_layers} layers): "
        f"{met['tokens_per_s']:.1f} tokens/s, median TTFT "
        f"{np.median(met['ttft_s']):.3f} s [{smi}]")


def phase_sharded_qat():
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__ as G

    new_p, loss = G._dryrun_impl(4)
    check(bool(np.isfinite(float(loss))), f"sharded QAT loss {float(loss):.4f}")
    for name, arr in new_p.items():
        devs = {s.device for s in arr.addressable_shards}
        check(len(devs) == len(jax.devices()),
              f"{name} {arr.shape}: shards on {len(devs)} cards, "
              f"shard shape {arr.addressable_shards[0].data.shape}")


# ---------------------------------------------------------------- main


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        sys.exit(2)
    import qutlass_tpu  # noqa: F401 — fails fast outside a checkout
    from qutlass_tpu.profiling import setup_compile_cache

    cache = setup_compile_cache()
    smi = smi_line()
    devs = jax.devices()
    log(f"card: {smi}")
    log(f"jax {jax.__version__}; devices {len(devs)} x "
        f"{devs[0].device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; compile cache {cache}")
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devs)}",
              file=sys.stderr)
        sys.exit(2)

    ph = Phases()
    if args.four:
        ph.run("tp_serving", phase_tp_serving, smi)
        ph.run("sharded_qat", phase_sharded_qat)
    else:
        ph.run("ops", phase_ops)
        ph.run("gpu_tests", phase_gpu_tests)
        ph.run("serving", phase_serving, smi)
        ph.run("qat", phase_qat)
    log(f"card: {smi}")
    if ph.failed:
        print(f"chip_smoke: failed phases: {', '.join(ph.failed)}",
              file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
