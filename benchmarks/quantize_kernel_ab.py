"""Fused rotate+quantize+int8 kernel against its XLA twin, on the card.

    python benchmarks/quantize_kernel_ab.py [--out DIR] [--parts hlo,ops,e2e]

1. The op alone, MX (quest) and NV (abs_max), M in {1, 16, 256, 2048},
   K in {4096, 12288, 25600}, had=32: one jitted program applies the op
   to 8 different activations (so launch costs count as they do inside
   a model) and reduces every output; seconds per op = median / 8.
2. End to end on Qwen3-8B (36 layers, random weights, int8 weights):
   one decode step of 8 slots at ragged positions and one 1024-token
   prefill, each compiled twice — kernel route and XLA route — and timed
   in turns (kernel, XLA, XLA, kernel, ...).
3. The optimized HLO of the production linear with the kernel route
   (M=2048, K=4096, N=12288): its custom calls, transposes and int8 dot,
   written to ``DIR/hlo_linear.txt``.

Every number is printed beside the card's name and power limit.  Needs a
GPU; exits non-zero without one.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def with_route(kernel: bool, fn):
    """Trace ``fn`` with the fused kernel on or off (the public ops read
    ``qutlass_tpu._gpu_int8_kernel`` at trace time)."""
    import qutlass_tpu as q
    orig = q._gpu_int8_kernel
    q._gpu_int8_kernel = lambda k: kernel and orig(k)
    try:
        return fn()
    finally:
        q._gpu_int8_kernel = orig


def alternate(fa, fb, rounds=6, reps=5):
    """Median seconds of fa and fb, timed in turns a b b a ..."""
    import jax
    ta, tb = [], []
    for f in (fa, fb):
        jax.block_until_ready(f())
    for r in range(rounds):
        order = (fa, fb) if r % 2 == 0 else (fb, fa)
        for f in order:
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(f())
                (ta if f is fa else tb).append(time.perf_counter() - t0)
    return float(np.median(ta)), float(np.median(tb))


def op_table(card):
    import jax
    import jax.numpy as jnp

    from qutlass_tpu.kernels import quantize_int8 as KQ
    from qutlass_tpu.ops import emulation as E
    from qutlass_tpu.utils import hadamard_matrix

    h = hadamard_matrix(32)
    gs = jnp.float32(100.0)
    n_ops = 8
    print(f"op alone (seconds per op, {n_ops} ops per program) [{card}]")
    print("fmt  M      K      kernel_us   xla_us   xla/kernel")
    for fmt in ("mx", "nv"):
        for k in (4096, 12288, 25600):
            for m in (1, 16, 256, 2048):
                xs = jax.random.normal(jax.random.PRNGKey(m + k),
                                       (n_ops, m, k), jnp.bfloat16)

                def consume(out):
                    a, s, sb = out
                    return (jnp.sum(a, dtype=jnp.int32).astype(jnp.float32)
                            + jnp.sum(s) + jnp.sum(sb, dtype=jnp.int32))

                if fmt == "mx":
                    kern = lambda x: KQ.quantize_int8(x, h, fmt="mx",
                                                      method="quest")
                    xla = lambda x: E.fused_quantize_mx_int8(
                        x, h, rot_size=32, method="quest")
                else:
                    kern = lambda x: KQ.quantize_int8(x, h, gs, fmt="nv",
                                                      method="abs_max")
                    xla = lambda x: E.fused_quantize_nv_int8(
                        x, h, gs, rot_size=32, method="abs_max")
                fk = jax.jit(lambda xs, op=kern: sum(
                    consume(op(xs[i])) for i in range(n_ops)))
                fx = jax.jit(lambda xs, op=xla: sum(
                    consume(op(xs[i])) for i in range(n_ops)))
                tk, tx = alternate(lambda: fk(xs), lambda: fx(xs))
                print(f"{fmt}   {m:5d}  {k:5d}  {tk / n_ops * 1e6:9.1f}  "
                      f"{tx / n_ops * 1e6:9.1f}  {tx / tk:6.2f}", flush=True)


def e2e(card):
    import jax
    import jax.numpy as jnp

    from qutlass_tpu.models import (QWEN3_8B, init_params,
                                    quantize_model_weights)
    from qutlass_tpu.models import serving as S
    from qutlass_tpu.utils import hadamard_matrix

    cfg = QWEN3_8B
    h = hadamard_matrix(32)
    params = init_params(cfg, jax.random.PRNGKey(0))
    qp = quantize_model_weights(cfg, params, h)
    del params
    max_len = 2048
    cache = S.init_cache(cfg, 8, max_len)
    tok = jnp.arange(8, dtype=jnp.int32)
    pos = jnp.asarray([100, 300, 517, 900, 1023, 64, 1500, 2000],
                      jnp.int32)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (1, 1024), 0,
                                cfg.vocab_size)

    # the weights are arguments: closed over, they would be embedded in
    # the program as constants
    def dec(p_, c, t, p):
        return S.decode_step.__wrapped__(cfg, p_, c, t, p, h,
                                         quantized=True)[0]

    def pre(p_, t):
        return S.prefill.__wrapped__(cfg, p_, t, h, max_len=max_len,
                                     quantized=True)[0]

    res = {}
    for name, fn, args in (("decode step, 8 slots", dec,
                            (qp, cache, tok, pos)),
                           ("prefill, 1024 tokens", pre, (qp, prompt))):
        comp = {}
        for route in (True, False):
            t0 = time.perf_counter()
            # a fresh function object per route: jit caches traces by
            # function, and the route is read while tracing
            comp[route] = with_route(route, lambda: jax.jit(
                lambda *a: fn(*a)).lower(*args).compile())
            print(f"  compiled {name} ({'kernel' if route else 'XLA'} "
                  f"route) in {time.perf_counter() - t0:.1f} s", flush=True)
        tk, tx = alternate(lambda: comp[True](*args),
                           lambda: comp[False](*args))
        res[name] = (tk, tx)
        print(f"e2e {name}: kernel {tk * 1e3:.3f} ms, XLA {tx * 1e3:.3f} ms,"
              f" XLA/kernel {tx / tk:.3f} [{card}]", flush=True)
    return res


def hlo_linear(out_dir):
    import jax
    import jax.numpy as jnp

    from qutlass_tpu.models.transformer import _linear, quantize_weight
    from qutlass_tpu.utils import hadamard_matrix

    h = hadamard_matrix(32)
    w = jax.random.normal(jax.random.PRNGKey(0), (12288, 4096),
                          jnp.bfloat16) * 0.02
    wd = quantize_weight(w, h=h)
    x = jax.random.normal(jax.random.PRNGKey(1), (2048, 4096), jnp.bfloat16)
    txt = jax.jit(lambda x, wd: _linear(x, wd, h, "quest", True)).lower(
        x, wd).compile().as_text()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "hlo_linear.txt"), "w") as f:
        f.write(txt)
    lines = [l.strip() for l in txt.splitlines()
             if "custom_call_target" in l or " transpose(" in l
             or "s8[" in l and " dot(" in l]
    print("optimized HLO of _linear (M=2048 K=4096 N=12288), custom calls / "
          "transposes / int8 dots:")
    for l in lines:
        print("  " + l[:300])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "bench_out"))
    ap.add_argument("--parts", default="hlo,ops,e2e",
                    help="comma-separated subset of hlo,ops,e2e")
    args = ap.parse_args()
    import jax
    if jax.default_backend() != "gpu":
        print("needs a GPU", file=sys.stderr)
        sys.exit(2)
    from qutlass_tpu.profiling import setup_compile_cache
    setup_compile_cache()
    card = smi()
    print(f"card: {card}; jax {jax.__version__}", flush=True)
    parts = args.parts.split(",")
    if "hlo" in parts:
        hlo_linear(args.out)
    if "ops" in parts:
        op_table(card)
    if "e2e" in parts:
        e2e(card)


if __name__ == "__main__":
    main()
