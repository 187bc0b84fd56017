"""Headline benchmark — MXFP4 W4A4 quantized linear vs bf16.

The reference protocol (benchmarks/bench_mxfp4_sm120.py:90,161-178) is
both model tables (Qwen3-32B: 5120x5120, 5120x51200, 25600x5120;
Llama-3.1-70B: 8192x8192, 8192x57344, 28672x8192), Hadamard size in
{32, 64, 128}, M in {1,4,8,16,32,64,128,256,512,1024,2048}; activation
path = fused rotate+quantize+int8 encode -> int8 GEMM (ops/int8path.py —
the production linear) with pre-prepared weights; TFLOP/s = 2*M*N*K/t.

The run is budget-aware: the core subset (all 6 geometries x had=32 x
M in {1, 16, 256, 2048}) first, then the NVFP4 line, then had 64/128
while ``QUTLASS_BENCH_BUDGET_S`` (default 1080 s) lasts.
``QUTLASS_BENCH_FULL=1`` runs the full grid; ``QUTLASS_BENCH_FAST=1``
only the core subset.  Each point is the median of warmed,
``block_until_ready``-timed runs (profiling.time_fn); each timed run
cycles through several weight copies so the weights stream from device
memory, as in a model, instead of sitting in L2.

Needs an accelerator: on a host with none it exits non-zero and prints
no result.  Prints ONE JSON line:
  metric      mxfp4_w4a4_linear_speedup_vs_bf16_geomean
  value       geometric-mean speedup of the quantized linear over the
              bf16 linear across the measured grid
  device      platform, device kind and count of the run
plus ``nvfp4_geomean`` when the NV line was measured.  Per-shape
details go to stderr.
"""
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

MS_CORE = [1, 16, 256, 2048]
MS_FULL = [1, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048]
TABLES = {
    "qwen3-32b": [(5120, 5120), (5120, 51200), (25600, 5120)],
    "llama31-70b": [(8192, 8192), (8192, 57344), (28672, 8192)],
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _geomean(xs):
    return float(np.exp(np.mean(np.log(xs))))


def main():
    import jax

    if jax.default_backend() == "cpu":
        log("bench.py measures an accelerator; JAX found only the CPU")
        sys.exit(1)
    import jax.numpy as jnp

    import qutlass_tpu as q
    from qutlass_tpu.ops import int8path as I8
    from qutlass_tpu.profiling import setup_compile_cache, time_fn
    from qutlass_tpu.utils import hadamard_matrix

    setup_compile_cache()
    t_start = time.time()
    budget = float(os.environ.get("QUTLASS_BENCH_BUDGET_S", "1080"))
    fast = os.environ.get("QUTLASS_BENCH_FAST", "") not in ("", "0")
    full = os.environ.get("QUTLASS_BENCH_FULL", "") not in ("", "0")
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device={device} budget={budget:.0f}s")

    hs = {n: hadamard_matrix(n) for n in (32, 64, 128)}
    one = jnp.ones((1,), jnp.float32)
    core, ext = [], []
    for table, geos in TABLES.items():
        for k, n in geos:
            core.append((table, k, n, 32, MS_FULL if full else MS_CORE))
    if not fast:
        for had in (64, 128):
            for table, geos in TABLES.items():
                for k, n in geos:
                    (core if full else ext).append(
                        (table, k, n, had, MS_FULL if full else MS_CORE))

    def nw_for(k, n):
        return 8 if n * k <= 5120 * 5120 else 4

    @jax.jit
    def bf16_linear(a, wts):
        return sum(jnp.sum(a @ w, dtype=jnp.float32) for w in wts)

    def mx_linear(had):
        @jax.jit
        def f(a, wi8s, wsbs):
            ai, sa, _ = q.fusedQuantizeMxInt8(a, hs[had], method="quest")
            return sum(jnp.sum(I8.matmul_mxf4_bf16_int8(ai, wi, sa, sb, one),
                               dtype=jnp.float32)
                       for wi, sb in zip(wi8s, wsbs))
        return f

    @jax.jit
    def nv_linear(a, nvi8s, nvsbs):
        xi, sx, _ = q.fusedQuantizeNvInt8(a, hs[32], jnp.float32(6.0))
        return sum(jnp.sum(I8.matmul_mxf4_bf16_int8_kk(xi.T, wi, sx, sb, one),
                           dtype=jnp.float32)
                   for wi, sb in zip(nvi8s, nvsbs))

    mx_pts, nv_pts, tbs = [], [], {}
    t_point = 30.0

    def out_of_budget():
        return time.time() - t_start + 1.5 * t_point > budget

    def bf16_time(m, k, n, a, wts):
        if (m, k, n) not in tbs:
            tbs[(m, k, n)] = time_fn(bf16_linear, a, wts)["q50"] / len(wts)
        return tbs[(m, k, n)]

    def run_mx(worklist):
        nonlocal t_point
        cur = None
        for table, k, n, had, ms in worklist:
            nw = nw_for(k, n)
            if cur is None or cur[0] != (k, n):
                if out_of_budget():
                    return False
                wts, wi8s, wsbs = [], [], []
                for i in range(nw):
                    w = (jax.random.normal(jax.random.PRNGKey(i), (n, k),
                                           jnp.bfloat16) * 0.05)
                    wqt, wst = q.fusedQuantizeMx(w, hs[32], layout="kmajor")
                    wi8, wsb, _ = I8.prepare_weight_int8(wqt, wst)
                    wts.append(w.T)
                    wi8s.append(wi8)
                    wsbs.append(wsb)
                cur = ((k, n), wts, wi8s, wsbs)
            _, wts, wi8s, wsbs = cur
            f = mx_linear(had)
            for m in ms:
                if out_of_budget():
                    return False
                tp0 = time.time()
                a = jax.random.normal(jax.random.PRNGKey(m), (m, k),
                                      jnp.bfloat16)
                tq = time_fn(f, a, wi8s, wsbs)["q50"] / nw
                tb = bf16_time(m, k, n, a, wts)
                mx_pts.append((table, k, n, had, m, tq, tb))
                log(f"{table} K={k:5d} N={n:5d} had={had:3d} M={m:5d}: "
                    f"mxfp4-int8 {tq*1e6:9.1f}us "
                    f"({2*m*n*k/tq/1e12:6.2f} TF/s) bf16 {tb*1e6:9.1f}us  "
                    f"speedup {tb/tq:5.2f}x")
                t_point = 0.5 * t_point + 0.5 * (time.time() - tp0)
        return True

    completed = run_mx(core[:1])
    if completed and not out_of_budget():
        for k, n in TABLES["qwen3-32b"]:
            if out_of_budget():
                break
            nw = nw_for(k, n)
            wts, nvi8s, nvsbs = [], [], []
            for i in range(nw):
                w = (jax.random.normal(jax.random.PRNGKey(99 + i), (n, k),
                                       jnp.bfloat16) * 0.05)
                wqt, wst = q.fusedQuantizeNv(w, hs[32], jnp.float32(6.0),
                                             layout="kmajor")
                ni, nsb = I8.prepare_weight_nv_int8(wqt, wst)
                nvi8s.append(ni)
                nvsbs.append(nsb)
                wts.append(w.T)
            for m in (16, 256, 2048):
                if out_of_budget():
                    break
                a = jax.random.normal(jax.random.PRNGKey(m), (m, k),
                                      jnp.bfloat16)
                tq = time_fn(nv_linear, a, nvi8s, nvsbs)["q50"] / nw
                tb = bf16_time(m, k, n, a, wts)
                nv_pts.append((k, n, m, tq, tb))
                log(f"NVFP4 qwen3-32b K={k:5d} N={n:5d} M={m:5d}: "
                    f"int8-path {tq*1e6:9.1f}us bf16 {tb*1e6:9.1f}us  "
                    f"speedup {tb/tq:5.2f}x")
    if completed:
        completed = run_mx(core[1:])
    if completed and ext:
        run_mx(ext)

    if not mx_pts:
        log("no point measured within the budget")
        sys.exit(1)
    out = {"metric": "mxfp4_w4a4_linear_speedup_vs_bf16_geomean",
           "value": round(_geomean([tb / tq for *_, tq, tb in mx_pts]), 4),
           "unit": "x", "points": len(mx_pts), "device": device}
    if nv_pts:
        out["nvfp4_geomean"] = round(
            _geomean([tb / tq for *_, tq, tb in nv_pts]), 4)
    if not completed:
        out["note"] = "budget expired mid-core-grid; geomean over measured subset"
    log(f"total wall time {time.time()-t_start:.0f}s")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
