"""qutlass-tpu quickstart — runs on the CPU or a GPU.

Covers the full API surface a reference (IST-DASLab/qutlass) user
needs: quantize + GEMM, the K-major fast path, a quantized linear
layer, QAT training with jax.grad, and KV-cache generation.

    python examples/quickstart.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qutlass_tpu.profiling import setup_compile_cache  # noqa: E402

setup_compile_cache()

import jax
import jax.numpy as jnp
import ml_dtypes

import qutlass_tpu as q


def hadamard(n):
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return jnp.asarray(h * n ** -0.5, jnp.bfloat16)


rng = np.random.default_rng(0)
h = hadamard(32)
one = jnp.ones((1,), jnp.float32)

# --- 1. reference-parity API: fused rotate+quantize, block-scaled GEMM ---
x = jnp.asarray(rng.standard_normal((128, 1024)).astype(ml_dtypes.bfloat16))
w = jnp.asarray((rng.standard_normal((256, 1024)) * 0.05
                 ).astype(ml_dtypes.bfloat16))
xq, xs = q.fusedQuantizeMx(x, h, method="quest")       # e2m1 + e8m0 bytes
wq, ws = q.fusedQuantizeMx(w, h, method="quest")
y = q.matmul_mxf4_bf16_tn(xq, wq, q.to_blocked(xs), q.to_blocked(ws), one)
print("mxf4 GEMM:", y.shape, y.dtype)

# --- 2. K-major layout ---
wqt, wst = q.fusedQuantizeMx(w, h, method="quest", layout="kmajor")
xqt, xst = q.fusedQuantizeMx(x, h, method="quest", layout="kmajor")
yk = q.matmul_mxf4_bf16_kmajor(xqt, wqt, xst, wst, one)
assert np.array_equal(np.asarray(yk), np.asarray(y))
yf = q.fused_linear_mxf4(x, wqt, wst, h)               # one kernel launch
assert np.array_equal(np.asarray(yf), np.asarray(y))
print("kmajor + fused paths agree bit-for-bit")

# --- 3. NVFP4 (two-level scales) ---
gs = jnp.asarray([6.0], jnp.float32)
nq, ns = q.fusedQuantizeNv(x, h, gs, method="abs_max", layout="kmajor")
nwq, nws = q.fusedQuantizeNv(w, h, gs, method="abs_max", layout="kmajor")
yn = q.matmul_nvf4_bf16_kmajor(nq, nwq, ns, nws, one / 36.0)
print("nvf4 GEMM:", yn.shape)

# --- 4. QAT: differentiable W4A4 linear (Quartet scheme) ---
from qutlass_tpu.nn import quartet_linear

def loss(xx, ww):
    return jnp.mean(quartet_linear(xx, ww, h, "quest").astype(jnp.float32) ** 2)

gx, gw = jax.grad(loss, (0, 1))(x, w)
print("QAT grads:", gx.shape, gw.shape,
      "finite:", bool(jnp.isfinite(gw.astype(jnp.float32)).all()))

# --- 5. quantized model + KV-cache generation ---
from qutlass_tpu.models import (generate, init_params,
                                quantize_model_weights, tiny_config)

cfg = tiny_config()
params = init_params(cfg, jax.random.PRNGKey(0))
qparams = quantize_model_weights(cfg, params, h)       # fmt="nv" also works
prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, cfg.vocab_size)
toks = generate(cfg, qparams, prompt, h, steps=8, max_len=32, quantized=True)
print("generated tokens:", np.asarray(toks)[0])

# sampled decoding (temperature / top-k / top-p) with EOS padding
toks = generate(cfg, qparams, prompt, h, steps=8, max_len=32, quantized=True,
                key=jax.random.PRNGKey(2), temperature=0.8, top_p=0.95,
                eos_id=7)
print("sampled tokens:  ", np.asarray(toks)[0])

# ragged batches: right-padded prompts + per-row lengths
ragged = jnp.concatenate([prompt, jnp.zeros((2, 2), jnp.int32)], axis=1)
toks = generate(cfg, qparams, ragged, h, steps=4, max_len=32, quantized=True,
                lengths=jnp.asarray([8, 5], jnp.int32))
print("ragged tokens:   ", np.asarray(toks).tolist())

# MoE family has the same serving surface (models.moe.generate), and
# examples/tp_serving.py shards all of this over a tensor-parallel mesh.

print("quickstart OK")
