"""Quartet MXFP4 QAT training loop: a 2-layer MLP with every linear
running ``quartet_linear`` (W4A4 forward, clip-mask STE backward),
trained with optax — the flow the reference ships as its backward
kernels + HF Transformers integration (reference README.md:44-51,
quartet_test.py flow), end-to-end under ``jax.grad``.

``grad_mode`` picks the backward arithmetic (qutlass_tpu/nn/linear.py):
``int8`` runs all three GEMMs as int8 contractions, ``mxfp8`` is
reference parity, ``bf16`` is the exact STE.

    python examples/qat_training.py   # on JAX's default device
"""
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qutlass_tpu.profiling import setup_compile_cache  # noqa: E402

setup_compile_cache()

import jax
import jax.numpy as jnp
import optax

from qutlass_tpu.nn import quartet_linear
from qutlass_tpu.utils import hadamard_matrix


def mlp_problem(d_in: int, d_hidden: int, d_out: int, grad_mode: str,
                seed: int = 0):
    """The 2-layer quartet MLP: (params, teacher, loss_fn), where the
    loss regresses the MLP onto a fixed random linear teacher."""
    h = hadamard_matrix(32)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {
        "w1": (jax.random.normal(k1, (d_hidden, d_in)) * 0.05
               ).astype(jnp.bfloat16),
        "w2": (jax.random.normal(k2, (d_out, d_hidden)) * 0.05
               ).astype(jnp.bfloat16),
    }
    teacher = jax.random.normal(k3, (d_out, d_in)) * 0.1

    def model(p, x):
        y = quartet_linear(x, p["w1"], h, "quest", grad_mode)
        y = jax.nn.silu(y.astype(jnp.float32)).astype(jnp.bfloat16)
        return quartet_linear(y, p["w2"], h, "quest", grad_mode)

    def loss_fn(p, x, t):
        return jnp.mean((model(p, x).astype(jnp.float32) - t) ** 2)

    return params, teacher, loss_fn


def train(grad_mode: str = "int8", steps: int = 40, d_in: int = 256,
          d_hidden: int = 512, d_out: int = 256, batch: int = 128,
          log_every: int = 10):
    """Train the MLP with optax adam; returns the per-step losses."""
    params, teacher, loss_fn = mlp_problem(d_in, d_hidden, d_out, grad_mode)
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def train_step(p, opt_state, x, t):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, t)
        updates, opt_state = opt.update(grads, opt_state)
        p = jax.tree.map(
            lambda w, u: (w.astype(jnp.float32) + u).astype(w.dtype),
            p, updates)
        return p, opt_state, loss

    rng = np.random.default_rng(0)
    losses = []
    for i in range(steps):
        x = jnp.asarray(rng.standard_normal((batch, d_in)), jnp.bfloat16)
        t = x.astype(jnp.float32) @ teacher.T
        params, opt_state, loss = train_step(params, opt_state, x, t)
        losses.append(float(loss))
        if log_every and i % log_every == 0:
            print(f"step {i:3d}  loss {losses[-1]:.5f}")
    return losses


def main(grad_mode: str = "int8", steps: int = 40):
    losses = train(grad_mode, steps)
    print(f"grad_mode={grad_mode}: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    assert losses[-1] < losses[0] * 0.5, \
        "QAT training failed to reduce the loss"
    print("qat_training OK")


if __name__ == "__main__":
    main(*(sys.argv[1:2] or ["int8"]))
