"""Continuous batching: a stream of prompts through a fixed slot pool.

The in-repo analogue of the vLLM serving role the reference
delegates (README.md:50): static shapes everywhere, per-row decode
positions, slot reuse on completion.  Each prompt's greedy output is
identical to generating it alone.

    python examples/continuous_batching.py   # on JAX's default device
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qutlass_tpu.profiling import setup_compile_cache  # noqa: E402

setup_compile_cache()

import jax
import jax.numpy as jnp

from qutlass_tpu.models import (ContinuousBatcher, init_params,
                                quantize_model_weights, tiny_config)


def hadamard(n):
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return jnp.asarray(h * n ** -0.5, jnp.bfloat16)


def main():
    cfg = tiny_config()
    params = init_params(cfg, jax.random.PRNGKey(0))
    h = hadamard(32)
    # int8 weight format (default): every linear is an int8 contraction
    qparams = quantize_model_weights(cfg, params, h)

    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 12))), 8)
               for _ in range(6)]

    cb = ContinuousBatcher(cfg, qparams, h, n_slots=3, max_len=64,
                           quantized=True)
    outs = cb.run(prompts)
    for i, toks in enumerate(outs):
        print(f"prompt {i} ({len(prompts[i][0])} tokens) -> {toks.tolist()}")

    # --- tensor-parallel: the same scheduler over a sharded engine ----
    if jax.device_count() >= 2:
        from qutlass_tpu.models import serving_tp as TP
        from qutlass_tpu.parallel.sharding import make_mesh

        mesh = make_mesh({"tp": 2})
        sp = TP.shard_params(cfg, qparams, mesh)
        eng = TP.TPEngine(cfg, sp, h, mesh, quantized=True)
        cb_tp = ContinuousBatcher(n_slots=3, max_len=64, engine=eng)
        outs_tp = cb_tp.run(prompts)
        same = all(np.array_equal(a, b) for a, b in zip(outs, outs_tp))
        print(f"tp=2 engine reproduces single-device outputs: {same}")


if __name__ == "__main__":
    main()
