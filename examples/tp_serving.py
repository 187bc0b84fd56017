"""Tensor-parallel quantized serving over a device mesh.

Shards a W4A4 MXFP4 model Megatron-style over the ``tp`` mesh axis
(heads + MLP columns; KV cache sharded over heads) and generates with
one compiled dispatch.  On a machine with several GPUs the mesh axis
maps to the cards and the two per-layer psums cross NVLink; on a CPU
it runs on an 8-device virtual mesh.

    python examples/tp_serving.py
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", os.environ.get("XLA_FLAGS", "")
                      + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qutlass_tpu.profiling import setup_compile_cache  # noqa: E402

setup_compile_cache()

import jax
import jax.numpy as jnp

from qutlass_tpu.models import (init_params, quantize_model_weights,
                                serving_tp, tiny_config)
from qutlass_tpu.parallel.sharding import make_mesh
from qutlass_tpu.utils import hadamard_matrix

cfg = tiny_config(num_kv_heads=4)
params = init_params(cfg, jax.random.PRNGKey(0))
h = hadamard_matrix(32)
qparams = quantize_model_weights(cfg, params, h)   # every linear -> MXFP4

tp = 4 if jax.device_count() >= 4 else jax.device_count()
mesh = make_mesh({"tp": tp})
sharded = serving_tp.shard_params(cfg, qparams, mesh)
print(f"mesh: {mesh.shape}; per-device weight bytes ~1/{tp} of total")

prompt = jnp.zeros((2, 4), jnp.int32)
tokens = serving_tp.tp_generate(cfg, sharded, prompt, h, mesh, steps=8,
                                max_len=16, key=jax.random.PRNGKey(1),
                                temperature=0.8, top_k=20)
print("sampled tokens:", tokens.tolist())

# MoE family: experts shard over the same axis (no all_to_all needed —
# partial expert sums ride the per-layer psum)
from qutlass_tpu.models import moe, moe_tp, tiny_moe_config

mcfg = tiny_moe_config()
mq = moe.quantize_model_weights(mcfg, moe.init_params(
    mcfg, jax.random.PRNGKey(2)), h)
tp2 = 2 if jax.device_count() >= 2 else 1
mmesh = make_mesh({"tp": tp2})
mtoks = moe_tp.tp_generate(mcfg, moe_tp.shard_params(mcfg, mq, mmesh),
                           jnp.zeros((1, 4), jnp.int32), h, mmesh,
                           steps=6, max_len=16)
print("moe tokens:    ", mtoks.tolist())
