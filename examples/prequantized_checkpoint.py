"""Serving a pre-quantized checkpoint in the reference's layout.

The reference ecosystem (vLLM PR #24440, FP-Quant; reference
README.md:50,66,80) persists NVFP4/MXFP4 linears row-major:
``weight_packed`` u8 [N, K/2], ``weight_scale`` bytes [N, K/gs] and,
for NVFP4, a per-tensor ``weight_global_scale``.  This example
fabricates such a checkpoint from a tiny model, then loads and serves
it with ``load_model`` — tokens match the directly-quantized model
exactly.

    python examples/prequantized_checkpoint.py
"""
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qutlass_tpu.profiling import setup_compile_cache  # noqa: E402

setup_compile_cache()

import jax
import jax.numpy as jnp

from qutlass_tpu.io import export_quantized_weight
from qutlass_tpu.models import (generate, init_params,
                                quantize_model_weights, tiny_config)
from qutlass_tpu.models.hf_loader import load_model
from qutlass_tpu.utils import hadamard_matrix

cfg = tiny_config()
params = init_params(cfg, jax.random.PRNGKey(0))
h = hadamard_matrix(32)

# --- produce the on-disk reference layout (normally done on GPU) ----------
direct = quantize_model_weights(cfg, params, h, fmt="nv",
                                weight_format="both")
state = {
    "model.embed_tokens.weight": np.asarray(params["embed"], np.float32),
    "model.norm.weight": np.asarray(params["final_norm"], np.float32),
    "lm_head.weight": np.asarray(params["lm_head"], np.float32),
}
hf_names = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
            "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
            "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
            "down_proj": "mlp.down_proj"}
for i, layer in enumerate(direct["layers"]):
    p = f"model.layers.{i}."
    for norm in ("input_norm", "post_attn_norm", "q_norm", "k_norm"):
        hf = {"input_norm": "input_layernorm",
              "post_attn_norm": "post_attention_layernorm",
              "q_norm": "self_attn.q_norm",
              "k_norm": "self_attn.k_norm"}[norm]
        state[p + hf + ".weight"] = np.asarray(layer[norm], np.float32)
    for ours, hf in hf_names.items():
        packed, scales, gs = export_quantized_weight(layer[ours])
        state[p + hf + ".weight_packed"] = np.asarray(packed)
        state[p + hf + ".weight_scale"] = np.asarray(scales)
        state[p + hf + ".weight_global_scale"] = np.asarray(
            gs, np.float32).reshape(1)

tmp = tempfile.mkdtemp()
from safetensors.numpy import save_file
save_file(state, f"{tmp}/model.safetensors")
with open(f"{tmp}/config.json", "w") as f:
    json.dump({
        "model_type": "qwen3", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps, "tie_word_embeddings": False,
        "quantization_config": {"format": "nvfp4-pack-quantized"},
    }, f)

# --- load + serve ---------------------------------------------------------
lcfg, qparams = load_model(tmp)        # auto-detects the quantized layout
prompt = jnp.asarray([[5, 17, 42, 7]], jnp.int32)
toks_loaded = generate(lcfg, qparams, prompt, h, steps=8, max_len=16, quantized=True)
toks_direct = generate(cfg, direct, prompt, h, steps=8, max_len=16, quantized=True)
print("loaded :", np.asarray(toks_loaded)[0])
print("direct :", np.asarray(toks_direct)[0])
assert np.array_equal(np.asarray(toks_loaded), np.asarray(toks_direct))
print("OK — pre-quantized checkpoint serves identically to direct quantization")
