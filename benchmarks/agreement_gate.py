"""Model-level numerics gate: greedy-token agreement, int8 vs fp4
evaluator.

docs/NUMERICS.md documents that whole-model jit is fusion-context
sensitive: XLA fuses the f32 rms-norm reduction differently around the
int8-MXU evaluator than around the fp4-decode GEMM, flipping 1-ulp
quantizer inputs, so int8-vs-fp4 model outputs agree at cosine level
while every op is bitwise in isolation.  This script turns
"cosine-level" into a number with a threshold: greedy decode N prompts
for S steps under both evaluators and report

  * prefix agreement — mean over rows of (steps until first divergence)
    / S.  After the first differing token the contexts differ, so only
    the prefix is a meaningful comparison.
  * exact rows — fraction of rows whose full S-token stream matches.

GATE: prefix agreement >= 0.95.  Reference anchor: the reference pins
numerics at the kernel level only (tests/mxfp4_test.py); a model-level
gate is extra.

:func:`run_gate` runs in the calling process (one JAX process per card:
a second process would fail for want of device memory).

Usage: python benchmarks/agreement_gate.py [--prompts 64] [--steps 64]
       [--pin 0|1]
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_gate(prompts: int = 64, steps: int = 64, pin: int = 1,
             threshold: float = 0.95) -> dict:
    """Greedy-decode ``prompts`` prompts for ``steps`` steps under the
    int8 and the fp4 evaluator; return the agreement summary.

    ``pin`` sets QUTLASS_TPU_PIN_NORMS while the gate traces: norms and
    linears are isolated between optimization_barriers so both
    evaluator programs compile the shared f32 reductions identically
    (pin=0 measures the unpinned contract).
    """
    import jax
    import jax.numpy as jnp

    from qutlass_tpu.models import (init_params, quantize_model_weights,
                                    tiny_config)
    from qutlass_tpu.models import serving as S

    old = os.environ.get("QUTLASS_TPU_PIN_NORMS")
    os.environ["QUTLASS_TPU_PIN_NORMS"] = str(pin)
    try:
        # 128-multiple hidden/intermediate: both evaluators take their
        # production routes
        cfg = tiny_config(hidden_size=512, intermediate_size=1024,
                          num_layers=2, num_heads=4, num_kv_heads=2,
                          head_dim=128, vocab_size=2048)
        params = init_params(cfg, jax.random.PRNGKey(0))
        hm = np.array([[1.0]])
        while hm.shape[0] < 32:
            hm = np.block([[hm, hm], [hm, -hm]])
        h = jnp.asarray(hm * 32 ** -0.5, jnp.bfloat16)

        streams = {}
        for wf in ("int8", "fp4"):
            qp = quantize_model_weights(cfg, params, h, weight_format=wf)
            toks_in = jax.random.randint(jax.random.PRNGKey(7),
                                         (prompts, 32), 0, cfg.vocab_size)
            logits, cache = S.prefill(cfg, qp, toks_in, h,
                                      max_len=32 + steps, quantized=True)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            toks = [tok]
            for i in range(steps - 1):
                logits, cache = S.decode_step(cfg, qp, cache, tok,
                                              jnp.int32(32 + i), h,
                                              quantized=True)
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                toks.append(tok)
            streams[wf] = np.stack([np.asarray(t) for t in toks], axis=1)
    finally:
        if old is None:
            os.environ.pop("QUTLASS_TPU_PIN_NORMS", None)
        else:
            os.environ["QUTLASS_TPU_PIN_NORMS"] = old

    a, b = streams["int8"], streams["fp4"]
    eq = a == b                                     # [N, S]
    # prefix length = index of first mismatch (S if none)
    first_diff = np.where(eq.all(axis=1), steps, (~eq).argmax(axis=1))
    prefix = float(first_diff.mean() / steps)
    return {"backend": jax.default_backend(), "pin": pin,
            "prompts": prompts, "steps": steps,
            "prefix_agreement": round(prefix, 4),
            "exact_rows": round(float(eq.all(axis=1).mean()), 4),
            "gate": threshold, "pass": prefix >= threshold}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", type=int, default=64)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--threshold", type=float, default=0.95)
    ap.add_argument("--pin", type=int, default=1, choices=[0, 1])
    args = ap.parse_args()
    from qutlass_tpu.profiling import setup_compile_cache
    setup_compile_cache()
    out = run_gate(args.prompts, args.steps, args.pin, args.threshold)
    print(json.dumps(out), flush=True)
    if not out["pass"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
