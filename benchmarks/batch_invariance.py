"""Which ops of a decode step change a row's result with the batch size.

    python benchmarks/batch_invariance.py

On the CPU a row of a batched decode step is computed exactly as it is
alone, so continuous batching reproduces solo generation bitwise.  On a
GPU, libraries may pick another algorithm (another summation order) for
another batch size.  This script runs each op of a Qwen3-8B decode step
(full width, random weights) on one row alone (B=1) and on the same row
repeated eight times (B=8), and prints whether row 0 comes out bitwise
equal, with the largest difference.  Attention is also run in the
candidate formulations that could make it batch-invariant.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import jax
    import jax.numpy as jnp

    from qutlass_tpu.models import QWEN3_8B, init_params, quantize_model_weights
    from qutlass_tpu.models import serving as S
    from qutlass_tpu.models import transformer as T
    from qutlass_tpu.profiling import setup_compile_cache
    from qutlass_tpu.utils import hadamard_matrix

    setup_compile_cache()
    print(f"device: {jax.devices()[0].device_kind}", flush=True)
    cfg = QWEN3_8B
    small = T.ModelConfig(**{**cfg.__dict__, "num_layers": 2})
    h = hadamard_matrix(32)
    params = init_params(small, jax.random.PRNGKey(0))
    qp = quantize_model_weights(small, params, h)
    layer = qp["layers"][0]
    L, d = 2048, cfg.hidden_size
    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    x1 = jax.random.normal(k1, (1, 1, d), jnp.bfloat16)
    kc1 = jax.random.normal(k2, (1, L, cfg.num_kv_heads, cfg.head_dim),
                            jnp.bfloat16)
    vc1 = jax.random.normal(k3, (1, L, cfg.num_kv_heads, cfg.head_dim),
                            jnp.bfloat16)
    q1 = jax.random.normal(k4, (1, 1, cfg.num_heads, cfg.head_dim),
                           jnp.bfloat16)
    pos1 = jnp.asarray([1500], jnp.int32)

    def rep(a, b=8):
        return jnp.concatenate([a] * b, axis=0)

    def attend_precise(qh, kc, vc, pl):
        hp = jax.lax.Precision.HIGHEST
        b, t = qh.shape[:2]
        rep_ = cfg.num_heads // cfg.num_kv_heads
        q5 = qh.reshape(b, t, cfg.num_kv_heads, rep_, cfg.head_dim)
        sc = jnp.einsum("btgrd,bsgd->bgrts", q5.astype(jnp.float32),
                        kc.astype(jnp.float32), precision=hp) * (
                            cfg.head_dim ** -0.5)
        qpos = jnp.broadcast_to(pl[..., None] - t + jnp.arange(t), (b, t))
        mask = jnp.arange(kc.shape[1])[None, None, :] <= qpos[:, :, None]
        sc = jnp.where(mask[:, None, None], sc, -jnp.inf)
        pr = jax.nn.softmax(sc, axis=-1)
        out = jnp.einsum("bgrts,bsgd->btgrd", pr, vc.astype(jnp.float32),
                         precision=hp)
        return out.reshape(b, t, cfg.num_heads, cfg.head_dim)

    def attend_mulsum(qh, kc, vc, pl):
        b, t = qh.shape[:2]
        rep_ = cfg.num_heads // cfg.num_kv_heads
        q5 = qh.reshape(b, t, cfg.num_kv_heads, rep_, cfg.head_dim)
        qf = q5.astype(jnp.float32)[:, 0]                  # [b, g, r, d]
        kf = kc.astype(jnp.float32)                        # [b, s, g, d]
        sc = jnp.sum(qf[:, None] * kf[:, :, :, None, :], axis=-1)  # b s g r
        sc = sc * (cfg.head_dim ** -0.5)
        mask = jnp.arange(kc.shape[1])[None, :] <= (pl[:, None] - 1)
        sc = jnp.where(mask[:, :, None, None], sc, -jnp.inf)
        pr = jax.nn.softmax(sc, axis=1)
        out = jnp.sum(pr[..., None] * vc.astype(jnp.float32)[:, :, :, None, :],
                      axis=1)                              # b g r d
        return out.reshape(b, 1, cfg.num_heads, cfg.head_dim)

    ops = {
        "rms_norm": (lambda x: T._rms_norm(x, layer["input_norm"],
                                           cfg.rms_eps), (x1,)),
        "linear q_proj (W4A4 int8)": (
            lambda x: T._linear(x, layer["q_proj"], h, "quest", True), (x1,)),
        "linear down_proj (W4A4 int8)": (
            lambda x: T._linear(x, layer["down_proj"], h, "quest", True),
            (jax.random.normal(k4, (1, 1, cfg.intermediate_size),
                               jnp.bfloat16),)),
        "attention (einsum, default precision)": (
            lambda q, k, v, p: S._attend(cfg, q, k, v, p),
            (q1, kc1, vc1, pos1)),
        "attention (einsum, HIGHEST)": (attend_precise, (q1, kc1, vc1, pos1)),
        "attention (multiply + sum)": (attend_mulsum, (q1, kc1, vc1, pos1)),
        "lm head (bf16 dot)": (lambda x: S._logits(small, qp, x[:, 0]), (x1,)),
    }
    for name, (fn, args) in ops.items():
        f = jax.jit(fn)
        o1 = np.asarray(f(*args), np.float64)
        o8 = np.asarray(f(*[rep(a) for a in args]), np.float64)
        d = np.abs(o1[0] - o8[0])
        same8 = all(np.array_equal(o8[0], o8[i]) for i in range(8))
        print(f"{name:42s} B=1 vs B=8 row 0: "
              f"{'EQUAL' if d.max() == 0 else 'DIFFER'}  max|diff| "
              f"{d.max():.3e}  rows of B=8 equal to each other: {same8}",
              flush=True)

    # a whole 2-layer decode step
    cache1 = S.init_cache(small, 1, L)
    lg, cache1 = S.prefill(small, qp, jax.random.randint(
        k1, (1, 64), 0, cfg.vocab_size), h, max_len=L, quantized=True)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    cache8 = jax.tree.map(rep, cache1)
    l1, _ = S.decode_step(small, qp, cache1, tok, jnp.asarray([64]), h,
                          quantized=True)
    l8, _ = S.decode_step(small, qp, cache8, rep(tok), rep(jnp.asarray([64])),
                          h, quantized=True)
    d = np.abs(np.asarray(l1[0], np.float64) - np.asarray(l8[0], np.float64))
    print(f"{'decode step, 2 layers':42s} B=1 vs B=8 row 0: "
          f"{'EQUAL' if d.max() == 0 else 'DIFFER'}  max|diff| {d.max():.3e}",
          flush=True)


if __name__ == "__main__":
    main()
