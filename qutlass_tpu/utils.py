"""Layout helpers.

The block-scale layout here is plain row-major ``[rows, K/gs]`` — the
Blackwell 128x4 swizzle that the reference applies via ``to_blocked``
(qutlass/utils.py:160-193) is not needed.  ``to_blocked`` is kept for API parity and is a flatten (identity
layout); ``to_blocked_swizzled`` produces the actual cuBLAS layout for
interop/export.
"""
from __future__ import annotations

import jax.numpy as jnp


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def get_padded_shape_mx(a) -> tuple[int, int]:
    """Padded e8m0 scale-buffer shape for an MX quantize of ``a``.

    Mirrors reference utils.py:140-147 (rows to x128, cols = K/32 to x4)
    so scale tensors are interchangeable shape-wise with the reference.
    """
    rows = a.size // a.shape[-1]
    cols = a.shape[-1] // 32
    return round_up(rows, 128), round_up(cols, 4)


def get_padded_shape_nv(a) -> tuple[int, int]:
    rows = a.size // a.shape[-1]
    cols = a.shape[-1] // 16
    return round_up(rows, 128), round_up(cols, 4)


def to_blocked(scales: jnp.ndarray, use_triton_kernel: bool = False) -> jnp.ndarray:
    """Scale layout transform — identity modulo flattening.

    The GEMMs consume row-major scales directly, so this is a
    flatten of the (already padded) scale matrix.  The signature matches
    reference utils.py:160 (``use_triton_kernel`` is accepted and
    ignored).
    """
    del use_triton_kernel
    return scales.reshape(-1)


def from_blocked(flat: jnp.ndarray, k: int, gs: int) -> jnp.ndarray:
    """Inverse of :func:`to_blocked`: recover the padded 2-D scale matrix."""
    cols = round_up(k // gs, 4)
    return flat.reshape(-1, cols)


def to_blocked_swizzled(scales: jnp.ndarray) -> jnp.ndarray:
    """The cuBLAS 128x4 block-swizzle layout (for export to GPU stacks).

    Matches reference utils.py:160-193 on a padded [H, W] input.
    """
    rows, cols = scales.shape
    assert rows % 128 == 0 and cols % 4 == 0, "pad first"
    nr, nc = rows // 128, cols // 4
    b = scales.reshape(nr, 128, nc, 4).transpose(0, 2, 1, 3)
    return b.reshape(-1, 4, 32, 4).transpose(0, 2, 1, 3).reshape(-1)


def pad_to_block(x: jnp.ndarray, dims, blocksize: int) -> jnp.ndarray:
    """Zero-pad ``dims`` of ``x`` up to a multiple of ``blocksize``."""
    pads = [(0, 0)] * x.ndim
    for d in dims:
        pads[d] = (0, round_up(x.shape[d], blocksize) - x.shape[d])
    if all(p == (0, 0) for p in pads):
        return x
    return jnp.pad(x, pads)


def hadamard_matrix(n: int, dtype=jnp.bfloat16) -> jnp.ndarray:
    """Normalized Sylvester-Hadamard rotation ``H_n / sqrt(n)``.

    The reference loads rotation matrices at runtime and its tests build
    them with ``scipy.linalg.hadamard(n) * n**-0.5`` (reference
    tests/mxfp4_test.py:39-42); supported sizes are powers of two in
    {16, 32, 64, 128} (README.md:59-73).  Orthonormal, so the rotation
    is a distribution-flattening isometry.
    """
    assert n >= 1 and (n & (n - 1)) == 0, "Hadamard size must be a power of 2"
    import numpy as np
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return jnp.asarray(h * n ** -0.5, dtype)


def dct_matrix(n: int, dtype=jnp.bfloat16) -> jnp.ndarray:
    """Orthonormal DCT-II rotation matrix (reference README.md:66 option).

    Row ``i``, column ``j``: ``c_i * cos(pi * (2j + 1) * i / (2n))`` with
    ``c_0 = sqrt(1/n)``, ``c_i = sqrt(2/n)`` — the same matrix
    ``scipy.fft.dct(eye(n), norm="ortho")`` produces.
    """
    import numpy as np
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * j + 1) * i / (2 * n))
    m[0] *= np.sqrt(1.0 / n)
    m[1:] *= np.sqrt(2.0 / n)
    return jnp.asarray(m, dtype)


def identity_matrix(n: int, dtype=jnp.bfloat16) -> jnp.ndarray:
    """Identity "rotation" (quantize without rotating; README.md:66)."""
    return jnp.eye(n, dtype=dtype)


def largest_divisor_multiple(n: int, unit: int, cap: int) -> int:
    """Largest divisor of ``n`` that is a multiple of ``unit`` and <= cap,
    FLOORED at ``unit``: when cap < unit the result is ``unit`` itself
    (callers like tuning.quantize_int8_tiles' shrink loop rely on this
    floor as their can't-shrink-further signal)."""
    assert n % unit == 0
    best = unit
    m = n // unit
    for d in range(1, m + 1):
        if m % d == 0 and d * unit <= cap:
            best = d * unit
    return best


def block_diag_128(h: jnp.ndarray) -> jnp.ndarray:
    """Lift an [r, r] rotation (r dividing 128) to the 128x128
    block-diagonal bf16 operand kron(I, h): one full-width tensor-core
    product rotates 128 columns at once."""
    reps = 128 // h.shape[-1]
    hb = h.astype(jnp.bfloat16)
    if reps == 1:
        return hb
    return jnp.kron(jnp.eye(reps, dtype=jnp.bfloat16), hb)
