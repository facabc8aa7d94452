"""Exact float32 arithmetic helpers.

The reference mapper computes all alignment scores in IEEE f32 with specific
operation ordering (including FMA via Rust's `f32::mul_add` and `f32::powi`
via LLVM's binary exponentiation).  Scores are observable in the output (AS
tag, MAPQ) and the reference test goldens are tight (1e-6), so we reproduce
the same operation order here, vectorized with numpy.

`mul_add(a, b, c)` emulates a fused multiply-add on f32 operands by computing
`a*b + c` in float64 (the product of two f32 is exact in f64) and rounding
once to f32.  This matches a hardware FMA except in double-rounding corner
cases that are far below the 1e-6 golden tolerance.

`powi(base, n)` reproduces compiler-rt's `__powisf2` binary exponentiation so
that the sequence of f32 roundings matches Rust's `f32::powi`.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
F32_EPSILON = np.float32(1.1920929e-07)  # f32::EPSILON
F32_MIN = np.float32(-3.4028235e38)  # f32::MIN


def mul_add(a, b, c):
    """f32 fused multiply-add: round_f32(a * b + c). Elementwise on arrays."""
    out = (
        np.asarray(a, dtype=np.float64) * np.asarray(b, dtype=np.float64)
        + np.asarray(c, dtype=np.float64)
    )
    return out.astype(np.float32) if out.ndim else np.float32(out)


def powi(base, n):
    """f32 integer power via binary exponentiation (matches __powisf2).

    `base` is a scalar or array of f32; `n` is a non-negative integer scalar
    or integer array (broadcastable against base).
    """
    base = np.asarray(base, dtype=np.float32)
    n = np.asarray(n)
    if n.ndim == 0 and base.ndim == 0:
        b = int(n)
        a = np.float32(base)
        r = np.float32(1.0)
        if b == 0:
            return r
        while True:
            if b & 1:
                r = np.float32(r * a)
            b //= 2
            if b == 0:
                break
            a = np.float32(a * a)
        return r
    if base.ndim == 0 and n.ndim > 0 and n.size:
        # scalar base, array exponents: all values come from a tiny table
        # of per-exponent scalar results (each k uses its own __powisf2
        # multiplication tree, identical to the elementwise path)
        kmax = int(n.max())
        if 0 <= int(n.min()) and kmax <= 4096:
            table = np.empty(kmax + 1, dtype=np.float32)
            for k in range(kmax + 1):
                table[k] = powi(base, k)
            return table[np.asarray(n, dtype=np.int64)]
    # Vectorized: same multiplication tree per element
    base_b, n_b = np.broadcast_arrays(base, n)
    r = np.ones(base_b.shape, dtype=np.float32)
    a = base_b.astype(np.float32).copy()
    rem = n_b.astype(np.int64).copy()
    # Guard: all exponents >= 0 here (model uses i+1 >= 1)
    while np.any(rem > 0):
        odd = (rem & 1) == 1
        r = np.where(odd, np.float32(r * a), r)
        rem >>= 1
        more = rem > 0
        if not np.any(more):
            break
        a = np.where(more, np.float32(a * a), a)
    return r
