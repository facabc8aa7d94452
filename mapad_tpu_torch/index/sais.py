"""Suffix array construction.

Replaces the used subset of rust-bio's `suffix_array()` (reference
src/index/indexing.rs:163).  Two paths:

- `suffix_array_numpy`: O(n log^2 n) prefix-doubling with numpy lexsort.
  Robust, no native code, fine up to ~1e8 symbols.
- `suffix_array`: dispatches to the native C++ SAIS builder when available
  (large genomes), else the numpy path.

The input is a rank-transformed text (small integer alphabet).  Duplicate
sentinels are allowed; ties resolve by plain lexicographic suffix order,
identical to SAIS on the byte text.
"""

from __future__ import annotations

import numpy as np


def suffix_array_numpy(text: np.ndarray) -> np.ndarray:
    n = len(text)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = np.asarray(text, dtype=np.int64)
    k = 1
    idx = np.argsort(rank, kind="stable")
    while True:
        key1 = rank
        if k < n:
            key2 = np.concatenate([rank[k:], np.full(k, -1, dtype=np.int64)])
        else:
            key2 = np.full(n, -1, dtype=np.int64)
        idx = np.lexsort((key2, key1))
        r1 = key1[idx]
        r2 = key2[idx]
        neq = np.ones(n, dtype=bool)
        neq[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[idx] = np.cumsum(neq) - 1
        rank = new_rank
        if rank[idx[-1]] == n - 1:
            return idx.astype(np.int64)
        k *= 2


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Build the suffix array of a rank-transformed text."""
    try:
        from . import sais_native

        if len(text) >= (1 << 20) and sais_native.available():
            return sais_native.suffix_array(text)
    except ImportError:
        pass
    return suffix_array_numpy(text)
