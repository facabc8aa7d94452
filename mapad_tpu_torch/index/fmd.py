"""Host-side FMD-index runtime (numpy).

Counterpart of reference src/map/fmd_index.rs.  This is the exact-semantics
host implementation used by the index builder, the oracle search, suffix-array
LF-walks and the tests; the batched device implementation in
mapad_tpu.ops.fm mirrors its numerics.

Layout notes (designed for later HBM residency):
- BWT as a flat uint8 array of symbol ranks over "$ACGTX" ($=0 A=1 .. X=5).
- Occ as exclusive-prefix checkpoints every `occ_k` positions:
  cp[b, c] = number of occurrences of c in bwt[0 : b*occ_k).
  occ(r, c) = cp[r // occ_k, c] + count(bwt[blk_start : r+1] == c).
- The two sentinel positions are cached separately (fmd_index.rs:138-151),
  so occ('$') never touches the tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.seq import RankTransform, COMPLEMENT_TABLE


class BiInterval(NamedTuple):
    """Bidirectional suffix-array interval (fmd_index.rs:184-219)."""

    lower: int
    lower_rev: int
    size: int

    def swapped(self) -> "BiInterval":
        return BiInterval(self.lower_rev, self.lower, self.size)

    def range_fwd(self) -> range:
        return range(self.lower, self.lower + self.size)


# symbols a whole-BWT scan takes at once: its temporaries stay ~0.5 GB
# however long the text (np.bincount widens its input to int64)
SCAN_CHUNK = 1 << 26


def symbol_positions(bwt: np.ndarray, c: int) -> np.ndarray:
    """Positions of rank c in the BWT, by chunks (int64)."""
    return np.concatenate(
        [np.flatnonzero(bwt[i : i + SCAN_CHUNK] == c) + i
         for i in range(0, len(bwt), SCAN_CHUNK)] or [np.zeros(0, np.int64)]
    ).astype(np.int64)


def compute_less(bwt: np.ndarray, alphabet_size: int) -> np.ndarray:
    """C table: less[c] = number of text symbols strictly smaller than c."""
    counts = np.zeros(alphabet_size, dtype=np.int64)
    for i in range(0, len(bwt), SCAN_CHUNK):
        counts = counts + np.bincount(bwt[i : i + SCAN_CHUNK],
                                      minlength=alphabet_size)
    less = np.zeros(alphabet_size + 1, dtype=np.int64)
    less[1:] = np.cumsum(counts)
    return less[:-1].copy()


def compute_occ_checkpoints(
    bwt: np.ndarray, occ_k: int, alphabet_size: int
) -> np.ndarray:
    """Exclusive-prefix checkpoints: cp[b, c] = #c in bwt[0 : b*occ_k)."""
    n = len(bwt)
    nb = (n + occ_k - 1) // occ_k
    cp = np.zeros((nb + 1, alphabet_size), dtype=np.int64)
    chunk_blocks = 1 << 18
    for b0 in range(0, nb, chunk_blocks):
        b1 = min(b0 + chunk_blocks, nb)
        seg = bwt[b0 * occ_k : b1 * occ_k].astype(np.int64)
        blk = np.arange(len(seg), dtype=np.int64) // occ_k
        counts = np.bincount(
            blk * alphabet_size + seg, minlength=(b1 - b0) * alphabet_size
        )
        cp[b0 + 1 : b1 + 1] = counts.reshape(b1 - b0, alphabet_size)
    np.cumsum(cp, axis=0, out=cp)
    return cp


class FmdIndex:
    """Bidirectional FMD-index over ranks (Li 2012)."""

    def __init__(
        self,
        bwt: np.ndarray,
        less: np.ndarray,
        occ_cp: np.ndarray,
        occ_k: int,
        rank_transform: RankTransform,
        sentinels: "np.ndarray | list | None" = None,
    ):
        self.bwt = np.asarray(bwt, dtype=np.uint8)
        self.less = np.asarray(less, dtype=np.int64)
        self.occ_cp = np.asarray(occ_cp)
        self.occ_k = int(occ_k)
        self.rank_transform = rank_transform
        self.back_transform = rank_transform.back_transform()
        if sentinels is None:
            # full-BWT scan: fine for in-memory construction, but a
            # genome-scale mmapped load would fault in the whole multi-GB
            # array (measured 375 s at hg19 scale) -- the index bundle
            # stores the two positions in meta.json instead
            sentinels = symbol_positions(self.bwt, 0)
        sentinels = np.asarray(sentinels, dtype=np.int64)
        self.sentinel_occ = np.zeros(2, dtype=np.int64)
        self.sentinel_occ[: min(2, len(sentinels))] = sentinels[:2]

    def __len__(self):
        return len(self.bwt)

    # --- rank / occ queries ---

    def occ(self, r: int, c: int) -> int:
        """Occurrences of rank c in bwt[0..=r]."""
        b = r // self.occ_k
        start = b * self.occ_k
        return int(self.occ_cp[b, c]) + int(
            np.count_nonzero(self.bwt[start : r + 1] == c)
        )

    def _sentinel_occ_count(self, pos: int) -> int:
        s0, s1 = int(self.sentinel_occ[0]), int(self.sentinel_occ[1])
        return (1 if pos >= s0 else 0) + (1 if pos >= s1 else 0)

    # --- interval operations ---

    def init_interval(self) -> BiInterval:
        return BiInterval(0, 0, len(self.bwt))

    def extend_all(self, interval: BiInterval):
        """One backward-extension sweep over the 4-letter DNA alphabet.

        Yields (rank, BiInterval) for ranks 4,3,2,1 (T,G,C,A) sharing
        cumulative occ state; exact port of FmdExtIterator
        (fmd_index.rs:108-182).
        """
        lower, lower_rev, size = interval
        o = 0 if lower == 0 else self._sentinel_occ_count(lower - 1)
        s = self._sentinel_occ_count(lower + size - 1) - o
        l = lower_rev
        out = []
        for c in (4, 3, 2, 1):
            l += s
            o = 0 if lower == 0 else self.occ(lower - 1, c)
            s = self.occ(lower + size - 1, c) - o
            out.append((c, BiInterval(int(self.less[c]) + o, l, s)))
        return out

    def backward_ext(self, interval: BiInterval, a: int) -> BiInterval:
        """Backward extension by a plain (non-transformed) symbol."""
        if not self.rank_transform.contains(a):
            return BiInterval(0, 0, 0)
        target = self.rank_transform.get(a)
        for c, iv in self.extend_all(interval):
            if c == target:
                return iv
        return BiInterval(0, 0, 0)

    def forward_ext(self, interval: BiInterval, a: int) -> BiInterval:
        comp = int(COMPLEMENT_TABLE[a])
        return self.backward_ext(interval.swapped(), comp).swapped()

    def get_rev(self, c: int) -> int:
        """Rank -> plain symbol."""
        return int(self.back_transform[c])
