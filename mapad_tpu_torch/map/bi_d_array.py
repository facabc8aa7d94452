"""Bi-directional D-array: lookahead lower bounds for search pruning.

Exact host port of reference src/map/bi_d_array.rs.  For each read half
(split at find_alignment_start) walks the FMD-index extending perfectly; at
each extension failure records the most conservative penalty.  Computed for
MAX_OFFSET=15 start offsets and min-reduced to stay correct under indels.
"""

from __future__ import annotations

import numpy as np

from ..utils.f32 import F32_MIN

MAX_OFFSET = 15


class BiDArray:
    def __init__(self, pattern, base_qualities, split, parameters, fmd_index, sdm):
        pattern = np.asarray(pattern, dtype=np.uint8)
        base_qualities = np.asarray(base_qualities, dtype=np.uint8)
        n = len(pattern)
        split = int(split)

        # Per-absolute-read-position penalty elements (bi_d_array.rs:152-189):
        # best mismatch-only penalty minus optimal penalty, floored by the
        # gap-extend penalty where gaps are allowed.
        best_mm_only = sdm.min_penalties_mm_only(pattern, base_qualities)
        optimal = sdm.optimal_penalties(pattern, base_qualities)
        mm_retval = np.float32(best_mm_only - optimal)
        idx = np.arange(n)
        gaps_allowed = np.minimum(idx, n - idx - 1) >= parameters.gap_dist_ends
        self._pen = np.where(
            gaps_allowed,
            np.maximum(mm_retval, parameters.penalty_gap_extend),
            mm_retval,
        ).astype(np.float32)

        d_backwards = self._min_over_offsets(
            pattern[:split], 0, split, "forward", fmd_index
        )
        d_forwards = self._min_over_offsets(
            pattern[split:], split, n - split, "backward", fmd_index
        )
        self.d_composite = np.concatenate([d_backwards, d_forwards]).astype(np.float32)
        self.split = split

    def _compute_part(self, part, part_offset, direction, initial_skip, fmd):
        """One offset walk; yields part_len values (after initial zeros)."""
        z = np.float32(0.0)
        last_mismatch_pos = initial_skip - 1
        interval = fmd.init_interval()
        seq = part if direction == "forward" else part[::-1]
        # The first initial_skip+1 yielded values are 0.0 (truncated to part len)
        values = [np.float32(0.0)] * min(initial_skip + 1, len(part))
        for index in range(initial_skip, len(part)):
            base = int(seq[index])
            if direction == "forward":
                interval = fmd.forward_ext(interval, base)
            else:
                interval = fmd.backward_ext(interval, base)
            if interval.size < 1:
                # Most conservative penalty over scanned window
                best = F32_MIN
                for j in range(last_mismatch_pos + 1, index + 1):
                    if direction == "forward":
                        abs_idx = part_offset + j
                    else:
                        abs_idx = len(self._pen) - 1 - j
                    best = np.maximum(best, self._pen[abs_idx])
                z = np.float32(z + best)
                interval = fmd.init_interval()
                last_mismatch_pos = index
            values.append(z)
        return values[: len(part)]

    def _min_over_offsets(self, part, part_offset, count, direction, fmd):
        if count == 0:
            return np.zeros(0, dtype=np.float32)
        walks = [
            self._compute_part(part, part_offset, direction, offset, fmd)
            for offset in range(MAX_OFFSET)
        ]
        out = np.zeros(count, dtype=np.float32)
        for i in range(count):
            m = np.float32(0.0)
            for w in walks:
                m = np.minimum(m, w[i])
            out[i] = m
        return out

    def get(self, backward_index: int, forward_index: int) -> np.float32:
        """Summed lower bound (bi_d_array.rs:200-224)."""
        n = len(self.d_composite)
        d_rev = (
            self.d_composite[backward_index]
            if 0 <= backward_index < n
            else np.float32(0.0)
        )
        t = n - (1 + forward_index)
        if t < 0:
            d_fwd = np.float32(0.0)
        else:
            ci = t + self.split
            d_fwd = self.d_composite[ci] if ci < n else np.float32(0.0)
        return np.float32(d_rev + d_fwd)
