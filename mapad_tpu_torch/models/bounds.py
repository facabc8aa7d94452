"""Mismatch bounds: search-space cutoffs.

Counterpart of reference src/map/mismatch_bounds.rs.  `reject` prunes search
frames against an absolute per-read-length budget; `reject_iterative` stops
the search once frames are more than one representative mismatch worse than
the best hit found so far.
"""

from __future__ import annotations

import numpy as np

MAX_CACHED_READ_LENGTH = 256
_U64_MASK = (1 << 64) - 1


class MismatchBound:
    def reject(self, value, read_length: int) -> bool:
        raise NotImplementedError

    def reject_iterative(self, value, reference) -> bool:
        raise NotImplementedError

    def remaining_frac_of_repr_mm(self, value, read_length: int) -> np.float32:
        raise NotImplementedError


class Continuous(MismatchBound):
    """score / len^exponent < cutoff (reference :76-120)."""

    def __init__(self, cutoff, exponent, representative_mismatch_penalty):
        self.cutoff = np.float32(cutoff)
        self.exponent = np.float32(exponent)
        self.representative_mismatch_penalty = np.float32(representative_mismatch_penalty)
        self.cache = np.float32(
            np.power(
                np.arange(MAX_CACHED_READ_LENGTH, dtype=np.float32), self.exponent
            )
        )

    def _scale_read_length(self, read_length: int) -> np.float32:
        if read_length < MAX_CACHED_READ_LENGTH:
            return self.cache[read_length]
        return np.float32(np.power(np.float32(read_length), self.exponent))

    def reject(self, value, read_length):
        return bool(
            np.float32(value) / self._scale_read_length(read_length) < self.cutoff
        )

    def reject_iterative(self, value, reference):
        return bool(
            np.float32(value)
            < np.float32(reference) + self.representative_mismatch_penalty
        )

    def remaining_frac_of_repr_mm(self, value, read_length):
        scaled = self._scale_read_length(read_length)
        return np.float32(
            (self.cutoff - np.float32(value) / scaled)
            / (self.representative_mismatch_penalty / scaled)
        )

    def threshold_for_length(self, read_length: int) -> np.float32:
        """Smallest accepted score (device-side vectorized reject uses this)."""
        return np.float32(self.cutoff * self._scale_read_length(read_length))


class Discrete(MismatchBound):
    """BWA-style Poisson allowed-mismatch-count bound (reference :122-261)."""

    MIN_READ_LENGTH = 17

    def __init__(self, poisson_threshold, base_error_rate, representative_mismatch_penalty):
        self.poisson_threshold = np.float32(poisson_threshold)
        self.base_error_rate = np.float32(base_error_rate)
        self.representative_mismatch_penalty = np.float32(representative_mismatch_penalty)
        self.cache = np.asarray(
            [
                self._calculate_max_num_mismatches(idx + self.MIN_READ_LENGTH)
                for idx in range(MAX_CACHED_READ_LENGTH)
            ],
            dtype=np.float32,
        )

    def _calculate_max_num_mismatches(self, read_length: int) -> float:
        # Exact f32 port of reference :217-241 (including u64 wrap of k!)
        lam = np.float32(np.float32(read_length) * self.base_error_rate)
        exp_minus_lambda = np.float32(np.exp(np.float32(-lam)))
        # BWA allows k+1 mismatches, and so does the reference
        last_k = 0
        k_entry, sum_entry = 1, exp_minus_lambda
        lambda_to_the_k = np.float32(1.0)
        k_factorial = 1
        # take_while(1 - sum > threshold).last()
        if not (np.float32(np.float32(1.0) - sum_entry) > self.poisson_threshold):
            return 0.0
        last_k = k_entry
        for k in range(1, read_length + 1):
            lambda_to_the_k = np.float32(lambda_to_the_k * lam)
            k_factorial = (k_factorial * k) & _U64_MASK
            sum_entry = np.float32(
                sum_entry
                + np.float32(
                    np.float32(lambda_to_the_k * exp_minus_lambda)
                    / np.float32(k_factorial)
                )
            )
            k_entry = k + 1
            if not (np.float32(np.float32(1.0) - sum_entry) > self.poisson_threshold):
                break
            last_k = k_entry
        return float(last_k)

    def get(self, read_length: int) -> np.float32:
        if read_length < self.MIN_READ_LENGTH:
            return np.float32(0.0)
        idx = read_length - self.MIN_READ_LENGTH
        if idx < MAX_CACHED_READ_LENGTH:
            return self.cache[idx]
        return np.float32(self._calculate_max_num_mismatches(read_length))

    def reject(self, value, read_length):
        return bool(
            np.float32(value)
            < self.get(read_length) * self.representative_mismatch_penalty
        )

    def reject_iterative(self, value, reference):
        return bool(
            np.float32(value)
            < np.float32(reference) + self.representative_mismatch_penalty
        )

    def remaining_frac_of_repr_mm(self, value, read_length):
        # get(len).mul_add(repr, -value) / repr
        from ..utils.f32 import mul_add

        return np.float32(
            mul_add(
                self.get(read_length),
                self.representative_mismatch_penalty,
                -np.float32(value),
            )
            / self.representative_mismatch_penalty
        )

    def threshold_for_length(self, read_length: int) -> np.float32:
        return np.float32(self.get(read_length) * self.representative_mismatch_penalty)

    def __str__(self):
        # bp -> allowed mismatch table (reference :147-187)
        width = int(np.ceil(np.log10(MAX_CACHED_READ_LENGTH)))
        lines = []
        previous = None
        for read_length in range(self.MIN_READ_LENGTH, MAX_CACHED_READ_LENGTH + 1):
            allowed = float(self.get(read_length))
            if previous is None or abs(allowed - previous) > 1.1920929e-07:
                previous = allowed
                word = "mismatches" if allowed > 1.0 + 1.1920929e-07 else "mismatch"
                lines.append(f"{read_length:>{width}} bp:\t{allowed:g} {word}")
        return "\n".join(lines)


class TestBound(MismatchBound):
    """Fixed-threshold bound for tests (reference :263-281)."""

    __test__ = False

    def __init__(self, threshold, representative_mm_bound):
        self.threshold = np.float32(threshold)
        self.representative_mm_bound = np.float32(representative_mm_bound)
        self.representative_mismatch_penalty = self.representative_mm_bound

    def reject(self, value, read_length):
        return bool(np.float32(value) < self.threshold)

    def reject_iterative(self, value, reference):
        return False

    def remaining_frac_of_repr_mm(self, value, read_length):
        return np.float32(
            (self.threshold - np.float32(value)) / self.representative_mm_bound
        )

    def threshold_for_length(self, read_length: int) -> np.float32:
        return self.threshold
