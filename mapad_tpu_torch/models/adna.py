"""Sequence difference models (aDNA damage scoring).

Counterpart of reference src/map/sequence_difference_models.rs.  Scores are
log2-probabilities in IEEE f32; operation order matches the reference exactly
(see mapad_tpu.utils.f32) because scores surface in output (AS tag, MAPQ) and
the reference test goldens are 1e-6-tight.

All models expose both a scalar `get()` (parity/tests) and vectorized LUT
builders used by the batched device pipeline:
  score_lut(pattern, quals)  -> (L, 4) f32: score of ref base b vs read, minus
                                 optimal penalty (the in-search quantity)
  optimal_penalties(pattern, quals) -> (L,) f32
"""

from __future__ import annotations

import logging

import numpy as np

from ..utils.f32 import F32, F32_EPSILON, F32_MIN, mul_add, powi
from ..utils.seq import DNA_UPPERCASE_ALPHABET

logger = logging.getLogger(__name__)

MAX_ENCODED_BASE_QUALITY = 255

_A, _C, _G, _T = (DNA_UPPERCASE_ALPHABET[i] for i in range(4))


class SequenceDifferenceModel:
    """Base: models yield non-positive log2-probability scores.

    Mirrors the trait at reference sequence_difference_models.rs:14-62.
    """

    def get(self, i: int, read_length: int, from_: int, to: int, base_quality: int) -> np.float32:
        raise NotImplementedError

    def get_representative_mismatch_penalty(self) -> np.float32:
        read_length = 80
        return np.float32(
            self.get(read_length // 2, read_length, _T, _A, MAX_ENCODED_BASE_QUALITY)
            - self.get(read_length // 2, read_length, _T, _T, MAX_ENCODED_BASE_QUALITY)
        )

    def get_min_penalty(
        self, i: int, read_length: int, to: int, base_quality: int, only_mismatches: bool
    ) -> np.float32:
        """Best (max) score at this position over candidate reference bases."""
        if not only_mismatches and to not in DNA_UPPERCASE_ALPHABET:
            return np.float32(0.0)
        best = F32_MIN
        for base in DNA_UPPERCASE_ALPHABET:
            if only_mismatches and base == to:
                continue
            best = np.maximum(best, self.get(i, read_length, base, to, base_quality))
        return np.float32(best)

    def find_alignment_start(self, pattern_length: int) -> int:
        return pattern_length // 2

    # --- Vectorized builders (default path: loop over scalar get) ---

    def get_vec(self, i, read_length, from_, to, base_quality) -> np.ndarray:
        """Elementwise vectorized `get` over equally-shaped integer arrays."""
        i = np.atleast_1d(i)
        read_length = np.broadcast_to(np.atleast_1d(read_length), i.shape)
        from_ = np.broadcast_to(np.atleast_1d(from_), i.shape)
        to = np.broadcast_to(np.atleast_1d(to), i.shape)
        base_quality = np.broadcast_to(np.atleast_1d(base_quality), i.shape)
        out = np.empty(i.shape, dtype=np.float32)
        for k in range(i.size):
            out.flat[k] = self.get(
                int(i.flat[k]), int(read_length.flat[k]), int(from_.flat[k]),
                int(to.flat[k]), int(base_quality.flat[k]),
            )
        return out

    def raw_grid(self, i, read_length, to, base_quality) -> np.ndarray:
        """(..., 4) raw scores with from_ sweeping ACGT, to fixed per cell.

        Generic fallback: one get_vec per candidate base.  Subclasses with
        separable structure (SimpleAncientDnaModel) override this to compute
        the shared per-position terms once."""
        return np.stack(
            [
                self.get_vec(
                    i, read_length,
                    np.full(np.shape(to), b, dtype=np.uint8), to, base_quality,
                )
                for b in DNA_UPPERCASE_ALPHABET
            ],
            axis=-1,
        )

    def score_lut(self, pattern: np.ndarray, quals: np.ndarray) -> np.ndarray:
        """(L, 4) f32: get(i, L, base_b, pattern[i], quals[i]) - optimal_penalty[i].

        The in-search mismatch/match candidate scores (reference
        mapping.rs:1137-1146, 1175-1184 subtract the per-base optimum).
        """
        L = len(pattern)
        idx = np.arange(L)
        opt = self.optimal_penalties(pattern, quals)
        cols = []
        for b in DNA_UPPERCASE_ALPHABET:
            raw = self.get_vec(idx, L, np.full(L, b), pattern, quals)
            cols.append(np.float32(raw - opt))
        return np.stack(cols, axis=1)

    def optimal_penalties(self, pattern: np.ndarray, quals: np.ndarray) -> np.ndarray:
        """(L,) f32 per-base optimal penalty (reference mapping.rs:572-588)."""
        L = len(pattern)
        return np.asarray(
            [
                self.get_min_penalty(i, L, int(pattern[i]), int(quals[i]), False)
                for i in range(L)
            ],
            dtype=np.float32,
        )

    def min_penalties_mm_only(self, pattern: np.ndarray, quals: np.ndarray) -> np.ndarray:
        """(L,) f32 mismatch-only minimum penalties (for the Bi-D array)."""
        L = len(pattern)
        return np.asarray(
            [
                self.get_min_penalty(i, L, int(pattern[i]), int(quals[i]), True)
                for i in range(L)
            ],
            dtype=np.float32,
        )


class SimpleAncientDnaModel(SequenceDifferenceModel):
    """ANFO/r-candy model of deamination, divergence, and sequencing error.

    Parity target: reference sequence_difference_models.rs:104-334.
    library_prep: ("single_stranded", five_prime_overhang, three_prime_overhang)
                  or ("double_stranded", overhang)
    """

    def __init__(
        self,
        library_prep,
        ds_deamination_rate: float,
        ss_deamination_rate: float,
        divergence: float,
        ignore_base_qualities: bool = False,
    ):
        self.library_prep = (library_prep[0], *[np.float32(x) for x in library_prep[1:]])
        self.ds_deamination_rate = np.float32(ds_deamination_rate)
        self.ss_deamination_rate = np.float32(ss_deamination_rate)
        self.divergence = np.float32(divergence)
        self.use_default_base_quality = (
            self.qual2prob(MAX_ENCODED_BASE_QUALITY) if ignore_base_qualities else None
        )
        if self.use_default_base_quality is None:
            self.cache = np.asarray(
                [self.qual2prob(q) for q in range(MAX_ENCODED_BASE_QUALITY + 1)],
                dtype=np.float32,
            )
        else:
            self.cache = np.zeros(0, dtype=np.float32)
        logger.info("%s", self)

    @staticmethod
    def qual2prob(encoded_base_quality: int) -> np.float32:
        # 10f32.powf(-q / 10.0) / 3.0
        e = np.float32(-np.float32(encoded_base_quality) / np.float32(10.0))
        return np.float32(np.power(np.float32(10.0), e) / np.float32(3.0))

    def find_alignment_start(self, pattern_length: int) -> int:
        # Production search is pure backward (3'->5') extension
        # (reference sequence_difference_models.rs:209-212)
        return pattern_length

    def _seq_err(self, base_quality):
        if self.use_default_base_quality is not None:
            return np.broadcast_to(self.use_default_base_quality, np.shape(base_quality))
        return self.cache[np.asarray(base_quality)]

    def get(self, i, read_length, from_, to, base_quality):
        return self.get_vec(
            np.asarray([i]), np.asarray([read_length]), np.asarray([from_]),
            np.asarray([to]), np.asarray([base_quality]),
        )[0]

    def get_vec(self, i, read_length, from_, to, base_quality):
        i = np.asarray(i, dtype=np.int64)
        read_length = np.broadcast_to(np.asarray(read_length, dtype=np.int64), i.shape)
        from_ = np.broadcast_to(np.asarray(from_), i.shape)
        to = np.broadcast_to(np.asarray(to), i.shape)
        base_quality = np.broadcast_to(np.asarray(base_quality), i.shape)

        fp_dist = i
        tp_dist = read_length - 1 - i

        kind = self.library_prep[0]
        if kind == "single_stranded":
            five_prime_overhang = powi(self.library_prep[1], fp_dist + 1)
            three_prime_overhang = powi(self.library_prep[2], tp_dist + 1)
            p_fwd = mul_add(
                five_prime_overhang,
                -three_prime_overhang,
                np.float32(five_prime_overhang + three_prime_overhang),
            )
            p_rev = np.zeros(i.shape, dtype=np.float32)
        else:
            overhang = self.library_prep[1]
            p_fwd = powi(overhang, fp_dist + 1)
            p_rev = powi(overhang, tp_dist + 1)

        c_to_t = mul_add(
            self.ss_deamination_rate, p_fwd,
            np.float32(self.ds_deamination_rate * (np.float32(1.0) - p_fwd)),
        )
        g_to_a = mul_add(
            self.ss_deamination_rate, p_rev,
            np.float32(self.ds_deamination_rate * (np.float32(1.0) - p_rev)),
        )

        sequencing_error = np.asarray(self._seq_err(base_quality), dtype=np.float32)
        independent_error = mul_add(
            sequencing_error, -self.divergence,
            np.float32(sequencing_error + self.divergence),
        )

        ind4 = np.float32(np.float32(4.0) * independent_error)
        match_p = mul_add(np.float32(3.0), -independent_error, np.float32(1.0))
        cc = mul_add(ind4, c_to_t, np.float32(match_p - c_to_t))
        ct = mul_add(ind4, -c_to_t, np.float32(independent_error + c_to_t))
        ga = mul_add(ind4, -g_to_a, np.float32(independent_error + g_to_a))
        gg = mul_add(ind4, g_to_a, np.float32(match_p - g_to_a))

        val = independent_error.copy()
        val = np.where((from_ == _A) & (to == _A), match_p, val)
        val = np.where((from_ == _T) & (to == _T), match_p, val)
        val = np.where((from_ == _C) & (to == _C), cc, val)
        val = np.where((from_ == _C) & (to == _T), ct, val)
        val = np.where((from_ == _G) & (to == _A), ga, val)
        val = np.where((from_ == _G) & (to == _G), gg, val)

        return np.float32(np.log2(np.maximum(val, F32_EPSILON)))

    def raw_grid(self, i, read_length, to, base_quality):
        """(..., 4) raw scores for from_ in ACGT in ONE pass.

        Bit-identical to the generic stack-of-get_vec (same intermediate
        values, same np.log2 application) but computes the shared damage
        terms (overhang powers, deamination, sequencing error) once instead
        of once per candidate base -- the LUT prep for an 8192-read chunk
        dropped ~4x on the bench host."""
        i = np.asarray(i, dtype=np.int64)
        read_length = np.broadcast_to(np.asarray(read_length, dtype=np.int64), i.shape)
        to = np.broadcast_to(np.asarray(to), i.shape)
        base_quality = np.broadcast_to(np.asarray(base_quality), i.shape)

        fp_dist = i
        tp_dist = read_length - 1 - i

        kind = self.library_prep[0]
        if kind == "single_stranded":
            five_prime_overhang = powi(self.library_prep[1], fp_dist + 1)
            three_prime_overhang = powi(self.library_prep[2], tp_dist + 1)
            p_fwd = mul_add(
                five_prime_overhang,
                -three_prime_overhang,
                np.float32(five_prime_overhang + three_prime_overhang),
            )
            p_rev = np.zeros(i.shape, dtype=np.float32)
        else:
            overhang = self.library_prep[1]
            p_fwd = powi(overhang, fp_dist + 1)
            p_rev = powi(overhang, tp_dist + 1)

        c_to_t = mul_add(
            self.ss_deamination_rate, p_fwd,
            np.float32(self.ds_deamination_rate * (np.float32(1.0) - p_fwd)),
        )
        g_to_a = mul_add(
            self.ss_deamination_rate, p_rev,
            np.float32(self.ds_deamination_rate * (np.float32(1.0) - p_rev)),
        )

        sequencing_error = np.asarray(self._seq_err(base_quality), dtype=np.float32)
        independent_error = mul_add(
            sequencing_error, -self.divergence,
            np.float32(sequencing_error + self.divergence),
        )

        ind4 = np.float32(np.float32(4.0) * independent_error)
        match_p = mul_add(np.float32(3.0), -independent_error, np.float32(1.0))
        cc = mul_add(ind4, c_to_t, np.float32(match_p - c_to_t))
        ct = mul_add(ind4, -c_to_t, np.float32(independent_error + c_to_t))
        ga = mul_add(ind4, -g_to_a, np.float32(independent_error + g_to_a))
        gg = mul_add(ind4, g_to_a, np.float32(match_p - g_to_a))

        val = np.empty(i.shape + (4,), dtype=np.float32)
        # from_ == A / C / G / T columns; default independent_error
        val[..., 0] = np.where(to == _A, match_p, independent_error)
        val[..., 1] = np.where(
            to == _C, cc, np.where(to == _T, ct, independent_error)
        )
        val[..., 2] = np.where(
            to == _A, ga, np.where(to == _G, gg, independent_error)
        )
        val[..., 3] = np.where(to == _T, match_p, independent_error)
        return np.float32(np.log2(np.maximum(val, F32_EPSILON)))

    # Vectorized min-penalty used by LUT builders (same semantics as scalar)
    def _min_penalty_vec(self, pattern, quals, only_mismatches: bool):
        L = len(pattern)
        idx = np.arange(L)
        pattern = np.asarray(pattern)
        scores = np.stack(
            [
                self.get_vec(idx, L, np.full(L, b), pattern, quals)
                for b in DNA_UPPERCASE_ALPHABET
            ],
            axis=1,
        )  # (L, 4)
        if only_mismatches:
            mask = pattern[:, None] == np.frombuffer(
                DNA_UPPERCASE_ALPHABET, dtype=np.uint8
            )[None, :]
            scores = np.where(mask, F32_MIN, scores)
            return np.max(scores, axis=1)
        out = np.max(scores, axis=1)
        is_acgt = np.isin(pattern, np.frombuffer(DNA_UPPERCASE_ALPHABET, dtype=np.uint8))
        return np.where(is_acgt, out, np.float32(0.0)).astype(np.float32)

    def optimal_penalties(self, pattern, quals):
        return self._min_penalty_vec(pattern, quals, False)

    def min_penalties_mm_only(self, pattern, quals):
        return self._min_penalty_vec(pattern, quals, True)

    def score_lut(self, pattern, quals):
        L = len(pattern)
        idx = np.arange(L)
        pattern = np.asarray(pattern)
        opt = self.optimal_penalties(pattern, quals)
        cols = [
            np.float32(self.get_vec(idx, L, np.full(L, b), pattern, quals) - opt)
            for b in DNA_UPPERCASE_ALPHABET
        ]
        return np.stack(cols, axis=1)

    def __str__(self):
        # Model self-description logged at startup (reference :214-271)
        BASE_QUALITY = 37
        READ_LEN = 50
        lines = [
            f'"Ordinary" mismatch: {self.get_representative_mismatch_penalty():.2f}',
            f"Central C->T / G->A: {self.get(READ_LEN // 2, READ_LEN, _C, _T, BASE_QUALITY):.2f}",
        ]
        five = " ".join(
            f"{self.get(pos, READ_LEN, _C, _T, BASE_QUALITY):.2f}" for pos in range(10)
        )
        lines.append(f"5' C->T: {five} ...")
        if self.library_prep[0] == "single_stranded":
            three = " ".join(
                f"{self.get(pos, READ_LEN, _C, _T, BASE_QUALITY):.2f}"
                for pos in reversed(range(READ_LEN - 10, READ_LEN))
            )
            lines.append(f"3' C->T: {three} ...")
        else:
            three = " ".join(
                f"{self.get(pos, READ_LEN, _G, _A, BASE_QUALITY):.2f}"
                for pos in reversed(range(READ_LEN - 10, READ_LEN))
            )
            lines.append(f"3' G->A: {three} ...")
        return "\n".join(lines)


class VindijaPwm(SequenceDifferenceModel):
    """Simple symmetric C->T PWM (reference :339-394; test/example model)."""

    def __init__(self):
        self.ppm_read_ends_symmetric_ct = np.asarray(
            [0.4, 0.25, 0.1, 0.06, 0.05, 0.04, 0.03], dtype=np.float32
        )
        self.position_probability_ct_default = np.float32(0.02)
        self.observed_substitution_probability_default = np.float32(0.0005)

    def get(self, i, read_length, from_, to, base_quality):
        if from_ == _C:
            im = min(i, read_length - (i + 1))
            if im < len(self.ppm_read_ends_symmetric_ct):
                p_ct = self.ppm_read_ends_symmetric_ct[im]
            else:
                p_ct = self.position_probability_ct_default
            if to == _T:
                p = p_ct
            elif to == _C:
                p = np.float32(np.float32(1.0) - p_ct)
            else:
                p = self.observed_substitution_probability_default
        else:
            if from_ == to:
                p = np.float32(
                    np.float32(1.0) - self.observed_substitution_probability_default
                )
            else:
                p = self.observed_substitution_probability_default
        return np.float32(np.log2(p))


class TestDifferenceModel(SequenceDifferenceModel):
    """Fake model for tests (reference :396-419)."""

    __test__ = False

    def __init__(self, deam_score, mm_score, match_score):
        self.deam_score = np.float32(deam_score)
        self.mm_score = np.float32(mm_score)
        self.match_score = np.float32(match_score)

    def get(self, i, read_length, from_, to, base_quality):
        if from_ == _C and to == _T:
            return self.deam_score
        if from_ == to:
            return self.match_score
        return self.mm_score

    def get_vec(self, i, read_length, from_, to, base_quality):
        i = np.asarray(i)
        from_ = np.broadcast_to(np.asarray(from_), i.shape)
        to = np.broadcast_to(np.asarray(to), i.shape)
        out = np.full(i.shape, self.mm_score, dtype=np.float32)
        out = np.where(from_ == to, self.match_score, out)
        out = np.where((from_ == _C) & (to == _T), self.deam_score, out)
        return out
