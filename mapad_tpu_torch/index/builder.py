"""Index construction: FASTA -> on-disk index bundle.

Counterpart of reference src/index/indexing.rs.  Pipeline (indexing.rs:43-212):
uppercase + IUPAC-validate, replace ambiguous bases (short runs < 20 get a
seeded random base with the original recorded; long runs become 'X'), build
text = ref + '$' + revcomp(ref) + '$', rank-transform over "$ACGTX", suffix
array, BWT, sampled SA (rate 32), C table, Occ checkpoints.

RNG note: ambiguous-base replacement reproduces the reference's exact choices
via a bit-compatible StdRng/ChaCha12 port (utils/rand_compat.py), so indexes
built here are interchangeable with reference-built ones.
"""

from __future__ import annotations

import logging

import numpy as np

from ..errors import ParseError
from ..io.fasta import read_fasta
from ..utils.rand_compat import StdRngCompat
from ..utils.seq import (
    DNA_UPPERCASE_ALPHABET,
    DNA_UPPERCASE_X_ALPHABET,
    IUPAC_ALPHABET,
    IUPAC_AMBIGUOUS,
    RankTransform,
    revcomp,
)
from .fmd import FmdIndex, compute_less, compute_occ_checkpoints
from .runtime import (
    DEFAULT_OCC_K,
    FastaIdPosition,
    FastaIdPositions,
    OriginalSymbols,
    SA_SAMPLING_RATE,
    SampledSuffixArray,
    save_index,
)
from .sais import suffix_array

logger = logging.getLogger(__name__)

MIN_RUN_LEN = 20


def run_apply(ref_seq: bytearray, min_run_len: int, rng) -> dict:
    """Replace ambiguous-base runs in place; return {pos: original_symbol}.

    Port of indexing.rs:215-256: short runs are replaced base-by-base with a
    random compatible base (recording originals); runs of length >=
    min_run_len are summarized as 'X'.
    """
    original_symbols: dict[int, int] = {}
    n = len(ref_seq)
    acgt = frozenset(DNA_UPPERCASE_ALPHABET)

    # Vectorized run detection over only the ambiguous positions: the
    # reference's run scan visits every run, but runs of plain ACGT are
    # never modified, so it suffices to split the ambiguous positions into
    # same-symbol runs (genome-scale texts make a per-symbol Python loop
    # impossible).  RNG call order is preserved: calls happen per ambiguous
    # base in text order, exactly as in indexing.rs:215-256.
    arr = np.frombuffer(memoryview(ref_seq), dtype=np.uint8)
    is_amb = ~np.isin(arr, np.frombuffer(DNA_UPPERCASE_ALPHABET, np.uint8))
    amb_pos = np.flatnonzero(is_amb)
    if len(amb_pos) == 0:
        return original_symbols
    # run boundaries: position gap or symbol change
    brk = np.flatnonzero(
        (np.diff(amb_pos) != 1) | (np.diff(arr[amb_pos].astype(np.int16)) != 0)
    )
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [len(amb_pos)]])
    for s, e in zip(starts, ends):
        i, j = int(amb_pos[s]), int(amb_pos[e - 1]) + 1
        run_len = j - i
        if run_len < min_run_len:
            for k in range(i, j):
                base = ref_seq[k]
                choices = IUPAC_AMBIGUOUS[base]
                new = choices[0] if len(choices) == 1 else choices[
                    rng.choose_index(len(choices))
                ]
                assert k not in original_symbols
                original_symbols[k] = base
                ref_seq[k] = new
        else:
            ref_seq[i:j] = b"X" * run_len
    return original_symbols


def bwt_from_sa(text_ranks: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """bwt[i] = text[sa[i] - 1], chunked to avoid genome-scale temporaries."""
    n = len(sa)
    bwt = np.empty(n, dtype=np.uint8)
    step = 1 << 26
    for i in range(0, n, step):
        idx = sa[i : i + step] - 1
        np.add(idx, n, out=idx, where=idx < 0)
        bwt[i : i + step] = text_ranks[idx]
    return bwt


def build_from_sequences(records, occ_k: int = DEFAULT_OCC_K, seed: int = 1234):
    """Build all index structures in memory from (name, seq) pairs."""
    rng = StdRngCompat(seed)

    parts = []
    contigs = []
    end = 0
    for name, seq in records:
        seq = bytes(seq).upper()
        end += len(seq)
        contigs.append(FastaIdPosition(end - len(seq), end - 1, name))
        parts.append(seq)
    ref_seq = bytearray(b"".join(parts))

    logger.info("Validate reference sequence")
    iupac_ok = np.zeros(256, dtype=bool)
    iupac_ok[list(IUPAC_ALPHABET)] = True
    if not bool(
        np.all(iupac_ok[np.frombuffer(memoryview(ref_seq), dtype=np.uint8)])
    ):
        raise ParseError("Found non-IUPAC symbol in reference sequence")

    logger.info("Modify reference sequence")
    original_symbols = run_apply(ref_seq, MIN_RUN_LEN, rng)

    logger.info("Add reverse complement and sentinels to reference")
    rc = revcomp(ref_seq)
    text = bytes(ref_seq) + b"$" + rc + b"$"

    logger.info("Compress reference")
    rank_transform = RankTransform(DNA_UPPERCASE_X_ALPHABET + b"$")
    text_ranks = rank_transform.transform(text)

    logger.info("Generate suffix array")
    sa = suffix_array(text_ranks)

    logger.info("Generate BWT")
    bwt = bwt_from_sa(text_ranks, sa)

    alphabet_size = len(rank_transform)
    less = compute_less(bwt, alphabet_size)
    occ_cp = compute_occ_checkpoints(bwt, occ_k, alphabet_size)
    fmd = FmdIndex(bwt, less, occ_cp, occ_k, rank_transform)

    logger.info("Compress suffix array")
    ssa = SampledSuffixArray.sample_from(fmd, sa, SA_SAMPLING_RATE)

    id_pos_map = FastaIdPositions(contigs)
    orig = OriginalSymbols.from_dict(original_symbols)
    return fmd, ssa, id_pos_map, orig


def run(reference_path: str, seed: int = 1234, occ_k: int = DEFAULT_OCC_K,
        mapad_format: bool = False):
    """Entry point: index the FASTA at reference_path (indexing.rs:29-38).

    mapad_format=True additionally writes the reference implementation's
    own on-disk container (6 of its 7 files: .tbw/.tle/.tsa/.tpi/.tos/.trt;
    indexing.rs:111-207.  The .toc occurrence table is not emitted -- its
    layout belongs to the patched rust-bio fork and is re-derived from the
    BWT at load time by this framework's reader, index/mapad_native.py)."""
    logger.info("Read input reference sequence")
    records = [(r.name, r.sequence) for r in read_fasta(reference_path)]
    fmd, ssa, id_pos_map, orig = build_from_sequences(records, occ_k=occ_k, seed=seed)
    logger.info("Save index")
    save_index(reference_path, fmd, ssa, id_pos_map, orig, {"seed": seed})
    if mapad_format:
        from .mapad_native import save_mapad_index

        logger.info("Save mapAD-format index files")
        save_mapad_index(reference_path, fmd, ssa, id_pos_map, orig)


def build_auxiliary_structures(reference: bytes, alphabet: bytes = b"ACGTacgt",
                               occ_k: int = 3):
    """In-memory FMD-index + raw SA for tests (reference src/utils.rs:12-33)."""
    rc = revcomp(reference)
    text = bytes(reference) + b"$" + rc + b"$"
    rank_transform = RankTransform(bytes(alphabet) + b"$")
    text_ranks = rank_transform.transform(text)
    sa = suffix_array(text_ranks)
    bwt = text_ranks[(sa - 1) % len(text_ranks)].astype(np.uint8)
    alphabet_size = len(rank_transform)
    less = compute_less(bwt, alphabet_size)
    occ_cp = compute_occ_checkpoints(bwt, occ_k, alphabet_size)
    fmd = FmdIndex(bwt, less, occ_cp, occ_k, rank_transform)
    return fmd, sa
