"""DNA sequence utilities: alphabets, complement, rank transform helpers.

Counterpart of the used subset of rust-bio's `alphabets::dna` plus the
alphabet constants at reference src/index/mod.rs:16-28.
"""

from __future__ import annotations

import numpy as np

DNA_UPPERCASE_ALPHABET = b"ACGT"
DNA_UPPERCASE_X_ALPHABET = b"ACGTX"
DNA_PURINE = b"AG"
DNA_PYRIMIDINE = b"CT"
DNA_KETONE = b"GT"
DNA_AMINO = b"AC"
DNA_STRONG = b"CG"
DNA_WEAK = b"AT"
DNA_NOT_A = b"CGT"
DNA_NOT_C = b"AGT"
DNA_NOT_G = b"ACT"
DNA_NOT_T = b"ACG"

IUPAC_AMBIGUOUS = {
    ord("U"): b"T",
    ord("R"): DNA_PURINE,
    ord("Y"): DNA_PYRIMIDINE,
    ord("K"): DNA_KETONE,
    ord("M"): DNA_AMINO,
    ord("S"): DNA_STRONG,
    ord("W"): DNA_WEAK,
    ord("B"): DNA_NOT_A,
    ord("D"): DNA_NOT_C,
    ord("H"): DNA_NOT_G,
    ord("V"): DNA_NOT_T,
    ord("N"): DNA_UPPERCASE_ALPHABET,
}

# IUPAC alphabet as accepted by rust-bio's dna::iupac_alphabet() (upper+lower)
IUPAC_ALPHABET = frozenset(b"ACGTURYSWKMBDHVNacgturyswkmbdhvn")

# Complement table matching rust-bio dna::complement: A<->T, C<->G, preserves
# case, maps IUPAC codes to their complements, everything else unchanged.
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in [
    (b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A"), (b"U", b"A"),
    (b"R", b"Y"), (b"Y", b"R"), (b"S", b"S"), (b"W", b"W"), (b"K", b"M"),
    (b"M", b"K"), (b"B", b"V"), (b"V", b"B"), (b"D", b"H"), (b"H", b"D"),
    (b"N", b"N"),
]:
    _COMP[_a[0]] = _b[0]
    _COMP[_a[0] + 32] = _b[0] + 32  # lowercase

COMPLEMENT_TABLE = _COMP


def complement(base: int) -> int:
    """Complement a single base (ASCII code)."""
    return int(_COMP[base])


def revcomp(seq) -> bytes:
    """Reverse complement of an ASCII byte sequence."""
    arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    return _COMP[arr][::-1].tobytes()


def revcomp_arr(arr: np.ndarray) -> np.ndarray:
    return _COMP[arr][::-1]


class RankTransform:
    """Dense rank transform over a sorted alphabet (rust-bio RankTransform).

    Ranks are assigned in ascending ASCII order of the alphabet symbols.
    For the index alphabet "$ACGTX": $=0 A=1 C=2 G=3 T=4 X=5.
    """

    def __init__(self, alphabet: bytes):
        self.symbols = bytes(sorted(set(alphabet)))
        self.ranks = {s: i for i, s in enumerate(self.symbols)}
        self._table = np.full(256, 255, dtype=np.uint8)
        for s, r in self.ranks.items():
            self._table[s] = r

    def __len__(self):
        return len(self.symbols)

    def get(self, symbol: int) -> int:
        return self.ranks[symbol]

    def contains(self, symbol: int) -> bool:
        return symbol in self.ranks

    def transform(self, text) -> np.ndarray:
        arr = np.frombuffer(bytes(text), dtype=np.uint8)
        out = self._table[arr]
        if np.any(out == 255):
            bad = arr[out == 255][0]
            raise ValueError(f"symbol {bad!r} not in alphabet")
        return out

    def back_transform(self) -> np.ndarray:
        """rank -> ASCII symbol array (reference fmd_index.rs:49-54)."""
        return np.frombuffer(self.symbols, dtype=np.uint8).copy()


# Rank codes for the standard index alphabet "$ACGTX"
RANK_SENTINEL = 0
RANK_A, RANK_C, RANK_G, RANK_T, RANK_X = 1, 2, 3, 4, 5

# base char (ACGT) <-> 0..3 code helpers used by scoring LUTs
_ACGT = np.frombuffer(DNA_UPPERCASE_ALPHABET, dtype=np.uint8)
BASE_TO_CODE = np.full(256, 4, dtype=np.uint8)  # 4 = not ACGT
for _i, _c in enumerate(_ACGT):
    BASE_TO_CODE[_c] = _i
CODE_TO_BASE = _ACGT
