"""Index runtime: on-disk format, loaders, sampled suffix array, contig map.

Counterpart of reference src/index/mod.rs + versioned_index.rs.  The on-disk
format replaces snap+bincode with mmap-able flat .npy arrays plus a JSON
manifest, versioned with INDEX_VERSION.

Files written for reference prefix NAME (reference writes .tbw/.tle/.toc/
.tpi/.trt/.tsa/.tos — we write a single bundle directory):
  NAME.tpx/meta.json      manifest: version, alphabet, occ_k, sa rate, contigs
  NAME.tpx/bwt.npy        uint8 BWT ranks
  NAME.tpx/less.npy       int64 C table
  NAME.tpx/occ.npy        int64 exclusive-prefix Occ checkpoints
  NAME.tpx/sa_sample.npy  int64 sampled suffix array (rate 32)
  NAME.tpx/sa_extra_keys.npy / sa_extra_vals.npy   sentinel-adjacent rows
  NAME.tpx/orig_pos.npy / orig_sym.npy             OriginalSymbols map
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from ..errors import IndexVersionMismatch, InvalidIndex
from ..utils.seq import RankTransform
from .fmd import FmdIndex, symbol_positions

INDEX_VERSION = 1
SA_SAMPLING_RATE = 32
DEFAULT_OCC_K = 64


@dataclass
class FastaIdPosition:
    start: int
    end: int
    identifier: str


class FastaIdPositions:
    """Contig id <-> global position map (reference index/mod.rs:39-76)."""

    def __init__(self, id_position):
        self.id_position = list(id_position)
        self._starts = np.asarray([c.start for c in self.id_position], dtype=np.int64)
        self._ends = np.asarray([c.end for c in self.id_position], dtype=np.int64)

    def __iter__(self):
        return iter(self.id_position)

    def __len__(self):
        return len(self.id_position)

    def get_reference_identifier(self, position: int, pattern_length: int):
        """-> (tid, relative_pos, name) or None if the read crosses a contig
        boundary (reference :55-75)."""
        for tid, c in enumerate(self.id_position):
            if c.start <= position and position + pattern_length - 1 <= c.end:
                return tid, position - c.start, c.identifier
        return None

    def get_reference_identifier_batch(self, positions, pattern_lengths):
        """Vectorized variant: int32 tids (-1 = boundary overlap) + rel pos."""
        positions = np.asarray(positions, dtype=np.int64)
        pattern_lengths = np.asarray(pattern_lengths, dtype=np.int64)
        tid = np.searchsorted(self._ends, positions, side="left")
        tid = np.clip(tid, 0, len(self._starts) - 1)
        ok = (self._starts[tid] <= positions) & (
            positions + pattern_lengths - 1 <= self._ends[tid]
        )
        rel = positions - self._starts[tid]
        return np.where(ok, tid, -1).astype(np.int32), rel


class OriginalSymbols:
    """Forward-strand position -> original (pre-replacement) base."""

    def __init__(self, positions: np.ndarray, symbols: np.ndarray):
        self.positions = np.asarray(positions, dtype=np.int64)
        self.symbols = np.asarray(symbols, dtype=np.uint8)
        self._n = len(self.positions)
        self._min = int(self.positions[0]) if self._n else 0
        self._max = int(self.positions[-1]) if self._n else -1
        self._map = {
            int(p): int(s) for p, s in zip(self.positions, self.symbols)
        }

    @classmethod
    def from_dict(cls, d: dict):
        if d:
            keys = np.asarray(sorted(d.keys()), dtype=np.int64)
            vals = np.asarray([d[k] for k in sorted(d.keys())], dtype=np.uint8)
        else:
            keys = np.zeros(0, dtype=np.int64)
            vals = np.zeros(0, dtype=np.uint8)
        return cls(keys, vals)

    def get(self, idx: int):
        if self._n == 0 or idx < self._min or idx > self._max:
            return None
        return self._map.get(idx)

    def __len__(self):
        return len(self.positions)


class SampledSuffixArray:
    """Sampled SA with LF-walk lookup (reference index/mod.rs:150-196)."""

    def __init__(self, fmd: FmdIndex, sample: np.ndarray, sampling_rate: int,
                 extra_keys: np.ndarray, extra_vals: np.ndarray):
        self.fmd = fmd
        self.sample = np.asarray(sample, dtype=np.int64)
        self.sampling_rate = int(sampling_rate)
        self.extra_keys = np.asarray(extra_keys, dtype=np.int64)
        self.extra_vals = np.asarray(extra_vals, dtype=np.int64)
        self._native = None
        self._native_tried = False

    def __len__(self):
        return len(self.fmd.bwt)

    def get(self, index: int):
        if index >= len(self):
            return None
        # transparent native accelerator (exact same LF-walk semantics)
        if self._native is None and not self._native_tried:
            self._native_tried = True
            try:
                from ..map import native_search

                if native_search.available():
                    self._native = native_search.NativeSALookup(self)
            except Exception:
                self._native = None
        if self._native is not None:
            v = int(self._native.lookup([index])[0])
            return None if v < 0 else v
        pos = index
        offset = 0
        while True:
            if pos % self.sampling_rate == 0:
                return int(self.sample[pos // self.sampling_rate]) + offset
            c = int(self.fmd.bwt[pos])
            if c == 0:  # sentinel: cached extra row
                i = np.searchsorted(self.extra_keys, pos)
                return int(self.extra_vals[i]) + offset
            pos = int(self.fmd.less[c]) + self.fmd.occ(pos - 1, c)
            offset += 1

    @classmethod
    def sample_from(cls, fmd: FmdIndex, suffix_array: np.ndarray,
                    sampling_rate: int = SA_SAMPLING_RATE):
        """Build from a full SA (reference SampledSuffixArrayOwned::sample)."""
        n = len(suffix_array)
        sample = suffix_array[::sampling_rate].astype(np.int64)
        # the sentinel rows the sample misses (a chunked scan: no
        # whole-text mask)
        keys = symbol_positions(fmd.bwt, 0)
        keys = keys[keys % sampling_rate != 0]
        vals = suffix_array[keys].astype(np.int64)
        assert n == len(fmd.bwt)
        return cls(fmd, sample, sampling_rate, keys, vals)


@dataclass
class Index:
    """Bundle of all loaded index parts."""

    fmd: FmdIndex
    suffix_array: SampledSuffixArray
    id_pos_map: FastaIdPositions
    original_symbols: OriginalSymbols
    meta: dict


def bundle_dir(reference_path: str) -> str:
    return f"{reference_path}.tpx"


def save_index(reference_path, fmd: FmdIndex, suffix_array: SampledSuffixArray,
               id_pos_map: FastaIdPositions, original_symbols: OriginalSymbols,
               extra_meta: dict | None = None):
    d = bundle_dir(reference_path)
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "bwt.npy"), fmd.bwt)
    np.save(os.path.join(d, "less.npy"), fmd.less)
    np.save(os.path.join(d, "occ.npy"), fmd.occ_cp)
    np.save(os.path.join(d, "sa_sample.npy"), suffix_array.sample)
    np.save(os.path.join(d, "sa_extra_keys.npy"), suffix_array.extra_keys)
    np.save(os.path.join(d, "sa_extra_vals.npy"), suffix_array.extra_vals)
    np.save(os.path.join(d, "orig_pos.npy"), original_symbols.positions)
    np.save(os.path.join(d, "orig_sym.npy"), original_symbols.symbols)
    meta = {
        "version": INDEX_VERSION,
        "alphabet": fmd.rank_transform.symbols.decode("ascii"),
        "occ_k": fmd.occ_k,
        "sa_sampling_rate": suffix_array.sampling_rate,
        "text_len": len(fmd.bwt),
        # sentinel BWT positions, so genome-scale loads skip the full-BWT
        # scan FmdIndex would otherwise do (375 s over a 6.2 GB mmap)
        "sentinels": [int(s) for s in fmd.sentinel_occ],
        "contigs": [
            {"start": int(c.start), "end": int(c.end), "identifier": c.identifier}
            for c in id_pos_map
        ],
    }
    meta.update(extra_meta or {})
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_index(reference_path: str, mmap: bool = True) -> Index:
    d = bundle_dir(reference_path)
    meta_path = os.path.join(d, "meta.json")
    if not os.path.exists(meta_path):
        # Fall back to an index built by the reference implementation
        # (mapad index -g ref.fa -> ref.fa.tbw/.tle/.tsa/.tpi/.tos/.trt).
        from . import mapad_native

        if mapad_native.is_mapad_native_index(reference_path):
            return mapad_native.load_mapad_index(reference_path)
        present = [
            s for s in mapad_native.MAPAD_SUFFIXES
            if os.path.exists(reference_path + s)
        ]
        if present:
            missing = [
                s for s in mapad_native.MAPAD_SUFFIXES if s not in present
            ]
            raise InvalidIndex(
                f"Found a partial mapAD-native index at {reference_path}"
                f"{{{','.join(present)}}} but missing {missing}. Copy the "
                "complete index or re-run the `index` subcommand."
            )
        raise InvalidIndex(
            f"Index bundle not found at {d}. Run the `index` subcommand first."
        )
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("version") != INDEX_VERSION:
        raise IndexVersionMismatch(meta.get("version"), INDEX_VERSION)

    mm = "r" if mmap else None

    def _load(name):
        return np.load(os.path.join(d, name), mmap_mode=mm)

    rt = RankTransform(meta["alphabet"].encode("ascii"))
    fmd = FmdIndex(_load("bwt.npy"), _load("less.npy"), _load("occ.npy"),
                   meta["occ_k"], rt, sentinels=meta.get("sentinels"))
    # lets DeviceFmIndex.from_host cache its packed occ rows (a ~45 min
    # rebuild at hg19 scale) next to the bundle
    fmd.cache_dir = d
    ssa = SampledSuffixArray(
        fmd, _load("sa_sample.npy"), meta["sa_sampling_rate"],
        _load("sa_extra_keys.npy"), _load("sa_extra_vals.npy"),
    )
    id_pos = FastaIdPositions(
        FastaIdPosition(c["start"], c["end"], c["identifier"])
        for c in meta["contigs"]
    )
    orig = OriginalSymbols(_load("orig_pos.npy"), _load("orig_sym.npy"))
    return Index(fmd, ssa, id_pos, orig, meta)
