"""ctypes bindings for the C++ hit postprocessor (csrc/host/postprocess.cpp).

Converts a whole chunk of (read, hits) pairs into encoded BAM record bytes
in one call that releases the GIL and parallelizes internally -- the hot
output path counterpart of reference mapping.rs:402-927.  Semantically
identical to map/postprocess.py (equivalence-tested record-for-record).

Hits are passed in the packed op-word format shared by the device chain log
and the native searcher (kind<<17 | pos<<2 | base_code, 0-terminated);
`pack_hits` converts Python HitInterval lists (oracle path, tests).
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import NamedTuple

import numpy as np

from .._build import host_library
from ..utils.seq import BASE_TO_CODE
from . import OP_DELETION, OP_MISMATCH, HitInterval

logger = logging.getLogger(__name__)

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = host_library("postprocess", ["-pthread"])
        lib.postprocess_batch.restype = ctypes.c_int
        lib.postprocess_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as e:
        logger.warning("native postprocess unavailable (%s)", e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


class PackedHits(NamedTuple):
    """A read's hit set in flat-array form (no per-op Python objects).

    ops rows are u32 words `kind<<17 | pos<<2 | base_code`, 0-terminated
    (or full); track order is reconstructed downstream (bucket by pos,
    buckets right of `split` reversed).
    """

    ivals: np.ndarray   # (n, 3) int64: lower, lower_rev, size
    scores: np.ndarray  # (n,) float32
    ops: np.ndarray     # (n, stride) uint32
    split: int

    def __len__(self):
        return len(self.scores)

    def __bool__(self):
        return len(self.scores) > 0

    def decode(self) -> list:
        """-> list[HitInterval] (Python postprocess / wire / test path)."""
        from ..index.fmd import BiInterval
        from ..utils.seq import CODE_TO_BASE
        from . import EditOperation

        hits = []
        for h in range(len(self.scores)):
            buckets: dict[int, list] = {}
            for w in self.ops[h]:
                w = int(w)
                if w == 0:
                    break
                kind = (w >> 17) & 7
                pos = (w >> 2) & 0x7FFF
                base = (
                    int(CODE_TO_BASE[w & 3])
                    if kind in (OP_MISMATCH, OP_DELETION)
                    else 0
                )
                buckets.setdefault(pos, []).append(EditOperation(kind, pos, base))
            track = []
            for pos in sorted(buckets):
                ops = buckets[pos]
                if pos < self.split:
                    track.extend(ops)
                else:
                    track.extend(reversed(ops))
            hits.append(
                HitInterval(
                    BiInterval(int(self.ivals[h, 0]), int(self.ivals[h, 1]),
                               int(self.ivals[h, 2])),
                    np.float32(self.scores[h]),
                    track,
                )
            )
        return hits


_EMPTY_PACKED_OPS = np.zeros((0, 1), dtype=np.uint32)
_EMPTY_PACKED = PackedHits(
    np.zeros((0, 3), dtype=np.int64), np.zeros(0, dtype=np.float32),
    _EMPTY_PACKED_OPS, 0,
)


def pack_hits(hits: list, split: int) -> PackedHits:
    """Encode decoded HitIntervals back to packed form (tests/oracle path).

    The packed op row must reproduce the original *pre-track-order* word
    sequence semantics; since track order is itself derived from a stable
    bucket sort, re-encoding the track in order round-trips exactly for
    buckets left of the split and reverses right-side buckets (an
    involution), so decode(pack(x)) == x.
    """
    if not hits:
        return _EMPTY_PACKED
    n = len(hits)
    stride = max(len(h.edit_operations) for h in hits) + 1
    ivals = np.zeros((n, 3), dtype=np.int64)
    scores = np.zeros(n, dtype=np.float32)
    ops = np.zeros((n, stride), dtype=np.uint32)
    for i, h in enumerate(hits):
        ivals[i] = (h.interval.lower, h.interval.lower_rev, h.interval.size)
        scores[i] = h.alignment_score
        # emit in reverse-track order so the decoder's stable bucket sort +
        # right-of-split reversal reconstructs the original track
        words = []
        for op in h.edit_operations:
            code = int(BASE_TO_CODE[op.base]) & 3 if op.base else 0
            # OP_VALID_BIT (1<<20) disambiguates real words from the 0
            # terminator (ops/search.py:58)
            words.append((1 << 20) | (op.kind << 17) | (op.pos << 2) | code)
        for j, w in enumerate(_reorder_for_pack(h.edit_operations, words, split)):
            ops[i, j] = w
    return PackedHits(ivals, scores, ops, split)


def _reorder_for_pack(track, words, split):
    """Emit words so that bucket-by-pos + reverse-right-of-split yields
    `track` again: left-of-split buckets keep order, right-side buckets are
    emitted reversed."""
    out = []
    i = 0
    n = len(track)
    while i < n:
        j = i
        while j < n and track[j].pos == track[i].pos:
            j += 1
        seg = words[i:j]
        if track[i].pos >= split:
            seg = seg[::-1]
        out.extend(seg)
        i = j
    return out


def _c64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


class NativePostprocessor:
    """Per-index native postprocessor; prepares flat arrays once."""

    def __init__(self, index, alignment_parameters, threads: int | None = None):
        from ..models.bounds import Continuous, Discrete, TestBound

        assert available()
        self.index = index
        self.parameters = alignment_parameters
        self.threads = threads or os.cpu_count() or 1
        fmd = index.fmd
        self._bwt = np.ascontiguousarray(fmd.bwt, dtype=np.uint8)
        less = np.zeros(6, dtype=np.int64)
        less[: len(fmd.less)] = np.asarray(fmd.less, dtype=np.int64)[:6]
        self._less = less
        cp = np.asarray(fmd.occ_cp, dtype=np.int64)
        if cp.shape[1] < 6:
            cp = np.pad(cp, ((0, 0), (0, 6 - cp.shape[1])))
        elif cp.shape[1] > 6:
            cp = cp[:, :6]
        self._occ_cp = np.ascontiguousarray(cp)
        ssa = index.suffix_array
        self._sa_sample = _c64(ssa.sample)
        self._sa_ek = _c64(ssa.extra_keys)
        self._sa_ev = _c64(ssa.extra_vals)
        self._sampling_rate = int(ssa.sampling_rate)

        contigs = list(index.id_pos_map)
        self._c_starts = _c64([c.start for c in contigs])
        self._c_ends = _c64([c.end for c in contigs])
        names = [c.identifier.encode() for c in contigs]
        off = np.zeros(len(names) + 1, dtype=np.int32)
        off[1:] = np.cumsum([len(nm) for nm in names])
        self._c_name_off = off
        self._c_names = np.frombuffer(
            b"".join(names) or b"\x00", dtype=np.uint8
        ).copy()

        self._orig_pos = _c64(index.original_symbols.positions)
        self._orig_sym = np.ascontiguousarray(
            index.original_symbols.symbols, dtype=np.uint8
        )

        mb = alignment_parameters.mismatch_bound
        if isinstance(mb, Discrete):
            self._bound_kind = 0
        elif isinstance(mb, Continuous):
            self._bound_kind = 1
        elif isinstance(mb, TestBound):
            self._bound_kind = 2
        else:
            raise TypeError(f"unsupported bound {type(mb)}")
        self._repr_mm = np.float32(mb.representative_mismatch_penalty)
        self._mb = mb
        self._sdm = alignment_parameters.difference_model
        self._bound_cache: dict[int, tuple] = {}

    def _bounds_for_length(self, ln: int):
        from ..models.bounds import Continuous

        got = self._bound_cache.get(ln)
        if got is None:
            if self._bound_kind == 0:
                got = (np.float32(self._mb.get(ln)), np.float32(1.0))
            elif self._bound_kind == 1:
                assert isinstance(self._mb, Continuous)
                got = (self._mb.cutoff, self._mb._scale_read_length(ln))
            else:
                got = (self._mb.threshold, np.float32(1.0))
            self._bound_cache[ln] = got
        return got

    def convert_chunk(
        self, records, results, chunk_id: int, position_seed: int = 0,
        read_group=None, index_offset: int = 0,
    ) -> bytes:
        """records + [(hits, duration)] -> concatenated encoded BAM records.

        `hits` entries may be PackedHits or decoded HitInterval lists
        (packed on the fly).  `index_offset` is the records' starting index
        within their task sheet (block-streaming callers convert a sheet in
        slices; the per-read PrRange seed depends on the in-sheet index).
        """
        from ..io.bam import _encode_tags
        from .postprocess import TAG_FILTER

        R = len(records)
        name_off = np.zeros(R + 1, dtype=np.int32)
        seq_off = np.zeros(R + 1, dtype=np.int32)
        aux_off = np.zeros(R + 1, dtype=np.int32)
        flags = np.zeros(R, dtype=np.uint16)
        rng_seeds = np.zeros(R, dtype=np.uint64)
        durations = np.zeros(R, dtype=np.float32)
        splits = np.zeros(R, dtype=np.int32)
        bound_a = np.zeros(R, dtype=np.float32)
        bound_b = np.zeros(R, dtype=np.float32)

        names = []
        seqs = []
        quals = []
        auxes = []
        packed_list = []
        rg_id = None
        if read_group is not None:
            rg_id = read_group[0] if isinstance(read_group, tuple) else read_group
            rg_bytes = _encode_tags([
                (b"RG", "Z",
                 rg_id if isinstance(rg_id, bytes) else str(rg_id).encode())
            ])

        n_hits_total = 0
        ops_words_total = 0
        for i, (record, (hits, duration)) in enumerate(zip(records, results)):
            nm = bytes(record.name or b"")
            sq = bytes(record.sequence)
            names.append(nm)
            seqs.append(sq)
            quals.append(bytes(record.base_qualities))
            name_off[i + 1] = name_off[i] + len(nm)
            seq_off[i + 1] = seq_off[i] + len(sq)
            flags[i] = record.bam_flags & 0xFFFF
            rng_seeds[i] = np.uint64(
                ((position_seed << 40) ^ (chunk_id << 20) ^ (index_offset + i))
                & 0xFFFFFFFFFFFFFFFF
            )
            durations[i] = np.float32(duration if duration is not None else 0.0)
            ln = len(sq)
            splits[i] = self._sdm.find_alignment_start(ln)
            bound_a[i], bound_b[i] = self._bounds_for_length(ln)
            if record.bam_tags:
                tags = [
                    (bytes(t), tc, v) for t, tc, v in record.bam_tags
                    if bytes(t) not in TAG_FILTER
                    and not (bytes(t) == b"RG" and read_group is not None)
                ]
                a = _encode_tags(tags)
            else:
                a = b""
            if read_group is not None:
                a = a + rg_bytes
            auxes.append(a)
            aux_off[i + 1] = aux_off[i] + len(a)

            if not isinstance(hits, PackedHits):
                hits = pack_hits(hits or [], int(splits[i]))
            elif hits.split != splits[i] and len(hits):
                # split mismatch would change track order; never expected
                raise ValueError("packed split mismatch")
            packed_list.append(hits)
            n_hits_total += len(hits)
            ops_words_total += len(hits) * (
                hits.ops.shape[1] if len(hits) else 0
            )

        hit_off = np.zeros(R + 1, dtype=np.int32)
        hit_ivals = np.zeros((n_hits_total, 3), dtype=np.int64)
        hit_scores = np.zeros(n_hits_total, dtype=np.float32)
        ops_off = np.zeros(n_hits_total + 1, dtype=np.int64)
        ops_words = np.zeros(ops_words_total, dtype=np.uint32)
        h = 0
        w = 0
        for i, ph in enumerate(packed_list):
            k = len(ph)
            hit_off[i + 1] = hit_off[i] + k
            if k:
                hit_ivals[h : h + k] = ph.ivals
                hit_scores[h : h + k] = ph.scores
                stride = ph.ops.shape[1]
                ops_words[w : w + k * stride] = ph.ops.reshape(-1)
                for j in range(k):
                    ops_off[h + j + 1] = w + (j + 1) * stride
                h += k
                w += k * stride

        names_b = np.frombuffer(b"".join(names) or b"\x00", dtype=np.uint8).copy()
        seqs_b = np.frombuffer(b"".join(seqs) or b"\x00", dtype=np.uint8).copy()
        quals_b = np.frombuffer(b"".join(quals) or b"\x00", dtype=np.uint8).copy()
        aux_b = np.frombuffer(b"".join(auxes) or b"\x00", dtype=np.uint8).copy()

        lib = _load()
        out_buf = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_int64(0)
        rc = lib.postprocess_batch(
            _ptr(self._bwt, ctypes.c_uint8), ctypes.c_int64(len(self._bwt)),
            _ptr(self._less, ctypes.c_int64),
            _ptr(self._occ_cp, ctypes.c_int64),
            ctypes.c_int64(self.index.fmd.occ_k),
            ctypes.c_int64(self._sampling_rate),
            _ptr(self._sa_sample, ctypes.c_int64),
            _ptr(self._sa_ek, ctypes.c_int64),
            _ptr(self._sa_ev, ctypes.c_int64),
            ctypes.c_int64(len(self._sa_ek)),
            _ptr(self._c_starts, ctypes.c_int64),
            _ptr(self._c_ends, ctypes.c_int64),
            _ptr(self._c_name_off, ctypes.c_int32),
            _ptr(self._c_names, ctypes.c_char),
            ctypes.c_int32(len(self._c_starts)),
            _ptr(self._orig_pos, ctypes.c_int64),
            _ptr(self._orig_sym, ctypes.c_uint8),
            ctypes.c_int64(len(self._orig_pos)),
            ctypes.c_int32(self._bound_kind), ctypes.c_float(self._repr_mm),
            _ptr(bound_a, ctypes.c_float), _ptr(bound_b, ctypes.c_float),
            ctypes.c_int32(R),
            _ptr(name_off, ctypes.c_int32), _ptr(names_b, ctypes.c_uint8),
            _ptr(seq_off, ctypes.c_int32), _ptr(seqs_b, ctypes.c_uint8),
            _ptr(quals_b, ctypes.c_uint8), _ptr(flags, ctypes.c_uint16),
            _ptr(rng_seeds, ctypes.c_uint64), _ptr(durations, ctypes.c_float),
            ctypes.c_int32(1),
            _ptr(aux_off, ctypes.c_int32), _ptr(aux_b, ctypes.c_uint8),
            _ptr(splits, ctypes.c_int32),
            _ptr(hit_off, ctypes.c_int32), _ptr(hit_ivals, ctypes.c_int64),
            _ptr(hit_scores, ctypes.c_float), _ptr(ops_off, ctypes.c_int64),
            _ptr(ops_words, ctypes.c_uint32),
            ctypes.c_int32(self.threads),
            ctypes.byref(out_buf), ctypes.byref(out_len),
        )
        if rc != 0:
            raise RuntimeError(f"postprocess_batch failed rc={rc}")
        try:
            data = ctypes.string_at(out_buf, out_len.value)
        finally:
            lib.postprocess_free(out_buf)
        return data
