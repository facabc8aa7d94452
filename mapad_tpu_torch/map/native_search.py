"""ctypes bindings for the C++ host searcher (csrc/host/searcher.cpp).

Exact-semantics fallback for reads that exceed the device step budgets;
~1000x faster than the Python oracle.  Hits decode through the same op-word
path as the device engine.
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

from .._build import host_library
from ..index.fmd import BiInterval
from ..utils.seq import CODE_TO_BASE
from . import EditOperation, HitInterval, OP_DELETION, OP_MISMATCH
from . import STACK_LIMIT, EDIT_TREE_LIMIT

logger = logging.getLogger(__name__)

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = host_library("searcher", [])
        lib.search_read.restype = ctypes.c_int32
        lib.exhaust_probe_batch.restype = ctypes.c_int32
        _lib = lib
    except Exception as e:
        logger.warning("native searcher unavailable (%s)", e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


class NativeSearcher:
    """Per-index native searcher; prepares flat index arrays once."""

    MAX_HITS = 24

    def __init__(self, fmd):
        self.fmd = fmd
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
        self._sent = np.asarray(fmd.sentinel_occ, dtype=np.int64)

    def probe_batch(self, ranks, codes, ns, sluts, pens, splits, scales,
                    threshs, params, interleave: int = 4):
        """K-way interleaved no-hit exhaustion probes (searcher.cpp
        exhaust_probe_batch).  All arrays are stacked per-read rows of a
        common width.  Returns an int32 verdict array: 0 = the exact
        search provably returns zero hits for that read (soundness
        argument in searcher.cpp), 1 = run the exact search."""
        lib = _load()
        assert lib is not None
        B, max_n = ranks.shape
        ranks = np.ascontiguousarray(ranks, dtype=np.uint8)
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        ns = np.ascontiguousarray(ns, dtype=np.int32)
        sluts = np.ascontiguousarray(sluts, dtype=np.float32)
        pens = np.ascontiguousarray(pens, dtype=np.float32)
        splits = np.ascontiguousarray(splits, dtype=np.int32)
        scales = np.ascontiguousarray(scales, dtype=np.float32)
        threshs = np.ascontiguousarray(threshs, dtype=np.float32)
        verdicts = np.ones(B, dtype=np.int32)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        lib.exhaust_probe_batch(
            ptr(self._bwt, ctypes.c_uint8), ctypes.c_int64(len(self._bwt)),
            ptr(self._less, ctypes.c_int64), ptr(self._occ_cp, ctypes.c_int64),
            ctypes.c_int64(self.fmd.occ_k), ptr(self._sent, ctypes.c_int64),
            ptr(ranks, ctypes.c_uint8), ptr(codes, ctypes.c_uint8),
            ptr(ns, ctypes.c_int32), ctypes.c_int32(max_n),
            ptr(sluts, ctypes.c_float), ptr(pens, ctypes.c_float),
            ptr(splits, ctypes.c_int32), ptr(scales, ctypes.c_float),
            ptr(threshs, ctypes.c_float),
            ctypes.c_float(
                float(np.float32(
                    params.penalty_gap_open + params.penalty_gap_extend
                ))
            ),
            ctypes.c_float(float(params.penalty_gap_extend)),
            ctypes.c_int32(int(params.gap_dist_ends)),
            ctypes.c_int32(int(params.max_num_gaps_open)),
            ctypes.c_int64(STACK_LIMIT), ctypes.c_int64(EDIT_TREE_LIMIT),
            ctypes.c_int32(B), ctypes.c_int32(int(interleave)),
            ptr(verdicts, ctypes.c_int32),
        )
        return verdicts

    def search(self, pattern_rank, pattern_code, n, score_lut, pen, split,
               cutoff_scale, cutoff_thresh, repr_mm, params,
               packed: bool = False, nohit_hint: bool = False):
        lib = _load()
        assert lib is not None
        n = int(n)
        stride = n + 16
        hit_scores = np.zeros(self.MAX_HITS, dtype=np.float32)
        hit_ivals = np.zeros(self.MAX_HITS * 3, dtype=np.int64)
        ops_out = np.zeros(self.MAX_HITS * stride, dtype=np.uint32)
        rank = np.ascontiguousarray(pattern_rank[:n], dtype=np.uint8)
        code = np.ascontiguousarray(pattern_code[:n], dtype=np.uint8)
        slut = np.ascontiguousarray(score_lut[:n], dtype=np.float32)
        pen_c = np.ascontiguousarray(pen[:n], dtype=np.float32)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        n_hits = lib.search_read(
            ptr(self._bwt, ctypes.c_uint8), ctypes.c_int64(len(self._bwt)),
            ptr(self._less, ctypes.c_int64), ptr(self._occ_cp, ctypes.c_int64),
            ctypes.c_int64(self.fmd.occ_k), ptr(self._sent, ctypes.c_int64),
            ptr(rank, ctypes.c_uint8), ptr(code, ctypes.c_uint8),
            ctypes.c_int32(n), ptr(slut, ctypes.c_float),
            ptr(pen_c, ctypes.c_float), ctypes.c_int32(int(split)),
            ctypes.c_float(float(cutoff_scale)),
            ctypes.c_float(float(cutoff_thresh)),
            ctypes.c_float(float(repr_mm)),
            ctypes.c_float(
                float(np.float32(params.penalty_gap_open + params.penalty_gap_extend))
            ),
            ctypes.c_float(float(params.penalty_gap_extend)),
            ctypes.c_int32(int(params.gap_dist_ends)),
            ctypes.c_int32(int(params.max_num_gaps_open)),
            ctypes.c_int32(1 if params.stack_limit_abort else 0),
            ctypes.c_int64(STACK_LIMIT), ctypes.c_int64(EDIT_TREE_LIMIT),
            ctypes.c_int32(self.MAX_HITS),
            ptr(hit_scores, ctypes.c_float), ptr(hit_ivals, ctypes.c_int64),
            ptr(ops_out, ctypes.c_uint32),
            # nohit_hint: the caller (device engine) saw no hit within the
            # device budget -- search_read runs its depth-first exhaustion
            # probe first and skips the heap search when it proves
            # emptiness (identical result either way; see searcher.cpp)
            ctypes.c_int32(1 if nohit_hint else 0),
        )
        if packed:
            from .native_post import _EMPTY_PACKED, PackedHits

            k = min(n_hits, self.MAX_HITS)
            if k == 0:
                return _EMPTY_PACKED
            return PackedHits(
                hit_ivals[: k * 3].reshape(k, 3).copy(),
                hit_scores[:k].copy(),
                ops_out[: k * stride].reshape(k, stride).copy().view(np.uint32),
                int(split),
            )
        hits = []
        for h in range(min(n_hits, self.MAX_HITS)):
            buckets = {}
            for w in ops_out[h * stride : (h + 1) * stride]:
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
                if pos < split:
                    track.extend(ops)
                else:
                    track.extend(reversed(ops))
            hits.append(
                HitInterval(
                    BiInterval(int(hit_ivals[h * 3]), int(hit_ivals[h * 3 + 1]),
                               int(hit_ivals[h * 3 + 2])),
                    np.float32(hit_scores[h]),
                    track,
                )
            )
        return hits


class NativeBiD:
    """Batch Bi-D arrays on the host (native compute_bid_batch).

    Same reference semantics as map.bi_d_array.BiDArray / ops.bi_d
    (src/map/bi_d_array.rs); computed threaded on host cores so the device
    kernel can skip its ~150 ms per-invocation Bi-D prologue and take the
    score-LUT table prepacked (ops/search_pool2.py slut layout)."""

    def __init__(self, fmd):
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
        self._sent = np.asarray(fmd.sentinel_occ, dtype=np.int64)
        self._occ_k = int(fmd.occ_k)

    def compute(self, ranks, pens, ns, splits, threads: int = 0):
        """ranks (R, M) u8, pens (R, M) f32, ns/splits (R,) i32
        -> (R, M) f32 composite (zero beyond each read's length)."""
        lib = _load()
        assert lib is not None
        ranks = np.ascontiguousarray(ranks, dtype=np.uint8)
        pens = np.ascontiguousarray(pens, dtype=np.float32)
        ns = np.ascontiguousarray(ns, dtype=np.int32)
        splits = np.ascontiguousarray(splits, dtype=np.int32)
        R, M = ranks.shape
        out = np.empty((R, M), dtype=np.float32)
        if not threads:
            threads = min(4, os.cpu_count() or 1)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        lib.compute_bid_batch(
            ptr(self._bwt, ctypes.c_uint8), ctypes.c_int64(len(self._bwt)),
            ptr(self._less, ctypes.c_int64),
            ptr(self._occ_cp, ctypes.c_int64),
            ctypes.c_int64(self._occ_k), ptr(self._sent, ctypes.c_int64),
            ptr(ranks, ctypes.c_uint8), ptr(pens, ctypes.c_float),
            ptr(ns, ctypes.c_int32), ptr(splits, ctypes.c_int32),
            ctypes.c_int32(R), ctypes.c_int32(M), ctypes.c_int32(threads),
            ptr(out, ctypes.c_float),
        )
        return out


class NativeSearchEngine:
    """Multi-core host engine: vectorized LUT prep + threaded native search.

    ctypes releases the GIL during `search_read`, so a thread pool gives
    real parallelism -- the host-side counterpart of the reference's rayon
    model (mapping.rs:155).  Exact reference semantics (equivalence-tested
    against the Python oracle).
    """

    def __init__(self, fmd_index, parameters, threads: int | None = None,
                 packed_hits: bool = False):
        import os as _os

        assert available(), "native searcher not available"
        self.fmd = fmd_index
        self.parameters = parameters
        self.threads = threads or _os.cpu_count() or 1
        self.searcher = NativeSearcher(fmd_index)
        self.packed_hits = packed_hits

    def search_chunk(self, records):
        import time as _time
        from concurrent.futures import ThreadPoolExecutor

        from ..models.bounds import Continuous, TestBound
        from ..ops.prep import _RANK_TABLE, _batch_luts
        from ..utils.seq import BASE_TO_CODE

        sdm = self.parameters.difference_model
        mb = self.parameters.mismatch_bound
        L = len(records)
        max_len = max((len(r.sequence) for r in records), default=1) or 1
        seqs = np.zeros((L, max_len), dtype=np.uint8)
        quals = np.zeros((L, max_len), dtype=np.uint8)
        n = np.zeros(L, dtype=np.int32)
        for i, r in enumerate(records):
            ln = len(r.sequence)
            n[i] = ln
            seqs[i, :ln] = np.frombuffer(bytes(r.sequence), dtype=np.uint8)
            quals[i, :ln] = np.frombuffer(
                bytes(r.base_qualities), dtype=np.uint8
            )
        score_lut, pen = _batch_luts(sdm, self.parameters, seqs, quals, n)

        def one(i):
            t0 = _time.perf_counter()
            ln = int(n[i])
            if ln == 0:
                return [], 0.0
            if isinstance(mb, Continuous):
                scale, thresh = mb._scale_read_length(ln), mb.cutoff
            else:
                scale, thresh = np.float32(1.0), mb.threshold_for_length(ln)
            repr_mm = (
                np.float32(-np.inf) if isinstance(mb, TestBound)
                else mb.representative_mismatch_penalty
            )
            hits = self.searcher.search(
                _RANK_TABLE[seqs[i, :ln]].astype(np.uint8),
                BASE_TO_CODE[seqs[i, :ln]], ln, score_lut[i], pen[i],
                sdm.find_alignment_start(ln), scale, thresh, repr_mm,
                self.parameters, packed=self.packed_hits,
            )
            return hits, _time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=self.threads) as pool:
            return list(pool.map(one, range(L)))


class NativeSALookup:
    """Batch suffix-array resolution via the native LF-walk."""

    def __init__(self, ssa):
        self.ssa = ssa
        fmd = ssa.fmd
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
        self._sample = np.ascontiguousarray(ssa.sample, dtype=np.int64)
        self._ek = np.ascontiguousarray(ssa.extra_keys, dtype=np.int64)
        self._ev = np.ascontiguousarray(ssa.extra_vals, dtype=np.int64)

    def lookup(self, positions):
        lib = _load()
        positions = np.ascontiguousarray(positions, dtype=np.int64)
        out = np.empty(len(positions), dtype=np.int64)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        lib.sa_lookup_batch(
            ptr(self._bwt, ctypes.c_uint8), ctypes.c_int64(len(self._bwt)),
            ptr(self._less, ctypes.c_int64), ptr(self._occ_cp, ctypes.c_int64),
            ctypes.c_int64(self.ssa.fmd.occ_k),
            ctypes.c_int64(self.ssa.sampling_rate),
            ptr(self._sample, ctypes.c_int64), ptr(self._ek, ctypes.c_int64),
            ptr(self._ev, ctypes.c_int64), ctypes.c_int64(len(self._ek)),
            ptr(positions, ctypes.c_int64), ctypes.c_int64(len(positions)),
            ptr(out, ctypes.c_int64),
        )
        return out
