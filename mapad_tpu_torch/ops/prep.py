"""Host-side preparation helpers of the device engine (numpy only).

JAX-free copies of the numpy helpers in mapad_tpu/ops/engine.py, kept in a
module that imports no torch so the native engine (map/native_search.py)
does not pull the device engine in:

- score LUT / Bi-D penalty tables (`_build_all_lut`, `_batch_luts`,
  `_LutCache`) with the same f32 op order as models/adna.py;
- the upload blob's wire cells: 10-bit (class, qual) cells
  (`_pack_cq10`) and the Bi-D run-length code (`_pack_bid_rle`);
- `_inject_pre_escalate` for reads the RLE could not carry;
- the result wire format: `_wire_opbits` and the numpy `_unpack_result`
  that reads back what the result pack (ops/engine.py, K5) writes.
"""

from __future__ import annotations

import numpy as np


def _wire_opbits(MW):
    """Wire width for one c_ops word in the packed result transfer.

    A masked op word is base[0:2] | pos[2:17] | kind[17:19] | VALID[20]
    (ops/search.py pack_op) and pos < max_len < MW, so on the wire an op
    needs 2 + ceil(log2(MW)) + 2 + 1 bits.  Derived from the array shape
    alone so _pack_result (device) and _unpack_result (host) agree
    without a side channel.  Returns (opbits, ops_per_int64, pos_bits).
    """
    pb = max(1, (MW - 1).bit_length())
    opbits = pb + 5
    return opbits, 64 // opbits, pb


# SAM quality ceiling ('~' - 33).  Blocks containing higher (malformed)
# base qualities take the legacy full-LUT upload path instead.
_DEV_LUT_Q = 94
_DEV_LUT_MEMO: dict = {}


def _build_all_lut(sdm, params, max_n: int, Q: int = _DEV_LUT_Q):
    """Flat score-LUT + gap-penalty tables over EVERY read length 1..max_n.

    Row `off[n] + (j*5 + cls)*Q + q` holds the 4 from-base scores (and the
    Bi-D penalty element) for position j of an n-long read whose base
    class is cls (A/C/G/T/other) at quality q -- the same pure-function
    cells `_LutCache._build` produces per length (elementwise raw_grid on
    the same scalar inputs, so identical f32 bits; asserted by
    tests/test_device_search.py), all lengths in one vectorized sweep.
    The last row is the all-zero padding row.  Returns
    (table (TOT+1, 4) f32, pen (TOT+1,) f32, off (max_n+1,) i32)."""
    lens = np.arange(1, max_n + 1, dtype=np.int64)
    jflat = np.concatenate([np.arange(nn, dtype=np.int64) for nn in lens])
    nflat = np.repeat(lens, lens)
    shape = (len(jflat), 5, Q)
    j = np.broadcast_to(jflat[:, None, None], shape)
    nl = np.broadcast_to(nflat[:, None, None], shape)
    to = np.broadcast_to(_CLS_REPR[None, :, None], shape)
    qual = np.broadcast_to(
        np.arange(Q, dtype=np.uint8)[None, None, :], shape
    )
    raw = sdm.raw_grid(j, nl, to, qual)  # (TOTJ, 5, Q, 4)
    is_acgt = np.isin(_CLS_REPR, _ACGT)[None, :, None]
    opt = np.where(is_acgt, raw.max(axis=3), np.float32(0.0)).astype(
        np.float32
    )
    score = np.float32(raw - opt[..., None]).reshape(-1, 4)
    table = np.vstack([score, np.zeros((1, 4), np.float32)])
    # mismatch-only minimum penalties (same op order as _batch_luts)
    eq = _CLS_REPR[None, :, None, None] == _ACGT[None, None, None, :]
    mm_raw = np.where(eq, _F32_MIN, raw).max(axis=3)
    mm_retval = np.float32(mm_raw - opt)
    gaps_allowed = (
        np.minimum(jflat, nflat - 1 - jflat) >= params.gap_dist_ends
    )[:, None, None]
    pen = np.where(
        gaps_allowed,
        np.maximum(mm_retval, params.penalty_gap_extend),
        mm_retval,
    ).astype(np.float32).reshape(-1)
    pen = np.concatenate([pen, np.zeros(1, np.float32)])
    base = np.zeros(max_n + 1, dtype=np.int64)
    base[1:] = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return table, pen, (base * (5 * Q)).astype(np.int32)


def _pack_cq10(seqs, quals):
    """Host side of the 10-bit (class, qual) wire cell: cls<<7|qual needs
    3+7 bits (cls <= 4, qual < _DEV_LUT_Q = 94 < 128), so three cells ride
    one int32 instead of the two a u16 layout allows."""
    cq = (_CLS_TABLE[seqs].astype(np.int32) << 7) | quals
    cq = np.ascontiguousarray(cq).reshape(-1)
    RM = cq.size
    RM3 = -(-RM // 3) * 3
    if RM3 != RM:
        cq = np.concatenate([cq, np.zeros(RM3 - RM, np.int32)])
    return cq[0::3] | (cq[1::3] << 10) | (cq[2::3] << 20)


def _cq_words(RM):
    """int32 word count of the 10-bit cq segment for RM cells."""
    return -(-RM // 3)


# RLE segments per read (_BID_SEG - 1 u8 breaks padded to _BID_SEG bytes,
# plus _BID_SEG f32 values).  32 covers the worst measured case: run count
# grows as read_len / log4(genome) -- a 10 kb test genome with 100 bp reads
# peaks at 29 runs, while production genomes (>= Mbp) stay under ~12.
_BID_SEG = 32


def _inject_pre_escalate(stash, n, escalated, abandoned_out, nohit_out):
    """Route reads the prep stage neutralized on device (Bi-D RLE
    overflow, `_pack_bid_rle`) to the host fallback: they produced no
    device hits by construction, so they join the escalated set as
    no-hit abandons (never retried/deep-tiered -- the next prep would
    overflow again).  Returns the number of newly escalated reads."""
    pre = None if stash is None else stash.get("pre_escalate")
    if pre is None:
        return 0
    added = 0
    for i in pre:
        i = int(i)
        if i >= n:
            continue
        if i not in escalated:
            added += 1
        escalated.add(i)
        if abandoned_out is not None:
            abandoned_out.add(i)
        if nohit_out is not None:
            nohit_out.add(i)
    return added


def _pack_bid_rle(bid):
    """Run-length encode the Bi-D composite for the upload blob.

    Each read's d_composite is a step function over positions with few
    value changes (increments at extension-failure points, min-reduced
    over 15 offset walks, map/bi_d_array.py) -- typically < 12 runs per
    75 bp read at production genome sizes.  Wire layout per read:
    _BID_SEG - 1 u8 break positions (sentinel 255 = unused; positions
    < max_len <= 128 fit u8) packed 4/int32, then _BID_SEG f32 segment
    values; cell j reconstructs as vals[count(breaks <= j)].  Cuts the
    bid segment from M to _BID_SEG * 1.25 words per read.  Reads with
    more runs than segments cannot be represented: their break table is
    truncated, so the caller MUST route them to the host fallback
    (returned as the third element) and neutralize them on device.

    Returns (breaks (L * _BID_SEG/4,) i32, vals (L * _BID_SEG,) i32
    bit-view, overflow_row_indices)."""
    bid = np.ascontiguousarray(bid, dtype=np.float32)
    L, M = bid.shape
    # break positions travel as u8 with 255 as the unused sentinel
    assert M <= 255, f"RLE break positions need max_len <= 255 (got {M})"
    change = bid[:, 1:] != bid[:, :-1]
    nseg = 1 + change.sum(axis=1)
    overflow = np.flatnonzero(nseg > _BID_SEG)
    rows, cols = np.nonzero(change)
    # rank of each change within its row (rows ascending from nonzero)
    k = np.arange(rows.size) - np.searchsorted(rows, rows)
    keep = k < _BID_SEG - 1
    r, kk, c = rows[keep], k[keep], cols[keep] + 1
    breaks = np.full((L, _BID_SEG), 255, dtype=np.uint8)
    vals = np.zeros((L, _BID_SEG), dtype=np.float32)
    vals[:, 0] = bid[:, 0]
    breaks[r, kk] = c.astype(np.uint8)
    vals[r, kk + 1] = bid[r, c]
    return (
        breaks.reshape(-1).view(np.int32),
        vals.reshape(-1).view(np.int32),
        overflow,
    )


_RANK_TABLE = np.zeros(256, dtype=np.int32)
for _i, _c in enumerate(b"ACGT"):
    _RANK_TABLE[_c] = _i + 1

# read-base equivalence classes for the score LUT: the per-cell score is a
# pure function of (position, read_len, to-class, qual) where to-class is
# A/C/G/T/other (raw_grid compares the exact byte against ACGT; every
# non-ACGT byte yields the same independent-error column)
_CLS_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CLS_TABLE[_c] = _i
_CLS_REPR = np.frombuffer(b"ACGTN", dtype=np.uint8)


class _Empty:
    sequence = b""
    base_qualities = b""


_EMPTY = _Empty()

_F32_MIN = np.float32(-3.4028235e38)
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _batch_luts(sdm, params, seqs, quals, n, threads: int = 0):
    """Vectorized score LUT + Bi-D penalty elements for a whole lane grid.

    Same f32 op order as the per-read builders (models/adna.py); computed on
    (L, M) grids in one sweep so host preparation is not per-read-bound.
    Rows are independent, so big grids split across a small thread pool
    (numpy releases the GIL in the grid kernels)."""
    L, M = seqs.shape
    if not threads:
        import os

        threads = max(1, (os.cpu_count() or 2) - 1)
    if threads > 1 and L >= 2048:
        from concurrent.futures import ThreadPoolExecutor

        blocks = [
            (i, min(i + -(-L // threads), L))
            for i in range(0, L, -(-L // threads))
        ]
        with ThreadPoolExecutor(max_workers=threads) as pool:
            parts = list(
                pool.map(
                    lambda b: _batch_luts(
                        sdm, params, seqs[b[0]:b[1]], quals[b[0]:b[1]],
                        n[b[0]:b[1]], threads=1,
                    ),
                    blocks,
                )
            )
        return (
            np.concatenate([p[0] for p in parts], axis=0),
            np.concatenate([p[1] for p in parts], axis=0),
        )
    j = np.broadcast_to(np.arange(M, dtype=np.int64), (L, M))
    n_grid = np.broadcast_to(n[:, None].astype(np.int64), (L, M))
    valid = j < n_grid
    n_safe = np.maximum(n_grid, j + 1)  # keep tp_dist >= 0 on padding

    raw = sdm.raw_grid(j, n_safe, seqs, quals)  # (L, M, 4)

    is_acgt = np.isin(seqs, _ACGT)
    opt = np.where(is_acgt, raw.max(axis=2), np.float32(0.0)).astype(np.float32)
    score_lut = np.float32(raw - opt[:, :, None])

    # mismatch-only minimum penalties (from != to)
    eq = seqs[:, :, None] == _ACGT[None, None, :]
    mm_raw = np.where(eq, _F32_MIN, raw).max(axis=2)
    mm_retval = np.float32(mm_raw - opt)
    gaps_allowed = np.minimum(j, n_grid - j - 1) >= params.gap_dist_ends
    pen = np.where(
        gaps_allowed,
        np.maximum(mm_retval, params.penalty_gap_extend),
        mm_retval,
    ).astype(np.float32)

    score_lut = np.where(valid[:, :, None], score_lut, np.float32(0.0))
    pen = np.where(valid, pen, np.float32(0.0)).astype(np.float32)
    return score_lut.astype(np.float32), pen


class _LutCache:
    """Per-read-length score-LUT / penalty tables.

    The (score_lut, pen) cell values from `_batch_luts` are pure functions
    of (position j, read_len n, read-base class, qual): all f32 math in
    raw_grid is elementwise, the from-base max runs over the same 4
    candidates, and gaps_allowed depends only on (j, n).  Caching one
    (n, 5, Q, 4) table per distinct read length turns the per-block LUT
    build into a gather -- bit-identical to recomputing (same op order on
    the same scalar inputs), asserted by tests/test_device_search.py.
    """

    def __init__(self, sdm, params):
        self.sdm = sdm
        self.params = params
        self.tables: dict[int, tuple] = {}

    @staticmethod
    def usable(sdm) -> bool:
        from ..models.adna import SequenceDifferenceModel

        # the generic raw_grid falls back to scalar get() per cell -- a
        # (n, 5, Q) table build would be slower than the direct grid
        return type(sdm).raw_grid is not SequenceDifferenceModel.raw_grid

    def _build(self, n: int, qmax: int):
        Q = max(qmax + 1, 46)
        j = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None, None], (n, 5, Q))
        to = np.broadcast_to(_CLS_REPR[None, :, None], (n, 5, Q))
        qual = np.broadcast_to(
            np.arange(Q, dtype=np.uint8)[None, None, :], (n, 5, Q)
        )
        raw = self.sdm.raw_grid(j, np.int64(n), to, qual)  # (n, 5, Q, 4)
        is_acgt = np.isin(_CLS_REPR, _ACGT)[None, :, None]
        opt = np.where(is_acgt, raw.max(axis=3), np.float32(0.0)).astype(
            np.float32
        )
        score = np.float32(raw - opt[..., None])
        eq = _CLS_REPR[None, :, None, None] == _ACGT[None, None, None, :]
        mm_raw = np.where(eq, _F32_MIN, raw).max(axis=3)
        mm_retval = np.float32(mm_raw - opt)
        jj = np.arange(n, dtype=np.int64)
        gaps_allowed = (
            np.minimum(jj, n - 1 - jj) >= self.params.gap_dist_ends
        )[:, None, None]
        pen = np.where(
            gaps_allowed,
            np.maximum(mm_retval, self.params.penalty_gap_extend),
            mm_retval,
        ).astype(np.float32)
        return Q, np.ascontiguousarray(score), np.ascontiguousarray(pen)

    def fill(self, seqs, quals, n_arr, score_out, pen_out):
        """Gather (score_lut, pen) rows for a padded (L, M) read grid into
        the given output arrays (rows beyond each read's length stay 0)."""
        for ln in np.unique(n_arr):
            ln = int(ln)
            if ln == 0:
                continue
            rows = np.flatnonzero(n_arr == ln)
            q = quals[rows][:, :ln]
            ent = self.tables.get(ln)
            if ent is None or ent[0] <= int(q.max(initial=0)):
                ent = self.tables[ln] = self._build(ln, int(q.max(initial=0)))
            _Q, t_score, t_pen = ent
            cls = _CLS_TABLE[seqs[rows][:, :ln]]
            j = np.arange(ln)[None, :]
            score_out[rows[:, None], j] = t_score[j, cls, q]
            pen_out[rows[:, None], j] = t_pen[j, cls, q]


def _unpack_result(handle, flat):
    """Rebuild a numpy PoolResult from the packed transfer buffer."""
    out = []
    off = 0
    for name, leaf in zip(handle._fields, handle):
        if leaf is None:
            out.append(None)
            continue
        dt = np.dtype(leaf.dtype)
        if name == "c_ops":
            MW = leaf.shape[-1]
            Cn = int(np.prod(leaf.shape[:-1]))
            opbits, K, pb = _wire_opbits(MW)
            MWK = -(-MW // K) * K
            n_i32 = Cn * (MWK // K) * 2
            w = flat[off : off + n_i32].view(np.int64).reshape(
                Cn, MWK // K
            )
            v = np.empty((Cn, MWK), dtype=np.int64)
            for k in range(K):
                v[:, k::K] = (w >> (k * opbits)) & ((1 << opbits) - 1)
            arr = (
                (v & 3)
                | (((v >> 2) & ((1 << pb) - 1)) << 2)
                | (((v >> (2 + pb)) & 3) << 17)
                | (((v >> (4 + pb)) & 1) << 20)
            )
            arr = arr[:, :MW].astype(dt).reshape(leaf.shape)
        elif dt == np.bool_:
            n_i32 = int(np.prod(leaf.shape))  # packed as int32
        else:
            n_i32 = int(np.prod(leaf.shape)) * dt.itemsize // 4
        if name != "c_ops":
            seg = flat[off : off + n_i32]
            if dt == np.bool_:
                arr = seg.astype(np.bool_).reshape(leaf.shape)
            else:
                arr = seg.view(dt).reshape(leaf.shape)
        off += n_i32
        out.append(arr)
    assert off == flat.size
    return type(handle)(*out)
