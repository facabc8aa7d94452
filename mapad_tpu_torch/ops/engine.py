"""Search engines on the card: `DeviceSearchEngine` batches reads onto
the card and reconstructs hits; `HybridSearchEngine` runs it on the head of
every block and the exact host C++ searcher on the tail.

Counterpart of mapad_tpu/ops/engine.py (`DeviceSearchEngine` in pool and
in batch mode on one device, `HybridSearchEngine`).  Pool mode (the
default, and what `search_stream` runs in either mode), per block of up to
`block_reads` reads:

1. prep thread (host): pad the reads, build the score LUT / penalty rows
   and the bound thresholds (numpy, ops/prep.py) and one int32 upload
   blob.  Small genomes: the blob carries the Bi-D composite from the host
   C++ (map/native_search.py).  Big genomes (int64 index), or
   MAPAD_HOST_BID=0: the blob carries consts and (class, qual) cells only;
2. device thread: upload the blob, unpack it (kernel K4; big: K6, then the
   Bi-D on the card, K7), run the pool search (K2 with K1 inline) and the
   chain extraction (K3, ops/search_pool2.py), pack the result (K5) and
   copy it back asynchronously on a side stream into pinned host memory;
3. caller: wait for the copy, decode the chains into per-read hits and
   route escalated reads: to a device retry block (MAPAD_RETRY_TIER=1), to
   a deep block with a larger per-read cap (the deep tier, on by default
   with a big index), or to the exact host C++ searcher (escalatees without
   any hit first through batched exhaustion probes, MAPAD_NOHIT_PROBE=1).

The pool search runs store generations (kernel K8, ops/search_pool2.py)
when asked: MAPAD_KGENS (with MAPAD_KGENS_MIN_LIVE and MAPAD_SPILL) for the
primary config, MAPAD_DEEP_KGENS for a deep config narrowed with
MAPAD_DEEP_LANES.  Models whose alignment starts inside the read run the
bidirectional form of the search.

The defaults of big mode (device Bi-D, 4096-read blocks, deep tier on) and
every tier constant follow mapad_tpu, so both packages route the same reads
the same way.

Three kernels live in this module, each beside its plain PyTorch version:

- K4 `_unpack_prep_lut` (csrc/unpack_prep.cu) replaces `_unpack_prep_lut`
  and `_unpack_cq10` (mapad_tpu/ops/engine.py:220-288).  Bound: bytes, the
  24 B LUT/Bi-D row written per cell (25 MB at R=8192, M=128).  A block
  takes whole reads (`unpack_plan`), stages their inputs and its output
  rows in shared memory and stores the rows in bulk.
- K5 `_pack_result` / `_pack_buffer` (csrc/pack_result.cu) replaces
  `_pack_result` (mapad_tpu/ops/engine.py:1589-1634).  Bound: bytes, the
  C*MW op words read (9.4 MB at C=16384, MW=144).  int64 fields travel as
  int32 pairs.  One launch of three regions (`pack_plan`); on the engine's
  path it reads K3's one allocation through its layout and writes into
  it, so no PoolResult is made there; a shard's read ids are made global
  in the same launch (`rebase`, the rule of `shard_rebase`).
- K6 `_unpack_prep_full` (csrc/unpack_prep.cu) replaces `_unpack_prep_full`
  (mapad_tpu/ops/engine.py:291-323).  Bound: bytes, the 28 B of rank,
  code, four scores and penalty written per cell (14.7 MB at R=4096,
  M=128).

The wrappers take the plain version for CPU tensors only (the tests); on
a CUDA tensor they launch the kernel or raise.  Each keeps a thread's
argument block and typed entry, checked and filled once per shape or
table, and sets only the pointers a call.

Batch mode (`mode="batch"`, small index only) is `search_chunk` over
fixed batches of `lanes` reads through a list of tiers, `(max_steps,
lanes)` pairs: each batch's dense inputs go up as they are, the Bi-D runs
on the card (K7) and the fixed-batch search (K10, ops/search.py) gives
every lane its own step budget; a tier's escalatees (still searching at
its budget, or longer than `max_len`) go to the next tier, the last tier's
to the exact host searcher.

The mesh (pool mode, kernel K9, parallel/pool_sharded.py): with more than
one device the engine deals every block round-robin into D shards and
each shard runs steps 2-3 above on its own device, stream and host thread
(K4 or K6 + K7, K2 + K3 into K3's one allocation, K5 with the shard's
id rebase, its own copy) over R/D reads, without waiting for the others
(`ShardRunner`, as `pool_search_sharded` runs them); the caller stacks the
shards' results, collects them shard by shard and un-deals them to input
order, the reads the prep neutralized included.  As in mapad_tpu the mesh
is every visible card when more than one is visible and MAPAD_SHARD is
unset on the card or set to 1, unless `device` names one card (`cuda:i`:
that card alone, the layout of a worker or a process per card); the
`mesh` keyword (a list of devices, one per shard, a device possibly named
several times) replaces the visible cards under the same rule.  The
blocks of the retry and deep tiers are sharded too.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import logging
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .._build import (LAUNCHES, check, cuda_function, current_raw_stream,
                      require)
from ..index.fmd import BiInterval
from ..map import EditOperation, HitInterval
from ..models.bounds import Continuous, TestBound
from ..parallel.pool_sharded import (
    ShardRunner,
    _local_view,
    _shard_rebase_plain,
    round_robin_permutation,
)
from ..parallel.sharding import automatic_mesh, canonical, replicate
from ..utils.seq import BASE_TO_CODE, CODE_TO_BASE
from .fm import DeviceFmIndex, resolve_device
from .prep import (
    _BID_SEG,
    _DEV_LUT_MEMO,
    _DEV_LUT_Q,
    _EMPTY,
    _RANK_TABLE,
    _LutCache,
    _batch_luts,
    _build_all_lut,
    _cq_words,
    _inject_pre_escalate,
    _pack_bid_rle,
    _pack_cq10,
    _unpack_result,
    _wire_opbits,
)
from .search import (
    OP_DELETION,
    OP_MISMATCH,
    SearchConfig,
    SearchParams,
    SearchResult,
    k_mismatch_search_batch,
)
from .search_pool import PoolConfig, PoolResult
from .search_pool2 import (
    _packed_words,
    _pool_result,
    _result_layout,
    k_mismatch_search_pool2,
)

logger = logging.getLogger(__name__)


DEFAULT_TIERS = ((2048, None),)
# The yields after a block's within which `search_stream` resolves the
# block's tier futures (MAPAD_INFLIGHT up to it): the streaming driver's
# ordered writer (map/pipeline.py) holds that many blocks queued behind the
# one whose futures it waits on, and then stops the stream.
STREAM_WAIT = 8


# --- K4: unpack the upload blob -----------------------------------------


def _consts(blob, R):
    """The five per-read consts at the head of every upload blob (a
    contiguous int32 vector): views (n, split; then scale, thresh, repr_mm
    as f32).  Five `as_strided` cost 7.0 us on the card's host against
    16.6 us by two `split`s (`tools/k45_time.py`)."""
    o = blob.storage_offset()
    f = blob.view(torch.float32)
    return (blob.as_strided((R,), (1,), o), blob.as_strided((R,), (1,), o + R),
            f.as_strided((R,), (1,), o + 2 * R),
            f.as_strided((R,), (1,), o + 3 * R),
            f.as_strided((R,), (1,), o + 4 * R))


def _cq_cells(cqseg, n, off, tab_rows, R, M, Q):
    """10-bit (class, qual) cells, three per word (`_unpack_cq10` of the JAX
    package) -> (cls (R*M,), table row index (R*M,)).  Cell j of an n-long
    read takes row off[n] + (j*5 + cls)*Q + q; padding cells (j >= n) the
    table's last (all-zero) row.  Gathers clamp like XLA's."""
    dev = cqseg.device
    RM = R * M
    cq = torch.stack(
        [cqseg & 0x3FF, (cqseg >> 10) & 0x3FF, (cqseg >> 20) & 0x3FF], dim=1
    ).reshape(-1)[:RM]
    cls = cq >> 7
    q = cq & 0x7F
    j = torch.arange(M, dtype=torch.int32, device=dev).repeat(R)
    n_rows = n.repeat_interleave(M)
    last = tab_rows - 1
    base = off[torch.clamp(n_rows, 0, off.shape[0] - 1).long()]
    idx = torch.where(j < n_rows, base + (j * 5 + cls) * Q + q, last)
    return cls, torch.clamp(idx, 0, last).long()


def _unpack_prep_lut_plain(blob, tab, off, R, M, Q, rle=False):
    """Plain PyTorch K4: blob -> (n, split, scale, thresh, repr_mm, slut)
    with slut the (R*M, 6) f32 rows [score4 | class | Bi-D]."""
    dev = blob.device

    def f32(x):
        return x.view(torch.float32)

    n, split, scale, thresh, repr_mm = _consts(blob, R)
    RM = R * M
    jrow = torch.arange(M, dtype=torch.int32, device=dev)
    if rle:
        BW = _BID_SEG // 4
        w4 = blob[5 * R : (5 + BW) * R].reshape(R, BW)
        b = torch.stack(
            [w4 & 0xFF, (w4 >> 8) & 0xFF, (w4 >> 16) & 0xFF,
             (w4 >> 24) & 0xFF],
            dim=2,
        ).reshape(R, _BID_SEG)[:, : _BID_SEG - 1]
        vals = f32(blob[(5 + BW) * R : (5 + BW + _BID_SEG) * R]).reshape(
            R, _BID_SEG
        )
        seg = (jrow[None, :, None] >= b[:, None, :]).sum(2)
        bid = vals.gather(1, seg).reshape(RM)
        cqseg = blob[(5 + BW + _BID_SEG) * R :]
    else:
        bid = f32(blob[5 * R : 5 * R + RM])
        cqseg = blob[5 * R + RM :]
    cls, idx = _cq_cells(cqseg, n, off, tab.shape[0], R, M, Q)
    score4 = tab[idx]
    slut = torch.cat(
        [score4, cls.to(torch.float32)[:, None], bid[:, None]], dim=1
    )
    return n, split, scale, thresh, repr_mm, slut


class _UnpackArgs(ctypes.Structure):
    """Mirror of `struct UnpackArgs` in csrc/unpack_prep.cu."""

    _fields_ = [
        ("blob", ctypes.c_void_p), ("tab", ctypes.c_void_p),
        ("off", ctypes.c_void_p), ("tab_rows", ctypes.c_int),
        ("n_off", ctypes.c_int), ("R", ctypes.c_int), ("M", ctypes.c_int),
        ("Q", ctypes.c_int), ("rle", ctypes.c_int), ("slut", ctypes.c_void_p),
    ]


UNPACK_THREADS = 256
UNPACK_CELLS = 1024  # cells a block of K4 takes, about: whole reads


class UnpackPlan(NamedTuple):
    """Where K4 runs (mirrors `struct UnpackPlan` in csrc/unpack_prep.cu):
    `blocks` blocks of `threads`, each over `reads` whole reads, and a
    block's `smem` bytes of shared memory by the word offsets of its parts:
    the staged output rows at 0 (6 words a cell and 2 of phase), the cell
    words, the reads' n, the run values (RLE) or the raw Bi-D, the break
    bytes as 16-bit lanes (RLE), each part with 3 words of slack for the
    16-byte phase of its source and at a 16-byte boundary."""

    blocks: int
    reads: int
    threads: int
    smem: int
    cq_at: int
    n_at: int
    bid_at: int
    brk_at: int


@functools.lru_cache(maxsize=64)
def unpack_plan(R: int, M: int, rle: bool) -> UnpackPlan:
    """K4's launch plan: a pure function of the block's shape."""
    reads = max(1, min(R, UNPACK_CELLS // M))
    cells = reads * M
    at, words = {}, 0
    for name, n in (("stage", 6 * cells + 2), ("cq", cells // 3 + 5),
                    ("n", reads + 3),
                    ("bid", (_BID_SEG * reads if rle else cells) + 3),
                    ("brk", _BID_SEG // 2 * reads if rle else 0)):
        at[name] = words
        words += (n + 3) & ~3
    return UnpackPlan(-(-R // reads), reads, UNPACK_THREADS, 4 * words,
                      at["cq"], at["n"], at["bid"], at["brk"])


class _UnpackPlanC(ctypes.Structure):
    """Mirror of `struct UnpackPlan` in csrc/unpack_prep.cu."""

    _fields_ = [(f, ctypes.c_int) for f in UnpackPlan._fields]


def _blob_words(R, M, rle):
    """int32 words of the small upload blob K4 unpacks."""
    bid = (_BID_SEG // 4 + _BID_SEG) * R if rle else R * M
    return 5 * R + bid + _cq_words(R * M)


class _K4(threading.local):
    """A thread's launch of K4: the entry point, typed once, and one
    argument block, its table fields set (and the tables checked) only when
    the tables change, its shape and plan only when the shape changes; a
    call sets the blob's and the output's pointers."""

    def __init__(self):
        self.args = _UnpackArgs()
        self.fn = cuda_function("unpack_prep", "unpack_prep",
                                [ctypes.POINTER(_UnpackArgs),
                                 ctypes.POINTER(_UnpackPlanC),
                                 ctypes.c_void_p])
        self.tables = (None, None)
        self.shape = None
        self.plan = None
        self.words = 0


_k4 = None


def _unpack_prep_lut(blob, tab, off, R, M, Q, rle=False):
    """K4 wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (never a fallback)."""
    if not blob.is_cuda:
        return _unpack_prep_lut_plain(blob, tab, off, R, M, Q, rle)
    global _k4
    if _k4 is None:
        _k4 = _K4()
    k, a = _k4, _k4.args
    if k.tables[0] is not tab or k.tables[1] is not off:
        for t, dt in ((tab, torch.float32), (off, torch.int32)):
            require(t.is_cuda and t.dtype == dt and t.is_contiguous(),
                    "unpack_prep takes contiguous CUDA tensors")
        require(tab.dim() == 2 and tab.shape[1] == 4
                and tab.data_ptr() % 16 == 0, "LUT table shape")
        a.tab, a.off = tab.data_ptr(), off.data_ptr()
        a.tab_rows, a.n_off = tab.shape[0], off.shape[0]
        k.tables = (tab, off)
    shape = (R, M, Q, bool(rle))
    if k.shape != shape:
        require(R >= 1 and M >= 1 and 6 * R * M < 2**31,
                "unpack_prep: the block exceeds 32-bit indexes")
        require(not rle or M <= 255, "the RLE's u8 breaks need M <= 255")
        a.R, a.M, a.Q, a.rle = R, M, Q, int(rle)
        k.plan = _UnpackPlanC(*unpack_plan(R, M, bool(rle)))
        k.words = _blob_words(R, M, rle)
        k.shape = shape
    require(blob.dtype == torch.int32 and blob.is_contiguous()
            and blob.numel() == k.words,
            "unpack_prep takes the contiguous int32 blob of R reads")
    slut = torch.empty((R * M, 6), dtype=torch.float32, device=blob.device)
    a.blob, a.slut = blob.data_ptr(), slut.data_ptr()
    LAUNCHES.add("unpack_prep")
    rc = k.fn(a, k.plan, current_raw_stream())
    if rc:
        check(rc, "unpack_prep")
    return (*_consts(blob, R), slut)


def _unpack_prep(blob, R, M):
    """Split the full-LUT upload blob (quality values past the device LUT's
    ceiling) into kernel inputs: a reinterpretation of the blob's words,
    no copy and no kernel."""

    return (*_consts(blob, R),
            blob[5 * R :].view(torch.float32).reshape(R * M, 6))


# --- K6: unpack the device-Bi-D blob into dense inputs -----------------


def _unpack_prep_full_plain(blob, tab, pen_tab, off, R, M, Q):
    """Plain PyTorch K6: consts + (class, qual) cells -> (rank, code, n,
    score_lut, pen, split, scale, thresh, repr_mm), the pool search's dense
    inputs: rank, code (R, M) i32; score_lut (R, M, 4) f32; pen (R, M)
    f32."""
    n, split, scale, thresh, repr_mm = _consts(blob, R)
    cls, idx = _cq_cells(blob[5 * R :], n, off, tab.shape[0], R, M, Q)
    score_lut = tab[idx].reshape(R, M, 4)
    pen = pen_tab[idx].reshape(R, M)
    code = cls.reshape(R, M)
    rank = torch.where(cls < 4, cls + 1, 0).to(torch.int32).reshape(R, M)
    return rank, code, n, score_lut, pen, split, scale, thresh, repr_mm


class _UnpackFullArgs(ctypes.Structure):
    """Mirror of `struct UnpackFullArgs` in csrc/unpack_prep.cu."""

    _fields_ = [
        ("blob", ctypes.c_void_p), ("tab", ctypes.c_void_p),
        ("pen_tab", ctypes.c_void_p), ("off", ctypes.c_void_p),
        ("tab_rows", ctypes.c_int), ("n_off", ctypes.c_int),
        ("R", ctypes.c_int), ("M", ctypes.c_int), ("Q", ctypes.c_int),
        ("rank", ctypes.c_void_p), ("code", ctypes.c_void_p),
        ("score_lut", ctypes.c_void_p), ("pen", ctypes.c_void_p),
    ]


class _K6(threading.local):
    """A thread's launch of K6: the entry point, typed once, and one
    argument block, its table fields set (and the tables checked) only
    when the tables change."""

    def __init__(self):
        self.args = _UnpackFullArgs()
        self.fn = cuda_function("unpack_prep", "unpack_prep_full",
                                [ctypes.POINTER(_UnpackFullArgs),
                                 ctypes.c_void_p])
        self.tables = (None, None, None)


_k6 = None


def _unpack_prep_full(blob, tab, pen_tab, off, R, M, Q):
    """K6 wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (never a fallback).  On the card the four dense outputs are
    views of one allocation: score_lut, rank, code, pen."""
    if not blob.is_cuda:
        return _unpack_prep_full_plain(blob, tab, pen_tab, off, R, M, Q)
    global _k6
    if _k6 is None:
        _k6 = _K6()
    k, a = _k6, _k6.args
    t = k.tables
    if t[0] is not tab or t[1] is not pen_tab or t[2] is not off:
        for x, dt in ((tab, torch.float32), (pen_tab, torch.float32),
                      (off, torch.int32)):
            require(x.is_cuda and x.dtype == dt and x.is_contiguous(),
                    "unpack_prep_full takes contiguous CUDA tensors")
        require(tab.dim() == 2 and tab.shape[1] == 4
                and pen_tab.shape == (tab.shape[0],), "LUT table shapes")
        a.tab, a.pen_tab, a.off = (tab.data_ptr(), pen_tab.data_ptr(),
                                   off.data_ptr())
        a.tab_rows, a.n_off = tab.shape[0], off.shape[0]
        k.tables = (tab, pen_tab, off)
    RM = R * M
    require(blob.dtype == torch.int32 and blob.is_contiguous()
            and blob.numel() == 5 * R + _cq_words(RM),
            "unpack_prep_full takes the contiguous int32 blob of R reads")
    # score_lut first: the kernel stores its rows 16 bytes at a time
    buf = torch.empty(7 * RM, dtype=torch.int32, device=blob.device)
    p = buf.data_ptr()
    a.blob, a.R, a.M, a.Q = blob.data_ptr(), R, M, Q
    a.score_lut, a.rank, a.code, a.pen = p, p + 16 * RM, p + 20 * RM, \
        p + 24 * RM
    LAUNCHES.add("unpack_prep_full")
    rc = k.fn(a, current_raw_stream())
    if rc:
        check(rc, "unpack_prep_full")
    f = buf.view(torch.float32)
    n, split, scale, thresh, repr_mm = _consts(blob, R)
    return (buf.as_strided((R, M), (M, 1), 4 * RM),
            buf.as_strided((R, M), (M, 1), 5 * RM), n,
            f.as_strided((R, M, 4), (4 * M, 4, 1), 0),
            f.as_strided((R, M), (M, 1), 6 * RM), split, scale, thresh,
            repr_mm)


# --- K5: pack the result --------------------------------------------------


def _pack_result_plain(res: PoolResult) -> torch.Tensor:
    """Plain PyTorch K5: every PoolResult field as int32 words, c_ops as
    narrow wire ops packed K per int64 (ops/prep.py `_wire_opbits`)."""
    parts = []
    for name, a in zip(res._fields, res):
        if a is None:
            continue
        if name == "c_ops":
            Cn, MW = a.shape
            opbits, K, pb = _wire_opbits(MW)
            w = a & 0x1FFFFF
            narrow = (
                (w & 3)
                | (((w >> 2) & ((1 << pb) - 1)) << 2)
                | (((w >> 17) & 3) << (2 + pb))
                | (((w >> 20) & 1) << (4 + pb))
            )
            MWK = -(-MW // K) * K
            g = torch.nn.functional.pad(narrow, (0, MWK - MW))
            g = g.reshape(Cn, MWK // K, K).to(torch.int64)
            w64 = g[..., 0]
            for k in range(1, K):
                w64 = w64 | (g[..., k] << (k * opbits))
            a = w64.contiguous().view(torch.int32)
        elif a.dtype in (torch.float32, torch.int64):
            # int64 fields travel as little-endian int32 pairs
            a = a.contiguous().view(torch.int32)
        elif a.dtype == torch.bool:
            a = a.to(torch.int32)
        parts.append(a.reshape(-1))
    return torch.cat(parts)


class _PackArgs(ctypes.Structure):
    """Mirror of `struct PackArgs` in csrc/pack_result.cu: a pointer to each
    PoolResult field, then the output's, the sizes and the shard's id
    rebase."""

    _fields_ = [("f", ctypes.c_void_p * len(PoolResult._fields)),
                ("out", ctypes.c_void_p)] + [
        (f, ctypes.c_int)
        for f in ("C", "MW", "L", "R", "opbits", "K", "pb", "big", "rebase",
                  "base", "r_local", "r_global")]


PACK_THREADS = 256
PACK_TILE_BYTES = 18432  # a tile of whole chain rows: 32 at MW = 144


class PackPlan(NamedTuple):
    """Where K5 runs (mirrors `struct PackPlan` in csrc/pack_result.cu):
    one launch of head, ops and tail blocks of `threads`, in that order; a
    head block takes four words a thread of one of the seven head fields,
    an ops block `rows` chain rows (a multiple of 4) staged in `smem` bytes
    of shared memory, a tail block a word a thread."""

    threads: int
    head_blocks: int
    ops_blocks: int
    tail_blocks: int
    rows: int
    smem: int


def _head_words(C, big):
    """Words on the wire of the seven head fields, in order: c_read,
    c_slot, c_abandon, c_lower, c_lrev, c_size (int32 pairs with `big`),
    c_score."""
    w = 2 * C if big else C
    return (C, C, C, w, w, w, C)


@functools.lru_cache(maxsize=64)
def pack_plan(C: int, MW: int, L: int, R: int, big: bool) -> PackPlan:
    """K5's launch plan: a pure function of the result's shape (R = 0
    where it has no read_steps)."""
    T = PACK_THREADS
    head = sum(-(-(-(-n // 4)) // T) for n in _head_words(C, big))
    rows = min(max(4, PACK_TILE_BYTES // (4 * MW) & ~3), (C + 3) & ~3)
    return PackPlan(T, head, -(-C // rows), -(-(3 + 2 * L + R) // T), rows,
                    4 * rows * MW)


class _PackPlanC(ctypes.Structure):
    """Mirror of `struct PackPlan` in csrc/pack_result.cu."""

    _fields_ = [(f, ctypes.c_int) for f in PackPlan._fields]


class _K5(threading.local):
    """A thread's launches of K5: the entry point, typed once, and one
    argument block, its sizes and plan set (and checked) only when the
    result's shape changes; a call sets the 15 pointers and the rebase."""

    def __init__(self):
        self.args = _PackArgs()
        self.ptrs = (ctypes.c_void_p * (len(PoolResult._fields) + 1)
                     ).from_buffer(self.args)
        self.fn = cuda_function("pack_result", "pack_result",
                                [ctypes.POINTER(_PackArgs),
                                 ctypes.POINTER(_PackPlanC),
                                 ctypes.c_void_p])
        self.shape = None
        self.plan = None
        self.words = 0  # of the packed result

    def set_shape(self, C, MW, L, R, big):
        if self.shape == (C, MW, L, R, big):
            return
        self.words = _packed_words(C, MW, L, R, big)
        require(C >= 1 and C * MW < 2**31 and self.words < 2**31,
                "pack_result: the result exceeds 32-bit indexes")
        opbits, K, pb = _wire_opbits(MW)
        a = self.args
        a.C, a.MW, a.L, a.R = C, MW, L, R
        a.opbits, a.K, a.pb, a.big = opbits, K, pb, int(big)
        self.plan = _PackPlanC(*pack_plan(C, MW, L, R, big))
        self.shape = (C, MW, L, R, big)

    def set_rebase(self, rebase):
        """`rebase`: None, or a shard's (base, r_local, r_global)."""
        a = self.args
        if rebase is None:
            a.rebase = 0
            return
        base, r_local, r_global = rebase
        require(0 <= base and base + r_local <= r_global < 2**31,
                "shard slice outside the block")
        a.rebase, a.base, a.r_local, a.r_global = 1, base, r_local, r_global

    def launch(self, big):
        LAUNCHES.add("pack_result_i64" if big else "pack_result")
        if self.args.rebase:
            LAUNCHES.add("pack_result_rebase")
        rc = self.fn(self.args, self.plan, current_raw_stream())
        if rc:
            check(rc, "pack_result")


_k5 = None


def _k5_local() -> _K5:
    global _k5
    if _k5 is None:
        _k5 = _K5()
    return _k5


def _pack_result(res: PoolResult) -> torch.Tensor:
    """K5 wrapper on a PoolResult: the plain version for CPU tensors, the
    kernel for CUDA tensors (never a fallback)."""
    if not res.c_read.is_cuda:
        return _pack_result_plain(res)
    for t in res:
        require(t is None or (t.is_cuda and t.is_contiguous()),
                "pack_result takes contiguous CUDA tensors")
    require(res.c_lrev.dtype == res.c_size.dtype == res.c_lower.dtype,
            "interval fields must share one type")
    C, MW = res.c_ops.shape
    L = res.lane_read.shape[0]
    R = 0 if res.read_steps is None else res.read_steps.shape[0]
    big = res.c_lower.dtype == torch.int64
    k = _k5_local()
    k.set_shape(C, MW, L, R, big)
    k.set_rebase(None)
    out = torch.empty(k.words, dtype=torch.int32, device=res.c_read.device)
    k.ptrs[:] = [None if t is None else t.data_ptr() for t in res] + [
        out.data_ptr()]
    k.launch(big)
    return out


def _pack_buffer(buf, config, R, big, rebase=None) -> torch.Tensor:
    """K5 on K3's one allocation (`_result_layout`; the engine's path): the
    fields read through the layout's offsets, no PoolResult made, the
    packed words written into the allocation's `packed` part and returned
    as a view of it.  `rebase`: a shard's (base, r_local, r_global), its
    read ids made global while they are packed (`shard_rebase`'s rule).
    On the CPU the plain versions over the views."""
    L, C, MW = config.lanes, config.max_chains, config.max_len + 16
    if not buf.is_cuda:
        res = _pool_result(buf, config, R, big)
        if rebase is not None:
            res = _shard_rebase_plain(res, *rebase)
        return _pack_result_plain(res)
    lay = _result_layout(L, C, MW, R, config.total_steps, bool(big))
    require(buf.dtype == torch.int32 and buf.numel() == lay.words,
            "pack_result takes K3's int32 allocation of this shape")
    k = _k5_local()
    k.set_shape(C, MW, L, R, big)
    k.set_rebase(rebase)
    base = buf.data_ptr()
    k.ptrs[:] = [base + b for b in lay.pack]
    k.launch(big)
    at = lay.at["packed"]
    return buf[at : at + k.words]


_NP_DTYPE = {torch.int32: np.int32, torch.int64: np.int64,
             torch.float32: np.float32, torch.bool: np.bool_}


def _spec(fields) -> PoolResult:
    """Shape/dtype stand-ins (zero-stride numpy views) that tell the numpy
    `_unpack_result` how to read the packed buffer, from each field's
    (shape, torch dtype) or None."""
    return PoolResult(*[
        None if f is None
        else np.broadcast_to(np.zeros((), _NP_DTYPE[f[1]]), tuple(f[0]))
        for f in fields
    ])


def _result_spec(res: PoolResult) -> PoolResult:
    """`_spec` of a PoolResult's tensors."""
    return _spec(None if t is None else (t.shape, t.dtype) for t in res)


@functools.lru_cache(maxsize=64)
def _buffer_spec(L, C, MW, R, big) -> PoolResult:
    """`_spec` of the PoolResult K3's allocation holds, from its shape
    alone (`_pack_buffer`'s words)."""
    i32, idt = torch.int32, torch.int64 if big else torch.int32
    return _spec((((C,), i32), ((C,), i32), ((C,), torch.bool), ((C,), idt),
                  ((C,), idt), ((C,), idt), ((C,), torch.float32),
                  ((C, MW), i32), ((), i32), ((L,), i32), ((L,), torch.bool),
                  ((), i32), ((), i32), ((R,), i32)))


def _track(words, split):
    """The edit operations of one op-word chain in track order: bucketed by
    read position, each bucket reversed at and past `split` (a 0 word ends
    the chain)."""
    buckets: dict[int, list] = {}
    for w in words:
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
        track.extend(ops if pos < split else reversed(ops))
    return track


class DeviceSearchEngine:
    def __init__(self, fmd_index, parameters, lanes: int = 2048,
                 config: SearchConfig | None = None,
                 tiers: tuple = DEFAULT_TIERS, mode: str = "pool",
                 pool_config: "PoolConfig | None" = None,
                 big: bool | None = None, packed_hits: bool = False,
                 threads: int | None = None, device=None, mesh=None):
        self.device = resolve_device(device)
        self.fmd = fmd_index
        self.parameters = parameters
        self.lanes = lanes
        self.mode = mode
        self.tiers = tiers
        # --threads bounds the exact-fallback worker pool
        self.threads = threads
        # packed_hits: hits as PackedHits (flat op-word arrays for the
        # native postprocess path) instead of decoded HitInterval lists
        self.packed_hits = packed_hits
        self.device_index = DeviceFmIndex.from_host(
            fmd_index, big=big, device=self.device
        )
        if self.device_index.big and mode != "pool":
            raise ValueError(
                "int64 (big-genome) device mode is implemented for the "
                "pool kernel only; use mode='pool'"
            )
        sdm = parameters.difference_model
        self._is_backward_only = sdm.find_alignment_start(100) == 100
        if config is None:
            config = SearchConfig(
                compute_forward_part=not self._is_backward_only
            )
        self.config = config
        if pool_config is None:
            # the production shape of mapad_tpu: L=512 lanes, S =
            # 512*8192/L steps (the frame store, L*S blocks, stays
            # constant), per-read cap 3072, 16384 chains an invocation
            pool_lanes = max(8, min(lanes, 512))
            pool_steps = max(2048, (512 * 8192) // pool_lanes)
            if os.environ.get("MAPAD_POOL_STEPS"):
                pool_steps = int(os.environ["MAPAD_POOL_STEPS"])
            cap_env = int(os.environ.get("MAPAD_POOL_CAP", 0))
            pool_config = PoolConfig(
                max_len=config.max_len,
                lanes=pool_lanes,
                total_steps=pool_steps,
                max_chains=16384,
                read_step_cap=min(cap_env or 3072, pool_steps),
                compute_forward_part=config.compute_forward_part,
                backward_only=self._is_backward_only,
                # store generations: unfinished and undispatched reads
                # resume after an in-place store compaction (K8) instead of
                # escalating; one generation unless asked for
                generations=int(os.environ.get("MAPAD_KGENS", "1")),
                # below this many live lanes the host clears the stragglers
                min_live=int(os.environ.get("MAPAD_KGENS_MIN_LIVE", "32")),
                # a generation after a boundary runs at most this many steps
                spill_steps=int(os.environ.get("MAPAD_SPILL", "768")),
            )
        elif pool_config.backward_only and not self._is_backward_only:
            pool_config = pool_config._replace(backward_only=False)
        if (pool_config.generations > 1
                and pool_config.read_step_cap + 4 > pool_config.total_steps):
            # a store boundary could free nothing: one generation
            pool_config = pool_config._replace(generations=1)
        self.pool_config = pool_config
        # counts, and seconds per stage: prep (prep thread), device (device
        # thread), wait + decode (caller), exact fallback (core-seconds)
        # (retry and deep blocks count into steps and seconds, not into
        # device_lanes / escalated / batches)
        self._stats = {"device_lanes": 0, "escalated": 0, "oracle": 0,
                       "batches": 0, "steps": 0, "prep_s": 0.0,
                       "device_s": 0.0, "wait_s": 0.0, "decode_s": 0.0,
                       "fb_secs": 0.0}
        self._stats_lock = threading.Lock()
        self._lut_lock = threading.Lock()
        # the lazily made helpers that MAPAD_PREP_THREADS prep threads
        # share (the host LUT cache, the C++ Bi-D and its executor)
        self._prep_lock = threading.Lock()
        self._dev_lut_by_dev: dict = {}
        self._params_cache = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
        # the mesh of pool mode, as in mapad_tpu: on by default on the card
        # (MAPAD_SHARD unset), opt-in elsewhere (MAPAD_SHARD=1), and only
        # over more than one device: every visible card unless `mesh`
        # names the shards' devices or `device` one card
        self.mesh = None
        self.n_shards = 1
        shard_env = os.environ.get("MAPAD_SHARD")
        want_shard = shard_env == "1" or (
            shard_env is None and self.device.type == "cuda"
        )
        if mode == "pool" and want_shard:
            if mesh is None:
                mesh = automatic_mesh(self.device)
            if mesh is not None and len(mesh) > 1:
                self.mesh = [canonical(d) for d in mesh]
                self.n_shards = len(self.mesh)
                self._mesh_index = replicate(self.mesh, self.device_index)
                for d in set(self.mesh):  # the replicas' copies are done
                    if d.type == "cuda":
                        torch.cuda.current_stream(d).synchronize()
                self._shards = ShardRunner(self.mesh)

    # --- host-side per-read preparation (exact f32 paths) ---

    def _prepare(self, records, max_len: int, lanes: int | None = None,
                 host_bid: bool = True, dense: bool = False):
        """Host preparation of one invocation.

        host_bid: the C++ Bi-D and one int32 upload blob (consts | Bi-D,
        RLE-coded by default | 10-bit (class, qual) cells; or consts |
        packed LUT/Bi-D rows when the qualities exceed the device LUT's
        ceiling).  Else (big genomes) the Bi-D is left to the card: the blob
        is consts | (class, qual) cells only (unpacked by K6), or, past the
        LUT's ceiling, the dense input arrays go up as they are.  Returns
        the upload and the host stash the exact fallback reuses.

        dense (batch mode, with host_bid=False): the nine input arrays of
        the batch search as they are under "dense" (`thresh` left -inf on
        empty lanes), uploaded to the engine's device on the current
        stream; the big-mode dense return above has the same keys on the
        host, with `thresh` +inf on empty lanes."""
        L = lanes if lanes is not None else self.lanes
        sdm = self.parameters.difference_model
        mb = self.parameters.mismatch_bound

        seqs = np.zeros((L, max_len), dtype=np.uint8)
        quals = np.zeros((L, max_len), dtype=np.uint8)
        n = np.zeros(L, dtype=np.int32)
        split = np.zeros(L, dtype=np.int32)
        cutoff_scale = np.ones(L, dtype=np.float32)
        cutoff_thresh = np.full(L, np.float32(-np.inf), dtype=np.float32)
        repr_mm = np.full(L, np.float32(-np.inf), dtype=np.float32)

        # per-length parameter cache (pure functions of the read length)
        by_len: dict[int, tuple] = getattr(self, "_len_params", None)
        if by_len is None:
            by_len = self._len_params = {}

        def len_params(ln):
            v = by_len.get(ln)
            if v is None:
                s = sdm.find_alignment_start(ln)
                # bound encoding: reject(v) == (v / scale) < thresh
                if isinstance(mb, Continuous):
                    sc, th = mb._scale_read_length(ln), mb.cutoff
                else:  # Discrete / TestBound: absolute threshold
                    sc, th = np.float32(1.0), mb.threshold_for_length(ln)
                rm = (
                    np.float32(-np.inf) if isinstance(mb, TestBound)
                    else mb.representative_mismatch_penalty
                )
                v = by_len[ln] = (s, sc, th, rm)
            return v

        for i, record in enumerate(records):
            seq = np.frombuffer(bytes(record.sequence), dtype=np.uint8)
            ln = len(seq)
            n[i] = ln
            if ln == 0:
                continue
            seqs[i, :ln] = seq
            quals[i, :ln] = np.frombuffer(
                bytes(record.base_qualities), dtype=np.uint8
            )
            split[i], cutoff_scale[i], cutoff_thresh[i], repr_mm[i] = (
                len_params(ln)
            )

        pattern_rank = np.where(n[:, None] > 0, _RANK_TABLE[seqs], 0)
        pattern_rank[seqs == 0] = 0
        pattern_code = BASE_TO_CODE[seqs].astype(np.int32)
        n_real = min(len(records), L)
        pen = np.zeros((L, max_len), dtype=np.float32)
        # device-LUT mode: ship consts + Bi-D + (class, qual) cells and
        # gather the score columns on the card from the one-time table
        # (K4; K6 in big mode); MAPAD_DEV_LUT=0 uploads the host-scored
        # rows (small mode) or the dense arrays (big mode) instead
        dev_ok = (
            self._lut_cache() is not None
            and os.environ.get("MAPAD_DEV_LUT", "1") != "0"
            and max_len % 2 == 0
            and max_len <= self.config.max_len
            and int(quals.max(initial=0)) < _DEV_LUT_Q
        )
        dev_lut = host_bid and dev_ok
        # Bi-D as a run-length code: reads with more runs than the code
        # carries are neutralized on the card (thresh = +inf) and routed to
        # the host fallback at collect time (stash["pre_escalate"])
        bid_rle = dev_lut and os.environ.get("MAPAD_BID_RLE", "1") != "0"
        RM = L * max_len
        bid_words = (_BID_SEG // 4 + _BID_SEG) * L if bid_rle else RM
        if host_bid and not dev_lut:
            # the score columns are filled straight into the blob
            blob = np.zeros(5 * L + RM * 6, dtype=np.int32)
            packed3 = blob[5 * L :].view(np.float32).reshape(L, max_len, 6)
            score_lut = packed3[:, :, :4]
        elif host_bid:
            blob = np.zeros(5 * L + bid_words + _cq_words(RM),
                            dtype=np.int32)
            packed3 = None
            score_lut = np.zeros((L, max_len, 4), dtype=np.float32)
        else:
            blob = packed3 = None
            score_lut = np.zeros((L, max_len, 4), dtype=np.float32)
        if n_real:
            cache = self._lut_cache()
            if cache is not None:
                cache.fill(
                    seqs[:n_real], quals[:n_real], n[:n_real],
                    score_lut[:n_real], pen[:n_real],
                )
            else:
                sl, pe = _batch_luts(
                    sdm, self.parameters, seqs[:n_real], quals[:n_real],
                    n[:n_real],
                )
                score_lut[:n_real] = sl
                pen[:n_real] = pe

        # host views kept for the escalated-read fallback: the native
        # searcher takes the SAME per-read LUT/penalty rows
        stash = dict(
            pattern_rank=pattern_rank, pattern_code=pattern_code, n=n,
            score_lut=score_lut, pen=pen, split=split,
            scale=cutoff_scale, thresh=cutoff_thresh, repr_mm=repr_mm,
            max_len=max_len,
        )

        def dense_arrays(thresh):
            return dict(
                pattern_rank=pattern_rank.astype(np.int32),
                pattern_code=pattern_code, n=n, score_lut=score_lut, pen=pen,
                split=split, scale=cutoff_scale, thresh=thresh,
                repr_mm=repr_mm,
            )

        if dense:
            return dict(_stash=stash, dense={
                k: self._to_device(v)
                for k, v in dense_arrays(cutoff_thresh).items()})
        # padded/empty reads reject everything at once
        thresh = cutoff_thresh.copy()
        thresh[n == 0] = np.float32(np.inf)
        if not host_bid:
            # the longest parts of the block bound the card's Bi-D walks
            bid_steps = (int(split.max(initial=0)),
                         int((n - split).max(initial=0)))
            out = dict(L=L, max_len=max_len, bid_steps=bid_steps,
                       _stash=stash)
            if dev_ok:
                blob = np.zeros(5 * L + _cq_words(RM), dtype=np.int32)
                for k, a in enumerate((n, split, cutoff_scale, thresh,
                                       repr_mm)):
                    blob[k * L : (k + 1) * L] = a.view(np.int32)
                blob[5 * L :] = _pack_cq10(seqs, quals)
                return dict(out, blob=blob, dev_full=True)
            return dict(out, dev_full=False, dense=dense_arrays(thresh))
        from ..map import native_search

        if not native_search.available():
            raise RuntimeError(
                "the host C++ Bi-D needs a C++ compiler; set "
                "MAPAD_HOST_BID=0 to compute the Bi-D on the device"
            )
        # the threaded C++ Bi-D overlaps the blob packing below
        bid_fut = self._bid_exec().submit(
            self._native_bid().compute,
            pattern_rank.astype(np.uint8), pen, n, split,
            max(1, (os.cpu_count() or 2) - 2),
        )
        blob[:L] = n.view(np.int32)
        blob[L : 2 * L] = split.view(np.int32)
        blob[2 * L : 3 * L] = cutoff_scale.view(np.int32)
        blob[3 * L : 4 * L] = thresh.view(np.int32)
        blob[4 * L : 5 * L] = repr_mm.view(np.int32)
        if dev_lut:
            blob[5 * L + bid_words :] = _pack_cq10(seqs, quals)
        else:
            packed3[:, :, 4] = pattern_code
        bid = bid_fut.result()
        if bid_rle:
            br, vv, ovf = _pack_bid_rle(bid)
            bw = _BID_SEG // 4
            blob[5 * L : (5 + bw) * L] = br
            blob[(5 + bw) * L : (5 + bw) * L + _BID_SEG * L] = vv
            if ovf.size:
                # unrepresentable reads finish at once with no hits and
                # escalate
                blob[3 * L + ovf] = np.float32(np.inf).view(np.int32)
                stash["pre_escalate"] = ovf
        elif dev_lut:
            blob[5 * L : 5 * L + RM] = (
                np.ascontiguousarray(bid, dtype=np.float32)
                .reshape(-1).view(np.int32)
            )
        else:
            packed3[:, :, 5] = bid
        return dict(blob=blob, L=L, max_len=max_len, dev_lut=dev_lut,
                    rle=bid_rle, _stash=stash)

    def _to_device(self, array, dev=None):
        dev = self.device if dev is None else dev
        host = torch.from_numpy(np.ascontiguousarray(array))
        if dev.type == "cuda":
            host = host.pin_memory()
        return host.to(dev, non_blocking=True)

    def _upload(self, prep, dev=None):
        """Upload to `dev` (the engine's device by default; on the current
        stream) and unpack (K4, or K6 for the device-Bi-D blob).  Returns
        the pool search's five consts and its keyword inputs: the packed
        LUT/Bi-D rows, or the dense arrays with the block's longest
        parts."""
        L, M = prep["L"], prep["max_len"]
        if "dense" in prep:
            d = {k: self._to_device(v, dev) for k, v in prep["dense"].items()}
            consts = (d["n"], d["split"], d["scale"], d["thresh"],
                      d["repr_mm"])
            dense = (d["pattern_rank"], d["pattern_code"], d["score_lut"],
                     d["pen"])
            return consts, dict(dense=dense, bid_steps=prep["bid_steps"])
        blob = self._to_device(prep["blob"], dev)
        if prep.get("dev_full"):
            tab, pen_tab, off = self._device_lut(dev)
            (rank, code, n, score_lut, pen, split, scale, thresh,
             repr_mm) = _unpack_prep_full(blob, tab, pen_tab, off, L, M,
                                          _DEV_LUT_Q)
            return (n, split, scale, thresh, repr_mm), dict(
                dense=(rank, code, score_lut, pen),
                bid_steps=prep["bid_steps"],
            )
        if prep["dev_lut"]:
            tab, _pen_tab, off = self._device_lut(dev)
            parts = _unpack_prep_lut(blob, tab, off, L, M, _DEV_LUT_Q,
                                     rle=prep["rle"])
        else:
            parts = _unpack_prep(blob, L, M)
        return parts[:5], dict(slut=parts[5])

    def _params(self) -> SearchParams:
        # host scalars: the kernels take them by value
        if self._params_cache is None:
            self._params_cache = SearchParams.from_alignment(
                self.parameters, "cpu"
            )
        return self._params_cache

    # --- public API ---

    def search_chunk(self, records, lazy_fallback: bool = False):
        """lazy_fallback (pool mode): escalated entries come back as Futures
        still running on the engine's fallback pool.  Batch mode returns
        every read resolved."""
        if self.mode != "pool":
            return self._search_chunk_batch(records)
        R = self.block_reads
        out = [None] * len(records)
        blocks = (
            (base, records[base : base + R])
            for base in range(0, len(records), R)
        )
        for base, block_out in self.search_stream(blocks, lazy_fallback=True):
            out[base : base + len(block_out)] = block_out
        if not lazy_fallback:
            out = [o.result() if isinstance(o, Future) else o for o in out]
        return out

    def _fallback_pool(self):
        """The exact host fallback's threads: MAPAD_FB_THREADS, else the
        engine's `threads`, else all cores but one; read at every stream
        (as mapad_tpu does), the pool made anew when the count changes.
        The replaced pool finishes what it holds."""
        n = int(os.environ.get("MAPAD_FB_THREADS", "0")) or (
            self.threads or max(1, (os.cpu_count() or 2) - 1)
        )
        pool = getattr(self, "_fb_pool", None)
        if pool is None or self._fb_threads != n:
            if pool is not None:
                pool.shutdown(wait=False)
            self._fb_threads = n
            self._fb_pool = ThreadPoolExecutor(max_workers=n)
        return self._fb_pool

    @property
    def block_reads(self) -> int:
        """Device invocation size: 8192 reads, 4096 with a big index (each
        read of a genome-scale text needs more of the shared step budget),
        as in mapad_tpu; with a mesh that many per shard, rounded up to a
        multiple of the shards.  Assignable (tests, tuning)."""
        override = getattr(self, "_block_reads", None) or int(
            os.environ.get("MAPAD_BLOCK_READS", 0)
        )
        D = self.n_shards
        if override:
            r = max(self.pool_config.lanes * D, override)
        else:
            r = max(self.pool_config.lanes,
                    4096 if self.device_index.big else 8192) * D
        return -(-r // D) * D

    @block_reads.setter
    def block_reads(self, value: int):
        self._block_reads = value

    def search_stream(self, blocks, lazy_fallback: bool = False,
                      max_in_flight: int = 2):
        """Pipelined block search: yields (key, results) per input block in
        submission order.

        A prep thread builds the next blocks' LUT rows and upload blob while
        up to `max_in_flight` invocations are queued on the device thread;
        each invocation's result pack and its copy to the host are enqueued
        behind its search, so the copy overlaps the next invocation.
        Escalated entries come back as Futures when lazy_fallback.

        The tiers of mapad_tpu, with its constants and routing (they need
        lazy_fallback: results resolve when the later invocation lands):

        - retry (MAPAD_RETRY_TIER=1): reads that merely ran out of the
          shared step budget of a full block (unfinished early,
          undispatched, chain overflow) re-run in a block of escalatees at
          the same shapes, up to MAPAD_RETRY_GENS passes;
        - deep (MAPAD_DEEP_TIER=1/0, default on with a big index): abandons
          and reads that spent most of their per-read cap re-run under
          `_deep_config` (a larger per-read cap) in partially filled
          blocks; escalatees without any hit go straight to the host
          (MAPAD_DEEP_NOHIT_HOST=0 keeps them in the tier);
        - the exact host C++ searcher takes what is left.

        Read at every call, as in mapad_tpu: MAPAD_INFLIGHT (default
        `max_in_flight`) invocations queued on the device thread at once
        (it runs them one after another); MAPAD_PREP_THREADS (default 1)
        blocks in prep at once, one more queued behind them.  Blocks are
        yielded in submission order whatever the prep threads.

        A tier's futures resolve within STREAM_WAIT yields of their
        block's: a caller that holds no more yielded blocks than that
        while it waits on the oldest (the streaming driver's ordered
        writer) never stops the stream that would resolve them.  A tier
        buffer whose oldest entry has waited `tier_wait` yields is
        flushed ahead of the queued blocks, as a tier block or, below
        MAPAD_RETRY_MIN reads, to the host; an escalatee of a block
        yielded that long ago goes to the host.  A stream too short for
        that wait runs as in mapad_tpu."""
        from collections import deque

        cfg = self.pool_config
        R = self.block_reads
        params = self._params()
        self._ensure_native()
        fb_pool = self._fallback_pool()
        max_in_flight = int(
            os.environ.get("MAPAD_INFLIGHT", str(max_in_flight))
        )
        prep_threads = int(os.environ.get("MAPAD_PREP_THREADS", "1"))
        prep_exec = getattr(self, "_prep_exec", None)
        if prep_exec is None or self._prep_threads != prep_threads:
            if prep_exec is not None:
                prep_exec.shutdown(wait=False)
            self._prep_threads = prep_threads
            self._prep_exec = ThreadPoolExecutor(
                max_workers=prep_threads, thread_name_prefix="pool-prep"
            )
        it = iter(blocks)
        prep_q: deque = deque()  # (key, records, Future[prepped])
        run_q: deque = deque()   # (key, records, launched)
        exhausted = False

        retry_enabled = (lazy_fallback
                         and os.environ.get("MAPAD_RETRY_TIER") == "1")
        retry_gens = int(os.environ.get("MAPAD_RETRY_GENS", "2"))
        # below this, one more device invocation costs more than the host
        # fallback pool clearing the stragglers
        retry_min = int(os.environ.get("MAPAD_RETRY_MIN", str(cfg.lanes // 4)))
        # mid-stream trigger: a retry block launches once this many
        # escalatees accumulated (small against R, so retries resolve
        # shortly after their block)
        retry_block = int(os.environ.get("MAPAD_RETRY_BLOCK", str(R // 8)))
        retry_buf: list = []  # (Future, record, gen, yields before it)
        _RETRY = object()  # sentinel key: internal block, never yielded

        deep_tier = lazy_fallback and self.deep_tier_enabled()
        cfg_deep = self._deep_config(cfg)
        deep_take = int(os.environ.get(
            "MAPAD_DEEP_BLOCK", str(max(retry_min, R // 8))
        ))
        deep_gens = int(os.environ.get("MAPAD_DEEP_GENS", "1"))
        deep_buf: list = []  # (Future, record, gen, yields before it)
        _DEEP = object()  # sentinel key: internal deep block
        # a flushed tier block lands behind the invocations in flight
        tier_wait = max(1, STREAM_WAIT + 1 - max_in_flight)
        yielded = 0  # input blocks yielded so far
        deep_nohit_host = deep_tier and (
            os.environ.get("MAPAD_DEEP_NOHIT_HOST", "1") == "1"
        )
        nohit_probe = os.environ.get("MAPAD_NOHIT_PROBE", "0") == "1"

        def fb_submit(rec, stash_i, stash, fut=None):
            f = fb_pool.submit(self._fallback_one, rec,
                               self._stash_row(stash, stash_i))
            if fut is None:
                return f

            # chain the fallback result into the caller-visible future
            def _done(src, dst=fut):
                exc = src.exception()
                if exc is not None:
                    dst.set_exception(exc)
                else:
                    dst.set_result(src.result())

            f.add_done_callback(_done)
            return fut

        def submit_tier(tag, buf, take_n, tier_cfg, stat, first=False):
            take = buf[:take_n]
            del buf[:take_n]
            recs = [t[1] for t in take]
            entry = ((tag, take), recs,
                     self._prep_exec.submit(self._prep_block, recs, R,
                                            tier_cfg))
            if first:
                prep_q.appendleft(entry)
            else:
                prep_q.append(entry)
            self._stats[stat] = self._stats.get(stat, 0) + len(take)

        def host_all(buf):
            for fut, rec, _gen, _born in buf:
                self._stats["oracle"] += 1
                fb_submit(rec, None, None, fut)
            buf.clear()

        def flush_waited():
            # tier entries that yielded blocks have waited on for
            # tier_wait yields: a tier block ahead of the queue, or the
            # host for too few to fill one
            for tag, buf, take_n, tier_cfg, stat in (
                    (_RETRY, retry_buf, R, cfg, "retried"),
                    (_DEEP, deep_buf, deep_take, cfg_deep, "deep_retried")):
                while buf and yielded - buf[0][3] >= tier_wait:
                    if len(buf) < retry_min:
                        host_all(buf)
                    else:
                        submit_tier(tag, buf, take_n, tier_cfg, stat,
                                    first=True)

        def refill_prep():
            # a block in prep on every prep thread, one queued behind them
            nonlocal exhausted
            flush_waited()
            while len(prep_q) < prep_threads + 1:
                # an accumulated retry/deep block is ready work: prefer it
                # over new input, and flush stragglers when the input and
                # the pipeline have drained
                drained = exhausted and not prep_q and not run_q
                if retry_enabled and retry_buf and (
                    len(retry_buf) >= retry_block
                    or (drained and len(retry_buf) >= retry_min)
                ):
                    submit_tier(_RETRY, retry_buf, R, cfg, "retried")
                    continue
                if deep_tier and deep_buf and (
                    len(deep_buf) >= deep_take
                    or (drained and len(deep_buf) >= retry_min)
                ):
                    submit_tier(_DEEP, deep_buf, deep_take, cfg_deep,
                                "deep_retried")
                    continue
                if exhausted:
                    break
                nxt = next(it, None)
                if nxt is None:
                    exhausted = True
                    continue
                key, recs = nxt
                prep_q.append(
                    (key, recs,
                     self._prep_exec.submit(self._prep_block, recs, R, cfg))
                )

        while True:
            refill_prep()
            while prep_q and len(run_q) < max_in_flight:
                key, recs, fut = prep_q.popleft()
                launched = self._launch_block(fut.result(), params)
                run_q.append((key, recs, launched))
                refill_prep()
            if not run_q:
                # too few for another device block: host fallback
                host_all(retry_buf)
                host_all(deep_buf)
                break
            key, recs, launched = run_q.popleft()
            out = [None] * len(recs)
            abandoned: set = set()
            deep: set = set()
            nohits: set = set()
            nohit_pend: list = []  # (fut, rec, i) for the batched probe
            tier = (
                key[0] if isinstance(key, tuple) and key
                and key[0] in (_RETRY, _DEEP) else None
            )
            escalated = self._collect_pool(
                recs, launched, out, abandoned, deep,
                count_stats=tier is None, nohit_out=nohits,
            )
            stash = launched[3]

            def route(i, rec, gen, born, fut=None):
                """Send one escalated read to retry/deep/host; returns the
                future resolving to its (hits, duration).  `born`: the
                yields before its input block's; one that has waited
                tier_wait yields goes to the host."""
                fits = (0 < len(rec.sequence) <= cfg.max_len
                        and yielded - born < tier_wait)
                # abandons exhausted their per-read cap and deep reads most
                # of it (the same config would spend it again): only
                # budget-starved reads re-run on the retry tier
                if (retry_enabled and gen < retry_gens and fits
                        and i not in abandoned and i not in deep):
                    fut = fut or Future()
                    retry_buf.append((fut, rec, gen + 1, born))
                    return fut
                nohit = i in nohits
                if (deep_tier and gen < deep_gens and fits
                        and not (deep_nohit_host and nohit)):
                    fut = fut or Future()
                    deep_buf.append((fut, rec, gen + 1, born))
                    return fut
                if deep_nohit_host and nohit:
                    self._stats["nohit_host"] = (
                        self._stats.get("nohit_host", 0) + 1
                    )
                self._stats["oracle"] += 1
                if nohit and nohit_probe and lazy_fallback:
                    # no-hit escalatees batch into interleaved exhaustion
                    # probes at block flush: most are proven hitless at a
                    # fraction of the exact search's memory stalls, the
                    # rest fall through to the exact search inside the
                    # same fallback task
                    fut = fut or Future()
                    nohit_pend.append((fut, rec, i))
                    return fut
                return fb_submit(rec, i, stash, fut)

            def flush_nohit():
                # one fallback-pool task per probe batch
                pb = int(os.environ.get("MAPAD_PROBE_BATCH", "16"))
                while nohit_pend:
                    chunk = nohit_pend[:pb]
                    del nohit_pend[:pb]
                    fb_pool.submit(self._probe_batch_entries, chunk, stash)

            if tier is not None:
                # retry/deep block: resolve the placeholder futures
                for j, (fut, rec, gen, born) in enumerate(key[1]):
                    if j in escalated:
                        route(j, rec, gen, born, fut)
                    else:
                        fut.set_result(out[j])
                flush_nohit()
                continue
            for i in escalated:
                fut = route(i, recs[i], 0, yielded)
                out[i] = fut if lazy_fallback else fut.result()
            flush_nohit()
            yield key, out
            yielded += 1

    def deep_tier_enabled(self) -> bool:
        """Deep tier default: on with a big (int64, genome-scale) index,
        off with a small one, as in mapad_tpu.  MAPAD_DEEP_TIER=1/0 forces
        either way."""
        env = os.environ.get("MAPAD_DEEP_TIER")
        if env is not None:
            return env == "1"
        return bool(self.device_index.big)

    def _deep_config(self, cfg: "PoolConfig | None" = None) -> "PoolConfig":
        """Deep-tier pool config, derived as mapad_tpu derives it: full
        width (the primary lanes and steps) with the per-read cap raised to
        min(steps, max(total_steps, lanes * cap / deep lanes)), one
        generation.  MAPAD_DEEP_LANES narrows it (L/2 lanes -> 2x steps at
        the same frame store) and then asks for MAPAD_DEEP_KGENS store
        generations (kernel K8; uncapped spill unless MAPAD_DEEP_SPILL), so a
        heavy read keeps its frontier across store fills up to its cap;
        MAPAD_DEEP_STEPS / MAPAD_DEEP_CAP override directly."""
        cfg = cfg or self.pool_config
        lanes = int(os.environ.get(
            "MAPAD_DEEP_LANES", str(max(32, cfg.lanes))
        ))
        # clamp overrides: no division by zero, no store larger than the
        # primary's
        lanes = max(1, min(lanes, cfg.lanes))
        steps = int(os.environ.get(
            "MAPAD_DEEP_STEPS",
            str(cfg.total_steps * max(1, cfg.lanes // lanes)),
        ))
        cap_budget = cfg.lanes * cfg.read_step_cap
        cap = int(os.environ.get(
            "MAPAD_DEEP_CAP",
            str(min(steps, max(cfg.total_steps, cap_budget // lanes))),
        ))
        kgens = int(os.environ.get("MAPAD_DEEP_KGENS", "4"))
        if cap + 4 > steps:
            kgens = 1
        return cfg._replace(
            lanes=lanes, total_steps=steps, read_step_cap=cap,
            generations=kgens,
            min_live=int(os.environ.get("MAPAD_KGENS_MIN_LIVE", "32")),
            spill_steps=int(os.environ.get("MAPAD_DEEP_SPILL", "0")),
        )

    def _host_bid_active(self) -> bool:
        """Host C++ Bi-D with the prepacked LUT/Bi-D rows.  Off by default
        with a big index (the Bi-D then runs on the card, kernel K7), as in
        mapad_tpu.  MAPAD_HOST_BID=1/0 forces either way."""
        from ..map import native_search

        env = os.environ.get("MAPAD_HOST_BID")
        if env == "0":
            return False
        if env is None and self.device_index.big:
            return False
        return native_search.available()

    def warm(self, records):
        """Build the kernels and run one block of every config a run can
        hit before timing starts: the primary one and, when the deep tier
        is on, the deep one."""
        self.search_chunk(records)
        if self.deep_tier_enabled():
            sub = records[: self.block_reads]
            launched = self._launch_block(
                self._prep_block(sub, self.block_reads,
                                 self._deep_config()),
                self._params(),
            )
            self._collect_pool(sub, launched, [None] * len(sub),
                               count_stats=False)

    def stats(self) -> dict:
        """A copy of the counts and stage seconds of the blocks run so far
        (the streaming driver logs it when a run ends)."""
        with self._stats_lock:
            return {k: type(v)(v) if isinstance(v, (dict, list)) else v
                    for k, v in self._stats.items()}

    @staticmethod
    def _stash_row(stash, i):
        """Single-read view of a block prep stash (index 0) for the
        fallback path, so fallbacks reuse the block's LUT/penalty rows."""
        if stash is None or i is None:
            return None
        if "_inv" in stash:
            i = int(stash["_inv"][i])  # input order -> dealt row (mesh)
        return dict(
            pattern_rank=stash["pattern_rank"][i : i + 1],
            pattern_code=stash["pattern_code"][i : i + 1],
            n=stash["n"][i : i + 1],
            score_lut=stash["score_lut"][i : i + 1],
            pen=stash["pen"][i : i + 1],
            split=stash["split"][i : i + 1],
            scale=stash["scale"][i : i + 1],
            thresh=stash["thresh"][i : i + 1],
            repr_mm=stash["repr_mm"][i : i + 1],
            max_len=stash["max_len"],
        )

    def _probe_batch_entries(self, entries, stash):
        """Fallback-pool task: interleaved no-hit exhaustion probes over
        one block's no-hit escalatees (`exhaust_probe_batch` of the host
        C++ searcher), then the exact search for every read the probe could
        not prove hitless.  entries: [(Future, record, block index)]."""
        t0 = time.perf_counter()
        try:
            searcher = self._ensure_native()

            def row_of(i):  # input order -> the stash's (dealt) row
                return int(stash["_inv"][i]) if "_inv" in stash else i

            batch, singles = [], []
            for e in entries:
                _, rec, i = e
                ln = len(rec.sequence)
                if (
                    searcher is not None
                    and stash is not None
                    and 0 < ln <= stash["max_len"]
                    and row_of(i) < len(stash["n"])
                    and int(stash["n"][row_of(i)]) == ln
                ):
                    batch.append(e)
                else:
                    singles.append(e)
            if batch:
                rows = [row_of(i) for _, _, i in batch]
                verdicts = searcher.probe_batch(
                    stash["pattern_rank"][rows],
                    stash["pattern_code"][rows],
                    stash["n"][rows], stash["score_lut"][rows],
                    stash["pen"][rows], stash["split"][rows],
                    stash["scale"][rows], stash["thresh"][rows],
                    self.parameters,
                    interleave=int(os.environ.get("MAPAD_PROBE_K", "4")),
                )
                probe_dt = time.perf_counter() - t0
                share = probe_dt / len(batch)
                if self.packed_hits:
                    from ..map.native_post import _EMPTY_PACKED

                    empty = _EMPTY_PACKED
                else:
                    empty = []
                n_empty = sum(1 for v in verdicts if v == 0)
                with self._stats_lock:
                    self._stats["fb_secs"] += probe_dt
                    self._stats["probe_empty"] = (
                        self._stats.get("probe_empty", 0) + n_empty
                    )
                for (fut, rec, i), v in zip(batch, verdicts):
                    if v == 0:
                        fut.set_result((empty, share))
                    else:
                        fut.set_result(self._fallback_one(
                            rec, self._stash_row(stash, i)))
            for fut, rec, i in singles:
                fut.set_result(self._fallback_one(
                    rec, self._stash_row(stash, i)))
        except Exception as e:  # a hung future would stall the stream
            for fut, _, _ in entries:
                if not fut.done():
                    fut.set_exception(e)

    def _prep_block(self, chunk, R, cfg):
        """Host-side preparation of one pool invocation (prep thread).  With
        a mesh the block is dealt round-robin into the shards' contiguous
        slices and each slice prepared as its shard's invocation; the stash
        holds the whole dealt block, with `_inv` to find a read's row."""
        t0 = time.perf_counter()
        perm = None
        if self.mesh is not None:
            require(R % self.n_shards == 0,
                    f"reads {R} must divide mesh size {self.n_shards}")
            # positional correlation in the input makes a contiguous split
            # step-imbalanced; the collect un-deals with the same perm
            perm = round_robin_permutation(R, self.n_shards)
            ext = list(chunk) + [_EMPTY] * (R - len(chunk))
            chunk = [ext[int(p)] for p in perm]
        # size the pattern axis to the block's longest read, rounded up to
        # 16 (fewer LUT cells and shorter c_ops rows for short reads)
        mlen = max((len(r.sequence) for r in chunk), default=1)
        m_fit = min(cfg.max_len, max(16, -(-mlen // 16) * 16))
        # per-read XD timing from per-read step counts; MAPAD_XD_STEPS=0
        # turns K2's step log off and tags every read of the block with the
        # block's average
        cfg = cfg._replace(
            max_len=m_fit,
            track_read_steps=os.environ.get("MAPAD_XD_STEPS", "1") != "0")
        recs = [r if len(r.sequence) <= cfg.max_len else _EMPTY
                for r in chunk]
        host_bid = self._host_bid_active()
        if perm is None:
            prep = self._prepare(recs, cfg.max_len, R, host_bid=host_bid)
        else:
            Rl = R // self.n_shards
            shards = [
                self._prepare(recs[lo : lo + Rl], cfg.max_len, Rl,
                              host_bid=host_bid)
                for lo in range(0, R, Rl)
            ]
            stash = _merge_stashes([p.pop("_stash") for p in shards], Rl)
            stash["_inv"] = np.argsort(perm)
            prep = dict(shards=shards, _stash=stash)
        with self._stats_lock:  # prep threads finish at once
            self._stats["prep_s"] += time.perf_counter() - t0
        return cfg, prep, t0

    def _device_exec(self):
        if getattr(self, "_dev_exec", None) is None:
            self._dev_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pool-device"
            )
        return self._dev_exec

    def _run_block(self, cfg, prep, params, shard=None):
        """Device thread, or shard `shard`'s thread (`ShardRunner`: its
        device and stream are current): upload + K4 (or K6 + K7), K2 + K3
        into K3's one allocation, K5 on it (`_pack_buffer`; a shard's read
        ids made global in the same launch) and the async copy of the
        packed result into pinned host memory on a side stream.  Returns
        (result spec, host buffer, copy-done event or None); the spec comes
        from the shapes: no PoolResult is made.  The step loop polls the
        card, so this thread's busy time is close to the card's time for
        the invocation (`_stats["device_s"]`, summed over the shards)."""
        t0 = time.perf_counter()
        if shard is None:
            dev, on_dev = self.device, self._on_device()
            copy_stream = getattr(self, "_copy_stream", None)
            index, rebase = self.device_index, None
        else:
            dev, on_dev = self.mesh[shard], contextlib.nullcontext()
            copy_stream = self._shards.streams[shard][1]
            index = self._mesh_index[shard]
        with on_dev:
            consts, kw = self._upload(prep, dev)
            R = prep["L"]
            if shard is not None:
                rebase = (shard * R, R, self.n_shards * R)
            buf = k_mismatch_search_pool2(index, *consts, params, cfg,
                                          views=False, **kw)
            packed = _pack_buffer(buf, cfg, R, index.big, rebase)
            spec = _buffer_spec(cfg.lanes, cfg.max_chains, cfg.max_len + 16,
                                R, index.big)
            if dev.type != "cuda":
                out = spec, packed.numpy(), None
            else:
                host = torch.empty(packed.shape, dtype=torch.int32,
                                   pin_memory=True)
                copy_stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(copy_stream):
                    host.copy_(packed, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(copy_stream)
                packed.record_stream(copy_stream)
                out = spec, host, done
        with self._stats_lock:
            self._stats["device_s"] += time.perf_counter() - t0
        return out

    def _launch_block(self, prepped, params):
        """Queue one prepared invocation on the device thread, or each
        shard's part on that shard's thread."""
        cfg, prep, t0 = prepped
        stash = prep.pop("_stash", None)
        if "shards" in prep:
            fut = [self._shards.submit(d, self._run_block, cfg, p, params,
                                       d)
                   for d, p in enumerate(prep["shards"])]
        else:
            fut = self._device_exec().submit(self._run_block, cfg, prep,
                                             params)
        return fut, None, t0, stash

    def _fetch(self, fut):
        """Wait for one invocation's copy -> numpy PoolResult; a sharded
        one's fields stacked along a leading shard axis."""
        if isinstance(fut, list):
            parts = [self._fetch(f) for f in fut]
            return PoolResult(*[None if f[0] is None else np.stack(f)
                                for f in zip(*parts)])
        spec, host, done = fut.result()
        if done is not None:
            done.synchronize()
            host = host.numpy()
        return _unpack_result(spec, host)

    def _collect_pool(self, chunk, launched, out,
                      abandoned_out: set | None = None,
                      deep_out: set | None = None,
                      count_stats: bool = True,
                      nohit_out: set | None = None):
        """Wait for one invocation's result, decode its chains into `out`
        and return the set of escalated read indexes (by cause in
        `_stats["esc_why"]` when count_stats, except with a mesh, as in
        mapad_tpu).  For the tiers' routing the optional sets receive: reads
        abandoned at the per-read cap, reads that spent
        MAPAD_RETRY_DEEP_FRAC of it, and escalated reads with no hit so
        far."""
        fut, _, t0, stash = launched
        t_fetch = time.perf_counter()
        result = self._fetch(fut)
        t_dec = time.perf_counter()
        self._stats["wait_s"] += t_dec - t_fetch
        collect = (self._collect_pool_sharded if result.c_read.ndim == 2
                   else self._decode_pool)
        return collect(chunk, result, out, t_dec - t0, stash, abandoned_out,
                       deep_out, count_stats, nohit_out)

    def _decode_pool(self, chunk, result, out, elapsed, stash,
                     abandoned_out: set | None = None,
                     deep_out: set | None = None,
                     count_stats: bool = True,
                     nohit_out: set | None = None):
        """Decode one invocation's numpy result (over the reads of `chunk`,
        `elapsed` seconds since its prep began) into `out`; returns the
        escalated read indexes (see `_collect_pool`)."""
        t_dec = time.perf_counter()
        per_read = elapsed / max(len(chunk), 1)
        read_time = None
        if result.read_steps is not None and result.read_steps.size:
            rs = np.asarray(result.read_steps)
            if (rs >= 0).any():
                step_time = elapsed / max(int(result.steps), 1)
                read_time = np.where(rs >= 0, rs * step_time, per_read)
        splits = [
            self.parameters.difference_model.find_alignment_start(
                len(r.sequence)
            )
            for r in chunk
        ]

        escalated = set(
            i for i in range(len(chunk))
            if len(chunk[i].sequence) > self.pool_config.max_len
        )
        no_causes = {"overlong": 0, "overflow": 0, "unfinished": 0,
                     "undispatched": 0, "abandon": 0, "bid_rle": 0}
        esc_why = (self._stats.setdefault("esc_why", no_causes)
                   if count_stats else no_causes)
        esc_why["overlong"] += len(escalated)
        esc_why["bid_rle"] += _inject_pre_escalate(
            stash, len(chunk), escalated, abandoned_out, nohit_out
        )
        n_chains = int(result.n_chains)
        if n_chains > result.c_read.shape[0]:
            # chain log overflow: cannot attribute hits safely
            pre = len(escalated)
            escalated.update(
                i for i in range(len(chunk)) if len(chunk[i].sequence) > 0
            )
            esc_why["overflow"] += len(escalated) - pre
            logger.warning("pool chain log overflow (%d chains)", n_chains)
        else:
            pre = len(escalated)
            for rid in result.lane_read[result.lane_unfinished]:
                if rid < len(chunk):
                    escalated.add(int(rid))
            esc_why["unfinished"] += len(escalated) - pre
            pre = len(escalated)
            for rid in range(int(result.next_read), len(chunk)):
                escalated.add(rid)
            esc_why["undispatched"] += len(escalated) - pre

            # group chains by read (descending slot == completion order);
            # abandon markers escalate their read
            cr = result.c_read[:n_chains]
            valid = (cr >= 0) & (cr < len(chunk))
            ab = result.c_abandon[:n_chains] & valid
            pre = len(escalated)
            ab_reads = np.unique(cr[ab]).tolist()
            escalated.update(ab_reads)
            esc_why["abandon"] += len(escalated) - pre
            if abandoned_out is not None:
                abandoned_out.update(int(r) for r in ab_reads)
            idx = np.flatnonzero(valid & ~result.c_abandon[:n_chains])
            ordk = idx[np.lexsort((-result.c_slot[idx], cr[idx]))]
            crs = cr[ordk]
            rid_range = np.arange(len(chunk))
            starts = np.searchsorted(crs, rid_range)
            ends = np.searchsorted(crs, rid_range, side="right")
            if nohit_out is not None:
                nohit_out.update(
                    i for i in escalated if starts[i] == ends[i]
                )
            if self.packed_hits:
                from ..map.native_post import _EMPTY_PACKED, PackedHits

                ivals_all = np.stack(
                    [
                        result.c_lower[ordk].astype(np.int64),
                        result.c_lrev[ordk].astype(np.int64),
                        result.c_size[ordk].astype(np.int64),
                    ],
                    axis=1,
                )
                scores_all = result.c_score[ordk].astype(np.float32)
                ops_all = result.c_ops[ordk].astype(np.uint32, copy=False)
            for i, record in enumerate(chunk):
                if i in escalated:
                    continue
                s, e = starts[i], ends[i]
                if self.packed_hits:
                    hits = (
                        PackedHits(ivals_all[s:e], scores_all[s:e],
                                   ops_all[s:e], splits[i])
                        if e > s else _EMPTY_PACKED
                    )
                else:
                    hits = [
                        self._decode_chain(result, int(k), splits[i])
                        for k in ordk[s:e]
                    ]
                out[i] = (
                    hits,
                    float(read_time[i]) if read_time is not None
                    else per_read,
                )

        if deep_out is not None:
            # escalated reads that already spent most of their per-read cap
            # are deep: a same-config retry would spend a full cap again
            frac = float(os.environ.get("MAPAD_RETRY_DEEP_FRAC", "0.5"))
            thr = max(1, int(self.pool_config.read_step_cap * frac))
            if result.read_steps is not None and result.read_steps.size:
                rs_a = np.asarray(result.read_steps)
                deep_out.update(
                    i for i in escalated
                    if i < rs_a.shape[0] and int(rs_a[i]) >= thr
                )
            else:
                deep_out.update(
                    int(rid)
                    for rid in result.lane_read[result.lane_unfinished]
                    if rid < len(chunk)
                )
        self._stats["decode_s"] += time.perf_counter() - t_dec
        self._stats["steps"] += int(result.steps)
        if count_stats:
            self._stats["device_lanes"] += len(chunk)
            self._stats["escalated"] += len(escalated)
            self._stats["batches"] += 1
        return escalated

    def _collect_pool_sharded(self, chunk, result, out, elapsed, stash,
                              abandoned_out=None, deep_out=None,
                              count_stats: bool = True, nohit_out=None):
        """Collect a sharded result (leading shard axis), as
        `_collect_pool_sharded` of mapad_tpu does: shard d owns dealt rows
        [d*R/D, (d+1)*R/D) of the block's round-robin deal (`_prep_block`)
        and decodes as one invocation (its reads' XD from its own step
        time); hits and the escalated, abandoned, deep and no-hit sets are
        then un-dealt to input order.  Per-cause escalation counts are not
        kept in this mode (the shards decode with count_stats=False)."""
        D, R_local = result.read_steps.shape
        R = D * R_local
        perm = round_robin_permutation(R, D)
        ext = list(chunk) + [_EMPTY] * (R - len(chunk))
        dealt = [ext[int(p)] for p in perm]
        out_d = [None] * R
        sets_d = [set(), set(), set(), set()]  # esc, abandon, deep, no-hit
        for d in range(D):
            lo = d * R_local
            sub_out = [None] * R_local
            ab_l, deep_l, nh_l = set(), set(), set()
            esc = self._decode_pool(
                dealt[lo : lo + R_local],
                _local_view(result, d, lo, R, R_local), sub_out, elapsed,
                None, ab_l, deep_l, count_stats=False, nohit_out=nh_l,
            )
            out_d[lo : lo + R_local] = sub_out
            for acc, local in zip(sets_d, (esc, ab_l, deep_l, nh_l)):
                acc.update(lo + i for i in local)

        n = len(chunk)
        escalated = set()
        for j in range(R):
            oi = int(perm[j])
            if oi >= n:
                continue
            out[oi] = out_d[j]
            for acc, dst in zip(sets_d, (escalated, abandoned_out, deep_out,
                                         nohit_out)):
                if dst is not None and j in acc:
                    dst.add(oi)
        # reads the prep neutralized (Bi-D RLE overflow) are rows of the
        # dealt block: through the deal to input order (mapad_tpu injects
        # the dealt rows as input indexes, so another read goes to the
        # host in their place)
        pre = None if stash is None else stash.get("pre_escalate")
        if pre is not None:
            _inject_pre_escalate({"pre_escalate": perm[pre]}, n, escalated,
                                 abandoned_out, nohit_out)
        if count_stats:
            self._stats["device_lanes"] += n
            self._stats["escalated"] += len(escalated)
            self._stats["batches"] += 1
        # per-shard steps: total / (D x slowest) is the split's efficiency
        acc = self._stats.setdefault("shard_steps", [0] * D)
        for d, st in enumerate(np.asarray(result.steps).reshape(-1)):
            acc[d] += int(st)
        return escalated

    def _decode_chain(self, result, k, split):
        return HitInterval(
            BiInterval(int(result.c_lower[k]), int(result.c_lrev[k]),
                       int(result.c_size[k])),
            np.float32(result.c_score[k]),
            _track(result.c_ops[k], split),
        )

    # --- fixed-batch tiered path (mode="batch") ---

    def _search_chunk_batch(self, records):
        """The reads through the tiers in fixed batches: a tier's batches
        are all queued on the card before the first is collected; its
        escalatees are the next tier's reads, and the last tier's go to the
        exact host searcher, whose pool runs while batches are collected."""
        out = [None] * len(records)
        params = self._params()
        self._ensure_native()
        workers = max(1, (os.cpu_count() or 2) - 1)
        fallback = []  # (read index, Future)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = list(range(len(records)))
            for tier_i, (max_steps, tier_lanes) in enumerate(self.tiers):
                if not pending:
                    break
                tier_t0 = time.perf_counter()
                tier_count = len(pending)
                lanes = tier_lanes if tier_lanes is not None else self.lanes
                config = self.config._replace(max_steps=max_steps)
                last_tier = tier_i == len(self.tiers) - 1
                in_flight = []
                for base in range(0, len(pending), lanes):
                    idxs = pending[base : base + lanes]
                    batch = [records[i] for i in idxs]
                    in_flight.append(
                        (idxs, batch,
                         self._dispatch_batch(batch, params, config, lanes))
                    )
                still_pending = []
                for idxs, batch, handle in in_flight:
                    results, escalated = self._collect_batch(batch, *handle)
                    for k, i in enumerate(idxs):
                        if k not in escalated:
                            out[i] = results[k]
                        elif last_tier:
                            fallback.append((i, pool.submit(
                                self._fallback_one, records[i])))
                        else:
                            still_pending.append(i)
                pending = still_pending
                logger.info(
                    "tier %d (S=%d): %d reads in %.1fs, %d escalated",
                    tier_i, max_steps, tier_count,
                    time.perf_counter() - tier_t0,
                    len(still_pending) + (len(fallback) if last_tier else 0),
                )
            for i in pending:  # only when the tier list is empty
                fallback.append((i, pool.submit(self._fallback_one,
                                                records[i])))
            for i, fut in fallback:
                out[i] = fut.result()
        self._stats["oracle"] += len(fallback)
        return out

    def _on_device(self):
        """The engine's device and stream as the current ones (the card)."""
        stack = contextlib.ExitStack()
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _dispatch_batch(self, batch, params, config, lanes=None):
        """Prep one batch on the host, upload it and queue K7 + K10 ->
        (SearchResult on the engine's device, splits, overlong read
        indexes, start time).  Reads longer than `max_len` enter the batch
        empty and escalate."""
        t0 = time.perf_counter()
        max_len = config.max_len
        overlong = {
            i for i, r in enumerate(batch) if len(r.sequence) > max_len
        }
        with self._on_device():
            prep = self._prepare(
                [r if len(r.sequence) <= max_len else _EMPTY for r in batch],
                max_len, lanes, host_bid=False, dense=True,
            )
            stash, d = prep["_stash"], prep["dense"]
            self._stats["prep_s"] += time.perf_counter() - t0
            handle = k_mismatch_search_batch(
                self.device_index, d["pattern_rank"], d["pattern_code"],
                d["n"], d["score_lut"], d["pen"], d["split"], d["scale"],
                d["thresh"], d["repr_mm"], params, config,
                bid_steps=(int(stash["split"].max(initial=0)),
                           int((stash["n"] - stash["split"]).max(initial=0))),
            )
        return handle, stash["split"], overlong, t0

    def _collect_batch(self, batch, handle, split_arr, overlong, t0):
        """Wait for one batch's result and decode it -> (per-read (hits,
        seconds) or None, escalated indexes)."""
        t_fetch = time.perf_counter()
        with self._on_device():
            result = SearchResult(*[t.cpu().numpy() for t in handle])
        t_dec = time.perf_counter()
        self._stats["wait_s"] += t_dec - t_fetch
        per_read = (t_dec - t0) / max(len(batch), 1)
        # a lane with more completions than hit slots kept only the first
        # H: its read goes on like an escalatee (mapad_tpu's decoder fails
        # on it instead)
        overflow = result.hcount > result.h_ops.shape[1]
        results = []
        escalated = set()
        for i, record in enumerate(batch):
            if i in overlong or (len(record.sequence) > 0 and (
                    result.escalate[i] or overflow[i])):
                escalated.add(i)
                results.append(None)
            else:
                hits = self._extract_hits(result, i, int(split_arr[i]))
                results.append((hits, per_read))
        self._stats["decode_s"] += time.perf_counter() - t_dec
        self._stats["steps"] += int(result.steps)
        self._stats["device_lanes"] += len(batch)
        self._stats["escalated"] += len(escalated)
        self._stats["batches"] += 1
        if escalated:
            logger.debug("escalating %d/%d reads to the next tier",
                         len(escalated), len(batch))
        return results, escalated

    def _extract_hits(self, result, lane: int, split: int):
        """One lane's hits of a SearchResult (numpy): decoded tracks, or
        PackedHits with packed_hits."""
        if self.packed_hits:
            return self._packed_lane_hits(result, lane, split)
        return [
            HitInterval(
                BiInterval(int(result.h_lower[lane, h]),
                           int(result.h_lrev[lane, h]),
                           int(result.h_size[lane, h])),
                np.float32(result.h_score[lane, h]),
                _track(result.h_ops[lane, h], split),
            )
            for h in range(int(result.hcount[lane]))
        ]

    def _packed_lane_hits(self, result, lane, split):
        from ..map.native_post import _EMPTY_PACKED, PackedHits

        hcount = int(result.hcount[lane])
        if hcount == 0:
            return _EMPTY_PACKED
        ivals = np.stack(
            [result.h_lower[lane, :hcount], result.h_lrev[lane, :hcount],
             result.h_size[lane, :hcount]],
            axis=1,
        ).astype(np.int64)
        return PackedHits(
            ivals,
            result.h_score[lane, :hcount].astype(np.float32),
            result.h_ops[lane, :hcount].astype(np.uint32, copy=False),
            int(split),
        )

    def _ensure_native(self):
        from ..map import native_search

        if getattr(self, "_native_searcher", None) is None:
            self._native_searcher = (
                native_search.NativeSearcher(self.fmd)
                if native_search.available()
                else None
            )
        return self._native_searcher

    def _native_bid(self):
        from ..map import native_search

        with self._prep_lock:
            if getattr(self, "_native_bid_cache", None) is None:
                self._native_bid_cache = native_search.NativeBiD(self.fmd)
            return self._native_bid_cache

    def _bid_exec(self):
        """One thread runs the C++ Bi-D (itself threaded) for every prep
        thread, one block after the other."""
        with self._prep_lock:
            if getattr(self, "_bid_exec_cache", None) is None:
                self._bid_exec_cache = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="bid"
                )
            return self._bid_exec_cache

    def _lut_cache(self):
        """Per-length LUT table cache (None when the model has no
        vectorized raw_grid -- then the direct grid build is faster).  Its
        `fill` may run on several prep threads: a table is a pure function
        of its length, so two threads that build one build the same."""
        with self._prep_lock:
            cache = getattr(self, "_lut_cache_obj", False)
            if cache is False:
                cache = self._lut_cache_obj = (
                    _LutCache(self.parameters.difference_model,
                              self.parameters)
                    if _LutCache.usable(self.parameters.difference_model)
                    else None
                )
            return cache

    def _device_lut(self, dev=None):
        """One-time all-length score-LUT table, penalty table and
        per-length offsets on `dev` (the engine's device by default; each
        shard's device with a mesh) for K4 and K6.  The host build is
        memoized across engines on the model's scalar parameters."""
        dev = canonical(self.device if dev is None else dev)
        with self._lut_lock:  # shard threads ask at once
            return self._device_lut_locked(dev)

    def _device_lut_locked(self, dev):
        ent = self._dev_lut_by_dev.get(dev)
        if ent is None:
            sdm = self.parameters.difference_model
            attrs = tuple(
                (k, str(v))
                for k, v in sorted(vars(sdm).items())
                if isinstance(
                    v, (str, bool, int, float, tuple,
                        np.floating, np.integer)
                )
            )
            p = self.parameters
            key = (
                type(sdm).__name__, attrs,
                str(np.float32(p.penalty_gap_extend)),
                int(p.gap_dist_ends), self.config.max_len, _DEV_LUT_Q,
            )
            host = _DEV_LUT_MEMO.get(key)
            if host is None:
                t0 = time.perf_counter()
                host = _DEV_LUT_MEMO[key] = _build_all_lut(
                    sdm, p, self.config.max_len
                )
                logger.debug(
                    "device LUT table: %d rows built in %.1fs",
                    host[0].shape[0], time.perf_counter() - t0,
                )
            ent = self._dev_lut_by_dev[dev] = tuple(
                torch.from_numpy(h).to(dev) for h in host
            )
        return ent

    def _fallback_one(self, record, stash=None):
        """Exact host C++ search of one escalated read -> (hits, seconds).
        `stash` is the read's row of its block's prep (`_stash_row`)."""
        searcher = self._ensure_native()
        t1 = time.perf_counter()
        ln = len(record.sequence)
        if ln == 0:
            hits = []
        elif searcher is None:
            # no C++ compiler: the sequential Python search
            from ..map.oracle import k_mismatch_search

            hits = k_mismatch_search(record.sequence, record.base_qualities,
                                     self.parameters, self.fmd)
        elif (
            stash is not None
            and ln <= stash["max_len"]
            and int(stash["n"][0]) == ln
        ):
            # reuse the block's prepped LUT/penalty rows (identical f32)
            hits = searcher.search(
                stash["pattern_rank"][0], stash["pattern_code"][0], ln,
                stash["score_lut"][0], stash["pen"][0],
                int(stash["split"][0]), stash["scale"][0],
                stash["thresh"][0], stash["repr_mm"][0],
                self.parameters, packed=self.packed_hits,
            )
        else:
            hits = self._native_search(searcher, record)
        dt = time.perf_counter() - t1
        with self._stats_lock:  # total exact-fallback core-seconds
            self._stats["fb_secs"] += dt
        return hits, dt

    def _native_search(self, searcher, record):
        sdm = self.parameters.difference_model
        mb = self.parameters.mismatch_bound
        seq = np.frombuffer(bytes(record.sequence), dtype=np.uint8)
        quals = np.frombuffer(bytes(record.base_qualities), dtype=np.uint8)
        ln = len(seq)
        score_lut, pen = _batch_luts(
            sdm, self.parameters, seq[None, :], quals[None, :],
            np.asarray([ln], dtype=np.int32),
        )
        if isinstance(mb, Continuous):
            scale, thresh = mb._scale_read_length(ln), mb.cutoff
        else:
            scale, thresh = np.float32(1.0), mb.threshold_for_length(ln)
        repr_mm = (
            np.float32(-np.inf) if isinstance(mb, TestBound)
            else mb.representative_mismatch_penalty
        )
        return searcher.search(
            _RANK_TABLE[seq].astype(np.uint8), BASE_TO_CODE[seq], ln,
            score_lut[0], pen[0], sdm.find_alignment_start(ln),
            scale, thresh, repr_mm, self.parameters,
            packed=self.packed_hits,
        )


def _merge_stashes(stashes, r_local):
    """The shards' host stashes as one stash of the whole dealt block (shard
    d's rows at [d*r_local, (d+1)*r_local))."""
    out = {k: np.concatenate([st[k] for st in stashes])
           for k in stashes[0] if k not in ("max_len", "pre_escalate")}
    out["max_len"] = stashes[0]["max_len"]
    pre = [st["pre_escalate"] + d * r_local
           for d, st in enumerate(stashes) if "pre_escalate" in st]
    if pre:
        out["pre_escalate"] = np.concatenate(pre)
    return out


class HybridSearchEngine:
    """Device pool + host native threads working each chunk concurrently
    (`HybridSearchEngine` of mapad_tpu, the default engine of `map`).

    The card runs the pool search on the head of every block while the host
    cores run the exact native searcher on its tail.  The split fraction
    adapts to the measured throughputs of the two sides, so they finish
    together whatever the balance of the hardware.  Both sides are exact,
    so the merged output is too.  `device_kw` goes to the
    `DeviceSearchEngine` (mode, pool_config, big, device, ...).
    """

    def __init__(self, fmd_index, parameters, lanes: int = 2048,
                 threads: int | None = None, device_fraction: float = 0.6,
                 packed_hits: bool = False, **device_kw):
        from ..map import native_search

        self.device = DeviceSearchEngine(
            fmd_index, parameters, lanes=lanes, packed_hits=packed_hits,
            **device_kw
        )
        self.packed_hits = packed_hits
        self.native = None
        if native_search.available():
            # leave cores free for the device pipeline's host side (LUT
            # prep, result collection, escalation fallbacks): saturating
            # every core with native search starves the card
            if threads is None:
                threads = max(1, (os.cpu_count() or 2) - 2)
            self.native = native_search.NativeSearchEngine(
                fmd_index, parameters, threads=threads,
                packed_hits=packed_hits,
            )
        else:
            logger.warning(
                "native searcher unavailable; hybrid engine runs device-only"
            )
        self._p = device_fraction
        self._stats = self.device._stats
        # reads each side searched (search_stream and search_chunk)
        self._stats.update(hybrid_device_reads=0, hybrid_native_reads=0)

    @property
    def block_reads(self) -> int:
        return self.device.block_reads

    def warm(self, records):
        self.device.warm(records)

    def stats(self) -> dict:
        """The device engine's counts and stage seconds, the reads each
        side searched and the device fraction reached."""
        return dict(self.device.stats(), device_fraction=self._p)

    def search_stream(self, blocks, lazy_fallback: bool = False):
        """Streaming hybrid: each block's tail (the 1-p fraction) runs on
        the native host engine concurrently with the device stream handling
        the head; p adapts to the measured per-side throughputs: the device
        side runs the whole wall clock (cumulative device reads / wall
        seconds) while the native side's capacity is its completed reads
        over its busy seconds, so a poor initial device_fraction corrects
        toward the ratio that makes both sides finish together."""
        if self.native is None:
            yield from self.device.search_stream(
                blocks, lazy_fallback=lazy_fallback
            )
            return
        nat_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="hybrid-native"
        )
        pending: dict = {}
        done = {"dev": 0, "nat": 0}
        nat_busy = [0.0]
        t_start = time.perf_counter()

        def _hashable(k):
            try:
                hash(k)
                return True
            except TypeError:
                return False

        def nat_search(recs):
            t0 = time.perf_counter()
            out = self.native.search_chunk(recs)
            nat_busy[0] += time.perf_counter() - t0
            return out

        def split():
            for key, recs in blocks:
                n = len(recs)
                k = n if n < 256 else max(1, min(n, int(n * self._p)))
                fut = nat_pool.submit(nat_search, recs[k:]) if k < n else None
                pending[id(key) if not _hashable(key) else key] = (k, fut)
                yield key, recs[:k]

        try:
            for key, dev_out in self.device.search_stream(
                split(), lazy_fallback=lazy_fallback
            ):
                k, fut = pending.pop(
                    id(key) if not _hashable(key) else key
                )
                done["dev"] += k
                self._stats["hybrid_device_reads"] += k
                if fut is None:
                    yield key, dev_out
                    continue
                nres = fut.result()
                done["nat"] += len(nres)
                self._stats["hybrid_native_reads"] += len(nres)
                wall = time.perf_counter() - t_start
                if done["dev"] + done["nat"] >= 1024 and nat_busy[0] > 0.05:
                    rate_dev = done["dev"] / wall
                    rate_nat = done["nat"] / nat_busy[0]
                    p_obs = rate_dev / max(rate_dev + rate_nat, 1e-9)
                    self._p = min(0.95, max(0.05, 0.5 * self._p + 0.5 * p_obs))
                    logger.debug(
                        "hybrid stream: device %.0f r/s, native %.0f r/s "
                        "(busy %.1fs of %.1fs), p -> %.2f",
                        rate_dev, rate_nat, nat_busy[0], wall, self._p,
                    )
                yield key, list(dev_out) + list(nres)
        finally:
            nat_pool.shutdown(wait=False)

    def search_chunk(self, records, lazy_fallback: bool = False):
        n = len(records)
        if self.native is None or n < 256:
            self._stats["hybrid_device_reads"] += n
            return self.device.search_chunk(records, lazy_fallback)
        k = max(1, min(n - 1, int(n * self._p)))
        dev_part, nat_part = records[:k], records[k:]
        with ThreadPoolExecutor(max_workers=1) as ex:
            t0 = time.perf_counter()
            fut = ex.submit(self._timed, self.native.search_chunk, nat_part)
            dres = self.device.search_chunk(dev_part, lazy_fallback)
            dev_dt = time.perf_counter() - t0
            nres, nat_dt = fut.result()
        self._stats["hybrid_device_reads"] += k
        self._stats["hybrid_native_reads"] += n - k
        rd = k / max(dev_dt, 1e-6)
        rn = (n - k) / max(nat_dt, 1e-6)
        new_p = rd / (rd + rn)
        self._p = min(0.95, max(0.05, 0.5 * self._p + 0.5 * new_p))
        logger.debug(
            "hybrid split: device %d@%.0f r/s, native %d@%.0f r/s, p -> %.2f",
            k, rd, n - k, rn, self._p,
        )
        return list(dres) + list(nres)

    @staticmethod
    def _timed(fn, part):
        t0 = time.perf_counter()
        out = fn(part)
        return out, time.perf_counter() - t0
