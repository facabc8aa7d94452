"""Batched FMD-index rank queries and extension on the card (kernel K1).

Counterpart of mapad_tpu/ops/fm.py (reference src/map/fmd_index.rs:108-182).
Layout: one fused int32 row per BWT block --
  row[0:6]    exclusive-prefix occ checkpoint counts for ranks 0..5
  row[6:128]  BWT symbol ranks packed 8 per int32 (4 bits each)
so one 512 B row answers the rank query for all four DNA symbols (k = 976
symbols per row).  The rows of the doubled 8 Mbp bench text are ~4.2 MB and
stay in the H100's 50 MB L2.

Big mode (`big=True`, automatic for texts of 2^31-1 symbols or more, e.g.
a doubled human reference): the counts need 64 bits, so a row is
  row[0:6] | row[6:12]   checkpoint counts as int32 lo / hi words
  row[12:128]            packed symbols (k = 928 per row)
still one 512 B row per query; `less` and `sentinels` are int64 and every
interval (lower, lower_rev, size) is int64.

K1 replaces `_row_occ4` / `extend_batch` (mapad_tpu/ops/fm.py:149-229):
on the card it is the warp-cooperative `__device__` function `occ4_warp` of
csrc/common.cuh, called inline by the pool search (csrc/pool_search.cu);
`extend_batch` below launches its thin `__global__` wrapper so the function
can be checked alone.  Its launch count (`extend_batch`, `extend_batch_i64`)
takes one for every launch of a kernel that runs it: the thin wrapper here,
each generation's launch of the pool search, the Bi-D walk kernel.  Bound
on the card: one 512 B row read per interval end (2 per lane) -- bytes,
L2-resident; a warp (or half a warp, `occ4_pair`: the pool search ranks
both ends at once) loads the row at once and counts its words with SWAR
nibble compares, then a butterfly sums them.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from .._build import LAUNCHES, check, cuda_function, require

ROW_WORDS = 128
N_CP = 6
OCC_K = (ROW_WORDS - N_CP) * 8  # 976 symbols per fused row
N_CP_BIG = 12
OCC_K_BIG = (ROW_WORDS - N_CP_BIG) * 8  # 928 symbols per big-mode row
# rows packed at once by `from_host`: 30 MB of symbols, ~250 MB of
# temporaries
PACK_CHUNK_ROWS = 1 << 15


def resolve_device(device) -> torch.device:
    """The card unless the caller names another device; raises when CUDA
    is asked for (or defaulted to) and no card is there."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels"
        )
    return device


class DeviceFmIndex(NamedTuple):
    """FMD-index arrays on the engine's device (int32 intervals; int64
    with `big`)."""

    rows: torch.Tensor  # (nb, 128) int32 fused occ+bwt rows
    less: torch.Tensor  # (A,) int32 / int64
    sentinels: torch.Tensor  # (2,) int32 / int64
    occ_k: int
    text_len: int
    big: bool = False

    @property
    def idx_dtype(self) -> torch.dtype:
        return torch.int64 if self.big else torch.int32

    @property
    def n_cp_cols(self) -> int:
        return N_CP_BIG if self.big else N_CP

    @classmethod
    def from_numpy(cls, rows, less, sentinels, occ_k: int, text_len: int,
                   big: bool = False, device=None) -> "DeviceFmIndex":
        """Take the arrays of the JAX package's DeviceFmIndex as numpy and
        put them on `device` (default: the card)."""
        device = resolve_device(device)
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        require(rows.ndim == 2 and rows.shape[1] == ROW_WORDS,
                f"fused index rows must be (nb, {ROW_WORDS}) int32")
        idt = np.int64 if big else np.int32
        return cls(
            rows=torch.from_numpy(rows.copy()).to(device),
            less=torch.from_numpy(
                np.asarray(less, dtype=np.int64).astype(idt)
            ).to(device),
            sentinels=torch.from_numpy(
                np.asarray(sentinels, dtype=np.int64).astype(idt)
            ).to(device),
            occ_k=int(occ_k),
            text_len=int(text_len),
            big=bool(big),
        )

    @classmethod
    def from_host(cls, fmd, occ_k: int | None = None,
                  big: bool | None = None,
                  device=None) -> "DeviceFmIndex":
        """Build from a host FmdIndex (index/fmd.py): the same fused rows as
        mapad_tpu/ops/fm.py:58-136, read from and written to the same
        `device_rows_k976.npy` (big: `device_rows_k928_big.npy`) cache next
        to the index bundle, and put them on `device` (default: the card).
        `big` defaults to automatic: int64 mode iff the text needs it.

        The rows are made PACK_CHUNK_ROWS at a time, straight into the one
        table on `device`: the host holds a chunk of the BWT and of the
        rows at once, never a whole-text copy (a genome-scale text is
        billions of symbols; the reference packs it as one uint32 array)."""
        n = len(fmd.bwt)
        if big is None:
            big = n >= 2**31 - 1
        device = resolve_device(device)
        k = occ_k or (OCC_K_BIG if big else OCC_K)
        assert k % 8 == 0
        nb = (n + k - 1) // k
        cache_dir = getattr(fmd, "cache_dir", None)
        cache_path = (
            os.path.join(
                cache_dir, f"device_rows_k{k}{'_big' if big else ''}.npy"
            )
            if cache_dir else None
        )
        rows = torch.empty((nb, ROW_WORDS), dtype=torch.int32, device=device)
        cached = None
        if cache_path and os.path.exists(cache_path):
            cached = np.load(cache_path, mmap_mode="r")
            if cached.shape != (nb, ROW_WORDS) or cached.dtype != np.int32:
                cached = None
        if cached is not None:
            for b0 in range(0, nb, PACK_CHUNK_ROWS):
                b1 = min(nb, b0 + PACK_CHUNK_ROWS)
                rows[b0:b1] = torch.from_numpy(np.array(cached[b0:b1]))
        else:
            # the index's own checkpoints where their spacing is k, as in
            # the reference; else the running counts of the chunks
            cps = fmd.occ_cp if k == fmd.occ_k else None
            with _RowCache(cache_path, nb) as cache:
                fill_rows(rows, _bwt_chunks(fmd.bwt, k, nb, device), big,
                          cps, cache)
        idt = torch.int64 if big else torch.int32
        return cls(
            rows=rows,
            less=torch.from_numpy(
                np.array(fmd.less, dtype=np.int64)).to(idt).to(device),
            sentinels=torch.from_numpy(
                np.array(fmd.sentinel_occ, dtype=np.int64)
            ).to(idt).to(device),
            occ_k=int(k),
            text_len=int(n),
            big=bool(big),
        )


def _pack_rows(sym: torch.Tensor, cp: torch.Tensor,
               big: bool) -> torch.Tensor:
    """(r, k) uint8 symbol ranks (15 past the text) and their rows'
    (r, 6) int64 exclusive-prefix counts -> (r, 128) int32 fused rows:
    `[cp(6) | symbols]`, big `[cp_lo(6) | cp_hi(6) | symbols]`, eight
    4-bit symbols a word, the first in the low nibble."""
    r, k = sym.shape
    nib = sym.reshape(r, k // 8, 8).to(torch.int64)
    word = nib[:, :, 0].clone()
    for b in range(1, 8):
        word |= nib[:, :, b] << (4 * b)
    # int64 -> int32 keeps the low 32 bits (numpy's uint32 view)
    cols = ([(cp & 0xFFFFFFFF).to(torch.int32), (cp >> 32).to(torch.int32)]
            if big else [cp.to(torch.int32)])
    return torch.cat([*cols, word.to(torch.int32)], dim=1)


def fill_rows(rows: torch.Tensor, chunks, big: bool, cps=None,
              cache=None) -> torch.Tensor:
    """Pack `chunks`, (first row, (r, k) uint8 symbol ranks on the rows'
    device, 15 past the text) in row order, into the fused rows `rows`,
    each chunk appended to `cache` (a `_RowCache`) as it is made.  The
    checkpoints are the (nb, >= 6) host array `cps` where given, else the
    running counts of the chunks.  -> the (6,) int64 counts of ranks 0..5
    in the whole text."""
    running = torch.zeros(N_CP, dtype=torch.int64, device=rows.device)
    for b0, sym in chunks:
        b1 = b0 + sym.shape[0]
        # each row's counts of ranks 0..5 (the padding, 15, counts in none)
        counts = torch.stack([(sym == c).sum(dim=1) for c in range(N_CP)],
                             dim=1)
        if cps is None:
            cp = running + torch.cumsum(counts, dim=0) - counts
        else:
            cp = np.asarray(cps[b0:b1], dtype=np.int64)[:, :N_CP]
            cp = torch.from_numpy(np.pad(
                cp, ((0, 0), (0, N_CP - cp.shape[1])))).to(rows.device)
        running += counts.sum(dim=0)
        rows[b0:b1] = _pack_rows(sym, cp, big)
        if cache is not None:
            cache.write(rows[b0:b1])
    return running


def _bwt_chunks(bwt, k: int, nb: int, device):
    """The host BWT a PACK_CHUNK_ROWS chunk of rows at a time, padded with
    15 past its end: (first row, (rows, k) uint8 on `device`)."""
    n = len(bwt)
    for b0 in range(0, nb, PACK_CHUNK_ROWS):
        b1 = min(nb, b0 + PACK_CHUNK_ROWS)
        seg = np.full((b1 - b0) * k, 15, dtype=np.uint8)
        part = bwt[b0 * k : min(b1 * k, n)]
        seg[: len(part)] = part
        yield b0, torch.from_numpy(seg).to(device).view(b1 - b0, k)


class _RowCache:
    """The rows' cache file at `path` (None: none), written a chunk at a
    time to a temporary name (np.save's header, then the rows) and put in
    place when the `with` block ends without an error; a bundle that
    cannot be written (read-only, full) gets none."""

    def __init__(self, path: str | None, nb: int):
        self.path, self.f = path, None
        if path is None:
            return
        self.tmp = f"{path}.{os.getpid()}.tmp"
        try:
            self.f = open(self.tmp, "wb")
            np.lib.format.write_array_header_1_0(self.f, {
                "descr": np.lib.format.dtype_to_descr(np.dtype(np.int32)),
                "fortran_order": False, "shape": (nb, ROW_WORDS)})
        except OSError:
            self._drop()

    def write(self, rows: torch.Tensor) -> None:
        if self.f is not None:
            try:
                self.f.write(rows.cpu().numpy().tobytes())
            except OSError:
                self._drop()

    def _drop(self) -> None:
        f, self.f = self.f, None
        if f is not None:
            f.close()
        if os.path.exists(self.tmp):
            os.remove(self.tmp)

    def __enter__(self) -> "_RowCache":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.f is None:
            return
        if exc_type is not None:
            self._drop()
        else:
            self.f.close()
            self.f = None
            os.replace(self.tmp, self.path)


def _row_occ4(index: DeviceFmIndex, r: torch.Tensor) -> torch.Tensor:
    """(N,) positions -> (N, 4) counts of ranks 1..4 in bwt[0..=r] (-1 -> 0).

    Plain version of K1's rank query.  Row indices clamp to the table like
    XLA's gather does (lanes holding no read may query garbage)."""
    k = index.occ_k
    nb = index.rows.shape[0]
    r_safe = torch.clamp(r, min=0)
    # the block number is an int32 (a garbage int64 position wraps), a
    # negative one counts from the end, and the gather clamps
    blk = (r_safe // k).to(torch.int32)
    blk = torch.clamp(torch.where(blk < 0, blk + nb, blk), 0, nb - 1).long()
    off = (r_safe % k).to(torch.int32)
    rows = index.rows[blk]
    if index.big:
        cp = ((rows[:, 1:5].long() & 0xFFFFFFFF)
              | (rows[:, 7:11].long() << 32))
    else:
        cp = rows[:, 1:5]
    words = rows[:, index.n_cp_cols:]
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=r.device)
    symbols = ((words[:, :, None] >> shifts) & 0xF).reshape(rows.shape[0], -1)
    pos = torch.arange(symbols.shape[1], dtype=torch.int32, device=r.device)
    in_prefix = pos[None, :] <= off[:, None]
    counts = torch.stack(
        [((symbols == c) & in_prefix).sum(dim=1, dtype=torch.int32)
         for c in (1, 2, 3, 4)],
        dim=1,
    )
    return torch.where(r[:, None] >= 0, counts.to(index.idx_dtype) + cp,
                       torch.zeros_like(cp))


def occ4_batch(index: DeviceFmIndex, r: torch.Tensor) -> torch.Tensor:
    """K1's rank query: (N,) positions -> (N, 4) counts of ranks 1..4 in
    bwt[0..=r] (-1 -> 0), in the index's interval type.  The plain version
    (`_row_occ4`) for CPU tensors, for CUDA tensors the kernel (`occ4_warp`
    of csrc/common.cuh, a warp a position; launches counted as
    `occ4_batch[_i64]`), never a fallback."""
    if not r.is_cuda:
        return _row_occ4(index, r)
    idt = index.idx_dtype
    require(index.rows.is_cuda and index.rows.dtype == torch.int32
            and index.rows.is_contiguous(), "index rows must be int32 CUDA")
    require(r.is_cuda and r.dtype == idt and r.is_contiguous()
            and r.dim() == 1, f"occ4_batch takes a contiguous (N,) {idt} "
            "CUDA tensor")
    out = torch.empty((r.shape[0], 4), dtype=idt, device=r.device)
    fn = cuda_function(
        "pool_search", "k1_occ4",
        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.c_int, ctypes.c_void_p],
    )
    LAUNCHES.add("occ4_batch_i64" if index.big else "occ4_batch")
    check(fn(index.rows.data_ptr(), index.rows.shape[0], index.occ_k,
             int(index.big), r.data_ptr(), out.data_ptr(), r.shape[0],
             torch.cuda.current_stream(r.device).cuda_stream), "k1_occ4")
    return out


def sentinel_count(index: DeviceFmIndex, r: torch.Tensor) -> torch.Tensor:
    """(N,) -> number of sentinels in bwt[0..=r] (fmd_index.rs:138-151)."""
    return ((r >= index.sentinels[0]).to(torch.int32)
            + (r >= index.sentinels[1]).to(torch.int32))


def extend_batch_plain(index: DeviceFmIndex, lower, lower_rev, size):
    """Plain PyTorch K1: the 4-symbol backward-extension sweep.

    (L,) int32 (big: int64) inputs -> (child_lower, child_lower_rev,
    child_size), each (L, 4) in sweep slot order [T, G, C, A] (ranks 4, 3,
    2, 1)."""
    L = lower.shape[0]
    r1 = lower - 1
    r2 = lower + size - 1
    rr = torch.cat([torch.where(lower == 0, torch.full_like(r1, -1), r1), r2])
    occ12 = _row_occ4(index, rr)
    occ1, occ2 = occ12[:L], occ12[L:]
    sent1 = torch.where(lower == 0, torch.zeros_like(r1),
                        sentinel_count(index, r1))
    sent2 = sentinel_count(index, r2)
    out_lower, out_lrev, out_size = [], [], []
    s_run = sent2 - sent1
    l_run = lower_rev
    for c in (4, 3, 2, 1):
        l_run = l_run + s_run
        o = occ1[:, c - 1]
        s_run = occ2[:, c - 1] - o
        out_lower.append(index.less[c] + o)
        out_lrev.append(l_run)
        out_size.append(s_run)
    return (torch.stack(out_lower, 1), torch.stack(out_lrev, 1),
            torch.stack(out_size, 1))


def extend_batch(index: DeviceFmIndex, lower, lower_rev, size):
    """K1 wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (never a fallback)."""
    if not lower.is_cuda:
        return extend_batch_plain(index, lower, lower_rev, size)
    L = lower.shape[0]
    idt = index.idx_dtype
    require(index.rows.is_cuda and index.rows.dtype == torch.int32
            and index.rows.is_contiguous(), "index rows must be int32 CUDA")
    for t in (lower, lower_rev, size, index.less, index.sentinels):
        require(t.is_cuda and t.dtype == idt and t.is_contiguous(),
                f"extend_batch takes contiguous {idt} CUDA tensors")
    require(lower_rev.shape == size.shape == (L,), "extend_batch shapes")
    outs = [torch.empty((L, 4), dtype=idt, device=lower.device)
            for _ in range(3)]
    fn = cuda_function(
        "pool_search", "k1_extend_batch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p],
    )
    LAUNCHES.add("extend_batch_i64" if index.big else "extend_batch")
    check(fn(
        index.rows.data_ptr(), index.less.data_ptr(),
        index.sentinels.data_ptr(), index.rows.shape[0], index.occ_k,
        int(index.big),
        lower.data_ptr(), lower_rev.data_ptr(), size.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), L,
        torch.cuda.current_stream(lower.device).cuda_stream,
    ), "k1_extend_batch")
    return tuple(outs)


def backward_ext_by_rank(index: DeviceFmIndex, lower, lower_rev, size, c):
    """Backward-extend (L,) intervals by per-lane symbol ranks c (1..4);
    c outside 1..4 yields the empty interval."""
    ch_lower, ch_lrev, ch_size = extend_batch(index, lower, lower_rev, size)
    slot = torch.clamp(4 - c, 0, 3).long()[:, None]
    valid = (c >= 1) & (c <= 4)
    zero = torch.zeros_like(lower)
    return (
        torch.where(valid, ch_lower.gather(1, slot)[:, 0], zero),
        torch.where(valid, ch_lrev.gather(1, slot)[:, 0], zero),
        torch.where(valid, ch_size.gather(1, slot)[:, 0], zero),
    )


def forward_ext_by_rank(index: DeviceFmIndex, lower, lower_rev, size, c):
    """Forward extension = backward extension of the swapped interval with
    the complement symbol, then swap back (fmd_index.rs:93-96)."""
    comp = torch.where((c >= 1) & (c <= 4), 5 - c, torch.zeros_like(c))
    sl, slr, ss = backward_ext_by_rank(index, lower_rev, lower, size, comp)
    return slr, sl, ss
