"""Batched Bi-D array computation on the card (kernel K7).

Counterpart of mapad_tpu/ops/bi_d.py (reference src/map/bi_d_array.rs): per
read, 15 offset walks per part extend the FMD-index perfectly; each failure
accrues the most conservative penalty of the window scanned since the last
failure (a running maximum that resets at each failure), and the walks are
min-reduced per position.  The f32 accumulation order of `z` within a walk
is the reference's.

K7 (`bi_d`, csrc/bi_d.cu) replaces `_walk_part` / `compute_bi_d`
(mapad_tpu/ops/bi_d.py:27-156).  The JAX version steps all R*15 walks in
lock step; the kernel makes each walk of a part a unit of work that one
warp walks alone with K1 inline (both rank queries of a step at once), and
block b's warps take the units of read b in turn (`bid_plan`; the launch
bounds keep three blocks, 45-48 warps, on an SM), the read's inputs staged
in shared memory and its walks min-reduced there.  Bound
on the card: bytes -- two 512 B index rows per walk step from L2 (the rows
of a genome-scale index: from device memory), plus the (R, M) inputs and
output; a walk is a chain of dependent row reads, so latency and the SM's
issue slots bound it in practice.

`n_steps` of the JAX loop is the longest part of the whole block of reads:
column i of a walk holds z after step i-1 for i <= n_steps and 0 beyond, so
the padding columns of a short read depend on the longest read of its
block.  The engine knows the lengths on the host and passes the maxima in
(`steps`); without them the wrapper reads them from the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .._build import LAUNCHES, check, cuda_function, require
from .fm import DeviceFmIndex, extend_batch_plain

MAX_OFFSET = 15
MAX_M = 1024  # csrc/bi_d.cu BID_MAX_M
F32_MIN = -3.4028234663852886e38  # the lowest finite f32


def _walk_part_plain(index: DeviceFmIndex, part_rank, part_pen, part_len,
                     forward: bool, n_steps: int):
    """MAX_OFFSET perfect-extension walks over one read part, all walks of
    the block in lock step (a transcription of the JAX loop).

    part_rank: (L, M) symbol ranks in walk order, 0 where invalid
    part_pen:  (L, M) f32 penalty elements in walk order
    part_len:  (L,) number of valid positions
    -> (L, M) f32 min-reduced D values of the part."""
    L, M = part_rank.shape
    W = MAX_OFFSET
    LW = L * W
    dev = part_rank.device
    idt = index.idx_dtype
    f32 = torch.float32
    skip = torch.arange(W, dtype=torch.int32, device=dev).repeat(L)
    plen = part_len.to(torch.int32).repeat_interleave(W)
    init_size = torch.full((LW,), index.text_len, dtype=idt, device=dev)
    lower = torch.zeros(LW, dtype=idt, device=dev)
    lrev = torch.zeros(LW, dtype=idt, device=dev)
    size = init_size.clone()
    z = torch.zeros(LW, dtype=f32, device=dev)
    rm = torch.full((LW,), F32_MIN, dtype=f32, device=dev)
    z_out = torch.zeros((LW, M + 1), dtype=f32, device=dev)
    slots = torch.arange(4, dtype=torch.int32, device=dev)[None, :]
    for idx in range(n_steps):
        active = (idx >= skip) & (idx < plen)
        c = part_rank[:, idx].to(torch.int32).repeat_interleave(W)
        pen = part_pen[:, idx].repeat_interleave(W)
        valid = (c >= 1) & (c <= 4)
        if forward:
            # forward ext = backward ext of the swapped interval with the
            # complement symbol
            sel = torch.where(valid, 5 - c, torch.zeros_like(c))
            ch_lower, ch_lrev, ch_size = extend_batch_plain(
                index, lrev, lower, size)
        else:
            sel = c
            ch_lower, ch_lrev, ch_size = extend_batch_plain(
                index, lower, lrev, size)
        hit = (slots == (4 - sel)[:, None]) & valid[:, None]

        def pick(a):
            return torch.where(hit, a, torch.zeros_like(a)).sum(1, dtype=a.dtype)

        sl, slr, ss = pick(ch_lower), pick(ch_lrev), pick(ch_size)
        if forward:
            sl, slr = slr, sl
        nl = torch.where(active, sl, lower)
        nlr = torch.where(active, slr, lrev)
        ns = torch.where(active, ss, size)
        rm = torch.where(active, torch.maximum(rm, pen), rm)
        dead = active & (ns < 1)
        z = torch.where(dead, z + rm, z)
        lower = torch.where(dead, torch.zeros_like(nl), nl)
        lrev = torch.where(dead, torch.zeros_like(nlr), nlr)
        size = torch.where(dead, init_size, ns)
        rm = torch.where(dead, torch.full_like(rm, F32_MIN), rm)
        z_out[:, idx + 1] = z
    cols = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    out = torch.where(cols <= skip[:, None], torch.zeros((), dtype=f32,
                                                         device=dev),
                      z_out[:, :M])
    out = out.reshape(L, W, M).min(dim=1).values
    return torch.minimum(out, torch.zeros((), dtype=f32, device=dev))


def _part_steps(n, split):
    """(max(split), max(n - split)) read back from the tensors."""
    if n.numel() == 0:
        return 0, 0
    return int(split.max()), int((n - split).max())


def walk_steps(n, split, compute_forward_part: bool) -> int:
    """Walk steps the reads need (the kernel's work, for its bound): walk w
    of a part of length p takes max(0, p - w) steps, over part 1 and, with
    the forward part, part 2."""
    n, sp = n.cpu().long(), split.cpu().long()
    parts = (sp, n - sp) if compute_forward_part else (sp,)
    return int(sum(torch.clamp(p - w, min=0).sum() for p in parts
                   for w in range(MAX_OFFSET)))


def compute_bi_d_plain(index: DeviceFmIndex, pattern_rank, pen, n, split,
                       compute_forward_part: bool = True, steps=None):
    """Plain PyTorch K7: -> (L, M) f32 composite Bi-D array.

    composite[i] = d_backwards[i] for i < split else d_forwards[i - split]
    (bi_d_array.rs:95-98)."""
    L, M = pattern_rank.shape
    dev = pattern_rank.device
    s1, s2 = steps if steps is not None else _part_steps(n, split)
    n = n.to(torch.int32)
    split = split.to(torch.int32)
    # part 1: pattern[:split] walked forward, absolute index = walk index
    d_back = _walk_part_plain(index, pattern_rank, pen, split, True, s1)
    if not compute_forward_part:
        return d_back
    # part 2: pattern[split:] reversed; walk index j -> absolute n - 1 - j
    j = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    abs_idx = torch.clamp(n[:, None] - 1 - j, 0, M - 1).long()
    in_tail = j < (n - split)[:, None]
    tail_rank = torch.where(in_tail, pattern_rank.gather(1, abs_idx),
                            torch.zeros_like(pattern_rank))
    tail_pen = torch.where(in_tail, pen.gather(1, abs_idx),
                           torch.zeros_like(pen))
    d_fwd = _walk_part_plain(index, tail_rank, tail_pen, n - split, False, s2)
    fwd_idx = torch.clamp(j - split[:, None], 0, M - 1).long()
    return torch.where(j < split[:, None], d_back, d_fwd.gather(1, fwd_idx))


class _BidArgs(ctypes.Structure):
    """Mirror of `struct BidArgs` in csrc/bi_d.cu."""

    _fields_ = [
        ("rows", ctypes.c_void_p), ("less", ctypes.c_void_p),
        ("nb", ctypes.c_int),
        ("occ_k", ctypes.c_int), ("big", ctypes.c_int),
        ("text_len", ctypes.c_longlong),
        ("rank", ctypes.c_void_p), ("pen", ctypes.c_void_p),
        ("n", ctypes.c_void_p), ("split", ctypes.c_void_p),
        ("R", ctypes.c_int), ("M", ctypes.c_int),
        ("steps_back", ctypes.c_int), ("steps_fwd", ctypes.c_int),
        ("forward_part", ctypes.c_int), ("out", ctypes.c_void_p),
    ]


# --- the launch plan and the row division of csrc/bi_d.cu -------------------

WARP = 32
BID_WARPS = 16  # csrc/bi_d.cu BID_WARPS: warps a block at most


def occ_divisor(k: int, bits: int) -> tuple[int, int]:
    """(magic, shift) such that (n * magic) >> (bits + shift) == n // k for
    every 0 <= n < 2^(bits-1): the kernel's row number of a rank n of a
    `bits`-bit interval (umulhi, then a shift).  shift = ceil(log2 k) - 1
    and magic = ceil(2^(bits+shift) / k) < 2^bits; its error e = magic * k
    - 2^(bits+shift) is below k <= 2^(shift+1), so n * e < 2^(bits+shift)
    for every such n, which makes the quotient exact.  Raises where that
    proof does not hold."""
    require(k >= 2, "the rows hold two symbols or more")
    shift = (k - 1).bit_length() - 1
    magic = -(-(1 << (bits + shift)) // k)
    err = magic * k - (1 << (bits + shift))
    require(0 < magic < (1 << bits) and 0 <= err < k
            and ((1 << (bits - 1)) - 1) * err < (1 << (bits + shift)),
            f"no exact {bits}-bit multiply-high for a division by {k}")
    return magic, shift


def occ_div(n: int, k: int, magic: int, shift: int,
            bits: int) -> tuple[int, int]:
    """The kernel's (n // k, n % k) by k's constant from `occ_divisor`, for
    0 <= n < 2^(bits-1): the quotient by a multiply-high and a shift, the
    remainder in 32-bit wrapping arithmetic."""
    q = ((n * magic) >> bits) >> shift
    return q, ((n & 0xFFFFFFFF) - ((q * k) & 0xFFFFFFFF)) & 0xFFFFFFFF


class BidPlan(NamedTuple):
    """Where K7's walks run: block b takes read b with `warps` warps and
    `smem` bytes of shared memory; `per_sm` such blocks one SM holds at once
    (the occupancy query)."""

    warps: int
    smem: int
    per_sm: int

    @property
    def resident_warps(self) -> int:
        """Warps in flight on an SM when it holds `per_sm` blocks."""
        return self.per_sm * self.warps


def bid_smem(M: int, parts: int) -> int:
    """Bytes of a block's read: per part the M int keys of its D array, its
    M f32 penalties and its M rank bytes, to 16 B."""
    return -(-(parts * M * 9) // 16) * 16


def bid_plan(M: int, parts: int, blocks_per_sm) -> BidPlan:
    """K7's launch plan for reads padded to M with `parts` (1 or 2) parts a
    read.  `blocks_per_sm(threads, smem)`: the blocks of that shape one SM
    holds at once (the occupancy query, with the kernel's registers).

    A block has a warp for each walk of its read, up to BID_WARPS; a read
    of the longest M fits the 48 KB every block has without opting in.
    Raises where the card holds no such block."""
    require(1 <= M <= MAX_M, f"the Bi-D walks parts of at most {MAX_M}")
    require(parts in (1, 2), "a read has one part or two")
    warps = min(BID_WARPS, parts * MAX_OFFSET)
    smem = bid_smem(M, parts)
    per_sm = blocks_per_sm(warps * WARP, smem)
    require(per_sm >= 1, f"the card holds no block of {warps * WARP} "
            f"threads and {smem} B of shared memory")
    return BidPlan(warps, smem, per_sm)


class _BidPlanC(ctypes.Structure):
    """Mirror of `struct BidPlan` in csrc/bi_d.cu."""

    _fields_ = [("warps", ctypes.c_int), ("smem", ctypes.c_int),
                ("div_shift", ctypes.c_int),
                ("div_magic", ctypes.c_ulonglong)]


@functools.lru_cache(maxsize=64)
def bid_card_plan(dev: torch.device, M: int, parts: int,
                  big: bool) -> BidPlan:
    """`bid_plan` with the occupancy of K7's kernel in the interval width of
    `big` on the card `dev` (a query of the runtime, no launch; kept for
    each shape)."""
    occupancy = cuda_function("bi_d", "bid_occupancy",
                              [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(dev):

        def blocks_per_sm(threads, smem):
            out = ctypes.c_int(0)
            check(occupancy(int(big), threads, smem, ctypes.byref(out)),
                  "bid_occupancy")
            return out.value

        return bid_plan(M, parts, blocks_per_sm)


def compute_bi_d(index: DeviceFmIndex, pattern_rank, pen, n, split,
                 compute_forward_part: bool = True, steps=None):
    """K7 wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (never a fallback).

    pattern_rank: (L, M) i32 ranks (1..4, 0 invalid); pen: (L, M) f32
    penalty elements per absolute read position; n, split: (L,) i32.
    `steps` = (max(split), max(n - split)) where the caller knows them on
    the host; else they are read back from the card."""
    if not pattern_rank.is_cuda:
        return compute_bi_d_plain(index, pattern_rank, pen, n, split,
                                  compute_forward_part, steps)
    L, M = pattern_rank.shape
    i32 = torch.int32
    for t, dt in ((pattern_rank, i32), (pen, torch.float32), (n, i32),
                  (split, i32), (index.rows, i32),
                  (index.less, index.idx_dtype)):
        require(t.is_cuda and t.dtype == dt and t.is_contiguous(),
                "compute_bi_d takes contiguous CUDA tensors")
    require(pen.shape == (L, M) and n.shape == split.shape == (L,),
            "compute_bi_d shapes")
    require(1 <= M <= MAX_M, f"compute_bi_d walks parts of at most {MAX_M}")
    require(index.less.numel() >= 5, "compute_bi_d reads less[1..4]")
    require(2 <= index.occ_k <= 8 * (128 - index.n_cp_cols),
            "a row holds occ_k symbols")
    s1, s2 = steps if steps is not None else _part_steps(n, split)
    require(0 <= s1 <= M and 0 <= s2 <= M, "part lengths exceed max_len")
    out = torch.empty((L, M), dtype=torch.float32, device=pen.device)
    if L == 0:
        return out
    fwd = bool(compute_forward_part)
    plan = bid_card_plan(pen.device, M, 2 if fwd else 1, index.big)
    magic, shift = occ_divisor(index.occ_k, 64 if index.big else 32)
    args = _BidArgs(
        index.rows.data_ptr(), index.less.data_ptr(), index.rows.shape[0],
        index.occ_k, int(index.big), index.text_len, pattern_rank.data_ptr(),
        pen.data_ptr(), n.data_ptr(), split.data_ptr(), L, M, int(s1),
        int(s2), int(fwd), out.data_ptr(),
    )
    fn = cuda_function("bi_d", "bi_d",
                       [ctypes.POINTER(_BidArgs), ctypes.POINTER(_BidPlanC),
                        ctypes.c_void_p])
    LAUNCHES.add("bi_d_i64" if index.big else "bi_d")
    # K1 runs inline in the walk kernel
    LAUNCHES.add("extend_batch_i64" if index.big else "extend_batch")
    with torch.cuda.device(pen.device):
        check(fn(ctypes.byref(args),
                 ctypes.byref(_BidPlanC(plan.warps, plan.smem, shift,
                                        magic)),
                 torch.cuda.current_stream(pen.device).cuda_stream), "bi_d")
    return out


def bi_d_get(composite, split, n, backward_index, forward_index):
    """Batched BiDArray::get (bi_d_array.rs:200-224).  All args (L,)."""
    L, M = composite.shape
    bk = torch.clamp(backward_index, 0, M - 1).long()
    t = n - (1 + forward_index)
    ci = t + split
    ci_c = torch.clamp(ci, 0, M - 1).long()
    zero = torch.zeros((), dtype=composite.dtype, device=composite.device)
    d_rev = torch.where((backward_index >= 0) & (backward_index < n),
                        composite.gather(1, bk[:, None])[:, 0], zero)
    d_fwd = torch.where((t >= 0) & (ci < n),
                        composite.gather(1, ci_c[:, None])[:, 0], zero)
    return d_rev + d_fwd
