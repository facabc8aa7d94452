"""Batched Bi-D array computation on the card (kernel K7).

Counterpart of mapad_tpu/ops/bi_d.py (reference src/map/bi_d_array.rs): per
read, 15 offset walks per part extend the FMD-index perfectly; each failure
accrues the most conservative penalty of the window scanned since the last
failure (a running maximum that resets at each failure), and the walks are
min-reduced per position.  The f32 accumulation order of `z` within a walk
is the reference's.

K7 (`bi_d`, csrc/bi_d.cu) replaces `_walk_part` / `compute_bi_d`
(mapad_tpu/ops/bi_d.py:27-156).  The JAX version steps all R*15 walks in
lock step; the kernel gives each read a block and each offset walk a warp
that walks its part alone with K1 inline (two fused-row rank queries a
step), and the block min-reduces the walks through shared memory.  Bound on
the card: bytes -- two 512 B index rows per walk step from L2 (the rows of
a genome-scale index: from device memory), plus the (R, M) inputs and
output.

`n_steps` of the JAX loop is the longest part of the whole block of reads:
column i of a walk holds z after step i-1 for i <= n_steps and 0 beyond, so
the padding columns of a short read depend on the longest read of its
block.  The engine knows the lengths on the host and passes the maxima in
(`steps`); without them the wrapper reads them from the card.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import LAUNCHES, check, cuda_function, require
from .fm import DeviceFmIndex, extend_batch_plain

MAX_OFFSET = 15
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
        ("sent", ctypes.c_void_p), ("nb", ctypes.c_int),
        ("occ_k", ctypes.c_int), ("big", ctypes.c_int),
        ("text_len", ctypes.c_longlong),
        ("rank", ctypes.c_void_p), ("pen", ctypes.c_void_p),
        ("n", ctypes.c_void_p), ("split", ctypes.c_void_p),
        ("R", ctypes.c_int), ("M", ctypes.c_int),
        ("steps_back", ctypes.c_int), ("steps_fwd", ctypes.c_int),
        ("forward_part", ctypes.c_int), ("out", ctypes.c_void_p),
    ]


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
                  (index.less, index.idx_dtype),
                  (index.sentinels, index.idx_dtype)):
        require(t.is_cuda and t.dtype == dt and t.is_contiguous(),
                "compute_bi_d takes contiguous CUDA tensors")
    require(pen.shape == (L, M) and n.shape == split.shape == (L,),
            "compute_bi_d shapes")
    require(1 <= M <= 1024, "compute_bi_d walks parts of at most 1024")
    s1, s2 = steps if steps is not None else _part_steps(n, split)
    require(0 <= s1 <= M and 0 <= s2 <= M, "part lengths exceed max_len")
    out = torch.empty((L, M), dtype=torch.float32, device=pen.device)
    if L == 0:
        return out
    args = _BidArgs(
        index.rows.data_ptr(), index.less.data_ptr(),
        index.sentinels.data_ptr(), index.rows.shape[0], index.occ_k,
        int(index.big), index.text_len, pattern_rank.data_ptr(),
        pen.data_ptr(), n.data_ptr(), split.data_ptr(), L, M, int(s1),
        int(s2), int(bool(compute_forward_part)), out.data_ptr(),
    )
    fn = cuda_function("bi_d", "bi_d",
                       [ctypes.POINTER(_BidArgs), ctypes.c_void_p])
    LAUNCHES.add("bi_d_i64" if index.big else "bi_d")
    # K1 runs inline in the walk kernel
    LAUNCHES.add("extend_batch_i64" if index.big else "extend_batch")
    check(fn(ctypes.byref(args),
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
