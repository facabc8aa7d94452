"""Wrappers of the probe kernels P1-P4 (csrc/probe_dma.cu, csrc/probe_copy.cu),
each with its plain PyTorch version beside it.

- `gather_steps` (P1, kernel `probe_dma`) replaces tools/bench_dma.py
  `scatter_dma_kernel` (34-55, one `pallas_call` in `run_scatter` 57-73):
  T dependent steps, each moving L whole rows of a (NB, W) int32 table at
  indices that the previous steps' sums decide, into a scratch, and adding
  the f32 sum of their column 0 to acc.
- `copy_src_slice` / `copy_dst_slice` (P2-P4, kernels `copy_src_slice`,
  `copy_dst_slice`) replace the slice copies through a VMEM scratch of
  tools/_probe_shapes.py (`src_slice` 26-41, `dst_slice` 43-57),
  tools/_t9.py (`k9` 10-15) and tools/_dump_pair.py (`k_src` 32-37,
  `k_dst` 39-43).

Each wrapper runs the plain version for a tensor on the CPU and the kernel
for a CUDA tensor (never a fallback), and adds to `LAUNCHES` under its
kernel's name where it launches.  Nothing here is on a mapping path.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import LAUNCHES, check, cuda_function, require

STEP_MUL = 1237  # index stride per step (tools/bench_dma.py:39)
ACC_MOD = 7
SCRATCH_WORDS = 72 * 128  # a block's staging buffer in csrc/probe_copy.cu


# --- P1: dependent scattered row gather -----------------------------------


class _GatherArgs(ctypes.Structure):
    """Mirror of `struct GatherArgs` in csrc/probe_dma.cu."""

    _fields_ = [
        ("rows", ctypes.c_void_p), ("blk", ctypes.c_void_p),
        ("acc", ctypes.c_void_p), ("chk", ctypes.c_void_p),
        ("partials", ctypes.c_void_p), ("NB", ctypes.c_int),
        ("W", ctypes.c_int), ("L", ctypes.c_int), ("t0", ctypes.c_int),
        ("steps", ctypes.c_int),
    ]


def _xor_all(x: torch.Tensor) -> torch.Tensor:
    """XOR of every element of an int32 tensor, as a (1,) tensor."""
    v = x.reshape(-1)
    while v.numel() > 1:
        h = v.numel() // 2
        v = torch.cat([v[:h] ^ v[h:2 * h], v[2 * h:]])
    return v


def _gather_state(rows, blk, steps, t0, acc, chk):
    """Validate P1's inputs; returns (acc, chk), new zeros where None."""
    dev = rows.device
    acc = torch.zeros(1, dtype=torch.float32, device=dev) if acc is None \
        else acc
    chk = torch.zeros(1, dtype=torch.int32, device=dev) if chk is None \
        else chk
    require(rows.ndim == 2 and rows.dtype == torch.int32
            and rows.is_contiguous() and rows.numel() > 0,
            "rows must be a contiguous (NB, W) int32 table")
    require(blk.ndim == 1 and blk.dtype == torch.int32 and blk.numel() > 0
            and blk.is_contiguous(), "blk must be a contiguous (L,) int32")
    require(acc.shape == (1,) and acc.dtype == torch.float32
            and chk.shape == (1,) and chk.dtype == torch.int32,
            "acc is (1,) float32, chk (1,) int32")
    require(all(t.device == dev for t in (blk, acc, chk)),
            "rows, blk, acc and chk must be on one device")
    nb, lanes = rows.shape[0], blk.shape[0]
    require(steps >= 1 and t0 >= 0, "steps >= 1, t0 >= 0")
    require((t0 + steps) * STEP_MUL + nb < 2**31,
            "the step's row indices must stay in int32")
    lo, hi = torch.aminmax(blk)
    require(0 <= int(lo) and int(hi) < nb, "blk must lie in [0, NB)")
    lo, hi = torch.aminmax(rows[:, 0])
    col = max(-int(lo), int(hi))
    require(lanes * col < 2**24,
            "L * max|rows[:, 0]| must stay below 2^24 (an exact f32 sum)")
    require(abs(float(acc[0])) + steps * lanes * col < 2**31,
            "acc must stay in int32 range")
    return acc, chk


def gather_steps_plain(rows, blk, steps: int, t0: int = 0, acc=None,
                       chk=None):
    """Plain PyTorch P1: steps t0 .. t0+steps-1 of the TPU kernel, with acc
    and chk carried in place (new zeros when None).  Returns (acc, chk)."""
    acc, chk = _gather_state(rows, blk, steps, t0, acc, chk)
    nb = rows.shape[0]
    for t in range(t0, t0 + steps):
        a7 = torch.remainder(acc.to(torch.int32), ACC_MOD)
        idx = torch.remainder(blk + t * STEP_MUL + a7, nb)
        scratch = rows.index_select(0, idx)
        chk.copy_(chk ^ _xor_all(scratch))
        acc.add_(scratch[:, 0].to(torch.float32).sum())
    return acc, chk


def gather_steps(rows, blk, steps: int, t0: int = 0, acc=None, chk=None,
                 launch_per_step: bool = False, events=None):
    """P1: `steps` dependent steps from step t0 (acc and chk carried in
    place; new zeros when None).  Returns (acc, chk).

    On the card: one cooperative launch of all steps, or with
    `launch_per_step` one launch a step queued from one host loop (the form
    the pool search runs in).  `events`, a list, gets a (start, end) pair of
    timing events recorded around the launches.  `acc` must be what an
    earlier call returned (its int32 part feeds the indices)."""
    acc, chk = _gather_state(rows, blk, steps, t0, acc, chk)
    if not rows.is_cuda:
        return gather_steps_plain(rows, blk, steps, t0, acc, chk)
    fn = cuda_function("probe_dma", "probe_dma_gather",
                       [ctypes.POINTER(_GatherArgs), ctypes.c_int,
                        ctypes.c_void_p])
    nb, width = rows.shape
    lanes = blk.shape[0]
    partials = torch.empty(2 * lanes, dtype=torch.int32, device=rows.device)
    args = _GatherArgs(rows.data_ptr(), blk.data_ptr(), acc.data_ptr(),
                       chk.data_ptr(), partials.data_ptr(), nb, width, lanes,
                       t0, steps)
    stream = torch.cuda.current_stream()
    if events is not None:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(stream)
    LAUNCHES.add("probe_dma", steps if launch_per_step else 1)
    check(fn(ctypes.byref(args), int(launch_per_step), stream.cuda_stream),
          "probe_dma")
    if events is not None:
        ev[1].record(stream)
        events.append(ev)
    return acc, chk


# --- P2-P4: a slice staged through shared memory ----------------------------


class _CopyArgs(ctypes.Structure):
    """Mirror of `struct CopyArgs` in csrc/probe_copy.cu."""

    _fields_ = [
        ("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
        ("ld", ctypes.c_int), ("row0", ctypes.c_int), ("col0", ctypes.c_int),
        ("nrows", ctypes.c_int), ("ncols", ctypes.c_int),
        ("addend", ctypes.c_int),
    ]


def _matrix(x, what):
    """x as the (R, prod(rest)) int32 view the kernels index."""
    require(x.dtype == torch.int32 and x.ndim >= 2 and x.is_contiguous()
            and 0 < x.numel() < 2**31,
            f"{what} must be a contiguous int32 array of 2 or more dims")
    return x.reshape(x.shape[0], -1)


def _check_slice(m, row0, nrows, col0, ncols):
    R, C = m.shape
    require(0 <= row0 and nrows >= 1 and row0 + nrows <= R
            and 0 <= col0 and ncols >= 1 and col0 + ncols <= C,
            f"slice [{row0}:{row0 + nrows}, {col0}:{col0 + ncols}] outside "
            f"({R}, {C})")
    require(ncols <= SCRATCH_WORDS,
            f"a slice row of {ncols} words exceeds the {SCRATCH_WORDS}-word "
            "staging buffer")


def _launch_copy(name, src, dst, ld, row0, col0, nrows, ncols, addend):
    fn = cuda_function("probe_copy", name,
                       [ctypes.POINTER(_CopyArgs), ctypes.c_void_p])
    args = _CopyArgs(src.data_ptr(), dst.data_ptr(), ld, row0, col0, nrows,
                     ncols, addend)
    LAUNCHES.add(name)
    check(fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream),
          name)


def copy_src_slice_plain(x, row0: int, nrows: int, col0: int, ncols: int):
    """Plain PyTorch `copy_src_slice`."""
    m = _matrix(x, "x")
    _check_slice(m, row0, nrows, col0, ncols)
    scratch = torch.empty((nrows, ncols), dtype=x.dtype, device=x.device)
    scratch.copy_(m[row0:row0 + nrows, col0:col0 + ncols])
    return scratch


def copy_src_slice(x, row0: int, nrows: int, col0: int, ncols: int):
    """Rows [row0, row0+nrows) x columns [col0, col0+ncols) of x, viewed as
    (R, prod(rest)), staged through shared memory into a new dense
    (nrows, ncols) int32 tensor."""
    if not x.is_cuda:
        return copy_src_slice_plain(x, row0, nrows, col0, ncols)
    m = _matrix(x, "x")
    _check_slice(m, row0, nrows, col0, ncols)
    out = torch.empty((nrows, ncols), dtype=torch.int32, device=x.device)
    _launch_copy("copy_src_slice", m, out, m.shape[1], row0, col0, nrows,
                 ncols, 0)
    return out


def _check_dst(inp, out, row0, col0, addend):
    src, m = _matrix(inp, "inp"), _matrix(out, "out")
    require(inp.device == out.device, "inp and out must be on one device")
    _check_slice(m, row0, src.shape[0], col0, src.shape[1])
    require(-2**31 <= addend < 2**31, "addend must fit int32")
    a0, b0 = inp.data_ptr(), out.data_ptr()
    require(a0 + inp.numel() * 4 <= b0 or b0 + out.numel() * 4 <= a0,
            "inp must not overlap out")
    return src, m


def copy_dst_slice_plain(inp, out, row0: int, col0: int, addend: int = 0):
    """Plain PyTorch `copy_dst_slice`."""
    src, m = _check_dst(inp, out, row0, col0, addend)
    scratch = src.clone()
    scratch += addend
    m[row0:row0 + src.shape[0], col0:col0 + src.shape[1]] = scratch
    return out


def copy_dst_slice(inp, out, row0: int, col0: int, addend: int = 0):
    """inp, viewed as (nrows, prod(rest)), plus `addend` (int32, wrapping)
    staged through shared memory into rows [row0, row0+nrows) x columns
    [col0, col0+ncols) of `out` viewed as (R, prod(rest)), in place; every
    other element of `out` stays as it was.  Returns out."""
    if not out.is_cuda:
        return copy_dst_slice_plain(inp, out, row0, col0, addend)
    src, m = _check_dst(inp, out, row0, col0, addend)
    _launch_copy("copy_dst_slice", src, m, m.shape[1], row0, col0,
                 src.shape[0], src.shape[1], addend)
    return out
