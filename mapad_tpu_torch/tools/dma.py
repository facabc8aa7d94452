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

- `load_latency_ns` (kernel `probe_chase`, no TPU counterpart) measures the
  card's dependent-load latency, the unit of K3's walk floor.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from .._build import (LAUNCHES, check, cuda_function, current_raw_stream,
                      require)

STEP_MUL = 1237  # index stride per step (tools/bench_dma.py:39)
ACC_MOD = 7
SCRATCH_WORDS = 72 * 128  # a block's staging buffer in csrc/probe_copy.cu


# --- P1: dependent scattered row gather -----------------------------------


class _GatherArgs(ctypes.Structure):
    """Mirror of `struct GatherArgs` in csrc/probe_dma.cu."""

    _fields_ = [
        ("rows", ctypes.c_void_p), ("blk", ctypes.c_void_p),
        ("acc", ctypes.c_void_p), ("chk", ctypes.c_void_p),
        ("slots", ctypes.c_void_p), ("NB", ctypes.c_int),
        ("W", ctypes.c_int), ("L", ctypes.c_int), ("t0", ctypes.c_int),
        ("steps", ctypes.c_int),
    ]


GATHER_THREADS = 256
GATHER_WARPS = GATHER_THREADS // 32


class GatherPlan(NamedTuple):
    """Where P1 runs (mirrors `struct GatherPlan` in csrc/probe_dma.cu):
    `blocks` blocks of GATHER_THREADS threads, all co-resident, each
    gathering `lanes_per_block` rows a step into `smem` bytes of shared
    memory; `stride` barrier slots a step parity (blocks rounded up to
    even, so a 16-byte load reads two)."""

    blocks: int
    lanes_per_block: int
    smem: int
    stride: int


def gather_plan(L: int, W: int, sms: int, per_sm,
                smem_block: int) -> GatherPlan:
    """P1's launch plan for L lanes of W-word rows on a card of `sms` SMs
    whose block may take `smem_block` bytes of dynamic shared memory.
    `per_sm(smem)`: the blocks of GATHER_THREADS threads and `smem` bytes
    one SM holds at once (the occupancy query).  A block takes a lane a
    warp and more where the card cannot hold that many blocks at once: the
    fewest lanes a block (so the most blocks, each step's loads spread
    over the most SMs) whose grid is all co-resident.  Raises where a
    block's rows outgrow its shared memory first."""
    require(L >= 1 and W >= 1, "P1 gathers at least one row of one word")
    lpb = GATHER_WARPS
    while True:
        smem = lpb * W * 4
        require(smem <= smem_block,
                f"{lpb} rows of {W} words exceed a block's {smem_block} B "
                "of shared memory")
        fit = per_sm(smem) * sms
        blocks = -(-L // lpb)
        if blocks <= fit:
            break
        lpb = max(-(-L // max(fit, sms)), lpb + 1)
    return GatherPlan(blocks, lpb, smem, (blocks + 1) & ~1)


class _GatherPlanC(ctypes.Structure):
    """Mirror of `struct GatherPlan` in csrc/probe_dma.cu."""

    _fields_ = [(f, ctypes.c_int) for f in GatherPlan._fields]


def slot_words(plan: GatherPlan) -> int:
    """Words of P1's barrier slots: the steps run so far in word 0 (a
    16-byte head), then 2 x `stride` slots of two words."""
    return 4 + 4 * plan.stride


_card_figures: dict = {}


def gather_card_plan(dev, L: int, W: int) -> GatherPlan:
    """`gather_plan` with the figures of the card `dev` (a few queries of
    the runtime, no launch; the card's figures and each shape's occupancy
    cached)."""
    key = dev.index
    fig = _card_figures.get(key)
    if fig is None:
        card = cuda_function("probe_dma", "gather_card",
                             [ctypes.POINTER(ctypes.c_int)])
        occupancy = cuda_function("probe_dma", "gather_occupancy",
                                  [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int)])
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(dev):
            check(card(out), "gather_card")
        occ: dict = {}

        def per_sm(smem):
            if smem not in occ:
                n = ctypes.c_int(0)
                with torch.cuda.device(dev):
                    check(occupancy(smem, ctypes.byref(n)),
                          "gather_occupancy")
                occ[smem] = n.value
            return occ[smem]

        fig = _card_figures[key] = (out[0], out[1], per_sm)
    sms, smem_block, per_sm = fig
    return gather_plan(L, W, sms, per_sm, smem_block)


class _Slots(threading.local):
    """A thread's barrier slots of P1, one zeroed tensor a card, grown
    (zeroed anew) where a plan needs more: the tags in it go on from call
    to call, so a call's first step never meets a slot its own tag has
    marked.  Calls of one thread on one card follow each other on its
    stream, or the caller orders them."""

    def __init__(self):
        self.by_card: dict = {}

    def get(self, dev, words: int) -> torch.Tensor:
        t = self.by_card.get(dev.index)
        if t is None or t.numel() < words:
            t = self.by_card[dev.index] = torch.zeros(
                words, dtype=torch.int32, device=dev)
        return t


_slots = _Slots()


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

    On the card: one launch of all steps, or with `launch_per_step` one
    launch a step queued from one host loop.  `events`, a list, gets a (start, end) pair of timing events recorded
    around the launches.  `acc` must be what an earlier call returned (its
    int32 part feeds the indices)."""
    acc, chk = _gather_state(rows, blk, steps, t0, acc, chk)
    if not rows.is_cuda:
        return gather_steps_plain(rows, blk, steps, t0, acc, chk)
    fn = cuda_function("probe_dma", "probe_dma_gather",
                       [ctypes.POINTER(_GatherArgs),
                        ctypes.POINTER(_GatherPlanC), ctypes.c_int,
                        ctypes.c_void_p])
    nb, width = rows.shape
    lanes = blk.shape[0]
    plan = gather_card_plan(rows.device, lanes, width)
    slots = _slots.get(rows.device, slot_words(plan))
    args = _GatherArgs(rows.data_ptr(), blk.data_ptr(), acc.data_ptr(),
                       chk.data_ptr(), slots.data_ptr(), nb, width, lanes,
                       t0, steps)
    plan_c = _GatherPlanC(*plan)
    stream = torch.cuda.current_stream()
    LAUNCHES.add("probe_dma", steps if launch_per_step else 1)
    if events is not None:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        busy_card()
        ev[0].record(stream)
    rc = fn(ctypes.byref(args), plan_c, int(launch_per_step),
            stream.cuda_stream)
    if events is not None:
        ev[1].record(stream)
        events.append(ev)
    check(rc, "probe_dma")
    return acc, chk


SPIN_CYCLES = 200_000  # ~0.1 ms of the card's clock


def busy_card():
    """Queue a spin of SPIN_CYCLES on the current stream (where torch has
    one), so that a timing event recorded next waits for the card, not for
    the host to enqueue what follows it."""
    sleep = getattr(torch.cuda, "_sleep", None)
    if sleep is not None:
        sleep(SPIN_CYCLES)


# --- P2-P4: a slice staged through shared memory ----------------------------


class _CopyArgs(ctypes.Structure):
    """Mirror of `struct CopyArgs` in csrc/probe_copy.cu: nine 8-byte
    fields, so that a call fills them as one int64 array."""

    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("stream", ctypes.c_void_p)] + [
        (f, ctypes.c_longlong) for f in
        ("ld", "row0", "col0", "nrows", "ncols", "addend")]


def _strided(x, what):
    """(R, C) of x's (R, prod(rest)) view, checked, without making it."""
    n = x.numel()
    if not (x.dtype == torch.int32 and x.ndim >= 2 and x.is_contiguous()
            and 0 < n < 2**31):
        raise ValueError(f"{what} must be a contiguous int32 array of 2 or "
                         "more dims")
    return x.shape[0], n // x.shape[0]


def _matrix(x, what):
    """x as the (R, prod(rest)) int32 view the plain versions index."""
    _strided(x, what)
    return x.reshape(x.shape[0], -1)


def _check_slice(R, C, row0, nrows, col0, ncols):
    """Raise where the slice leaves the (R, C) view or a row of it the
    staging buffer; the text is made only then."""
    if (0 <= row0 and nrows >= 1 and row0 + nrows <= R and 0 <= col0
            and ncols >= 1 and col0 + ncols <= C
            and ncols <= SCRATCH_WORDS):
        return
    require(ncols <= SCRATCH_WORDS,
            f"a slice row of {ncols} words exceeds the {SCRATCH_WORDS}-word "
            "staging buffer")
    require(False, f"slice [{row0}:{row0 + nrows}, {col0}:{col0 + ncols}] "
            f"outside ({R}, {C})")


class _Copy(threading.local):
    """A thread's launch of the copy kernels: the entry points, typed once,
    and one argument block, filled in place as an int64 array each call."""

    def __init__(self):
        self.args = _CopyArgs()
        self.fields = (ctypes.c_longlong * 9).from_buffer(self.args)
        self.fns = {name: cuda_function("probe_copy", name,
                                        [ctypes.POINTER(_CopyArgs)])
                    for name in ("copy_src_slice", "copy_dst_slice")}


_copy = None


def _launch_copy(name, src, dst, ld, row0, col0, nrows, ncols, addend):
    global _copy
    if _copy is None:
        _copy = _Copy()
    c = _copy
    c.fields[:] = (src, dst, current_raw_stream(), ld, row0, col0, nrows,
                   ncols, addend)
    LAUNCHES.add(name)
    rc = c.fns[name](c.args)
    if rc:
        check(rc, name)


def copy_src_slice_plain(x, row0: int, nrows: int, col0: int, ncols: int):
    """Plain PyTorch `copy_src_slice`."""
    m = _matrix(x, "x")
    _check_slice(*m.shape, row0, nrows, col0, ncols)
    scratch = torch.empty((nrows, ncols), dtype=x.dtype, device=x.device)
    scratch.copy_(m[row0:row0 + nrows, col0:col0 + ncols])
    return scratch


def copy_src_slice(x, row0: int, nrows: int, col0: int, ncols: int):
    """Rows [row0, row0+nrows) x columns [col0, col0+ncols) of x, viewed as
    (R, prod(rest)), staged through shared memory into a new dense
    (nrows, ncols) int32 tensor.  On the card: the current device's
    current stream."""
    if not x.is_cuda:
        return copy_src_slice_plain(x, row0, nrows, col0, ncols)
    R, C = _strided(x, "x")
    _check_slice(R, C, row0, nrows, col0, ncols)
    out = torch.empty((nrows, ncols), dtype=torch.int32, device=x.device)
    _launch_copy("copy_src_slice", x.data_ptr(), out.data_ptr(), C, row0,
                 col0, nrows, ncols, 0)
    return out


def _check_dst(inp, out, row0, col0, addend):
    """((nrows, ncols) of inp, (R, C) of out), checked."""
    nrows, ncols = _strided(inp, "inp")
    R, C = _strided(out, "out")
    require(inp.device == out.device, "inp and out must be on one device")
    _check_slice(R, C, row0, nrows, col0, ncols)
    require(-2**31 <= addend < 2**31, "addend must fit int32")
    a0, b0 = inp.data_ptr(), out.data_ptr()
    require(a0 + inp.numel() * 4 <= b0 or b0 + out.numel() * 4 <= a0,
            "inp must not overlap out")
    return (nrows, ncols), (R, C), a0, b0


def copy_dst_slice_plain(inp, out, row0: int, col0: int, addend: int = 0):
    """Plain PyTorch `copy_dst_slice`."""
    _check_dst(inp, out, row0, col0, addend)
    src, m = _matrix(inp, "inp"), _matrix(out, "out")
    scratch = src.clone()
    scratch += addend
    m[row0:row0 + src.shape[0], col0:col0 + src.shape[1]] = scratch
    return out


def copy_dst_slice(inp, out, row0: int, col0: int, addend: int = 0):
    """inp, viewed as (nrows, prod(rest)), plus `addend` (int32, wrapping)
    staged through shared memory into rows [row0, row0+nrows) x columns
    [col0, col0+ncols) of `out` viewed as (R, prod(rest)), in place; every
    other element of `out` stays as it was.  Returns out.  On the card: the
    current device's current stream."""
    if not out.is_cuda:
        return copy_dst_slice_plain(inp, out, row0, col0, addend)
    (nrows, ncols), (_R, C), a0, b0 = _check_dst(inp, out, row0, col0,
                                                 addend)
    _launch_copy("copy_dst_slice", a0, b0, C, row0, col0, nrows, ncols,
                 addend)
    return out


# --- the card's dependent-load latency (K3's walk floor) ------------------


def load_latency_ns(dev, n_ints: int, hops: int = 20000, flush=None,
                    runs: int = 3) -> float:
    """ns a dependent load takes on the card `dev`: one thread chasing a
    random cycle through `n_ints` int32 words, `hops` links a call, the
    median of `runs` calls by CUDA events (after one call that is not
    timed).  `flush`: a tensor zeroed before each timed call (not timed),
    so that a cycle larger than it finds none of its words in the L2."""
    import torch

    from . import event_runs

    require(dev.type == "cuda", "the latency probe runs on the card")
    perm = torch.randperm(n_ints, device=dev, dtype=torch.int64)
    nxt = torch.empty(n_ints, dtype=torch.int32, device=dev)
    nxt[perm] = perm.roll(-1).to(torch.int32)
    del perm
    at = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = cuda_function("probe_dma", "probe_chase",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p])

    def call():
        LAUNCHES.add("probe_chase")
        check(fn(nxt.data_ptr(), hops, at.data_ptr(), current_raw_stream()),
              "probe_chase")
    call()
    ms = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        ms += event_runs(call, 1)
    return sorted(ms)[len(ms) // 2] * 1e6 / hops
