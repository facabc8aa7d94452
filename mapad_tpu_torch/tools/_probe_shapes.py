"""P2 on the card: a slice of each of eight shapes staged through shared
memory (`dma.copy_src_slice` / `dma.copy_dst_slice`, csrc/probe_copy.cu),
checked against torch slicing of `arange` data and timed.

    python -m mapad_tpu_torch.tools._probe_shapes

Port of tools/_probe_shapes.py, which mapped the ref shapes that the TPU
compiler of its day accepted for a DMA (:58-70); on the card every shape
must copy.  Prints OK or FAIL a shape, as the reference does, with the
kernel's time (CUDA events around many calls: for a copy of a few KB, the
launch) and its device time from the profiler; exits 1 on a FAIL.
"""

from __future__ import annotations

import math

import torch

from ..ops.fm import resolve_device
from . import card, cuda_ms, device_ms
from .dma import (copy_dst_slice, copy_dst_slice_plain, copy_src_slice,
                  copy_src_slice_plain)

# name, direction, array shape, the reference's slice (rows, and columns
# where it slices them), block shape -- tools/_probe_shapes.py:58-70
SHAPES = (
    ("src (64,128)->(2,128)", "src", (64, 128), (slice(6, 8),), (2, 128)),
    ("src (64,128)->(8,128)", "src", (64, 128), (slice(8, 16),), (8, 128)),
    ("src 3d (64,2,128)->(1,2,128)", "src", (64, 2, 128), (slice(3, 4),),
     (1, 2, 128)),
    ("src 3d (64,8,128)->(1,8,128)", "src", (64, 8, 128), (slice(3, 4),),
     (1, 8, 128)),
    ("dst (1024,128) write (72,128)", "dst", (1024, 128),
     (slice(100, 172),), (72, 128)),
    ("src (64,256)->(1,256)", "src", (64, 256), (slice(3, 4),), (1, 256)),
    ("src (64,384)->(1,384)", "src", (64, 384), (slice(3, 4),), (1, 384)),
    ("src 2-minor slice (64,256)->(1,128)", "src", (64, 256),
     (slice(3, 4), slice(0, 128)), (1, 128)),
)
UNTOUCHED = -1  # what a destination holds outside its slice


def slice_args(shape, sl):
    """(row0, nrows, col0, ncols) of a slice over the (R, prod(rest)) view."""
    cols = sl[1] if len(sl) > 1 else slice(0, math.prod(shape[1:]))
    return sl[0].start, sl[0].stop - sl[0].start, cols.start, \
        cols.stop - cols.start


def arange(shape, device):
    return torch.arange(math.prod(shape), dtype=torch.int32,
                        device=device).reshape(shape)


def case(kind, shape, sl, blk, device, addend=0):
    """One probe on `arange` data: (kernel, plain, library, want).  The
    first three are calls that return the result of the wrapper, of its
    plain version and of the one PyTorch call that does the same
    (`x[sl].clone()`, `out[sl] = inp + addend`); a destination's calls each
    write into their own array, UNTOUCHED outside the slice.  `want` is
    torch slicing's result."""
    row0, nrows, col0, ncols = slice_args(shape, sl)
    if kind == "src":
        x = arange(shape, device)
        return (
            lambda: copy_src_slice(x, row0, nrows, col0, ncols).reshape(blk),
            lambda: copy_src_slice_plain(x, row0, nrows, col0,
                                         ncols).reshape(blk),
            lambda: x[sl].clone(), x[sl])
    inp = arange(blk, device) + 1
    outs = [torch.full(shape, UNTOUCHED, dtype=torch.int32, device=device)
            for _ in range(3)]
    want = outs[2].clone()
    want[sl] = inp + addend

    def library():
        outs[2][sl] = inp + addend
        return outs[2]

    return (lambda: copy_dst_slice(inp, outs[0], row0, col0, addend),
            lambda: copy_dst_slice_plain(inp, outs[1], row0, col0, addend),
            library, want)


def check(device=None) -> list:
    """Every shape through its wrapper: [(name, ok)]."""
    device = resolve_device(device)
    out = []
    for name, kind, shape, sl, blk in SHAPES:
        kernel, _plain, _library, want = case(kind, shape, sl, blk, device)
        out.append((name, torch.equal(kernel(), want)))
    return out


def main() -> int:
    device = resolve_device(None)
    name = card()
    fails = 0
    for what, kind, shape, sl, blk in SHAPES:
        call, _plain, _library, want = case(kind, shape, sl, blk, device)
        ok = torch.equal(call(), want)
        fails += not ok
        dev = device_ms(call, 20)
        print(f"{'OK' if ok else 'FAIL':5s} {what}: {cuda_ms(call, 200):.4f} "
              f"ms a call, device "
              f"{'not measured' if dev is None else f'{dev:.5f} ms'} "
              f"({name})")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
