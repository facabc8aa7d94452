"""The host side of one P2 copy (`dma.copy_src_slice` at P2's (64, 8, 128)
-> (1, 8, 128) slice), part by part, on the card's host.

    python -m mapad_tpu_torch.tools.copy_host [--root DIR ...]

Times each part of the wrapper as it runs in a call, and the whole call,
with `time.perf_counter_ns` over 10,000 calls each (after 1,000 calls of
warm-up), then `x[sl].clone()`, the one PyTorch call that does the same.
Each `--root` names another checkout of the repository (an older revision
of the wrappers, say) whose `mapad_tpu_torch` is timed the same way in a
process of its own; this checkout's is timed first.  A checkout whose
`tools/dma.py` has no `_Copy` is of the older form: each call looked
up its entry point (`_build.cuda_function`, under a lock), made a
`torch.cuda.Stream` object for the stream's handle, built a new argument
block, and set the library's device at every launch.  Prints one line a
checkout: microseconds a call of each part.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPS, WARM = 10_000, 1_000
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# runs in a process of its own with the checkout's root first on sys.path
BODY = r"""
import ctypes, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from mapad_tpu_torch import _build
from mapad_tpu_torch._build import LAUNCHES
from mapad_tpu_torch.tools import dma

REPS, WARM = int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
x = torch.arange(64 * 8 * 128, dtype=torch.int32,
                 device=dev).reshape(64, 8, 128)
row0, nrows, col0, ncols = 3, 1, 0, 1024
out = torch.empty((nrows, ncols), dtype=torch.int32, device=dev)
new = hasattr(dma, "_Copy")


def us(fn):
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    for _ in range(REPS):
        fn()
    dt = time.perf_counter_ns() - t
    torch.cuda.synchronize()
    return dt / REPS / 1e3


parts = {}
if new:
    dma.copy_src_slice(x, row0, nrows, col0, ncols)
    c = dma._copy
    fn, a = c.fns["copy_src_slice"], c.args
    R, C = dma._strided(x, "x")
    src, dst = x.data_ptr(), out.data_ptr()
    stream = _build.current_raw_stream()

    def fill():
        c.fields[:] = (src, dst, stream, C, row0, col0, nrows, ncols, 0)

    fill()
    parts["checks"] = us(lambda: (dma._strided(x, "x"),
                                  dma._check_slice(R, C, row0, nrows, col0,
                                                   ncols)))
    parts["stream"] = us(_build.current_raw_stream)
    parts["args"] = us(fill)
    parts["launch"] = us(lambda: fn(a))
else:
    name = "copy_src_slice"
    argtypes = [ctypes.POINTER(dma._CopyArgs), ctypes.c_void_p]
    m = dma._matrix(x, "x")
    fn = _build.cuda_function("probe_copy", name, argtypes)
    args = dma._CopyArgs(m.data_ptr(), out.data_ptr(), m.shape[1], row0,
                         col0, nrows, ncols, 0)
    stream = torch.cuda.current_stream().cuda_stream
    parts["checks"] = us(lambda: dma._check_slice(dma._matrix(x, "x"), row0,
                                                  nrows, col0, ncols))
    parts["lookup"] = us(lambda: _build.cuda_function("probe_copy", name,
                                                      argtypes))
    parts["stream"] = us(lambda: torch.cuda.current_stream().cuda_stream)
    parts["args"] = us(lambda: dma._CopyArgs(m.data_ptr(), out.data_ptr(),
                                             m.shape[1], row0, col0, nrows,
                                             ncols, 0))
    parts["launch"] = us(lambda: fn(ctypes.byref(args), stream))
parts["empty"] = us(lambda: torch.empty((nrows, ncols), dtype=torch.int32,
                                        device=dev))
parts["count"] = us(lambda: LAUNCHES.add("copy_src_slice"))
parts["whole"] = us(lambda: dma.copy_src_slice(x, row0, nrows, col0, ncols))
parts["x[sl].clone()"] = us(lambda: x[row0:row0 + nrows].clone())
print(f"{sys.argv[1]} ({'bound once' if new else 'older form'}), us a call "
      f"over {REPS:,} calls: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in parts.items()),
      flush=True)
"""


def run(root: str) -> int:
    """Time the wrapper of the checkout at `root` in a process of its own."""
    return subprocess.run([sys.executable, "-c", BODY, os.path.abspath(root),
                           str(REPS), str(WARM)]).returncode


def main(argv=None) -> int:
    from . import card

    argv = list(sys.argv[1:] if argv is None else argv)
    roots = [ROOT] + [argv[i + 1] for i, a in enumerate(argv)
                      if a == "--root"]
    print(card(), flush=True)
    return max(run(r) for r in roots)


if __name__ == "__main__":
    sys.exit(main())
