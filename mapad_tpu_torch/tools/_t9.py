"""P3 on the card: row 7 of an `arange`-filled (1024, 32) int32 table
through a (1, 32) scratch (`dma.copy_src_slice`, csrc/probe_copy.cu).

    python -m mapad_tpu_torch.tools._t9

Port of tools/_t9.py, written to fail on the TPU compiler of its day (a
DMA ref whose minor dim is 32).  Here it must copy, and equal `rows[7:8]`:
a 128-byte row, which the kernel moves 16 bytes at a time.  Exits 1 if it
does not.
"""

from __future__ import annotations

import torch

from ..ops.fm import resolve_device
from . import card
from .dma import copy_src_slice

NB, W, ROW = 1024, 32, 7


def run(device=None):
    """(the copied row, rows[7:8]) on the device."""
    device = resolve_device(device)
    rows = torch.arange(NB * W, dtype=torch.int32,
                        device=device).reshape(NB, W)
    return copy_src_slice(rows, ROW, 1, 0, W), rows[ROW:ROW + 1]


def main() -> int:
    got, want = run()
    ok = torch.equal(got, want)
    print(f"{'OK' if ok else 'FAIL'}: row {ROW} of ({NB}, {W}) through a "
          f"(1, {W}) scratch {'equals' if ok else 'differs from'} "
          f"rows[{ROW}:{ROW + 1}] ({card()})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
