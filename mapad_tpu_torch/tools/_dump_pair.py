"""P4 on the card: a sliced-source copy (row 2 of an `arange`-filled
(8, 128) int32 array through a (1, 128) scratch) and a sliced-destination
copy (`in + 1` into row 3 of an (8, 128) output), both checked; then the
PTX and SASS of their kernels are written out for a diff.

    python -m mapad_tpu_torch.tools._dump_pair [--out DIR]

Port of tools/_dump_pair.py, which dumped the TPU compiler's modules of
`k_src` and `k_dst` to compare what it refused with what it took.  Here
`nvcc -ptx` of csrc/probe_copy.cu gives the PTX and `cuobjdump -sass` of
the built library the SASS; each kernel's section goes to
DIR/<kernel>.ptx and DIR/<kernel>.sass (DIR defaults to .smoke/dump_pair/
at the repository's root), and their instruction counts are printed.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess

import torch

from .. import _build
from ..ops.fm import resolve_device
from . import card
from .dma import copy_dst_slice, copy_src_slice

W = 128
SRC_ROW, DST_ROW = 2, 3
KERNELS = ("copy_src_slice", "copy_dst_slice")
DEFAULT_OUT = os.path.join(os.path.dirname(_build._HERE), ".smoke",
                           "dump_pair")


def run_pair(device=None):
    """[(what, got, want)] of the two copies on `arange` data; rows of the
    destination outside row 3 must keep their -1."""
    device = resolve_device(device)
    rows = torch.arange(8 * W, dtype=torch.int32, device=device).reshape(8, W)
    out = torch.full((8, W), -1, dtype=torch.int32, device=device)
    want = out.clone()
    want[DST_ROW] = rows[0] + 1
    return [
        ("k_src", copy_src_slice(rows, SRC_ROW, 1, 0, W),
         rows[SRC_ROW:SRC_ROW + 1]),
        ("k_dst", copy_dst_slice(rows[:1], out, DST_ROW, 0, addend=1), want),
    ]


def _section(text, start, stop):
    """The lines from the first that matches `start` up to the next that
    matches `stop` (exclusive)."""
    lines = text.splitlines()
    i = next(k for k, s in enumerate(lines) if re.search(start, s))
    j = next((k for k in range(i + 1, len(lines))
              if re.search(stop, lines[k])), len(lines))
    return lines[i:j]


def dump(out_dir: str = DEFAULT_OUT) -> dict:
    """Write each kernel's PTX and SASS to out_dir; returns {kernel: (PTX
    instructions, SASS instructions)}."""
    nvcc = _build.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (CUDA toolkit required)")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC, "probe_copy.cu")
    ptx_path = os.path.join(out_dir, "probe_copy.ptx")
    subprocess.run([nvcc, "-ptx", "-arch=compute_90a", "-O3", "-std=c++17",
                    "--fmad=false", "-I", _build.CSRC, src, "-o", ptx_path],
                   check=True, capture_output=True)
    ptx = open(ptx_path).read()
    _build.cuda_library("probe_copy")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         _build._cuda_out("probe_copy")[1]],
        check=True, capture_output=True, text=True).stdout
    counts = {}
    for name in KERNELS:
        k = name + "_kernel"
        p = _section(ptx, rf"\.entry\s+{k}\b", r"^\}")
        p.append("}")
        s = _section(sass, rf"Function\s*:\s*{k}\b",
                     r"Function\s*:|^\s*\.{6,}")
        for ext, lines in (("ptx", p), ("sass", s)):
            with open(os.path.join(out_dir, f"{name}.{ext}"), "w") as f:
                f.write("\n".join(lines) + "\n")
        body = [line.strip() for line in p]
        body = body[body.index("{"):]
        counts[name] = (
            sum(1 for line in body if line.endswith(";")
                and not line.startswith((".", "//"))),
            sum(1 for line in s if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)),
        )
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    out = ap.parse_args(argv).out
    pair = run_pair()
    name = card()
    fails = 0
    for what, got, want in pair:
        ok = torch.equal(got, want)
        fails += not ok
        print(f"{what}: {'OK' if ok else 'FAIL'} ({name})")
    for kernel, (ptx, sass) in dump(out).items():
        print(f"{kernel}: {ptx} PTX, {sass} SASS instructions -> "
              f"{os.path.join(out, kernel)}.{{ptx,sass}}")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
