"""The index load's device rows, `DeviceFmIndex.from_host`, timed on the
card: cold (the bundle's row cache removed first, so that the rows are
packed and the cache written, as at an engine's first load) and warm (the
rows read back from that cache), best and median of `--reps` each.

    python -m mapad_tpu_torch.tools.load_time [-g GENOME.fa | --size BP]
        [--root DIR ...] [--reps 5] [--device cuda]

Without `-g`, writes a genome of `--size` random bases (4,000,000 by
default, the size of `chip_smoke.py`'s path 1) from a seed under
`.smoke/load_time/`, and indexes it with this checkout's CLI.  Each
`--root` names a checkout of the repository whose `mapad_tpu_torch` is
timed in a process of its own, in the order given (default: this
checkout), so that two revisions alternate on one card: `--root PARENT
--root . --root . --root PARENT`.  Prints one JSON line a turn.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# runs in a process of its own with the checkout's root first on sys.path
BODY = r"""
import json, os, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from mapad_tpu_torch.index import load_index
from mapad_tpu_torch.ops.fm import DeviceFmIndex

fasta, reps, dev = sys.argv[2], int(sys.argv[3]), torch.device(sys.argv[4])
torch.empty(1, device=dev)  # the device's context first
t = time.perf_counter()
fmd = load_index(fasta).fmd
load_s = time.perf_counter() - t


def once():
    t = time.perf_counter()
    rows = DeviceFmIndex.from_host(fmd, device=dev).rows
    if rows.is_cuda:
        torch.cuda.synchronize(rows.device)
    return time.perf_counter() - t, rows.numel() * 4


cold, warm = [], []
for _ in range(reps):
    for name in os.listdir(fmd.cache_dir):
        if name.startswith("device_rows_"):
            os.remove(os.path.join(fmd.cache_dir, name))
    cold.append(once()[0])
    secs, nbytes = once()
    warm.append(secs)
print(json.dumps(dict(
    root=sys.argv[1], text_len=len(fmd.bwt), rows_bytes=nbytes,
    load_index_s=load_s, cold_best_s=min(cold),
    cold_median_s=statistics.median(cold), warm_best_s=min(warm),
    warm_median_s=statistics.median(warm))), flush=True)
"""


def random_genome(size: int, seed: int) -> str:
    """A FASTA of `size` random bases under .smoke/load_time/ (written
    once) with its index bundle made by this checkout's CLI -> its path."""
    import numpy as np

    work = os.path.join(ROOT, ".smoke", "load_time")
    os.makedirs(work, exist_ok=True)
    fasta = os.path.join(work, f"genome_{size}_{seed}.fa")
    if not os.path.exists(fasta):
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)[
            np.random.default_rng(seed).integers(0, 4, size)]
        with open(fasta + ".tmp", "wb") as f:
            f.write(b">chr1\n")
            for i in range(0, size, 80):
                f.write(bases[i : i + 80].tobytes() + b"\n")
        os.replace(fasta + ".tmp", fasta)
    if not os.path.exists(os.path.join(f"{fasta}.tpx", "meta.json")):
        subprocess.run([sys.executable, "-m", "mapad_tpu_torch.cli", "index",
                        "-g", fasta], cwd=ROOT, check=True)
    return fasta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="load_time")
    ap.add_argument("-g", "--reference", default=None)
    ap.add_argument("--size", type=int, default=4_000_000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fasta = args.reference or random_genome(args.size, args.seed)
    for root in args.root or [ROOT]:
        subprocess.run([sys.executable, "-c", BODY, os.path.abspath(root),
                        fasta, str(args.reps), args.device], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
