"""Big-mode index rows at the sizes that select big mode.

`synthetic_index(n, seed, device)` makes, on the card and a chunk of rows
at a time, the fused rows of big mode (`[cp_lo(6) | cp_hi(6) | 116 words of
4-bit symbols]`, k = 928; `DeviceFmIndex.from_host(..., big=True)`'s
layout byte for byte) of a BWT of `n` symbols: random ranks 1..4 from a
seeded `torch.Generator` on that device, runs of X (rank 5: a genome's long
N runs) of 20 bp to tens of kbp, about one a SYNTHETIC_X_EVERY symbols,
and two sentinels (rank 0), all at positions drawn from the seed.  The whole BWT never exists, on the host or
on the card: a table of rows past 2^32 (n = 4.4e9: 4,741,380 rows, 2.43 GB)
takes seconds, with no genome and no index build.  The symbols are not the
BWT of a text, but every rank query is well defined on them, so a kernel
and its plain version can be held against each other there;
`text_strings` walks the LF mapping backwards to give strings whose
backward search never runs empty (reads that hit; a walk that meets an X
is drawn again).

    python -m mapad_tpu_torch.tools.big_rows load-peak -g GENOME.fa \\
        [--device cuda]

loads the index bundle of GENOME.fa, packs its device rows onto the device
by `DeviceFmIndex.from_host` (big mode where the text selects it; the
bundle's row cache removed first and written again, as the engine's first
load does), and prints one JSON line: seconds, the process's peak resident
memory before and after the packing, the rows' bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from ..ops.fm import (
    OCC_K_BIG,
    ROW_WORDS,
    DeviceFmIndex,
    _row_occ4,
    fill_rows,
    resolve_device,
)

# rows of the synthetic table made at once: 61 M symbols, ~0.6 GB of
# temporaries on the card
SYNTHETIC_CHUNK_ROWS = 1 << 16
# X runs: about one a SYNTHETIC_X_EVERY symbols, of 20 bp (a run the index
# builder makes X) to X_RUN_MAX, log-uniform (~0.6% of the symbols); on a
# short table at most n // 256
SYNTHETIC_X_EVERY = 1 << 20
X_RUN_MIN, X_RUN_MAX = 20, 50_000


def synthetic_sentinels(n: int, seed: int) -> tuple[int, int]:
    """The two sentinel positions of the synthetic BWT of `n` symbols,
    distinct and in order (the same on every device)."""
    rng = np.random.default_rng(seed)
    a, b = (int(v) for v in rng.integers(0, n - 1, size=2))
    if b >= a:
        b += 1
    return min(a, b), max(a, b)


def synthetic_x_runs(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The X runs of the synthetic BWT of `n` symbols -> (starts, ends),
    int64, in order, none touching another."""
    rng = np.random.default_rng([seed, 5])
    count = n // SYNTHETIC_X_EVERY + 1
    top = max(X_RUN_MIN, min(X_RUN_MAX, n // 256))
    length = np.exp(rng.uniform(np.log(X_RUN_MIN), np.log(top + 1),
                                size=count)).astype(np.int64)
    length = np.clip(length, X_RUN_MIN, top)
    start = np.sort(rng.integers(0, n - top, size=count))
    keep, end = [], -1
    for i, s in enumerate(start.tolist()):
        if s > end:
            keep.append(i)
            end = s + int(length[i])
    start, length = start[keep], length[keep]
    return start, start + length


def synthetic_bwt(n: int, seed: int, device):
    """The synthetic BWT of `n` symbols, SYNTHETIC_CHUNK_ROWS rows at a
    time: yields (first row, (rows, 928) uint8 ranks on `device`, 15 past
    the text)."""
    k = OCC_K_BIG
    sent = synthetic_sentinels(n, seed)
    x_start, x_end = synthetic_x_runs(n, seed)
    g = torch.Generator(device=device).manual_seed(seed)
    nb = -(-n // k)
    for b0 in range(0, nb, SYNTHETIC_CHUNK_ROWS):
        b1 = min(nb, b0 + SYNTHETIC_CHUNK_ROWS)
        lo, hi = b0 * k, min(b1 * k, n)
        sym = torch.full(((b1 - b0) * k,), 15, dtype=torch.uint8,
                         device=device)
        sym[: hi - lo] = torch.randint(1, 5, (hi - lo,), generator=g,
                                       dtype=torch.uint8, device=device)
        first = int(np.searchsorted(x_end, lo, side="right"))
        last = int(np.searchsorted(x_start, hi, side="left"))
        for a, b in zip(x_start[first:last].tolist(),
                        x_end[first:last].tolist()):
            sym[max(a, lo) - lo : min(b, hi) - lo] = 5
        for s in sent:
            if lo <= s < hi:
                sym[s - lo] = 0
        yield b0, sym.view(b1 - b0, k)


def synthetic_index(n: int, seed: int, device=None) -> DeviceFmIndex:
    """The big-mode DeviceFmIndex of the synthetic BWT of `n` symbols, its
    rows made on `device` (default: the card) a chunk at a time."""
    device = resolve_device(device)
    nb = -(-n // OCC_K_BIG)
    rows = torch.empty((nb, ROW_WORDS), dtype=torch.int32, device=device)
    counts = fill_rows(rows, synthetic_bwt(n, seed, device), True)
    less = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    sentinels = torch.tensor(synthetic_sentinels(n, seed), dtype=torch.int64,
                             device=device)
    return DeviceFmIndex(rows=rows, less=less, sentinels=sentinels,
                         occ_k=OCC_K_BIG, text_len=n, big=True)


def edge_ranks(index: DeviceFmIndex, count: int, seed: int) -> torch.Tensor:
    """`count` int64 ranks of `index` on its device: -1, the first and
    last ranks of the first, second and last rows, n - 2 and n - 1, the
    ranks around 2^31 and 2^32 where the text has them (a row's either
    side and the row they fall in), then random ranks from `seed`."""
    n, k, nb = index.text_len, index.occ_k, index.rows.shape[0]
    edges = [-1, 0, 1, k - 1, k, k + 1, (nb - 1) * k - 1, (nb - 1) * k,
             n - 2, n - 1]
    for e in (2**31, 2**32):
        edges += [e - k - 1, e - 2, e - 1, e, e + 1, e + k]
    edges = torch.tensor([e for e in edges if -1 <= e < n],
                         dtype=torch.int64)
    g = torch.Generator(device="cpu").manual_seed(seed)
    more = torch.randint(0, n, (count - edges.numel(),), generator=g,
                         dtype=torch.int64)
    return torch.cat([edges, more]).to(index.rows.device)


def bwt_symbols(index: DeviceFmIndex, r: torch.Tensor) -> torch.Tensor:
    """(N,) positions -> (N,) int64 BWT ranks at them, read from the rows."""
    k = index.occ_k
    row = index.rows[r // k]
    off = r % k
    word = row.gather(1, (index.n_cp_cols + off // 8)[:, None])[:, 0]
    return (word.long() >> (4 * (off % 8))) & 0xF


def text_strings(index: DeviceFmIndex, count: int, length: int,
                 seed: int) -> torch.Tensor:
    """`count` strings of `length` ranks (1..4, in text order) whose
    backward search over `index` never runs empty: each is an LF walk from
    a random position, read backwards (a walk that meets a sentinel is
    drawn again).  Plain PyTorch; -> (count, length) int64 on the index's
    device."""
    dev = index.rows.device
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    need = count
    while need > 0:
        j = torch.randint(0, index.text_len, (2 * need,), generator=g,
                          dtype=torch.int64).to(dev)
        walked, ok = [], torch.ones_like(j, dtype=torch.bool)
        for _ in range(length):
            c = bwt_symbols(index, j)
            ok &= (c >= 1) & (c <= 4)
            c = c.clamp(1, 4)
            occ = _row_occ4(index, j - 1).gather(1, (c - 1)[:, None])[:, 0]
            j = index.less[c] + occ
            walked.append(c)
        strings = torch.stack(walked[::-1], dim=1)[ok][:need]
        out.append(strings)
        need -= strings.shape[0]
    return torch.cat(out)


def _peak_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def load_peak(fasta: str, device=None) -> dict:
    """Load the bundle of `fasta` and pack its rows onto `device`, the row
    cache made anew -> seconds, peak resident GiB before and after, rows'
    bytes."""
    from ..index import load_index

    device = resolve_device(device)
    torch.empty(1, device=device)  # the device's context before the peak
    index = load_index(fasta)
    fmd = index.fmd
    for name in ("device_rows_k976.npy", "device_rows_k928_big.npy"):
        path = os.path.join(fmd.cache_dir, name)
        if os.path.exists(path):
            os.remove(path)
    before = _peak_gib()
    t = time.perf_counter()
    dfm = DeviceFmIndex.from_host(fmd, device=device)
    if dfm.rows.is_cuda:
        torch.cuda.synchronize(dfm.rows.device)
    return dict(seconds=time.perf_counter() - t, big=dfm.big,
                peak_gib_before=before, peak_gib=_peak_gib(),
                text_len=len(fmd.bwt), rows_bytes=dfm.rows.numel() * 4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="big_rows")
    sub = ap.add_subparsers(dest="command", required=True)
    lp = sub.add_parser("load-peak", help="pack a bundle's device rows "
                        "and print the host's peak resident memory")
    lp.add_argument("-g", "--reference", required=True)
    lp.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    print(json.dumps(load_peak(args.reference, args.device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
