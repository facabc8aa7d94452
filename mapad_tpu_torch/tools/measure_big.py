"""The int64 (big-mode) pool kernel on a loaded index past 2^31 symbols:
port of tools/measure_big.py.

On the card: one pool invocation (K2 + K3) of the first 4,096 reads,
prepared by the engine's own block prep (K6 and K7 run before the clock),
at L lanes, S steps, a per-read cap of CAP and 8,192 chains (the TPU tool's
shape); a first call, then the best of three timed calls.  Prints one
line: ms an invocation, steps and us a step, chains, abandons and
unfinished lanes, the rows' and the frame store's device memory (the
store's as allocated: L x (S+1) x 9 frames of 11 int32 words) and the
invocation's peak over what was allocated before it, and kernel-level
reads/s.

    python -m mapad_tpu_torch.tools.measure_big -g GENOME.fa -r READS.fq \\
        [--lanes 512] [--n-reads 4096] [--steps 8192] [--cap 1024] \\
        [map flags: -p 0.03 -l single_stranded ...]

The index bundle must exist (`index -g GENOME.fa`); its text must need
int64 mode by itself (2^31 - 1 symbols or more), or the tool fails.
From Python, `measure(..., device="cpu", big=True)` runs the plain
versions on a small index (the tests do).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

LANES, READS, STEPS, CAP, CHAINS = 512, 4096, 8192, 1024, 8192


def measure(index, params, records, lanes: int = LANES, steps: int = STEPS,
            cap: int = CAP, device=None, big: bool | None = None) -> dict:
    """Time one big-mode pool invocation over `records` on `index` (an
    `index.runtime.Index`) -> its figures.  `big` forces int64 mode on a
    smaller text; by default the text must select it."""
    from ..ops import search_pool2 as sp2
    from ..ops.engine import DeviceSearchEngine
    from ..ops.search_pool2 import CANDS, NFP_BIG

    engine = DeviceSearchEngine(index.fmd, params, lanes=lanes,
                                packed_hits=True, device=device, big=big)
    idx = engine.device_index
    if not idx.big:
        raise AssertionError(f"a text of {idx.text_len} symbols did not "
                             "select int64 mode")
    dev = engine.device
    on_card = dev.type == "cuda"
    R = len(records)
    cfg = engine.pool_config._replace(
        lanes=lanes, total_steps=steps, read_step_cap=cap,
        max_chains=CHAINS, generations=1)
    cfg, prep, _t0 = engine._prep_block(records, R, cfg)
    with torch.cuda.device(dev) if on_card else contextlib.nullcontext():
        consts, kw = engine._upload(prep)
        slut = kw.get("slut")
        if slut is None:
            slut = sp2._dense_slut(idx, kw["dense"], consts[0], consts[1],
                                   cfg, kw["bid_steps"])
        params_d = engine._params()

        def run():
            return sp2.k_mismatch_search_pool2(idx, *consts, params_d, cfg,
                                               slut=slut)

        if on_card:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        res = run()
        n_steps = int(res.steps)
        first_s = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated(dev) - before if on_card
                else 0)
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            res = run()
            n_steps = int(res.steps)
            best = min(best, time.perf_counter() - t)
    n_chains = int(res.n_chains)
    valid = res.c_read[: min(n_chains, cfg.max_chains)] >= 0
    return dict(
        text_len=idx.text_len, big=idx.big, reads=R, lanes=cfg.lanes,
        total_steps=cfg.total_steps, read_step_cap=cfg.read_step_cap,
        max_len=cfg.max_len, first_s=first_s, ms=best * 1e3,
        steps=n_steps, us_step=best * 1e6 / max(n_steps, 1),
        chains=n_chains,
        abandons=int((res.c_abandon[: valid.numel()] & valid).sum()),
        unfinished=int(res.lane_unfinished.sum()),
        max_lower=int(res.c_lower[: valid.numel()][valid].max())
        if bool(valid.any()) else -1,
        rows_gb=idx.rows.numel() * 4 / 1e9,
        store_gb=cfg.lanes * (cfg.total_steps + 1) * CANDS * NFP_BIG * 4
        / 1e9,
        invocation_peak_gb=peak / 1e9,
        reads_per_s=R / best,
    )


def line(m: dict) -> str:
    return (f"measure_big: text {m['text_len']:,} symbols (int64 mode "
            f"{m['big']}), {m['reads']} reads, L={m['lanes']} "
            f"S={m['total_steps']} CAP={m['read_step_cap']} M={m['max_len']}"
            f": {m['ms']:.2f} ms an invocation (best of 3; first "
            f"{m['first_s']:.2f} s), {m['steps']} steps, "
            f"{m['us_step']:.3f} us a step, chains {m['chains']}, abandons "
            f"{m['abandons']}, unfinished lanes {m['unfinished']}, largest "
            f"chain lower {m['max_lower']:,}; rows {m['rows_gb']:.3f} GB, "
            f"store {m['store_gb']:.3f} GB, invocation peak "
            f"{m['invocation_peak_gb']:.3f} GB; kernel-level "
            f"{m['reads_per_s']:,.0f} reads/s")


def main(argv=None) -> int:
    from .. import cli
    from ..index import load_index
    from ..io.sniff import InputSource
    from . import card

    ap = argparse.ArgumentParser(prog="measure_big")
    ap.add_argument("-g", "--reference", required=True)
    ap.add_argument("-r", "--reads", required=True)
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--n-reads", type=int, default=READS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--cap", type=int, default=CAP)
    args, map_flags = ap.parse_known_args(argv)
    margs = cli.build_parser().parse_args(
        ["map", "-r", args.reads, "-g", args.reference, "-o", "-",
         *map_flags])
    params = cli.build_alignment_parameters(margs)
    records = next(InputSource.from_path(args.reads)
                   .task_queue(args.n_reads)).records
    m = measure(load_index(args.reference), params, records, args.lanes,
                args.steps, args.cap)
    print(line(m), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
