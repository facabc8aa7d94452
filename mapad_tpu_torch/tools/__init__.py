"""The TPU round's Pallas probes of its DMA engine and compiler (the files
under tools/ that reach `pl.pallas_call`), ported to the H100 as P1-P4:

  bench_dma      P1: microseconds a step of a dependent scattered row gather
                 (the pool search's step), in one launch, one launch a step
                 and as plain PyTorch on the card
  p1_time        P1 against variants of its source (its bulk-copy form, an
                 older revision) in turns, its latency floor and the SM
                 cycles of each phase of its step
  k2_phases      not a probe: SM cycles of each phase of the pool search's
                 step (K2, csrc/pool_search.cu) on the card
  k10_time       not a probe: K10 (csrc/search_batch.cu) timed against
                 variants of its source, and its phases' SM cycles
  k7_time        not a probe: K7 (csrc/bi_d.cu) timed against variants of
                 its source, its occupancy, and its phases' SM cycles
  k3_time        not a probe: K3 (csrc/extract_chains.cu) and K6 timed
                 against variants of their sources, each time split into
                 card and host, and K3's walk floor and phases
  k45_time       not a probe: K4 (csrc/unpack_prep.cu) and K5
                 (csrc/pack_result.cu) timed against variants of their
                 sources, each time split into card and host, and the
                 engine's host time from K3's wrapper to K5's return
  copy_host      the host side of one P2 copy, part by part, beside the
                 PyTorch call that does the same
  _probe_shapes  P2: a slice of each of eight shapes staged through shared
                 memory, from a strided source or into a strided destination
  _t9            P3: row 7 of a (1024, 32) table through a (1, 32) scratch
  _dump_pair     P4: a sliced-source and a sliced-destination copy, checked,
                 with the PTX and SASS of their kernels written out

Kernels and wrappers: `dma.py` (csrc/probe_dma.cu, csrc/probe_copy.cu).
Each runs as `python -m mapad_tpu_torch.tools.<name>` on the card; their
functions take `device="cpu"` to run the plain versions (the tests do), and
raise without a card otherwise.  This module holds what they share: the
card's name, three ways to time a call (its host part among them), and
the harness of k2_phases, k10_time, k7_time, k3_time, k45_time and
p1_time (a kernel against older or hand-edited copies of its source):
the edit and parallel build of the variants with their ptxas figures,
the in-turn order, the CUDA-event runs, the bit-for-bit check and the
readout of the phases' SM cycles.
"""

from __future__ import annotations

import os
import subprocess


def cards() -> list:
    """Every card as `nvidia-smi --query-gpu=name,power.limit` gives it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()


def card() -> str:
    """The first card as `nvidia-smi --query-gpu=name,power.limit` gives
    it."""
    return cards()[0]


def apply_edits(src: str, edits, what: str) -> str:
    """`src` with each (old, new) of `edits` replaced in turn; raises where
    `old` is not in `src` exactly once (the source `what` no longer has
    that spot)."""
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{what}: no single {old[:48]!r}")
        src = src.replace(old, new)
    return src


def nvcc_all(jobs, flags=()) -> dict:
    """nvcc every (name, .cu path, .so path) of `jobs` at once, with the
    port's flags and `flags` -> {name: (ctypes library, nvcc's output)};
    raises on a failed build."""
    import ctypes

    from .. import _build

    procs = [(name, so, subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-I", _build.CSRC,
         cu, "-o", so], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for name, cu, so in jobs]
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"building {name} failed:\n{log}")
        libs[name] = (ctypes.CDLL(so), log)
    return libs


def build_variants(sources, out_dir: str, prefix: str,
                   flags=("-Xptxas", "-v")) -> dict:
    """nvcc every (name, text) of `sources` at once, each written to
    `out_dir` first, with `flags` (by default ptxas's figures) -> {name:
    (ctypes library, nvcc's output)}."""
    jobs = []
    for name, text in sources:
        cu = os.path.join(out_dir, f"{prefix}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        jobs.append((name, cu, os.path.join(out_dir,
                                            f"lib{prefix}_{name}.so")))
    return nvcc_all(jobs, flags)


def variant_sources(paths) -> list:
    """(name, text) of each variant source file, named by its stem."""
    out = []
    for path in paths:
        with open(path) as f:
            out.append((os.path.splitext(os.path.basename(path))[0],
                        f.read()))
    return out


def in_turns(names) -> list:
    """The order the variants run in: each once, then again in reverse, so
    that a drift of the card's clock falls on both sides alike."""
    names = list(names)
    return names + names[::-1]


def event_runs(call, n: int = 3) -> list:
    """ms of each of `n` calls of call(), each between two CUDA events."""
    import torch

    out = []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        call()
        ev[1].record()
        ev[1].synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return out


def same_bits(got, want, what: str):
    """Raise unless each tensor of `got` equals its own in `want` bit for
    bit (f32 compared as their int32 bits)."""
    import torch

    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: field {k} differs")


def print_phases(unit: str, phases, cyc, steps, extra: str = ""):
    """Print the SM cycles a step of each phase on the longest `unit` (the
    most steps, then the most cycles) and their mean over all its steps.
    cyc: (units, phases) cycles, steps: (units,) steps, both float64."""
    import torch

    top = steps == steps.max()
    i = int(torch.where(top, cyc.sum(1), -1.0).argmax())
    mine = cyc[i] / max(float(steps[i]), 1.0)
    mean = cyc.sum(0) / max(float(steps.sum()), 1.0)
    print(f"  cycles a step, longest {unit} ({i}, {int(steps[i])} steps): "
          + ", ".join(f"{p} {float(c):.0f}" for p, c in zip(phases, mine))
          + f" (sum {float(mine.sum()):.0f}); mean over {unit} steps: "
          + ", ".join(f"{p} {float(c):.0f}" for p, c in zip(phases, mean))
          + f" (sum {float(mean.sum()):.0f}){extra}", flush=True)


def host_us(fn, reps: int) -> float:
    """us a call of fn() takes on the host, the card left to run behind
    it (a warm-up call first; the card synchronized before and after)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    dt = time.perf_counter_ns() - t
    torch.cuda.synchronize()
    return dt / reps / 1e3


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over `reps` calls, CUDA events around the run (a
    warm-up call first).  For a small kernel this is the launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int, tries: int = 3):
    """Mean ms a call of fn() keeps the card busy, from `torch.profiler`:
    the device time of every kernel and copy it ran (`key_averages()`), over
    `reps` calls.  A profiler session can come back without device activity
    (most often the first one of a process, while its tracer starts up), so
    up to `tries` sessions are made; None when none of them saw any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    return None
