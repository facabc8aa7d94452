"""The TPU round's Pallas probes of its DMA engine and compiler (the files
under tools/ that reach `pl.pallas_call`), ported to the H100 as P1-P4:

  bench_dma      P1: microseconds a step of a dependent scattered row gather
                 (the pool search's step), in one launch, one launch a step
                 and as plain PyTorch on the card
  k2_phases      not a probe: SM cycles of each phase of the pool search's
                 step (K2, csrc/pool_search.cu) on the card
  k10_time       not a probe: K10 (csrc/search_batch.cu) timed against
                 variants of its source, and its phases' SM cycles
  _probe_shapes  P2: a slice of each of eight shapes staged through shared
                 memory, from a strided source or into a strided destination
  _t9            P3: row 7 of a (1024, 32) table through a (1, 32) scratch
  _dump_pair     P4: a sliced-source and a sliced-destination copy, checked,
                 with the PTX and SASS of their kernels written out

Kernels and wrappers: `dma.py` (csrc/probe_dma.cu, csrc/probe_copy.cu).
Each runs as `python -m mapad_tpu_torch.tools.<name>` on the card; their
functions take `device="cpu"` to run the plain versions (the tests do), and
raise without a card otherwise.  This module holds what they share: the
card's name, two ways to time a call, and the edit-and-build of kernel
variants that k2_phases and k10_time (SM cycles and times of K10, the
batch search, against older or hand-edited copies of its source) share.
"""

from __future__ import annotations

import subprocess


def card() -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` gives it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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


def device_ms(fn, reps: int):
    """Mean ms a call of fn() keeps the card busy, from `torch.profiler`:
    the device time of every kernel and copy it ran (`key_averages()`), over
    `reps` calls.  None when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None
