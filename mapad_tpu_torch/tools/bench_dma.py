"""P1 on the card: microseconds a step of T dependent steps of a scattered
row gather (`dma.gather_steps`, csrc/probe_dma.cu).

    python -m mapad_tpu_torch.tools.bench_dma
    W=128 L=1024 T=200 NB=8197 python -m mapad_tpu_torch.tools.bench_dma

Port of tools/bench_dma.py, the design probe of the pool step: each step
moves L rows of W int32 words out of an (NB, W) table at indices that the
previous steps decide (the pool search fetches each lane's 512 B index rows
so).  Defaults as the reference's (:87-90): W=128, L=1024, T=200, and its
NB=2^20 (a 512 MiB table).  The table and the row indices are made on the
card from a seed (values 0-99, as the reference's).  Three forms, timed
with CUDA events in turns after a warm-up, each the median of `rounds`:

  one_launch       all T steps in one cooperative launch (the TPU kernel is
                   one `pallas_call`)
  launch_per_step  the same kernel launched once a step from one host loop,
                   acc carried on the card (the form the pool search's K2
                   had before its one launch a store generation)
  library          plain PyTorch on the card: `index_select` of the rows and
                   a sum of their column 0 a step, the dependency on acc
                   kept (the reference's `run_xla_gather` drops the acc term,
                   so its steps do not depend on each other)

All three must give the same acc.  Each timed call's start event waits
behind a spin on the card (`dma.busy_card`), so the events time the card
and not the host's enqueue of the launch.  Each line names the card; the
bound is L * W * 4 bytes a step over the card's memory rate.
"""

from __future__ import annotations

import os

import torch

from ..ops.fm import resolve_device
from . import card
from .dma import ACC_MOD, STEP_MUL, busy_card, gather_steps

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FORMS = ("one_launch", "launch_per_step", "library")


def make_inputs(nb: int, width: int, lanes: int, seed: int = 0,
                device=None):
    """(rows (nb, width), blk (lanes,)) int32 on the device, from `seed`."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rows = torch.randint(0, 100, (nb, width), generator=g, device=device,
                         dtype=torch.int32)
    blk = torch.randint(0, nb, (lanes,), generator=g, device=device,
                        dtype=torch.int32)
    return rows, blk


def library_steps(rows, blk, steps: int):
    """P1's acc by plain PyTorch calls, one `index_select` a step."""
    acc = torch.zeros(1, dtype=torch.float32, device=rows.device)
    nb = rows.shape[0]
    for t in range(steps):
        a7 = torch.remainder(acc.to(torch.int32), ACC_MOD)
        idx = torch.remainder(blk + t * STEP_MUL + a7, nb)
        acc = acc + rows.index_select(0, idx)[:, 0].to(torch.float32).sum()
    return acc


def step_bound_us(lanes: int, width: int) -> float:
    return lanes * width * 4 / HBM_BYTES_PER_S * 1e6


def measure(rows, blk, steps: int, rounds: int = 5) -> dict:
    """Median microseconds a step of each of FORMS on the card, the forms
    run in turns (the order reversed every other round) after a warm-up.
    Raises if the three forms' acc differ."""
    if not rows.is_cuda:
        raise RuntimeError("P1 is timed on the card only (CUDA events)")

    def library(ev):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        busy_card()
        a.record()
        acc = library_steps(rows, blk, steps)
        b.record()
        ev.append((a, b))
        return acc

    run = {
        "one_launch": lambda ev: gather_steps(rows, blk, steps,
                                              events=ev)[0],
        "launch_per_step": lambda ev: gather_steps(
            rows, blk, steps, launch_per_step=True, events=ev)[0],
        "library": library,
    }
    accs = {form: run[form]([]) for form in FORMS}
    bits = {form: int(a.view(torch.int32)) for form, a in accs.items()}
    if len(set(bits.values())) != 1:
        raise AssertionError(f"P1 forms disagree on acc: {accs}")
    times = {form: [] for form in FORMS}
    for r in range(rounds):
        for form in (FORMS if r % 2 == 0 else FORMS[::-1]):
            ev = []
            run[form](ev)
            times[form].append(ev[0])
    torch.cuda.synchronize()
    out = {}
    for form, pairs in times.items():
        us = sorted(a.elapsed_time(b) * 1e3 / steps for a, b in pairs)
        out[form] = (us[(len(us) - 1) // 2] + us[len(us) // 2]) / 2
    return out


def main() -> int:
    width = int(os.environ.get("W", 128))
    lanes = int(os.environ.get("L", 1024))
    steps = int(os.environ.get("T", 200))
    nb = int(os.environ.get("NB", 1 << 20))
    rows, blk = make_inputs(nb, width, lanes)
    name = card()
    for form, us in measure(rows, blk, steps).items():
        print(f"{form}: L={lanes} W={width} T={steps} NB={nb}: {us:.3f} "
              f"us/step ({name})")
    print(f"bound: {step_bound_us(lanes, width):.4f} us/step "
          f"(L*W*4 bytes at {HBM_BYTES_PER_S / 1e12} TB/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
