"""P1 on the card against variants of its source, at `chip_smoke.py`'s
three tables, in one process.

    python -m mapad_tpu_torch.tools.p1_time [--phases] [variant.cu ...]

Builds the checkout's csrc/probe_dma.cu, its "bulk" form (made here by
`BULK_EDITS`: each row moved by one bulk copy, `cp.async.bulk` on the TMA
engine, all of a block's rows a step counted by one mbarrier whose phase
flips a step, where the rows are 16-byte aligned; the checkout's moves a
row a warp by 16-byte `cp.async`) and each variant source given (a copy
edited by hand, or an older revision such as the parent's: `git show
<rev>:mapad_tpu_torch/csrc/probe_dma.cu > .proof/probe_dma_parent.cu`) at
once.  A variant without `GatherPlan` is of the older form (a
cooperative-groups grid sync a step and a partials array of 2 x L words,
its grid chosen inside the entry) and is launched as that form was.  At
each table of `chip_smoke.PROBE_TABLES` (L=1024 lanes of W=128 words,
T=200 steps, the table made on the card from seed 0) it prints:

  us a step  of each build in both forms (one launch of T steps; one
             launch a step, queued from the entry's host loop), by CUDA
             events around one call (behind a spin on the card,
             `dma.busy_card`, so they time the card): eight turns, each
             build visited once a turn (the order reversed every other
             turn) for three calls a form; each visit's median, and the
             median of the eight; every call from acc = 0 and t0 = 0,
             its acc and chk held bit for bit against the checkout's
             wrapper;
  floors     the bytes bound (L x W x 4 bytes a step at 3.35 TB/s) and
             the latency floor: one dependent load a step, the card's
             dependent-load latency (`dma.load_latency_ns`) through a
             cycle as large as the table.

`--phases` also builds an instrumented copy of the checkout's source
(`PHASE_EDITS`: `clock64()` probes in each block's thread 0, which is in
warp 0, the warp that polls) and prints, at each table, the mean SM
cycles a block-step of each phase of one launch of T steps:

  gather   the step's indices and its rows' copies, up to the block
           barrier after `cp.async.wait_all`
  reduce   column 0 and the XOR of the rows in shared memory, the warps'
           sums, up to the block barrier after them
  barrier  warp 0: the block's sum, its slot's store and the poll until
           every slot carries the step's tag (the wait for the slowest
           block included), and the polls a step
  release  the total through shared memory to the block's warps
"""
from __future__ import annotations

import ctypes
import os
import sys

import torch

from .. import _build
from ..ops.fm import resolve_device
from . import (apply_edits, bench_dma, build_variants, card, dma,
               variant_sources)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKOUT = "checkout"
BULK = "bulk"
PHASED = "phases"
TURNS = 8  # each build visited once a turn, the order reversed every other
RUNS = 3   # calls a visit and form, their median kept
PHASES = ("gather", "reduce", "barrier", "release")

# the checkout's source -> a copy with clock64() probes: each block's
# thread 0 sums its cycles a phase and its polls, and adds them (and its
# steps) to a device array when the kernel ends
PHASE_EDITS = [
    ("using mapad::floor_mod;\n", """using mapad::floor_mod;

__device__ unsigned long long p1_phase[8];
extern "C" int p1_phase_reset() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(p1_phase, z, sizeof(z));
}
extern "C" int p1_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, p1_phase, sizeof(p1_phase));
}
#define P1_PHASE(i)                 \\
  do {                              \\
    const long long t_ = clock64(); \\
    ph_[i] += t_ - ph_t_;           \\
    ph_t_ = t_;                     \\
  } while (0)
"""),
    ("  int chk = 0;\n  for (int s = 0; s < a.steps; ++s) {\n", """\
  int chk = 0;
  long long ph_[4] = {0, 0, 0, 0};
  long long ph_t_ = 0, polls_ = 0;
  for (int s = 0; s < a.steps; ++s) {
    ph_t_ = clock64();
"""),
    ("    cp_async_wait_all();\n    __syncthreads();\n",
     "    cp_async_wait_all();\n    __syncthreads();\n    P1_PHASE(0);\n"),
    ("    if (tl == 0) red[warp] = part;\n    __syncthreads();\n",
     "    if (tl == 0) red[warp] = part;\n    __syncthreads();\n"
     "    P1_PHASE(1);\n"),
    ("        sum = 0;\n        all = true;\n",
     "        sum = 0;\n        all = true;\n        ++polls_;\n"),
    ("      } while (!__all_sync(FULL, all));\n",
     "      } while (!__all_sync(FULL, all));\n      P1_PHASE(2);\n"),
    ("    acc = acc + (float)total;\n",
     "    acc = acc + (float)total;\n    P1_PHASE(3);\n"),
    ("  for (int o = 16; o; o >>= 1) chk ^= __shfl_xor_sync(FULL, chk, o);\n",
     """\
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i)
      atomicAdd(&p1_phase[i], (unsigned long long)ph_[i]);
    atomicAdd(&p1_phase[4], (unsigned long long)polls_);
    atomicAdd(&p1_phase[5], (unsigned long long)a.steps);
  }
  for (int o = 16; o; o >>= 1) chk ^= __shfl_xor_sync(FULL, chk, o);
"""),
]

# the checkout's source -> its bulk form
BULK_EDITS = [
    ("__global__ void __launch_bounds__(THREADS)", """\
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait_phase(unsigned bar, int parity) {
  asm volatile("{\\n.reg .pred p;\\nWAIT:\\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\\n"
               "@!p bra WAIT;\\n}\\n" ::"r"(bar), "r"(parity) : "memory");
}

__global__ void __launch_bounds__(THREADS)"""),
    ("  float acc = a.acc[0];\n", """\
  float acc = a.acc[0];
  __shared__ __align__(8) unsigned long long bar;
  const unsigned bb = mapad::smem_addr(&bar);
  if (vec && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(bb)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
"""),
    ("    for (int j = warp; j < nl; j += WARPS) {\n"
     "      const int idx = floor_mod(a.blk[lane0 + j] + t * 1237 + a7, "
     "a.NB);\n", """\
    if (vec) {
      if (threadIdx.x == 0) {
        const unsigned bytes = (unsigned)a.W * 4u;
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        bar_expect(bb, bytes * (unsigned)nl);
        for (int j = 0; j < nl; ++j) {
          const int idx = floor_mod(a.blk[lane0 + j] + t * 1237 + a7, a.NB);
          mapad::bulk_load(scratch + (size_t)j * a.W,
                           a.rows + (size_t)idx * a.W, bytes, bb);
        }
      }
      bar_wait_phase(bb, s & 1);
    } else
    for (int j = warp; j < nl; j += WARPS) {
      const int idx = floor_mod(a.blk[lane0 + j] + t * 1237 + a7, a.NB);
"""),
    ("    cp_async_wait_all();\n    __syncthreads();\n", """\
    if (!vec) {
      cp_async_wait_all();
      __syncthreads();
    }
"""),
]


class P1Build:
    """One build's P1 entry, launched bare (argument block made once a
    table)."""

    def __init__(self, lib, text):
        self.planned = "GatherPlan" in text
        self.fn = lib.probe_dma_gather
        self.fn.restype = ctypes.c_int
        if self.planned:
            self.fn.argtypes = [ctypes.POINTER(dma._GatherArgs),
                                ctypes.POINTER(dma._GatherPlanC),
                                ctypes.c_int, ctypes.c_void_p]
            fig = (ctypes.c_int * 2)()
            _build.check(lib.gather_card(fig), "gather_card")
            occ = lib.gather_occupancy
            occ.restype = ctypes.c_int
            occ.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]

            def per_sm(smem):
                n = ctypes.c_int(0)
                _build.check(occ(smem, ctypes.byref(n)), "gather_occupancy")
                return n.value
            self.figures = (fig[0], per_sm, fig[1])
        else:
            self.fn.argtypes = [ctypes.POINTER(dma._GatherArgs),
                                ctypes.c_int, ctypes.c_void_p]

    def setup(self, rows, blk, steps):
        """-> (call(per_step), acc, chk): the entry on zeroed acc and chk
        from t0 = 0; the planned form's slots zeroed once here."""
        nb, width = rows.shape
        lanes = blk.shape[0]
        acc = torch.zeros(1, dtype=torch.float32, device=rows.device)
        chk = torch.zeros(1, dtype=torch.int32, device=rows.device)
        stream = torch.cuda.current_stream().cuda_stream
        if self.planned:
            sms, per_sm, smem = self.figures
            plan = dma.gather_plan(lanes, width, sms, per_sm, smem)
            scratch = torch.zeros(dma.slot_words(plan), dtype=torch.int32,
                                  device=rows.device)
            pc = dma._GatherPlanC(*plan)
        else:
            scratch = torch.empty(2 * lanes, dtype=torch.int32,
                                  device=rows.device)
            pc = None
        a = dma._GatherArgs(rows.data_ptr(), blk.data_ptr(), acc.data_ptr(),
                            chk.data_ptr(), scratch.data_ptr(), nb, width,
                            lanes, 0, steps)

        def call(per_step):
            acc.zero_()
            chk.zero_()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            dma.busy_card()
            ev[0].record()
            rc = (self.fn(ctypes.byref(a), pc, per_step, stream)
                  if self.planned else
                  self.fn(ctypes.byref(a), per_step, stream))
            ev[1].record()
            _build.check(rc, "probe_dma_gather")
            ev[1].synchronize()
            return ev[0].elapsed_time(ev[1]) * 1e3 / steps, scratch
        return call, acc, chk


def _phases(what, build, lib, rows, blk, T, want):
    """Print the phases' mean SM cycles a block-step of one launch of the
    instrumented build, its acc and chk held bit for bit against `want`."""
    call, acc, chk = build.setup(rows, blk, T)
    call(0)
    _build.check(lib.p1_phase_reset(), "p1_phase_reset")
    us = call(0)[0]
    if not (torch.equal(acc.view(torch.int32), want[0].view(torch.int32))
            and torch.equal(chk, want[1])):
        raise AssertionError("P1 with the phase probes: acc or chk differs")
    out = (ctypes.c_ulonglong * 8)()
    _build.check(lib.p1_phase_read(out), "p1_phase_read")
    steps = max(int(out[5]), 1)
    cyc = [out[i] / steps for i in range(4)]
    print(f"  phases ({what}), SM cycles a block-step, one launch: "
          + ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, cyc))
          + f" (sum {sum(cyc):.0f}, {sum(cyc) / us:.0f} a us at this "
          f"launch's {us:.3f} us a step); polls a step {out[4] / steps:.2f}",
          flush=True)


def _table(what, nb, builds, dev, phased=None):
    cs = _smoke()
    rows, blk = bench_dma.make_inputs(nb, cs.PROBE_W, cs.PROBE_L, seed=0,
                                      device=dev)
    T = cs.PROBE_T
    want = dma.gather_steps(rows, blk, T)
    torch.cuda.synchronize()
    runs = {}
    calls = {name: b.setup(rows, blk, T) for name, b in builds.items()}
    for turn in range(TURNS):
        for name in (builds if turn % 2 == 0 else list(builds)[::-1]):
            call, acc, chk = calls[name]
            for per_step in (0, 1):
                us = [call(per_step)[0] for _ in range(RUNS)]
                if not (torch.equal(acc.view(torch.int32),
                                    want[0].view(torch.int32))
                        and torch.equal(chk, want[1])):
                    raise AssertionError(f"P1 {name} per_step={per_step}: "
                                         "acc or chk differs")
                runs.setdefault((name, per_step), []).append(
                    sorted(us)[len(us) // 2])
    torch.cuda.synchronize()
    lat = dma.load_latency_ns(dev, nb * cs.PROBE_W)
    print(f"P1 at {what} (NB={nb}, {nb * cs.PROBE_W * 4 / 1e6:.1f} MB), "
          f"L={cs.PROBE_L} W={cs.PROBE_W} T={T}: bytes bound "
          f"{bench_dma.step_bound_us(cs.PROBE_L, cs.PROBE_W):.4f} us a step; "
          f"latency floor {lat / 1e3:.4f} us a step (one dependent load, "
          f"{lat:.1f} ns through {nb * cs.PROBE_W * 4 / 1e6:.1f} MB)",
          flush=True)
    for (name, per_step), us in runs.items():
        us = sorted(us)
        print(f"  {name} "
              f"{'launch per step' if per_step else 'one launch'}: "
              f"{(us[(len(us) - 1) // 2] + us[len(us) // 2]) / 2:.3f} us a "
              f"step (turns {', '.join(f'{x:.3f}' for x in us)}); "
              "bit-exact", flush=True)
    if phased is not None:
        _phases(what, *phased, rows, blk, T, want)
    del rows, blk


def _smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    phases = "--phases" in argv
    argv = [a for a in argv if a != "--phases"]
    resolve_device(None)
    _build.build_cuda(_build.PROBE_SOURCES)
    out_dir = os.path.join(_build.BUILD_DIR, "p1_time")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, "probe_dma.cu")) as f:
        text = f.read()
    src = [(CHECKOUT, text),
           (BULK, apply_edits(text, BULK_EDITS, "csrc/probe_dma.cu"))]
    src += variant_sources(argv)
    if phases:
        src.append((PHASED, apply_edits(text, PHASE_EDITS,
                                        "csrc/probe_dma.cu")))
    libs = build_variants(src, out_dir, "p1")
    cs = _smoke()
    for name, (_lib, log) in sorted(libs.items()):
        for entry, figs in cs.ptxas_entries(log):
            print(f"ptxas {name} {entry}: {figs}", flush=True)
    print(card(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    texts = dict(src)
    builds = {n: P1Build(libs[n][0], texts[n]) for n in texts}
    phased = (builds.pop(PHASED), libs[PHASED][0]) if phases else None
    for what, nb in cs.PROBE_TABLES:
        _table(what, nb, builds, dev, phased)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
