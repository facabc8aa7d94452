"""K2 on the card, phase by phase: SM cycles of a lane's step in each part
of the pool step kernel (csrc/pool_search.cu), at `chip_smoke.py`'s K2
check shape.

    python -m mapad_tpu_torch.tools.k2_phases [variant.cu ...]

Builds an instrumented copy of csrc/pool_search.cu (or of each variant
source given, a copy of it edited by hand) with `clock64()` probes between
the phases of a step, each warp summing its cycles a phase and adding them
to a device array when the kernel ends; runs it through the wrapper
(`ops/search_pool2.py` `_pool_loop_cuda`) on `chip_smoke.py`'s workload:
path 1's genome and the first 1,024 reads of its first block (L=512,
S=8192, CAP=3072), then 512 of them with int64 intervals on the same
index.  Each variant's result is held bit for bit against the kernel of
the checkout; each line gives us a step (host clock around one
synchronized call, the best of three) and the mean cycles a lane-step of
each phase:

  scan    the pop's ring scan and its warp reduction
  stage   the popped block's round trip into shared memory
  argmax  the block's first max candidate, the frame decode
  K1+LUT  the LUT/Bi-D rows and K1's two rank queries, the child intervals
  cands   the 9 candidates and the running best
  barrier the store write, the block's count, the grid barrier (warp 0's
          poll) and the sums, up to the block barrier after them
  refill  the rank, the new read, the counters

The block barrier defers its wait to a warp's next memory access (SASS
`BAR.SYNC.DEFER_BLOCKING`), and the refill's first loads (the block's
sums) come right after it: most of the wait for the step's slowest lane
shows in "refill", so read "barrier" and "refill" together.  The clock
runs per SM; a phase's mean hides the slowest lane.  The probes cost a few
percent.
"""

from __future__ import annotations

import ctypes
import os
import sys
import time

import torch

from .. import _build
from ..ops.fm import resolve_device
from . import apply_edits, build_variants, same_bits, variant_sources

PHASES = ("scan", "stage", "argmax", "K1+LUT", "cands", "barrier", "refill")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROBES = '''
__device__ unsigned long long k2_phase[16];
extern "C" int k2_phase_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(k2_phase, z, sizeof(z));
}
extern "C" int k2_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k2_phase, sizeof(k2_phase));
}
#define K2_PHASE(i)                 \\
  do {                              \\
    const long long t_ = clock64(); \\
    ph_[i] += t_ - ph_t_;           \\
    ph_t_ = t_;                     \\
  } while (0)
'''

# (text of csrc/pool_search.cu, the same text with a probe) for each
# phase's end, in the kernel's order
EDITS = (
    ("using namespace mapad;\n", "using namespace mapad;\n" + PROBES),
    ("  __syncthreads();\n\n"
     "  while (step < limit && (a.fixed > 0 || !gdone)) {\n"
     "    const int par = step & 1;\n",
     "  __syncthreads();\n  long long ph_[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  long long ph_t_ = clock64(), ph_n_ = 0;\n\n"
     "  while (step < limit && (a.fixed > 0 || !gdone)) {\n"
     "    const int par = step & 1;\n"
     "    ph_t_ = clock64();\n    ++ph_n_;\n"),
    ("      const bool popped = kstar > INT_MIN32;",
     "      K2_PHASE(0);\n      const bool popped = kstar > INT_MIN32;"),
    ("      for (int i = tl; i < REC; i += 32) stage_in[i] = written ? "
     "brow[i] : 0;\n      __syncwarp();\n",
     "      for (int i = tl; i < REC; i += 32) stage_in[i] = written ? "
     "brow[i] : 0;\n      __syncwarp();\n      K2_PHASE(1);\n"),
    ("      // --- the LUT/Bi-D row loads, issued before K1's ---",
     "      K2_PHASE(2);\n      // --- the LUT/Bi-D row loads, issued "
     "before K1's ---"),
    ("      const int gap_state = fwd ? f_gapf : f_gapb;",
     "      K2_PHASE(3);\n      const int gap_state = fwd ? f_gapf : f_gapb;"),
    ("      if (k < CANDS) {\n        // stored position 8-k",
     "      K2_PHASE(4);\n      if (k < CANDS) {\n        // stored position "
     "8-k"),
    ("    const int total = sh_total[par];",
     "    K2_PHASE(5);\n    const int total = sh_total[par];"),
    ("    gdone = live == 0;\n    ++step;\n  }\n",
     "    gdone = live == 0;\n    ++step;\n    K2_PHASE(6);\n  }\n"
     "  if (has_lane && tl == 0) {\n"
     "    for (int i = 0; i < 7; ++i) atomicAdd(&k2_phase[i], "
     "(unsigned long long)ph_[i]);\n"
     "    atomicAdd(&k2_phase[8], (unsigned long long)ph_n_);\n  }\n"),
)


def instrument(src: str) -> str:
    """The kernel source with the phase probes; raises where the source no
    longer has a phase's end as EDITS knows it."""
    return apply_edits(src, EDITS, "pool_search.cu")


def build(sources, out_dir):
    """nvcc every instrumented source at once -> {name: ctypes library}."""
    libs = build_variants([(name, instrument(text)) for name, text in
                           variant_sources(sources)], out_dir, "k2_phases",
                          flags=())
    return {name: lib for name, (lib, _log) in libs.items()}


def _inputs(big):
    """chip_smoke.py's K2 check inputs (path 1's genome and reads)."""
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs

    from .. import cli
    from ..index import load_index
    from ..map.record import Record
    from ..ops.engine import DeviceSearchEngine
    from ..ops.search_pool2 import _dense_slut

    args = cli.build_parser().parse_args(
        ["map", "-r", "x", "-g", "x", "-o", "x", *cs.MAP_FLAGS])
    params = cli.build_alignment_parameters(args)
    os.makedirs(cs.WORK, exist_ok=True)
    fasta, _fastq, reads = cs.write_workload(np, cs.GENOME_SIZE, 42, "")
    if cli.main(["index", "-g", fasta]) != 0:
        raise RuntimeError("index failed")
    index = load_index(fasta)
    eng = DeviceSearchEngine(index.fmd, params, lanes=args.lanes,
                             packed_hits=True, big=big)
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads[:8192]]
    cfg, prep, _t0 = eng._prep_block(recs, 8192, eng.pool_config)
    r = cs.CHECK2_READS if big else cs.CHECK_READS
    with torch.cuda.device(eng.device):
        consts, kw = eng._upload(prep)
        slut = kw["slut"] if "slut" in kw else _dense_slut(
            eng.device_index, kw["dense"], consts[0], consts[1], cfg,
            kw["bid_steps"])
    M = cfg.max_len
    return (eng.device_index, *[c[:r] for c in consts], eng._params(), cfg,
            slut[: r * M].contiguous())


def main(argv=None) -> int:
    from . import card
    from ..ops import search_pool2 as sp2

    argv = sys.argv[1:] if argv is None else argv
    resolve_device(None)
    sources = argv or [os.path.join(_build.CSRC, "pool_search.cu")]
    out_dir = os.path.join(_build.BUILD_DIR, "k2_phases")
    os.makedirs(out_dir, exist_ok=True)
    libs = build(sources, out_dir)
    print(card(), flush=True)
    real = sp2.cuda_function
    for big in (False, True):
        a = _inputs(big)
        cfg = a[7]
        want = sp2._extract_chains_cuda(*sp2._pool_loop_cuda(*a), cfg)
        for name, lib in libs.items():
            def fn(lib_name, fn_name, argtypes, lib=lib):
                if lib_name != "pool_search":
                    return real(lib_name, fn_name, argtypes)
                f = getattr(lib, fn_name)
                f.restype, f.argtypes = ctypes.c_int, argtypes
                return f

            sp2.cuda_function = fn
            try:
                got = sp2._extract_chains_cuda(*sp2._pool_loop_cuda(*a), cfg)
                same_bits(got, want, f"{name} against the checkout's kernel")
                ms = []
                for _ in range(3):
                    _build.check(lib.k2_phase_reset(), "k2_phase_reset")
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    state = sp2._pool_loop_cuda(*a)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
            finally:
                sp2.cuda_function = real
            out = (ctypes.c_ulonglong * 16)()
            _build.check(lib.k2_phase_read(out), "k2_phase_read")
            steps = int(state[3][0])
            lane_steps = max(out[8], 1)
            print(f"{name} {'int64' if big else 'int32'}: {steps} steps, "
                  f"{min(ms) * 1e3 / steps:.3f} us a step (runs "
                  f"{', '.join(f'{x:.2f}' for x in ms)} ms); cycles a "
                  "lane-step: " + ", ".join(
                      f"{p} {out[i] / lane_steps:.0f}"
                      for i, p in enumerate(PHASES)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
