"""K10 on the card against variants of its source, at `chip_smoke.py`'s two
K10 check shapes, in one process.

    python -m mapad_tpu_torch.tools.k10_time [--chunks N,...] [--phases]
        [variant.cu ...]

Builds each variant source given (a copy of csrc/search_batch.cu edited by
hand, or an older revision of it) beside the checkout's kernel, and runs
each through the wrapper (`ops/search.py` `_search_batch_cuda`) on
`chip_smoke.py`'s K10 inputs: path 1's genome, its first 2,048 reads at
the batch engine's defaults (the aDNA model, backward, S=2048), then its
first 512 reads under VindijaPwm (both directions).  A variant without
`batch_card` is of the older, plan-less form (four warps a block, no
shared memory) and is launched with its own two arguments.  `--chunks`
runs the checkout's kernel once more under each plan whose lane keeps at
most N chunk maxima (`ops/search.py` MAX_CHUNKS; 512 gives C=64 and 256
C=128 at S=2048).  Every variant's result is held bit for bit against the
checkout's kernel.  The kernels run in turns, the checkout first, then
the variants, then again in reverse order; each line gives the median of
three calls by CUDA events, the longest lane's steps and the us a step of
that lane (the kernel's time over its longest lane's steps: the lanes run
at once, so the longest one sets the time), the mean lane steps and the
launch plan.  The -Xptxas -v figures of every kernel built print first.

`--phases` builds the checkout's source once more with `clock64()` probes
between the parts of a step and prints the SM cycles a step of each part
on the longest lane (the lane of most steps, then most cycles) and the
mean over all lane-steps:

  scan    the pop's warp max over the chunk maxima in shared memory
  pop     the popped row and the popped chunk's keys, its new maximum
  K1      K1's two rank queries (`occ4_pair`)
  extend  the LUT and Bi-D rows, the best-first stop, the child intervals
  cands   the cutoff divisions and their ballot, reject_iterative over
          the 9 candidates, the new keys' chunk maxima
  write   the rows, keys and hit slots written, the chunk maxima stored

The probes cost a few percent; the clock runs per SM.
"""
from __future__ import annotations

import ctypes
import os
import sys

import torch

from .. import _build
from ..ops.fm import resolve_device
from . import (apply_edits, build_variants, event_runs, in_turns,
               print_phases, same_bits, variant_sources)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKOUT = "checkout"
PHASES = ("scan", "pop", "K1", "extend", "cands", "write")
MAX_LANES = 4096  # lanes whose phases the probes keep

PROBES = """
__device__ unsigned long long k10_phase[%d * 8];
extern "C" int k10_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k10_phase, sizeof(k10_phase));
}
#define K10_PHASE(i)                \\
  do {                              \\
    const long long t_ = clock64(); \\
    ph_[i] += t_ - ph_t_;           \\
    ph_t_ = t_;                     \\
  } while (0)
""" % MAX_LANES

# (text of csrc/search_batch.cu, the same text with a probe) for each
# phase's end, in the kernel's order
EDITS = (
    ("using namespace mapad;\n", "using namespace mapad;\n" + PROBES),
    ("  bool done = nn <= 0;\n",
     "  bool done = nn <= 0;\n  long long ph_[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long ph_t_ = 0;\n"),
    ("  for (int step = 0; !done && step < S; ++step) {\n",
     "  for (int step = 0; !done && step < S; ++step) {\n"
     "    ph_t_ = clock64();\n"),
    ("    best = warp_max(best);\n",
     "    best = warp_max(best);\n    K10_PHASE(0);\n"),
    ("    __syncwarp();  // every thread has read the popped row and the "
     "chunk\n",
     "    __syncwarp();  // every thread has read the popped row and the "
     "chunk\n    K10_PHASE(1);\n"),
    ("occ_query_upper<int>(ext_lower, f_size), occ1, occ2);\n",
     "occ_query_upper<int>(ext_lower, f_size), occ1, occ2);\n"
     "    K10_PHASE(2);\n"),
    ("                         occ2, ch_lower, ch_lrev, ch_size);\n",
     "                         occ2, ch_lower, ch_lrev, ch_size);\n"
     "    K10_PHASE(3);\n"),
    ("    // --- thread t writes slot base + t",
     "    K10_PHASE(4);\n    // --- thread t writes slot base + t"),
    ("    __syncwarp();  // the rows, keys and maxima of this step before "
     "the next\n",
     "    __syncwarp();  // the rows, keys and maxima of this step before "
     "the next\n    K10_PHASE(5);\n"),
    ("  if (t == 0) {\n    a.hcount[lane] = hcount;",
     "  if (t == 0 && lane < %d)\n    for (int i = 0; i < 6; ++i)\n"
     "      k10_phase[lane * 8 + i] = (unsigned long long)ph_[i];\n"
     "  if (t == 0) {\n    a.hcount[lane] = hcount;" % MAX_LANES),
)


def instrument(src: str) -> str:
    """The kernel source with the phase probes; raises where the source no
    longer has a phase's end as EDITS knows it."""
    return apply_edits(src, EDITS, "search_batch.cu")


def build(sources, out_dir):
    """nvcc every (name, text) source at once, printing each one's -Xptxas
    -v figures -> {name: (ctypes library, has a plan)}."""
    libs = build_variants(sources, out_dir, "k10")
    for name, (_lib, log) in libs.items():
        _ptxas(name, log)
    planned = {name: "batch_card" in text for name, text in sources}
    return {name: (lib, planned[name]) for name, (lib, _log) in libs.items()}


def _ptxas(name, log):
    """Print the -Xptxas -v figures of a build's kernel."""
    lines = [x.strip() for x in log.splitlines()
             if "search_batch_kernel" in x or "registers" in x
             or "spill" in x]
    print(f"ptxas {name}: " + " | ".join(lines), flush=True)


def _inputs():
    """chip_smoke.py's two K10 checks -> [(what, wrapper arguments)]."""
    sys.path.insert(0, ROOT)
    import dataclasses

    import numpy as np

    import chip_smoke as cs

    from .. import cli
    from ..index import load_index
    from ..map.record import Record
    from ..models import Discrete, VindijaPwm
    from ..ops import bi_d
    from ..ops.engine import DeviceSearchEngine

    args = cli.build_parser().parse_args(
        ["map", "-r", "x", "-g", "x", "-o", "x", *cs.MAP_FLAGS])
    params = cli.build_alignment_parameters(args)
    pwm = VindijaPwm()
    vparams = dataclasses.replace(
        params, difference_model=pwm, mismatch_bound=Discrete(
            args.poisson_prob, np.float32(args.divergence),
            pwm.get_representative_mismatch_penalty()))
    os.makedirs(cs.WORK, exist_ok=True)
    fasta, _fastq, reads = cs.write_workload(np, cs.GENOME_SIZE, 42, "")
    if cli.main(["index", "-g", fasta]) != 0:
        raise RuntimeError("index failed")
    index = load_index(fasta)
    out = []
    for what, p, r in (("aDNA model, backward", params, cs.BATCH_CHECK_READS),
                       ("VindijaPwm, both directions", vparams,
                        cs.BATCH_CENTER_READS)):
        eng = DeviceSearchEngine(index.fmd, p, mode="batch")
        cfg, M = eng.config, eng.config.max_len
        recs = [Record(sequence=s, base_qualities=q) for s, q in reads[:r]]
        with torch.cuda.device(eng.device):
            prep = eng._prepare(recs, M, r, host_bid=False, dense=True)
        d = prep["dense"]
        rank, code, n, lut, pen, split, scale, thresh, repr_mm = (
            d[k] for k in ("pattern_rank", "pattern_code", "n", "score_lut",
                           "pen", "split", "scale", "thresh", "repr_mm"))
        bid = bi_d.compute_bi_d(eng.device_index, rank, pen, n, split,
                                cfg.compute_forward_part)
        out.append((what, (eng.device_index, code, n, lut, bid, split,
                           scale, thresh, repr_mm, eng._params(), cfg)))
    return out


def main(argv=None) -> int:
    from . import card
    from ..ops import search as srch

    argv = list(sys.argv[1:] if argv is None else argv)
    resolve_device(None)
    chunks = []
    if "--chunks" in argv:
        i = argv.index("--chunks")
        chunks = [int(x) for x in argv[i + 1].split(",")]
        del argv[i:i + 2]
    phases = "--phases" in argv
    variants = [a for a in argv if a != "--phases"]
    out_dir = os.path.join(_build.BUILD_DIR, "k10_time")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, "search_batch.cu")) as f:
        checkout_src = f.read()
    sources = [(CHECKOUT, checkout_src)] + variant_sources(variants)
    if phases:
        sources.append((f"phases_{CHECKOUT}", instrument(checkout_src)))
    libs = build(sources, out_dir)
    del libs[CHECKOUT]  # built for its figures: the wrapper runs its own
    print(card(), flush=True)
    real = srch.cuda_function
    max_chunks = srch.MAX_CHUNKS

    def use(name):
        """Make the wrapper launch `name`'s kernel."""
        srch.cuda_function = real
        srch.MAX_CHUNKS = max_chunks
        if name == CHECKOUT:
            return
        if name.startswith("chunks"):
            srch.MAX_CHUNKS = int(name[6:])
            return
        lib, planned = libs[name]

        def fn(lib_name, fn_name, argtypes):
            if lib_name != "search_batch" or (
                    not planned and fn_name != "search_batch"):
                return real(lib_name, fn_name, argtypes)
            f = getattr(lib, fn_name)
            f.restype = ctypes.c_int
            if planned:
                f.argtypes = argtypes
                return f
            f.argtypes = [argtypes[0], ctypes.c_void_p]
            return lambda a, _plan, stream: f(a, stream)

        srch.cuda_function = fn

    timed = [n for n in libs if not n.startswith("phases_")] + [
        f"chunks{c}" for c in chunks]
    order = in_turns([CHECKOUT, *timed])
    for what, a in _inputs():
        L, M = a[1].shape
        S = a[-1].max_steps
        want = None
        for name in order + [n for n in libs if n.startswith("phases_")]:
            use(name)
            try:
                plan = srch.batch_card_plan(a[1].device, L, S, M)
                res, lane_steps = srch._search_batch_cuda(*a)
                torch.cuda.synchronize()
                if want is None:
                    want = res
                same_bits(res, want, f"{name} against the checkout's kernel")
                times = event_runs(lambda: srch._search_batch_cuda(*a))
            finally:
                use(CHECKOUT)
            ms = sorted(times)[1]
            ls = lane_steps.cpu()
            top = int(ls.max())
            print(f"K10 {name} ({what}) L={L} S={S}: {ms:.3f} ms (runs "
                  f"{', '.join(f'{x:.3f}' for x in times)}), longest lane "
                  f"{top} steps, {ms * 1e3 / max(top, 1):.3f} us a step; "
                  f"lane steps mean {float(ls.double().mean()):.1f}; "
                  f"bit-exact; plan {dict(plan._asdict())}", flush=True)
            if name.startswith("phases_"):
                _print_phases(libs[name][0], ls, L)
    return 0


def _print_phases(lib, lane_steps, L):
    """Cycles a step of each phase: the longest lane's, and the mean over
    all lane-steps."""
    out = (ctypes.c_ulonglong * (MAX_LANES * 8))()
    _build.check(lib.k10_phase_read(out), "k10_phase_read")
    n = min(L, MAX_LANES)
    cyc = torch.tensor(list(out), dtype=torch.float64).view(MAX_LANES, 8)[
        :n, :len(PHASES)]
    print_phases("lane", PHASES, cyc, lane_steps[:n].double())


if __name__ == "__main__":
    sys.exit(main())
