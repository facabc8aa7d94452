"""K7 on the card against variants of its source, at `chip_smoke.py`'s K7
shapes, in one process.

    python -m mapad_tpu_torch.tools.k7_time [--phases] [variant.cu ...]

Builds the checkout's csrc/bi_d.cu and each variant source given (a copy
of it edited by hand, or an older revision of it, such as the parent's
from `git show`) at once, each with a small occupancy query appended, and
runs each on `chip_smoke.py`'s three K7 inputs:

  int64, R=4096   path 2's first block (its 64 Mbp genome forced into big
                  mode, M=128), the main path's parts (backward only);
  int64, both     the same block with split = n // 2 and the forward part
                  (a read's two parts on their own walks);
  int32, R=2048   path 6's first batch at the batch engine's defaults.

A variant without `bid_occupancy` is of the older, plan-less form (a warp
a walk, 15 a block) and is launched with its own two arguments; the others
get the plan `ops/bi_d.py` `bid_plan` makes from their own occupancy
query.  The checkout's kernel through the wrapper (`compute_bi_d`) is held
against `compute_bi_d_plain` once per input, and every build's result
against it bit for bit.  The kernels run in turns, the checkout first, then the
variants, then again in reverse order; each line gives the median of three
calls by CUDA events, the walk steps the input needs, the ns a walk step
(the kernel's time over them), the plan and the resident warps an SM
(`cudaOccupancyMaxActiveBlocksPerMultiprocessor` at the launch's shape).
The -Xptxas -v figures of every kernel built print first.

`--phases` builds the checkout's source once more with `clock64()` probes
between the parts of a walk step and prints the SM cycles a step of each
part on the longest walk (most steps, then most cycles) and the mean over
all walk steps:

  inputs  the step's rank and penalty from shared memory, the running max
  div     K1's row number and offset: the multiply-high by occ_k's constant
  K1      the ends' rows swapped between the halves, the row loads, the
          SWAR counts and the butterfly, on the one-row path (both ends in
          one row) or the two-row one, and the two halves' counts swapped
  extend  the child's lower end and size, the failure test and its reset
  min     the atomicMin of the column into the part's shared array

and the share of steps that took the one-row path.  The probes cost a
few percent; the clock runs per SM.
"""
from __future__ import annotations

import ctypes
import os
import sys

import torch

from .. import _build
from ..ops import bi_d
from ..ops.fm import resolve_device
from . import (apply_edits, build_variants, event_runs, in_turns,
               print_phases, same_bits, variant_sources)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKOUT = "checkout"
PHASES = ("inputs", "div", "K1", "extend", "min")
MAX_WALKS = 4096 * 2 * bi_d.MAX_OFFSET  # walks whose phases the probes keep

# appended to every build: the occupancy of either form of the kernel
RESIDENT = """
extern "C" int k7_resident(int big, int threads, int smem, int* per_sm) {
  if (big)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, bi_d_kernel<int64_t>, threads, (size_t)smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, bi_d_kernel<int32_t>, threads, (size_t)smem);
}
"""

PROBES = """
__device__ unsigned long long k7_phase[%d * 8];
extern "C" int k7_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k7_phase, sizeof(k7_phase));
}
extern "C" int k7_phase_reset() {
  void* p = 0;
  cudaError_t e = cudaGetSymbolAddress(&p, k7_phase);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(k7_phase));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
#define K7_PHASE(i)                 \\
  do {                              \\
    const long long t_ = clock64(); \\
    ph_[i] += t_ - ph_t_;           \\
    ph_t_ = t_;                     \\
  } while (0)
""" % MAX_WALKS

# (text of csrc/bi_d.cu, the same text with a probe), in the kernel's order
EDITS = (
    ("using namespace mapad;\n", "using namespace mapad;\n" + PROBES),
    ("                                             int s, I r1, I r2, "
     "I& eq1,\n",
     "                                             long long* ph_, "
     "long long& ph_t_,\n"
     "                                             int s, I r1, I r2, "
     "I& eq1,\n"),
    ("  const int off = (int)((unsigned)r_safe - (unsigned)q * (unsigned)k);"
     "\n",
     "  const int off = (int)((unsigned)r_safe - (unsigned)q * (unsigned)k);"
     "\n  K7_PHASE(1);\n"),
    ("int n_steps, int skip, int* acc) {\n",
     "int n_steps, int skip, int* acc,\n"
     "                                          int wid) {\n"),
    ("    const int* row = rows + (size_t)blk1 * ROW_WORDS + N_CP;\n",
     "    const int* row = rows + (size_t)blk1 * ROW_WORDS + N_CP;\n"
     "    ++ph_[5];\n"),
    ("  if (skip >= last) return;  // z stays 0: the array's starting key\n",
     "  if (skip >= last) return;  // z stays 0: the array's starting key\n"
     "  long long ph_[6] = {0, 0, 0, 0, 0, 0};\n  long long ph_t_ = 0;\n"),
    ("  for (int idx = skip; idx < last; ++idx) {\n",
     "  for (int idx = skip; idx < last; ++idx) {\n    ph_t_ = clock64();\n"),
    ("    rm = fmaxf(rm, pens[idx]);\n",
     "    rm = fmaxf(rm, pens[idx]);\n    K7_PHASE(0);\n"),
    ("        occ_sym_step<I>(a.rows, a.nb, a.occ_k, p.div_magic, "
     "p.div_shift, s,\n                        occ_query_lower<I>(x), "
     "occ_query_upper<I>(x, size),\n                        eq1, d_eq);\n",
     "        occ_sym_step<I>(a.rows, a.nb, a.occ_k, p.div_magic, "
     "p.div_shift, ph_, ph_t_, s,\n                        "
     "occ_query_lower<I>(x), "
     "occ_query_upper<I>(x, size),\n                        eq1, d_eq);\n"
     "        K7_PHASE(2);\n"),
    ("      occ_sym_step<I>(a.rows, a.nb, a.occ_k, p.div_magic, p.div_shift, "
     "s,\n                      occ_query_lower<I>((I)0),\n",
     "      long long ph_[6], ph_t_ = 0;  // the root's queries: not kept\n"
     "      occ_sym_step<I>(a.rows, a.nb, a.occ_k, p.div_magic, p.div_shift, "
     "ph_, ph_t_, s,\n                      occ_query_lower<I>((I)0),\n"),
    ("    if (lead && idx + 1 < M)\n"
     "      atomicMin(&acc[idx + 1], mono_bits(__float_as_int(z)));\n",
     "    K7_PHASE(3);\n"
     "    if (lead && idx + 1 < M)\n"
     "      atomicMin(&acc[idx + 1], mono_bits(__float_as_int(z)));\n"
     "    K7_PHASE(4);\n"),
    ("  // past the part's end the walk idles: z stays to column n_steps\n",
     "  if (lead && wid < %d) {\n"
     "    for (int i = 0; i < 5; ++i)\n"
     "      k7_phase[wid * 8 + i] = (unsigned long long)ph_[i];\n"
     "    k7_phase[wid * 8 + 5] = (unsigned long long)(last - skip);\n"
     "    k7_phase[wid * 8 + 6] = (unsigned long long)ph_[5];\n"
     "  }\n"
     "  // past the part's end the walk idles: z stays to column n_steps\n"
     % MAX_WALKS),
    ("                          nn - sp, a.steps_fwd, w, keys + M);\n",
     "                          nn - sp, a.steps_fwd, w, keys + M,\n"
     "                          ((int)blockIdx.x * 2 + 1) * MAX_OFFSET + w);"
     "\n"),
    ("                         a.steps_back, w, keys);\n",
     "                         a.steps_back, w, keys,\n"
     "                         (int)blockIdx.x * 2 * MAX_OFFSET + w);\n"),
)


def instrument(src: str) -> str:
    """The kernel source with the phase probes; raises where the source no
    longer has a phase's end as EDITS knows it."""
    return apply_edits(src, EDITS, "bi_d.cu")


def build(sources, out_dir):
    """nvcc every (name, text) source at once with the occupancy query
    appended, printing each one's -Xptxas -v figures -> {name: (ctypes
    library, has a plan)}."""
    libs = build_variants([(name, text + RESIDENT) for name, text in sources],
                          out_dir, "k7")
    planned = {name: "bid_occupancy" in text for name, text in sources}
    for name, (_lib, log) in libs.items():
        _ptxas(name, log)
    return {name: (lib, planned[name]) for name, (lib, _log) in libs.items()}


def _ptxas(name, log):
    """Print the -Xptxas -v figures of each form of a build's kernel."""
    sys.path.insert(0, ROOT)
    from chip_smoke import ptxas_entries

    for entry, figs in ptxas_entries(log):
        if "bi_d_kernel" in entry:
            form = "int64" if "bi_d_kernelIl" in entry else "int32"
            print(f"ptxas {name} bi_d_kernel<{form}>: {figs}", flush=True)


def _inputs():
    """chip_smoke.py's three K7 inputs -> [(what, index, (rank, pen, n,
    split), forward part, steps)]."""
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs

    from .. import cli
    from ..index import load_index
    from ..map.record import Record
    from ..ops.engine import DeviceSearchEngine

    args = cli.build_parser().parse_args(
        ["map", "-r", "x", "-g", "x", "-o", "x", *cs.MAP_FLAGS])
    params = cli.build_alignment_parameters(args)
    os.makedirs(cs.WORK, exist_ok=True)
    out = []
    fasta2, _fq, reads2 = cs.write_workload(np, cs.GENOME2_SIZE, 52, "2")
    if cli.main(["index", "-g", fasta2]) != 0:
        raise RuntimeError("index failed")
    eng = DeviceSearchEngine(load_index(fasta2).fmd, params,
                             lanes=args.lanes, big=True, packed_hits=True)
    R = cs.BLOCK2_READS
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads2[:R]]
    cfg, prep, _t0 = eng._prep_block(recs, R, eng.pool_config)
    from ..ops import engine as teng
    from ..ops.prep import _DEV_LUT_Q

    tab, pen_tab, off = eng._device_lut()
    blob = torch.from_numpy(prep["blob"]).to(eng.device)
    dense = teng._unpack_prep_full(blob, tab, pen_tab, off, R,
                                   prep["max_len"], _DEV_LUT_Q)
    rank, n, pen, split = dense[0], dense[2], dense[4], dense[5]
    out.append((f"int64 R={R}, main path's parts", eng.device_index,
                (rank, pen, n, split), cfg.compute_forward_part,
                prep["bid_steps"]))
    half = torch.div(n, 2, rounding_mode="floor").to(torch.int32)
    n_h, half_h = n.cpu(), half.cpu()
    out.append((f"int64 R={R}, both parts (split n // 2)", eng.device_index,
                (rank, pen, n, half), True,
                (int(half_h.max()), int((n_h - half_h).max()))))

    fasta, _fq, reads = cs.write_workload(np, cs.GENOME_SIZE, 42, "")
    if cli.main(["index", "-g", fasta]) != 0:
        raise RuntimeError("index failed")
    beng = DeviceSearchEngine(load_index(fasta).fmd, params, mode="batch")
    r = cs.BATCH_CHECK_READS
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads[:r]]
    with torch.cuda.device(beng.device):
        prep = beng._prepare(recs, beng.config.max_len, r, host_bid=False,
                             dense=True)
    d, st = prep["dense"], prep["_stash"]
    out.append((f"int32 R={r}, path 6's batch", beng.device_index,
                (d["pattern_rank"], d["pen"], d["n"], d["split"]),
                beng.config.compute_forward_part,
                (int(st["split"].max()),
                 int((st["n"] - st["split"]).max()))))
    return out


class _ParentArgs(ctypes.Structure):
    """`struct BidArgs` of the parent's csrc/bi_d.cu (with `sent`)."""

    _fields_ = bi_d._BidArgs._fields_[:2] + [("sent", ctypes.c_void_p)] + \
        bi_d._BidArgs._fields_[2:]


class Launcher:
    """One build's K7, launched as the wrapper launches the checkout's."""

    def __init__(self, lib, planned):
        self.lib, self.planned = lib, planned
        self.fn = lib.bi_d
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = ([ctypes.POINTER(bi_d._BidArgs),
                             ctypes.POINTER(bi_d._BidPlanC)] if planned else
                            [ctypes.POINTER(_ParentArgs)]) + [ctypes.c_void_p]
        lib.k7_resident.restype = ctypes.c_int

    def resident(self, big, threads, smem):
        """Blocks of this shape an SM holds (the occupancy query)."""
        out = ctypes.c_int(0)
        _build.check(self.lib.k7_resident(int(big), threads, smem,
                                          ctypes.byref(out)), "k7_resident")
        return out.value

    def setup(self, idx, t, fwd, steps):
        """-> (call, plan or None, resident warps an SM)."""
        rank, pen, n, split = t
        L, M = rank.shape
        out = torch.empty((L, M), dtype=torch.float32, device=pen.device)
        stream = torch.cuda.current_stream().cuda_stream
        if not self.planned:
            # the parent's form, whose arguments still held the sentinels:
            # a block of 15 warps a read
            args = _ParentArgs(
                idx.rows.data_ptr(), idx.less.data_ptr(),
                idx.sentinels.data_ptr(), idx.rows.shape[0], idx.occ_k,
                int(idx.big), idx.text_len, rank.data_ptr(), pen.data_ptr(),
                n.data_ptr(), split.data_ptr(), L, M, int(steps[0]),
                int(steps[1]), int(bool(fwd)), out.data_ptr())
            warps = self.resident(idx.big, bi_d.MAX_OFFSET * 32, 0) * \
                bi_d.MAX_OFFSET

            def call():
                _build.check(self.fn(ctypes.byref(args), stream), "bi_d")
                return out
            return call, None, warps
        args = bi_d._BidArgs(
            idx.rows.data_ptr(), idx.less.data_ptr(), idx.rows.shape[0],
            idx.occ_k, int(idx.big), idx.text_len, rank.data_ptr(),
            pen.data_ptr(), n.data_ptr(), split.data_ptr(), L, M,
            int(steps[0]), int(steps[1]), int(bool(fwd)), out.data_ptr())
        plan = bi_d.bid_plan(M, 2 if fwd else 1,
                             lambda th, sm: self.resident(idx.big, th, sm))
        magic, shift = bi_d.occ_divisor(idx.occ_k, 64 if idx.big else 32)
        pc = bi_d._BidPlanC(plan.warps, plan.smem, shift, magic)

        def call():
            _build.check(self.fn(ctypes.byref(args), ctypes.byref(pc),
                                 stream), "bi_d")
            return out
        return call, plan, plan.resident_warps


def main(argv=None) -> int:
    from . import card

    argv = list(sys.argv[1:] if argv is None else argv)
    resolve_device(None)
    phases = "--phases" in argv
    variants = [a for a in argv if a != "--phases"]
    out_dir = os.path.join(_build.BUILD_DIR, "k7_time")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, "bi_d.cu")) as f:
        src = f.read()
    sources = [(CHECKOUT, src)] + variant_sources(variants)
    if phases:
        sources.append((f"phases_{CHECKOUT}", instrument(src)))
    libs = build(sources, out_dir)
    print(card(), flush=True)
    launchers = {name: Launcher(*lib) for name, lib in libs.items()}
    probed = [n for n in launchers if n.startswith("phases_")]
    timed = [n for n in launchers if n not in probed]
    for what, idx, t, fwd, steps in _inputs():
        want = bi_d.compute_bi_d(idx, *t, fwd, steps)
        plain = bi_d.compute_bi_d_plain(idx, *t, fwd, steps)
        torch.cuda.synchronize()
        same_bits((want,), (plain,), f"{what}: the wrapper against "
                  "compute_bi_d_plain")
        ws = bi_d.walk_steps(t[2], t[3], fwd)
        L, M = t[0].shape
        print(f"K7 {what}: L={L} M={M}, forward part {bool(fwd)}, steps "
              f"{tuple(steps)}, {ws} walk steps; the wrapper equals "
              "compute_bi_d_plain", flush=True)
        times = {}
        for name in in_turns(timed) + probed:
            call, plan, warps = launchers[name].setup(idx, t, fwd, steps)
            got = call()
            torch.cuda.synchronize()
            same_bits((got,), (want,), f"{name} ({what}) against the "
                      "checkout's kernel")
            runs = event_runs(call)
            times.setdefault(name, []).extend(runs)
            ms = sorted(runs)[1]
            print(f"K7 {name} ({what}): {ms:.4f} ms (runs "
                  f"{', '.join(f'{x:.4f}' for x in runs)}), "
                  f"{ms * 1e6 / max(ws, 1):.1f} ns a walk step; bit-exact; "
                  f"{warps} warps resident an SM; plan "
                  + (str(dict(plan._asdict())) if plan
                     else "none (a block a read)"), flush=True)
            if name in probed:
                lib = launchers[name].lib
                lib.k7_phase_reset.restype = ctypes.c_int
                _build.check(lib.k7_phase_reset(), "k7_phase_reset")
                call()
                torch.cuda.synchronize()
                _print_phases(lib, L * 2 * bi_d.MAX_OFFSET)
        print(f"K7 ({what}) medians over both turns: " + ", ".join(
            f"{n} {sorted(v)[len(v) // 2]:.4f} ms" for n, v in times.items()),
            flush=True)
    return 0


def _print_phases(lib, walks):
    """Cycles a step of each phase: the longest walk's, and the mean over
    all walk steps, with the share of one-row steps."""
    out = (ctypes.c_ulonglong * (MAX_WALKS * 8))()
    lib.k7_phase_read.restype = ctypes.c_int
    _build.check(lib.k7_phase_read(out), "k7_phase_read")
    n = min(walks, MAX_WALKS)
    a = torch.tensor(list(out), dtype=torch.float64).view(MAX_WALKS, 8)[:n]
    steps, one_row = a[:, 5], a[:, 6]
    total = max(float(steps.sum()), 1.0)
    print_phases("walk", PHASES, a[:, :len(PHASES)], steps,
                 f"; one-row steps {float(one_row.sum()) / total:.3f} of "
                 f"{int(steps.sum())}")


if __name__ == "__main__":
    sys.exit(main())
