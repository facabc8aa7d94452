"""K3 and K6 on the card, each time split into card and host, against
variants of their sources, at `chip_smoke.py`'s shapes, in one process.

    python -m mapad_tpu_torch.tools.k3_time [--phases] [variant.cu ...]

Builds the checkout's csrc/extract_chains.cu and csrc/unpack_prep.cu and
each variant source given (a copy edited by hand, or an older revision
such as the parent's: `git show <rev>:mapad_tpu_torch/csrc/
extract_chains.cu > .proof/extract_chains_parent.cu`, with that
revision's csrc/common.cuh beside it as `.proof/common.cuh`, which then
takes the place of the checkout's; a variant whose text has
`extract_chains` is a K3 variant, else a K6 one) at once, and runs K3 at
the smoke's three shapes:

  int32 pool_check   path 1's first 1,024 reads, L=512, S=8192, C=16384;
  boundary           the first store boundary of compact_check's uncapped
                     run (path 1's first 1,024 reads, S = CAP + 128, four
                     generations): an extraction with `final=False` on a
                     copy of the loop state as it was then, the loop
                     counters restored before each call;
  int64 pool_check   path 2's first 512 reads (64 Mbp genome, big mode);

and K6 at R=4096, M=128 (path 2's first block).  For each it prints:

  events   ms a call of the wrapper, CUDA events around 20 calls back to
           back (the smoke's measure: where the host takes longer than the
           card, the host's time);
  host     us a call the wrapper takes on the host (the enqueue, no
           synchronization inside the calls), and for K3 its parts: the
           allocation, the result's views, the launch;
  card     ms a call the card is busy, from `torch.profiler`, and each
           launch's own device time by kernel name; for K3 once more with
           the L2 flushed (a 128 MB write) before each call ("cold": the
           main path finds the store in DRAM);
  launch   ms a call of the bare library entry (argument block made once)
           by CUDA events, warm and with the L2 flushed before each call
           (the flush not timed), for the checkout and every variant in
           turns, each held bit for bit against the checkout's wrapper.

A K3 variant without `extract_card` is of the parent's form (six launches
a call, the scratch in pieces) and is launched so.  For K3 also the data's
figures: chains and entries, the deepest walked chain (the most non-zero
`c_ops` words of an entry) and the walk's latency floor: that depth times
the card's dependent-load latency (`dma.load_latency_ns`: one thread
chasing a random cycle through 256 MB, the L2 flushed first), measured in
this call (and through 8 MB, in L2, and through as many words as the
case's store holds, for comparison).

`--phases` builds the checkout's K3 once more with `clock64()` probes at
its phase ends and prints, for the warp that ends last and as the largest
over all warps, the SM cycles of each phase: count, barrier 1, emit,
barrier 2, walk, fold (the unused entries after the fold are not probed),
on a cold call.
"""
from __future__ import annotations

import ctypes
import os
import sys
import time

import torch

from .. import _build
from ..ops.fm import resolve_device
from . import (apply_edits, build_variants, event_runs, host_us, in_turns,
               same_bits, variant_sources)
from .dma import load_latency_ns

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKOUT = "checkout"
REPS = 20
CHASE_BIG = 1 << 26   # ints: 256 MB
CHASE_L2 = 1 << 21    # ints: 8 MB
CHASE_HOPS = 20000
PHASES = ("count", "barrier 1", "emit", "barrier 2", "walk", "fold")
PHASE_WARPS = 8192

PROBES = """
__device__ long long k3_phase[%d * 8];
extern "C" int k3_phase_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k3_phase, sizeof(k3_phase));
}
#define K3_PHASE(i)                                             \\
  do {                                                          \\
    if (tl == 0 && gw < %d) k3_phase[gw * 8 + (i)] = clock64(); \\
  } while (0)
""" % (PHASE_WARPS, PHASE_WARPS)

# (text of csrc/extract_chains.cu, the same text with a probe)
EDITS = (
    ("using namespace mapad;\n", "using namespace mapad;\n" + PROBES),
    ("  const int lo = S - steps, hi = S - base;",
     "  K3_PHASE(0);\n  const int lo = S - steps, hi = S - base;"),
    ("  grid_barrier(a.flags, tag + 1);\n",
     "  K3_PHASE(1);\n  grid_barrier(a.flags, tag + 1);\n  K3_PHASE(2);\n"),
    ("  grid_barrier(a.flags, tag + 2);\n",
     "  K3_PHASE(3);\n  grid_barrier(a.flags, tag + 2);\n  K3_PHASE(4);\n"),
    ("  // ... the step fold and the unused entries from the last warp down\n",
     "  K3_PHASE(5);\n"),
    ("  if (!a.final) return;\n  const int pad_lo",
     "  K3_PHASE(6);\n  if (!a.final) return;\n  const int pad_lo"),
)


class _ParentArgs(ctypes.Structure):
    """`struct ExtractArgs` of csrc/extract_chains.cu up to 9f975f4: six
    launches a call, scratch passed in pieces."""

    _fields_ = [
        ("store", ctypes.c_void_p), ("bmask", ctypes.c_void_p),
        ("lane", ctypes.c_void_p), ("glob", ctypes.c_void_p),
        ("fin_log", ctypes.c_void_p),
        ("R", ctypes.c_int), ("L", ctypes.c_int), ("S", ctypes.c_int),
        ("C", ctypes.c_int), ("MW", ctypes.c_int), ("track", ctypes.c_int),
        ("big", ctypes.c_int), ("first", ctypes.c_int),
        ("final", ctypes.c_int),
        ("lane_cnt", ctypes.c_void_p), ("lane_off", ctypes.c_void_p),
        ("lane_first", ctypes.c_void_p), ("c_lane", ctypes.c_void_p),
        ("e_slot", ctypes.c_void_p), ("pad", ctypes.c_void_p),
        ("c_read", ctypes.c_void_p), ("c_slot", ctypes.c_void_p),
        ("c_abandon", ctypes.c_void_p), ("c_lower", ctypes.c_void_p),
        ("c_lrev", ctypes.c_void_p), ("c_size", ctypes.c_void_p),
        ("c_score", ctypes.c_void_p), ("c_ops", ctypes.c_void_p),
        ("n_chains", ctypes.c_void_p), ("lane_read", ctypes.c_void_p),
        ("lane_unfinished", ctypes.c_void_p),
        ("next_read", ctypes.c_void_p), ("steps", ctypes.c_void_p),
        ("read_steps", ctypes.c_void_p),
    ]


def _fields(out, cfg, R, big):
    """The 14 PoolResult fields an extraction wrote into `out` (read_steps
    R long)."""
    from ..ops import search_pool2 as sp2

    if isinstance(out, dict):
        f = tuple(out.values())
        return f[:13] + (f[13][:R],)
    return tuple(sp2._pool_result(out, cfg, R, big))


def _parent_result(cfg, R, big, dev):
    """The parent's result buffers: a tensor a field."""
    L, C, MW = cfg.lanes, cfg.max_chains, cfg.max_len + 16
    idt = torch.int64 if big else torch.int32

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    return dict(
        c_read=empty(C), c_slot=empty(C),
        c_abandon=empty(C, dtype=torch.bool), c_lower=empty(C, dtype=idt),
        c_lrev=empty(C, dtype=idt), c_size=empty(C, dtype=idt),
        c_score=empty(C, dtype=torch.float32), c_ops=empty(C, MW),
        n_chains=empty(), lane_read=empty(L),
        lane_unfinished=empty(L, dtype=torch.bool), next_read=empty(),
        steps=empty(), read_steps=empty(R + 1),
    )


class K3Launcher:
    """One build's K3, launched on a loop state as the wrapper of its form
    launches it."""

    def __init__(self, lib):
        from ..ops import search_pool2 as sp2

        self.planned = hasattr(lib, "extract_card")
        self.fn = lib.extract_chains
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = (
            [ctypes.POINTER(sp2._ExtractArgs),
             ctypes.POINTER(sp2._ExtractPlanC), ctypes.c_void_p]
            if self.planned else
            [ctypes.POINTER(_ParentArgs), ctypes.c_void_p])

    def setup(self, state, cfg, final):
        """-> (call, out): a call of the bare entry on `state` writing
        `out`, the argument block made once."""
        from ..ops import search_pool2 as sp2

        store, bmask, lane, glob, fin_log, R, big, ext = state
        if self.planned:
            out = sp2._alloc_result(cfg, R, big, store.device)
            return (lambda: ext.launch(out, final, fn=self.fn)), out
        out = _parent_result(cfg, R, big, store.device)
        L, C = cfg.lanes, cfg.max_chains
        scratch = torch.empty(3 * L + 2 * C + 4, dtype=torch.int32,
                              device=store.device)
        args = _ParentArgs(
            store.data_ptr(), bmask.data_ptr(), lane.data_ptr(),
            glob.data_ptr(),
            fin_log.data_ptr() if fin_log is not None else None,
            R, L, cfg.total_steps, C, cfg.max_len + 16,
            int(fin_log is not None), int(big), int(ext.boundaries == 0),
            int(final),
            *[scratch[k:].data_ptr()
              for k in (0, L, 2 * L, 3 * L, 3 * L + C, 3 * L + 2 * C)],
            *[t.data_ptr() for t in out.values()])
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            _build.check(self.fn(ctypes.byref(args), stream), "extract")
            return scratch
        return call, out


def _k3_inputs(np, cs, cli, params, args):
    """The three K3 cases -> [(what, loop state, config, final, the loop
    counters to restore or None)], and K6's (blob, tab, pen_tab, off, R, M,
    Q)."""
    from ..index import load_index
    from ..map.record import Record
    from ..ops import engine as eng
    from ..ops import search_pool2 as sp2
    from ..ops.engine import DeviceSearchEngine
    from ..ops.prep import _DEV_LUT_Q

    out = []
    fasta, _fq, reads = cs.write_workload(np, cs.GENOME_SIZE, 42, "")
    if cli.main(["index", "-g", fasta]) != 0:
        raise RuntimeError("index failed")
    engine = DeviceSearchEngine(load_index(fasta).fmd, params,
                                lanes=args.lanes, packed_hits=True)
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads[:8192]]
    cfg, prep, _t0 = engine._prep_block(recs, 8192, engine.pool_config)
    R, M = prep["L"], prep["max_len"]
    blob = torch.from_numpy(prep["blob"]).to(engine.device)
    tab, _pen, off = engine._device_lut()
    parts = eng._unpack_prep_lut(blob, tab, off, R, M, _DEV_LUT_Q, True)
    r = cs.CHECK_READS
    consts = tuple(p[:r].contiguous() for p in parts[:5])
    slut = parts[5][: r * M].contiguous()
    idx = engine.device_index
    state = sp2._pool_loop_cuda(idx, *consts, engine._params(), cfg, slut)
    out.append((f"int32 pool_check (L={cfg.lanes} S={cfg.total_steps} "
                f"C={cfg.max_chains}, {r} reads)", state, cfg, True, None))

    # compact_check's uncapped run: the first boundary's extraction, on a
    # copy of the loop state as it was then
    tight = cfg._replace(total_steps=cfg.read_step_cap + cs.K8_MARGIN,
                         generations=4, min_live=1, spill_steps=0)
    r = cs.K8_READS
    consts8 = tuple(p[:r].contiguous() for p in parts[:5])
    slut8 = parts[5][: r * M].contiguous()
    caught = []
    real = sp2._extract_chains_cuda

    def catch(*a, final=True, **kw):
        if not final and not caught:
            st = [t.clone() if t is not None else None for t in a[:5]]
            st += [a[5], a[6]]
            ext = sp2._Extraction(*st, tight, torch.zeros(
                sp2.EXT_FLAGS, dtype=torch.int32, device=st[0].device))
            caught.append((tuple(st) + (ext,), st[3].clone()))
        return real(*a, final=final, **kw)

    sp2._extract_chains_cuda = catch
    try:
        sp2._pool_loop_cuda(idx, *consts8, engine._params(), tight, slut8)
    finally:
        sp2._extract_chains_cuda = real
    if not caught:
        raise RuntimeError("compact_check's run reached no store boundary")
    st, glob0 = caught[0]
    out.append((f"boundary (S={tight.total_steps} CAP="
                f"{tight.read_step_cap}, {r} reads, final=False)", st,
                tight, False, glob0))
    del engine, parts

    fasta2, _fq2, reads2 = cs.write_workload(np, cs.GENOME2_SIZE, 52, "2")
    if cli.main(["index", "-g", fasta2]) != 0:
        raise RuntimeError("index failed")
    big = DeviceSearchEngine(load_index(fasta2).fmd, params,
                             lanes=args.lanes, big=True, packed_hits=True)
    R = cs.BLOCK2_READS
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads2[:R]]
    cfg2, prep2, _t0 = big._prep_block(recs, R, big.pool_config)
    M = prep2["max_len"]
    blob2 = torch.from_numpy(prep2["blob"]).to(big.device)
    tab2, pen2, off2 = big._device_lut()
    k6_in = (blob2, tab2, pen2, off2, R, M, _DEV_LUT_Q)
    rank, code, n, score_lut, pen, split, scale, thresh, repr_mm = \
        eng._unpack_prep_full(*k6_in)
    slut2 = sp2._dense_slut(big.device_index, (rank, code, score_lut, pen),
                            n, split, cfg2, prep2["bid_steps"])
    r = cs.CHECK2_READS
    consts2 = tuple(p[:r].contiguous()
                    for p in (n, split, scale, thresh, repr_mm))
    state2 = sp2._pool_loop_cuda(big.device_index, *consts2, big._params(),
                                 cfg2, slut2[: r * M].contiguous())
    out.append((f"int64 pool_check (L={cfg2.lanes} S={cfg2.total_steps} "
                f"C={cfg2.max_chains}, {r} reads)", state2, cfg2, True,
                None))
    return out, k6_in


def _wrapper(sp2, state, cfg, final, restore):
    """A call of the module's K3 wrapper on `state` (the counters restored
    first for a boundary extraction, into a new result) -> the fields it
    wrote, the loop counters after it last."""
    if restore is None:
        return lambda: tuple(sp2._extract_chains_cuda(*state, cfg))
    glob, ext = state[3], state[7]

    def call():
        glob.copy_(restore)
        ext.out = None
        sp2._extract_chains_cuda(*state, cfg, final=False)
        return _fields(ext.out, cfg, state[5], state[6]) + (glob.clone(),)
    return call


def card_ms(call, reps=REPS, flush=None):
    """(ms a call the card is busy, {kernel: (launches a call, us a
    launch)}) from `torch.profiler` over `reps` calls; with `flush` (a
    tensor) its zeroing before each call, not counted."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            call()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.device_time_total <= 0
                or (flush is not None and "fill" in e.key.lower())):
            continue
        per[e.key] = (e.count / reps, e.device_time_total / max(e.count, 1))
    total = sum(n * us for n, us in per.values()) / 1e3
    return total, per


def _show(per):
    return "; ".join(f"{k[:60]} x{n:g} {us:.2f} us"
                     for k, (n, us) in sorted(per.items()))


def cold_runs(call, flush, n=3):
    """ms of each of n calls, each between two CUDA events, the L2 flushed
    before each (not timed)."""
    out = []
    for _ in range(n):
        flush.zero_()
        out += event_runs(call, 1)
    return out


def _appended(fields, restore, cfg):
    """What a boundary extraction wrote: the entries it appended (at
    min(entries so far, C), up to C), read_steps and the loop counters
    (the result's other words are left as they were)."""
    from ..ops import search_pool2 as sp2

    glob = fields[-1]
    lo = min(int(restore[sp2.G_ACC_N]), cfg.max_chains)
    hi = min(int(glob[sp2.G_ACC_N]), cfg.max_chains)
    return tuple(f[lo:hi] for f in fields[:8]) + (fields[13], glob)


def chain_figures(res, cfg, restore=None):
    """(chains, entries, deepest walked chain in words) of a result (of
    the entries a boundary extraction appended)."""
    from ..ops import search_pool2 as sp2

    if restore is None:
        n_ch = int(res[8])
        n_ext = min(n_ch, cfg.max_chains)
    else:
        glob = res[-1]
        n_ch = int(glob[sp2.G_ACC_NCH] - restore[sp2.G_ACC_NCH])
        n_ext = res[0].shape[0]
    ops = res[7][:n_ext]
    depth = int((ops != 0).sum(1).max()) if n_ext else 0
    return n_ch, n_ext, depth


def host_parts(sp2, state, cfg):
    """us a call of each host part of the checkout's K3 wrapper on a final
    extraction: the allocation, the PoolResult's views (1,000 calls each),
    the launch with its count (20 calls)."""
    store, bmask, lane, glob, fin_log, R, big, ext = state
    dev = store.device
    out = sp2._alloc_result(cfg, R, big, dev)

    def launch():
        sp2.LAUNCHES.add(ext.name)
        ext.launch(out, True)
    return {"allocation": host_us(
                lambda: sp2._alloc_result(cfg, R, big, dev), 1000),
            "views": host_us(lambda: sp2._pool_result(out, cfg, R, big),
                             1000),
            "launch": host_us(launch, REPS)}


def _print_phases(lib):
    """The SM cycles of each phase: the warp that ends last, and the
    largest over all warps."""
    import numpy as np

    out = (ctypes.c_longlong * (PHASE_WARPS * 8))()
    lib.k3_phase_read.restype = ctypes.c_int
    _build.check(lib.k3_phase_read(out), "k3_phase_read")
    a = np.frombuffer(out, dtype=np.int64).reshape(PHASE_WARPS, 8)
    a = a[a[:, 0] != 0]
    d = np.diff(a[:, :7], axis=1)
    last = int(np.argmax(d.sum(1)))
    print("  phases, SM cycles (the slowest warp; the largest of "
          f"{len(a)} warps): " + ", ".join(
              f"{p} {int(d[last, i])} ({int(d[:, i].max())})"
              for i, p in enumerate(PHASES)), flush=True)


def _k3_case(sp2, k3, libs, lat, flush, dev, phases, case):
    """Time one K3 case in every build, in turns."""
    what, state, cfg, final, restore = case
    R, big = state[5], state[6]
    wrap = _wrapper(sp2, state, cfg, final, restore)
    want = wrap()
    torch.cuda.synchronize()
    if restore is not None:
        want = _appended(want, restore, cfg)
    n_ch, n_ext, depth = chain_figures(want, cfg, restore)
    steps, base = (int(x) for x in state[3][[0, 5]].tolist())
    plan = sp2.extract_card_plan(dev, cfg.lanes, cfg.max_chains,
                                 cfg.max_len + 16, big)
    ev = sorted(event_runs(lambda: [wrap() for _ in range(REPS)],
                           3))[1] / REPS
    host = host_us(wrap, REPS)
    busy, per = card_ms(wrap)
    cold, per_cold = card_ms(wrap, flush=flush)
    # the same chase through as many words as the store holds
    lat_store = load_latency_ns(dev, state[0].numel(), CHASE_HOPS, flush)
    print(f"K3 {what}: steps {base}..{steps}, {n_ch} chains, {n_ext} "
          f"entries, deepest walked chain {depth} words; walk floor "
          f"{depth * lat['DRAM'] / 1e6:.4f} ms ({depth} x "
          f"{lat['DRAM']:.1f} ns; in L2 {depth * lat['L2'] / 1e6:.4f}; "
          f"through the store's {state[0].numel() * 4 / 2**30:.2f} GiB, "
          f"{lat_store:.1f} ns a load, {depth * lat_store / 1e6:.4f}); plan "
          f"{dict(plan._asdict())}", flush=True)
    print(f"  wrapper: events {ev:.4f} ms a call, host {host:.1f} us a "
          f"call; card {busy:.4f} ms a call ({_show(per)}); cold "
          f"{cold:.4f} ms ({_show(per_cold)})", flush=True)
    if final:
        print("  host parts, us a call: " + ", ".join(
            f"{k} {v:.1f}" for k, v in host_parts(sp2, state, cfg).items()),
            flush=True)
    times = {}
    for name in in_turns([n for n in k3 if not n.startswith("phases_")]):
        if restore is not None:
            state[3].copy_(restore)
        call, out = k3[name].setup(state, cfg, final)
        call()
        torch.cuda.synchronize()
        got = _fields(out, cfg, R, big)
        if restore is not None:
            got = _appended(got + (state[3].clone(),), restore, cfg)
        same_bits(got, want, f"K3 {name} ({what})")

        def timed_call():
            if restore is not None:
                state[3].copy_(restore)
            call()
        runs = [x / REPS for x in event_runs(
            lambda: [timed_call() for _ in range(REPS)], 3)]
        cold_ms = sorted(cold_runs(timed_call, flush))[1]
        times.setdefault(name, []).extend(runs)
        print(f"  K3 {name}: bare launch {sorted(runs)[1]:.4f} ms a call "
              f"(runs {', '.join(f'{x:.4f}' for x in runs)}), cold "
              f"{cold_ms:.4f}; bit-exact", flush=True)
    print(f"  K3 ({what}) medians over both turns: " + ", ".join(
        f"{n} {sorted(v)[len(v) // 2]:.4f} ms" for n, v in times.items()),
        flush=True)
    if phases:
        name = f"phases_{CHECKOUT}"
        if restore is not None:
            state[3].copy_(restore)
        call, _out = k3[name].setup(state, cfg, final)
        flush.zero_()
        call()
        torch.cuda.synchronize()
        _print_phases(libs[f"k3_{name}"][0])
    if restore is not None:
        state[3].copy_(restore)


def _k6_case(eng, libs, k6_src, k6_in):
    """Time K6: its wrapper, then every build's bare launch in turns."""
    def k6():
        return eng._unpack_prep_full(*k6_in)
    want = k6()
    torch.cuda.synchronize()
    same_bits(want, eng._unpack_prep_full_plain(*k6_in), "K6 against plain")
    blob, tab, pen_tab, off, R, M, Q = k6_in
    ev = sorted(event_runs(lambda: [k6() for _ in range(REPS)], 3))[1] / REPS
    host = host_us(k6, 1000)
    busy, per = card_ms(k6)
    print(f"K6 R={R} M={M}: wrapper events {ev:.4f} ms a call, host "
          f"{host:.1f} us a call, card {busy:.4f} ms a call ({_show(per)})",
          flush=True)
    times = {}
    for name in in_turns([n for n, _t in k6_src]):
        fn = libs[f"k6_{name}"][0].unpack_prep_full
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(eng._UnpackFullArgs), ctypes.c_void_p]
        outs = [torch.empty_like(want[k]) for k in (0, 1, 3, 4)]
        a = eng._UnpackFullArgs(
            blob.data_ptr(), tab.data_ptr(), pen_tab.data_ptr(),
            off.data_ptr(), tab.shape[0], off.shape[0], R, M, Q,
            *[o.data_ptr() for o in outs])
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            _build.check(fn(ctypes.byref(a), stream), "unpack_prep_full")
        call()
        torch.cuda.synchronize()
        same_bits(outs, [want[k] for k in (0, 1, 3, 4)],
                  f"K6 {name} against the checkout's wrapper")
        runs = [x / REPS for x in event_runs(
            lambda: [call() for _ in range(REPS)], 3)]
        times.setdefault(name, []).extend(runs)
        d, dper = card_ms(call)
        print(f"  K6 {name}: bare launch {sorted(runs)[1]:.4f} ms a call "
              f"by events, card {d:.4f} ms ({_show(dper)}); bit-exact",
              flush=True)
    print("  K6 medians over both turns: " + ", ".join(
        f"{n} {sorted(v)[len(v) // 2]:.4f} ms" for n, v in times.items()),
        flush=True)


def main(argv=None) -> int:
    import numpy as np

    from . import card

    argv = list(sys.argv[1:] if argv is None else argv)
    resolve_device(None)
    _build.build_cuda()
    phases = "--phases" in argv
    variants = [a for a in argv if a != "--phases"]
    out_dir = os.path.join(_build.BUILD_DIR, "k3_time")
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for name in ("extract_chains", "unpack_prep"):
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            texts[name] = f.read()
    k3_src = [(CHECKOUT, texts["extract_chains"])]
    k6_src = [(CHECKOUT, texts["unpack_prep"])]
    for path, (name, text) in zip(variants, variant_sources(variants)):
        # a variant of an older form brings that revision's common.cuh
        header = os.path.join(os.path.dirname(path), "common.cuh")
        if os.path.exists(header):
            with open(header) as f:
                text = text.replace('#include "common.cuh"', f.read())
        (k3_src if "extract_chains" in text else k6_src).append((name, text))
    if phases:
        k3_src.append((f"phases_{CHECKOUT}", apply_edits(
            texts["extract_chains"], EDITS, "extract_chains.cu")))
    libs = build_variants(
        [(f"k3_{n}", t) for n, t in k3_src]
        + [(f"k6_{n}", t) for n, t in k6_src], out_dir, "k3")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    for name, (_lib, log) in sorted(libs.items()):
        for entry, figs in cs.ptxas_entries(log):
            print(f"ptxas {name} {entry}: {figs}", flush=True)
    print(card(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)
    lat = {"DRAM": load_latency_ns(dev, CHASE_BIG, CHASE_HOPS, flush),
           "L2": load_latency_ns(dev, CHASE_L2, CHASE_HOPS)}
    print(f"dependent load: {lat['DRAM']:.1f} ns through 256 MB (the L2 "
          f"flushed first), {lat['L2']:.1f} ns through 8 MB (in L2; one "
          f"thread, {CHASE_HOPS} hops a call, median of three calls)",
          flush=True)

    from .. import cli
    from ..ops import engine as eng
    from ..ops import search_pool2 as sp2

    args = cli.build_parser().parse_args(
        ["map", "-r", "x", "-g", "x", "-o", "x", *cs.MAP_FLAGS])
    params = cli.build_alignment_parameters(args)
    os.makedirs(cs.WORK, exist_ok=True)
    cases, k6_in = _k3_inputs(np, cs, cli, params, args)
    k3 = {n: K3Launcher(libs[f"k3_{n}"][0]) for n, _t in k3_src}
    for case in cases:
        _k3_case(sp2, k3, libs, lat, flush, dev, phases, case)
    _k6_case(eng, libs, k6_src, k6_in)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
