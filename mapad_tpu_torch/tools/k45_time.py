"""K4 and K5 on the card, each time split into card and host, against
variants of their sources, at `chip_smoke.py`'s shapes, in one process.

    python -m mapad_tpu_torch.tools.k45_time [--variants-only] [variant.cu ...]

Builds the checkout's csrc/pack_result.cu and csrc/unpack_prep.cu and each
variant source given (a copy edited by hand, or an older revision such as
the parent's: `git show <rev>:mapad_tpu_torch/csrc/pack_result.cu >
.proof/pack_result_parent.cu`, the same for unpack_prep.cu, with that
revision's csrc/common.cuh beside them as `.proof/common.cuh`, which then
takes the place of the checkout's; a variant whose text has
`pack_result_kernel` is a K5 variant, else a K4 one) at once.  A variant
without `PackPlan` (K5) or `UnpackPlan` (K4) is of the older form (a
thread a word or a cell, no plan) and is launched, and wrapped, as that
form was: its wrapper is re-made here as it stood (the checks, a new
argument block, the entry's lookup, a `torch.cuda.Stream` object for the
stream, the allocation, the launch).
Cases:

  K4 rle     path 1's first block (8,192 reads, M=128), the Bi-D RLE on;
  K4 raw     the same reads with the RLE off (MAPAD_BID_RLE=0);
  K5 int32   pool_check's result: path 1's first 1,024 reads, L=512,
             S=8192, C=16384, MW=144;
  K5 int64   path 2's first 512 reads (64 Mbp genome, big mode).

For each case and build it prints:

  events   ms a call of the wrapper, CUDA events around 20 calls back to
           back (where the host takes longer than the card, the host's);
  host     us a call the wrapper takes on the host, and its parts;
  card     ms a call the card is busy (`torch.profiler`), warm and with the
           L2 flushed (a 128 MB write) before each call;
  launch   ms a call of the bare library entry (argument block made once)
           by CUDA events, warm and cold, every build in turns, each held
           bit for bit against the checkout's wrapper;

and for K5 the engine's host time an invocation from the start of K3's
wrapper to K5's return, each path in turns: with the PoolResult views K3's
wrapper makes and the older K5 wrapper, with the views and the checkout's
PoolResult entry, and without views (`views=False`, then `_pack_buffer`:
the engine's path now); and a mesh shard's (shard 1 of two), with the
views, `shard_rebase` (through the wrapper as it stood at f0659d3, and
bound once) and the PoolResult entry (the mesh path up to f0659d3), and
without views, K5 rebasing as it packs (the mesh path now).  K5's bare
launch also runs with that rebase ("checkout rebase"), against the plain
rebase and pack.  Last, `shard_rebase` alone on the int32 case's result,
its wrapper bound once and as it stood at f0659d3, in turns, each split
as the wrappers above.  `--variants-only` times the variants alone (the
checkout's builds give the bit-exact reference).
"""
from __future__ import annotations

import ctypes
import os
import sys

import torch

from .. import _build
from ..ops.fm import resolve_device
from . import (build_variants, event_runs, host_us, in_turns, same_bits,
               variant_sources)
from .k3_time import _show, card_ms, cold_runs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKOUT = "checkout"
REPS = 20
HOST_REPS = 1000


class _ParentPackArgs(ctypes.Structure):
    """`struct PackArgs` of csrc/pack_result.cu up to 946a23b: a pointer a
    PoolResult field, the sizes, the output."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "c_read", "c_slot", "c_abandon", "c_lower", "c_lrev", "c_size",
        "c_score", "c_ops", "n_chains", "lane_read", "lane_unfinished",
        "next_read", "steps", "read_steps")] + [
        (f, ctypes.c_int)
        for f in ("C", "MW", "L", "R", "opbits", "K", "pb", "big")] + [
        ("out", ctypes.c_void_p)]


def _split_consts(blob, R):
    """The consts by two `split`s: a form tried against the five
    `as_strided` of ops/engine.py `_consts`."""
    n, split = blob[: 2 * R].split(R)
    return (n, split, *blob[2 * R : 5 * R].view(torch.float32).split(R))


class K5Build:
    """One build's K5: its bare entry on a result, and (for the older
    form) its wrapper as it stood."""

    def __init__(self, lib):
        from ..ops import engine as eng

        self.planned = "PackPlan" in lib.text
        self.fn = lib.pack_result
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = (
            [ctypes.POINTER(eng._PackArgs), ctypes.POINTER(eng._PackPlanC),
             ctypes.c_void_p] if self.planned else
            [ctypes.POINTER(_ParentPackArgs), ctypes.c_longlong,
             ctypes.c_void_p])

    def bare(self, buf, res, cfg, R, big, rebase=None):
        """-> (call, out): the entry on the result, argument block made
        once (the planned form on K3's allocation, the older on the
        PoolResult's views); `rebase`, a shard's (base, r_local, r_global),
        for a build whose `PackArgs` ends in the rebase (a planned build
        without it reads the block's head, as its own struct is)."""
        from ..ops import engine as eng
        from ..ops import search_pool2 as sp2
        from ..ops.prep import _wire_opbits

        L, C, MW = cfg.lanes, cfg.max_chains, cfg.max_len + 16
        stream = torch.cuda.current_stream().cuda_stream
        opbits, K, pb = _wire_opbits(MW)
        total = sp2._packed_words(C, MW, L, R, big)
        if self.planned:
            lay = sp2._result_layout(L, C, MW, R, cfg.total_steps, big)
            a = eng._PackArgs()
            ptrs = (ctypes.c_void_p * 15).from_buffer(a)
            ptrs[:] = [buf.data_ptr() + b for b in lay.pack]
            a.C, a.MW, a.L, a.R = C, MW, L, R
            a.opbits, a.K, a.pb, a.big = opbits, K, pb, int(big)
            if rebase is not None:
                a.rebase = 1
                a.base, a.r_local, a.r_global = rebase
            plan = eng._PackPlanC(*eng.pack_plan(C, MW, L, R, big))
            at = lay.at["packed"]
            out = buf[at : at + total]

            def call():
                _build.check(self.fn(a, plan, stream), "pack_result")
            return call, out
        out = torch.empty(total, dtype=torch.int32, device=buf.device)
        a = _ParentPackArgs(*[t.data_ptr() for t in res], C, MW, L, R,
                            opbits, K, pb, int(big), out.data_ptr())

        def call():
            _build.check(self.fn(ctypes.byref(a), total, stream),
                         "pack_result")
        return call, out

    def wrapper(self, res):
        """The older form's wrapper on a PoolResult, as it stood (946a23b
        ops/engine.py `_pack_result`)."""
        from ..ops import search_pool2 as sp2
        from ..ops.prep import _wire_opbits

        C, MW = res.c_ops.shape
        L = res.lane_read.shape[0]
        R = res.read_steps.shape[0]
        for t in res:
            _build.require(t.is_cuda and t.is_contiguous(),
                           "pack_result takes contiguous CUDA tensors")
        opbits, K, pb = _wire_opbits(MW)
        big = res.c_lower.dtype == torch.int64
        _build.require(
            res.c_lrev.dtype == res.c_size.dtype == res.c_lower.dtype,
            "interval fields must share one type")
        total = sp2._packed_words(C, MW, L, R, big)
        out = torch.empty(total, dtype=torch.int32, device=res.c_read.device)
        args = _ParentPackArgs(*[t.data_ptr() for t in res], C, MW, L, R,
                               opbits, K, pb, int(big), out.data_ptr())
        _build.cuda_function("pack_result", "pack_result", None)
        _build.LAUNCHES.add("pack_result_i64" if big else "pack_result")
        _build.check(self.fn(ctypes.byref(args), total,
                             torch.cuda.current_stream(out.device)
                             .cuda_stream), "pack_result")
        return out


class K4Build:
    """One build's K4: its bare entry on a blob, and (for the older form)
    its wrapper as it stood."""

    def __init__(self, lib):
        from ..ops import engine as eng

        self.planned = "UnpackPlan" in lib.text
        self.fn = lib.unpack_prep
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = (
            [ctypes.POINTER(eng._UnpackArgs),
             ctypes.POINTER(eng._UnpackPlanC), ctypes.c_void_p]
            if self.planned else
            [ctypes.POINTER(eng._UnpackArgs), ctypes.c_void_p])

    def bare(self, blob, tab, off, R, M, Q, rle):
        """-> (call, slut): the entry on the blob, argument block made
        once."""
        from ..ops import engine as eng

        slut = torch.empty((R * M, 6), dtype=torch.float32,
                           device=blob.device)
        a = eng._UnpackArgs(blob.data_ptr(), tab.data_ptr(), off.data_ptr(),
                            tab.shape[0], off.shape[0], R, M, Q, int(rle),
                            slut.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if self.planned:
            plan = eng._UnpackPlanC(*eng.unpack_plan(R, M, rle))

            def call():
                _build.check(self.fn(a, plan, stream), "unpack_prep")
        else:
            def call():
                _build.check(self.fn(ctypes.byref(a), stream), "unpack_prep")
        return call, slut

    def wrapper(self, blob, tab, off, R, M, Q, rle):
        """The older form's wrapper, as it stood (946a23b ops/engine.py
        `_unpack_prep_lut`)."""
        from ..ops import engine as eng
        from ..ops.prep import _BID_SEG, _cq_words

        for t, dt in ((blob, torch.int32), (tab, torch.float32),
                      (off, torch.int32)):
            _build.require(t.is_cuda and t.dtype == dt and t.is_contiguous(),
                           "unpack_prep takes contiguous CUDA tensors")
        words = 5 * R + ((_BID_SEG // 4 + _BID_SEG) * R if rle else R * M)
        _build.require(blob.numel() == words + _cq_words(R * M), "blob size")
        _build.require(tab.dim() == 2 and tab.shape[1] == 4,
                       "LUT table shape")
        slut = torch.empty((R * M, 6), dtype=torch.float32,
                           device=blob.device)
        args = eng._UnpackArgs(blob.data_ptr(), tab.data_ptr(),
                               off.data_ptr(), tab.shape[0], off.shape[0], R,
                               M, Q, int(rle), slut.data_ptr())
        _build.cuda_function("unpack_prep", "unpack_prep", None)
        _build.LAUNCHES.add("unpack_prep")
        _build.check(self.fn(ctypes.byref(args),
                             torch.cuda.current_stream(blob.device)
                             .cuda_stream), "unpack_prep")
        return (*eng._consts(blob, R), slut)


def _inputs(np, cs, cli, params, args):
    """-> (K4 cases [(what, blob, tab, off, R, M, Q, rle)], K5 cases
    [(what, loop state, config, R, big)])."""
    from ..index import load_index
    from ..map.record import Record
    from ..ops import engine as eng
    from ..ops import search_pool2 as sp2
    from ..ops.engine import DeviceSearchEngine
    from ..ops.prep import _DEV_LUT_Q

    fasta, _fq, reads = cs.write_workload(np, cs.GENOME_SIZE, 42, "")
    if cli.main(["index", "-g", fasta]) != 0:
        raise RuntimeError("index failed")
    engine = DeviceSearchEngine(load_index(fasta).fmd, params,
                                lanes=args.lanes, packed_hits=True)
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads[:8192]]
    tab, _pen, off = engine._device_lut()
    k4 = []
    for rle in (True, False):
        os.environ["MAPAD_BID_RLE"] = "1" if rle else "0"
        cfg, prep, _t0 = engine._prep_block(recs, 8192, engine.pool_config)
        if prep["rle"] != rle:
            raise RuntimeError("the blob's Bi-D form is not the one asked")
        blob = torch.from_numpy(prep["blob"]).to(engine.device)
        k4.append((f"rle={rle} (R={prep['L']} M={prep['max_len']})", blob,
                   tab, off, prep["L"], prep["max_len"], _DEV_LUT_Q, rle))
    os.environ.pop("MAPAD_BID_RLE")
    _what, blob, tab, off, R, M, Q, _rle = k4[0]
    parts = eng._unpack_prep_lut(blob, tab, off, R, M, Q, True)
    r = cs.CHECK_READS
    consts = tuple(p[:r].contiguous() for p in parts[:5])
    state = sp2._pool_loop_cuda(engine.device_index, *consts,
                                engine._params(), cfg,
                                parts[5][: r * M].contiguous())
    k5 = [(f"int32 pool_check (L={cfg.lanes} C={cfg.max_chains} "
           f"MW={cfg.max_len + 16}, {r} reads)", state, cfg, r, False)]

    fasta2, _fq2, reads2 = cs.write_workload(np, cs.GENOME2_SIZE, 52, "2")
    if cli.main(["index", "-g", fasta2]) != 0:
        raise RuntimeError("index failed")
    big = DeviceSearchEngine(load_index(fasta2).fmd, params,
                             lanes=args.lanes, big=True, packed_hits=True)
    R2 = cs.BLOCK2_READS
    recs2 = [Record(sequence=s, base_qualities=q) for s, q in reads2[:R2]]
    cfg2, prep2, _t0 = big._prep_block(recs2, R2, big.pool_config)
    M2 = prep2["max_len"]
    blob2 = torch.from_numpy(prep2["blob"]).to(big.device)
    tab2, pen2, off2 = big._device_lut()
    rank, code, n, score_lut, pen, split, scale, thresh, repr_mm = \
        eng._unpack_prep_full(blob2, tab2, pen2, off2, R2, M2, _DEV_LUT_Q)
    slut2 = sp2._dense_slut(big.device_index, (rank, code, score_lut, pen),
                            n, split, cfg2, prep2["bid_steps"])
    r2 = cs.CHECK2_READS
    consts2 = tuple(p[:r2].contiguous()
                    for p in (n, split, scale, thresh, repr_mm))
    state2 = sp2._pool_loop_cuda(big.device_index, *consts2, big._params(),
                                 cfg2, slut2[: r2 * M2].contiguous())
    k5.append((f"int64 pool_check (L={cfg2.lanes} C={cfg2.max_chains} "
               f"MW={cfg2.max_len + 16}, {r2} reads)", state2, cfg2, r2,
               True))
    return k4, k5


def _line(name, ev, host, busy, per, cold, per_cold):
    return (f"  {name}: wrapper events {ev:.4f} ms a call, host {host:.1f} "
            f"us a call; card {busy:.4f} ms a call ({_show(per)}); cold "
            f"{cold:.4f} ms ({_show(per_cold)})")


def _timed_wrapper(name, call, flush):
    ev = sorted(event_runs(lambda: [call() for _ in range(REPS)],
                           3))[1] / REPS
    host = host_us(call, HOST_REPS)
    busy, per = card_ms(call)
    cold, per_cold = card_ms(call, flush=flush)
    print(_line(name, ev, host, busy, per, cold, per_cold), flush=True)


def _bare_in_turns(what, names, setup, want, flush):
    """Every build's bare entry in turns, each bit for bit against
    `want` (a tensor, or {name: tensor})."""
    times = {}
    for name in in_turns(names):
        call, out = setup(name)
        call()
        torch.cuda.synchronize()
        same_bits((out,), (want[name] if isinstance(want, dict) else want,),
                  f"{what} {name}")
        runs = [x / REPS for x in event_runs(
            lambda: [call() for _ in range(REPS)], 3)]
        cold = sorted(cold_runs(call, flush))[1]
        times.setdefault(name, []).extend(runs)
        print(f"    {name}: bare launch {sorted(runs)[1]:.4f} ms a call "
              f"(runs {', '.join(f'{x:.4f}' for x in runs)}), cold "
              f"{cold:.4f}; bit-exact", flush=True)
    print(f"  {what} bare launch, medians over both turns: " + ", ".join(
        f"{n} {sorted(v)[len(v) // 2]:.4f} ms" for n, v in times.items()),
        flush=True)


def _k4_case(eng, cs, builds, timed, flush, case):
    what, blob, tab, off, R, M, Q, rle = case
    want = eng._unpack_prep_lut(blob, tab, off, R, M, Q, rle)
    torch.cuda.synchronize()
    touched = cs.table_rows_touched(torch, blob, want[5][:, 4].to(
        torch.int32), off, tab.shape[0], R, M, Q)
    bound = cs.bound_ms(cs.nbytes(blob, want[5]) + 16 * touched)
    print(f"K4 {what}: bound {bound:.5f} ms (the blob, the rows written, "
          f"{touched} table rows); plan "
          f"{dict(eng.unpack_plan(R, M, rle)._asdict())}", flush=True)
    same_bits(want, eng._unpack_prep_lut_plain(blob, tab, off, R, M, Q, rle),
              "K4 against plain")
    for name in timed:
        b = builds[name]
        if b.planned and name == CHECKOUT:
            def call():
                return eng._unpack_prep_lut(blob, tab, off, R, M, Q, rle)
        elif b.planned:
            continue
        else:
            def call(b=b):
                return b.wrapper(blob, tab, off, R, M, Q, rle)
        same_bits(call(), want, f"K4 {name}'s wrapper")
        _timed_wrapper(name, call, flush)
        if name == CHECKOUT:
            a = eng._k4.args
            parts = {
                "allocation": lambda: torch.empty(
                    (R * M, 6), dtype=torch.float32, device=blob.device),
                "consts": lambda: eng._consts(blob, R),
                "consts by two splits": lambda: _split_consts(blob, R),
                "pointers": lambda: setattr(a, "blob", blob.data_ptr()),
                "launch": lambda: eng._k4.fn(a, eng._k4.plan,
                                             _build.current_raw_stream())}
        else:
            parts = {
                "checks and argument block": lambda: eng._UnpackArgs(
                    blob.data_ptr(), tab.data_ptr(), off.data_ptr(),
                    tab.shape[0], off.shape[0], R, M, Q, int(rle),
                    want[5].data_ptr()),
                "stream object": lambda: torch.cuda.current_stream(
                    blob.device).cuda_stream,
                "consts": lambda: eng._consts(blob, R)}
        print("    host parts, us a call: " + ", ".join(
            f"{k} {host_us(v, HOST_REPS):.1f}" for k, v in parts.items()),
            flush=True)
    _bare_in_turns(f"K4 {what}", timed,
                   lambda n: builds[n].bare(blob, tab, off, R, M, Q, rle),
                   want[5], flush)


def _parent_rebase(tps, res, base, r_local, r_global):
    """`shard_rebase`'s wrapper as it stood (f0659d3
    parallel/pool_sharded.py): the checks, a new argument block and the
    entry's lookup a call, a `torch.cuda.Stream` object for the stream."""
    for t in (res.c_read, res.lane_read, res.next_read):
        _build.require(t.is_cuda and t.dtype == torch.int32
                       and t.is_contiguous(),
                       "shard_rebase takes contiguous int32 CUDA tensors")
    _build.require(res.next_read.numel() == 1, "next_read is one word")
    _build.require(0 <= base and base + r_local <= r_global < 2**31,
                   "shard slice outside the block")
    args = tps._RebaseArgs(res.c_read.data_ptr(), res.lane_read.data_ptr(),
                           res.next_read.data_ptr(), res.c_read.shape[0],
                           res.lane_read.shape[0], base, r_local, r_global)
    fn = _build.cuda_function("pool_sharded", "shard_rebase",
                              [ctypes.POINTER(tps._RebaseArgs),
                               ctypes.c_void_p])
    _build.LAUNCHES.add("shard_rebase")
    _build.check(fn(ctypes.byref(args), torch.cuda.current_stream(
        res.c_read.device).cuda_stream), "shard_rebase")
    return res


def _k5_case(eng, sp2, cs, builds, timed, flush, case):
    from ..parallel import pool_sharded as tps

    what, state, cfg, R, big = case
    L, C, MW = cfg.lanes, cfg.max_chains, cfg.max_len + 16
    res = sp2._extract_chains_cuda(*state, cfg)
    buf = sp2._extract_chains_cuda(*state, cfg, views=False)
    # a copy: the packed part of `buf` is written again by every call
    want = eng._pack_buffer(buf, cfg, R, big).clone()
    # shard 1 of two of R reads: its ids made global while they are packed
    rebase = (R, R, 2 * R)
    want_rebased = eng._pack_result_plain(tps._shard_rebase_plain(
        sp2._extract_chains_cuda(*state, cfg), *rebase))
    torch.cuda.synchronize()
    print(f"K5 {what}: bound {cs.bound_ms(cs.nbytes(*res, want)):.5f} ms "
          f"(every field read, the words written); plan "
          f"{dict(eng.pack_plan(C, MW, L, R, big)._asdict())}", flush=True)
    same_bits((want,), (eng._pack_result_plain(res),), "K5 against plain")
    same_bits((eng._pack_result(res),), (want,), "K5's PoolResult entry")
    for name in timed:
        b = builds[name]
        if b.planned and name == CHECKOUT:
            calls = {"buffer entry": (lambda: eng._pack_buffer(buf, cfg, R,
                                                               big), want),
                     "buffer entry with a shard's rebase": (
                         lambda: eng._pack_buffer(buf, cfg, R, big, rebase),
                         want_rebased),
                     "PoolResult entry": (lambda: eng._pack_result(res),
                                          want)}
        elif b.planned:
            continue
        else:
            calls = {"wrapper": (lambda b=b: b.wrapper(res), want)}
        for entry, (call, expect) in calls.items():
            same_bits((call(),), (expect,), f"K5 {name} {entry}")
            _timed_wrapper(f"{name} {entry}", call, flush)
        if name == CHECKOUT:
            k = eng._k5
            lay = sp2._result_layout(L, C, MW, R, cfg.total_steps, big)
            base = buf.data_ptr()
            at = lay.at["packed"]
            parts = {
                "layout and shape": lambda: (
                    sp2._result_layout(L, C, MW, R, cfg.total_steps, big),
                    k.set_shape(C, MW, L, R, big)),
                "pointers": lambda: k.ptrs.__setitem__(
                    slice(None), [base + o for o in lay.pack]),
                "rebase": lambda: k.set_rebase(rebase),
                "view of the packed part": lambda: buf[at : at + 100],
                "launch": lambda: k.fn(k.args, k.plan,
                                       _build.current_raw_stream()),
                "an allocation instead": lambda: torch.empty(
                    want.numel(), dtype=torch.int32, device=buf.device)}
        else:
            parts = {
                "checks": lambda: [t.is_cuda and t.is_contiguous()
                                   for t in res],
                "argument block": lambda: _ParentPackArgs(
                    *[t.data_ptr() for t in res], C, MW, L, R, 0, 0, 0, 0,
                    want.data_ptr()),
                "stream object": lambda: torch.cuda.current_stream(
                    buf.device).cuda_stream,
                "allocation": lambda: torch.empty(
                    want.numel(), dtype=torch.int32, device=buf.device)}
        parts["K3's PoolResult views"] = lambda: sp2._pool_result(buf, cfg,
                                                                  R, big)
        print("    host parts, us a call: " + ", ".join(
            f"{k2} {host_us(v, HOST_REPS):.1f}" for k2, v in parts.items()),
            flush=True)

    # the engine's host time an invocation, K3's wrapper to K5's return;
    # and a mesh shard's (shard 1 of two): the parent's path (views, the
    # rebase through its older wrapper, the PoolResult entry), and the
    # engine's now (no views, the buffer entry with the rebase)
    older = [n for n in builds if not builds[n].planned]
    paths = {"views + PoolResult entry": lambda: eng._pack_result(
                 sp2._extract_chains_cuda(*state, cfg)),
             "no views + buffer entry": lambda: eng._pack_buffer(
                 sp2._extract_chains_cuda(*state, cfg, views=False), cfg, R,
                 big),
             "mesh shard, views + the parent's shard_rebase wrapper + "
             "PoolResult entry": lambda: eng._pack_result(_parent_rebase(
                 tps, sp2._extract_chains_cuda(*state, cfg), *rebase)),
             "mesh shard, views + shard_rebase + PoolResult entry":
                 lambda: eng._pack_result(tps.shard_rebase(
                     sp2._extract_chains_cuda(*state, cfg), *rebase)),
             "mesh shard, no views + buffer entry with the rebase":
                 lambda: eng._pack_buffer(
                     sp2._extract_chains_cuda(*state, cfg, views=False), cfg,
                     R, big, rebase)}
    for n in older:
        paths[f"views + {n}'s wrapper"] = (
            lambda b=builds[n]: b.wrapper(sp2._extract_chains_cuda(*state,
                                                                   cfg)))
    host = {k2: [] for k2 in paths}
    for k2 in in_turns(paths):
        host[k2].append(host_us(paths[k2], 200))
    print(f"  engine, K3's wrapper to K5's return, host us an invocation "
          f"(in turns): " + ", ".join(
              f"{k2} {', '.join(f'{x:.1f}' for x in v)}"
              for k2, v in host.items()), flush=True)
    names = list(timed)
    if CHECKOUT in names:
        names.insert(names.index(CHECKOUT) + 1, f"{CHECKOUT} rebase")
    _bare_in_turns(
        f"K5 {what}", names,
        lambda n: builds[n.split()[0]].bare(
            buf, res, cfg, R, big, rebase if n.endswith("rebase") else None),
        {n: want_rebased if n.endswith("rebase") else want for n in names},
        flush)
    if not big:
        _rebase_case(tps, res, R, rebase, flush)


def _rebase_case(tps, res, R, rebase, flush):
    """`shard_rebase` on a shard's PoolResult (the int32 K5 case's): the
    wrapper bound once and the parent's, in turns, each split into events,
    host and card; bit for bit against the plain version."""
    from ..ops.search_pool import PoolResult

    def fresh():
        return PoolResult(*[None if t is None else t.clone() for t in res])

    want = tps._shard_rebase_plain(fresh(), *rebase)
    for name, fn in (("bound once", tps.shard_rebase),
                     ("the parent's wrapper",
                      lambda *a: _parent_rebase(tps, *a))):
        got = fn(fresh(), *rebase)
        same_bits((got.c_read, got.lane_read, got.next_read),
                  (want.c_read, want.lane_read, want.next_read),
                  f"shard_rebase {name}")
    # timed at base 0, where the rewrite leaves its result as it is
    a = fresh()
    wrappers = {"bound once": lambda: tps.shard_rebase(a, 0, R, 2 * R),
                "the parent's wrapper": lambda: _parent_rebase(
                    tps, a, 0, R, 2 * R)}
    C, L = res.c_read.shape[0], res.lane_read.shape[0]
    print(f"shard_rebase C={C} L={L}: bound "
          f"{(C + L) * 4 * 2 / 3.35e12 * 1e3:.6f} ms", flush=True)
    for name in in_turns(wrappers):
        _timed_wrapper(f"shard_rebase, {name}", wrappers[name], flush)


def main(argv=None) -> int:
    import numpy as np

    from . import card

    argv = list(sys.argv[1:] if argv is None else argv)
    resolve_device(None)
    _build.build_cuda()
    variants_only = "--variants-only" in argv
    variants = [a for a in argv if a != "--variants-only"]
    out_dir = os.path.join(_build.BUILD_DIR, "k45_time")
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for name in ("pack_result", "unpack_prep"):
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            texts[name] = f.read()
    k5_src = [(CHECKOUT, texts["pack_result"])]
    k4_src = [(CHECKOUT, texts["unpack_prep"])]
    for path, (name, text) in zip(variants, variant_sources(variants)):
        # a variant of an older form brings that revision's common.cuh
        header = os.path.join(os.path.dirname(path), "common.cuh")
        if os.path.exists(header):
            with open(header) as f:
                text = text.replace('#include "common.cuh"', f.read())
        (k5_src if "pack_result_kernel" in text else k4_src).append(
            (name, text))
    libs = build_variants([(f"k5_{n}", t) for n, t in k5_src]
                          + [(f"k4_{n}", t) for n, t in k4_src], out_dir,
                          "k45")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    for name, (_lib, log) in sorted(libs.items()):
        for entry, figs in cs.ptxas_entries(log):
            print(f"ptxas {name} {entry}: {figs}", flush=True)
    print(card(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)

    from .. import cli
    from ..ops import engine as eng
    from ..ops import search_pool2 as sp2

    args = cli.build_parser().parse_args(
        ["map", "-r", "x", "-g", "x", "-o", "x", *cs.MAP_FLAGS])
    params = cli.build_alignment_parameters(args)
    os.makedirs(cs.WORK, exist_ok=True)
    k4_cases, k5_cases = _inputs(np, cs, cli, params, args)

    def builds(kind, src, cls):
        out = {}
        for n, text in src:
            lib = libs[f"{kind}_{n}"][0]
            lib.text = text
            out[n] = cls(lib)
        return out

    k4 = builds("k4", k4_src, K4Build)
    k5 = builds("k5", k5_src, K5Build)
    for case in k4_cases:
        _k4_case(eng, cs, k4, [n for n in k4 if n != CHECKOUT or not
                           variants_only], flush, case)
    for case in k5_cases:
        _k5_case(eng, sp2, cs, k5, [n for n in k5 if n != CHECKOUT or not
                                variants_only], flush, case)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
