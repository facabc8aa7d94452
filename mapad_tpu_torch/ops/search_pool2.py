"""Persistent best-first pool search (kernel K2), chain extraction (K3)
and the store compaction between store generations (K8).

Counterpart of mapad_tpu/ops/search_pool2.py: the same pop order (max
monotone key, then minimum ring age = LIFO, then the first max candidate of
the block), the same f32 operation order, the same store slot numbering
(the block of step s is block S-1-s, its 9 candidates stored in reverse),
so `PoolResult` matches the JAX function field for field: backward-only or
bidirectional (center-start models), with one store generation or several.

Two entries, as in the JAX function: host-packed LUT/Bi-D rows (`slut`, the
small-genome default: Bi-D from the host C++), or the dense per-read inputs
(`dense`, the big-genome default), from which the Bi-D composite is
computed on the card first (kernel K7, ops/bi_d.py) and the rows
[score4 | code | Bi-D] are assembled there.  With a big (int64) index the
intervals, `best_size` and `c_lower` / `c_lrev` / `c_size` are int64; a
stored frame then carries three more words (the high halves).

Two implementations of each kernel live here:

- `_pool_loop_plain` (with its `boundary`) / `_extract_chains_plain`: plain
  PyTorch, a line by line transcription of the JAX loop body and of its
  generations loop.  The wrappers take them for CPU tensors only (the
  tests) and `chip_smoke.py` holds the kernels against them on the card.
- the CUDA kernels of csrc/pool_search.cu, csrc/extract_chains.cu and
  csrc/pool_compact.cu.

K2 (`pool_search`, replaces `k_mismatch_search_pool2` setup + `body`,
search_pool2.py:99-612): one cooperative launch runs every step of a store
generation (csrc/pool_search.cu).  A warp carries a lane (the pop's ring
scan over the ages of its read's steps, the popped block, K1 inline in the
two halves of the warp, the 9 candidates on its first nine lanes and the
running best a serial pass over them, the store write); the refill of
finished lanes sits behind one grid barrier a step, made of the blocks'
counts of finished lanes, tagged with the step, which every block reads
itself: so the read ids go out in lane order as in the JAX loop.
`pool_plan` places the lanes: lanes a block, blocks (all co-resident on
the card) and the home of the key rings (shared memory where they fit,
else global memory, the same kernel body).  The host makes
one launch and, where a store boundary may follow, one read of the
counters a generation.  Bound: the bytes that cross HBM, the inputs once
and 288 B of store block a lane a step (396 B with int64 intervals); in
practice a chain of dependent reads and a grid barrier a step, whose floor
P1 (csrc/probe_dma.cu) measures.

K3 (`extract_chains` + `fold_read_steps` + tail, search_pool2.py:617-737,
921-971): one cooperative launch a call (csrc/extract_chains.cu), its
blocks all co-resident (`extract_plan`), in three phases behind two grid
barriers: per-lane counts of completion/abandon entries from the 9-bit
block masks the step kernel writes; every block's own lane-order prefix
sum of them (giving the first C entries in ascending (lane, slot) order,
as JAX's top_k of negated keys does) and an in-order emit of the rounds
of masks that hold marks; then the walks, 1 to 32 chains a warp (their
fields, and MW-1 ancestors into `c_ops`), beside the per-read step fold
(an exact `atomicMax`) and the unused entries on the last warps.  The
host makes one allocation for the result and the scratch
(`_result_layout`) and fills a few fields of an argument block kept with
the loop state (`_Extraction`).  Bound: bytes --
the block masks and the finish log (4 B each per lane per executed step),
the frames walked and the result -- or the walk's latency: the deepest
chain's dependent loads.
With store generations K3 also runs at every boundary: it then scans only
the steps run since the last boundary, writes its chains behind the
earlier ones (offset min(chains so far, C), entries past C dropped) with
slots made global (minus 9 x the steps compacted away), and the step fold
accumulates.

K8 (`pool_compact`, replaces the `boundary` of the generations > 1 branch,
search_pool2.py:739-919): when the store is full (step == S) with at least
`min_live` lanes live and a generation left, the host runs K3 and then K8:
the blocks of the last CAP steps (every live frame lies there: a read is
abandoned after CAP pops) move up by delta = S - CAP blocks, every moved
frame's parent slot grows by 9 x delta (ROOT stays) and its completion /
abandon marks are cleared, the two pop rings rotate by delta mod RB into a
second pair of buffers, lane_start and the step counter drop by delta, and
the step limit of the next generation is set (capped spill).  The move is
in place: source and destination overlap when CAP > S/2, so it runs in
chunks of delta blocks from the top of the store down, one launch each
(one launch at the production shapes).  The masks K3 reads do not move:
K3 is told the first step it has not seen.  Bound: bytes, the window read
once and written once (2 x L x CAP x 288 B, 396 B with int64 intervals)
plus the rings.  The step loop learns of a boundary from the flags it polls
anyway: one host read per boundary.
"""

from __future__ import annotations

import copy
import ctypes
import functools
import time
from typing import NamedTuple

import torch

from .._build import (LAUNCHES, check, cuda_function, current_raw_stream,
                      require)
from .bi_d import compute_bi_d, compute_bi_d_plain
from .fm import DeviceFmIndex, extend_batch_plain
from .prep import _wire_opbits
from .search import (
    CANDS,
    F_GAPS,
    F_LOWER,
    F_LREV,
    F_OP,
    F_PARENT,
    F_SCOREBITS,
    F_SIZE,
    F_STARTLEN,
    GAP_CLOSED,
    GAP_DELETION,
    GAP_INSERTION,
    NF,
    OP_COMP_BIT,
    OP_DELETION,
    OP_INSERTION,
    OP_MATCH,
    OP_MISMATCH,
    OP_VALID_BIT,
    SearchParams,
    pack_op,
)
from .search_pool import OP_ABANDON_BIT, PoolConfig, PoolResult

OP_PUSHED_BIT = 1 << 23  # op word of a live (poppable) pushed frame
INT_MIN = -(2**31)


def _check_config(config: PoolConfig, R: int):
    S = config.total_steps
    require(config.lanes * (S * CANDS + 1) < 2**31,
            "store slot numbers exceed int32")
    require(config.max_len + 16 <= 1 << 15, "op positions exceed 15 bits")
    if config.generations > 1:
        # the JAX package asserts this in its generations loop
        if config.debug_fixed_steps:
            raise AssertionError("debug_fixed_steps is a gens=1 ablation knob")
        # a boundary frees S - CAP steps; without the margin it could free
        # none and the loop would stand still
        require(config.read_step_cap + 4 <= S,
                f"generations>1 needs read_step_cap + 4 <= total_steps "
                f"(got cap={config.read_step_cap}, steps={S})")


def _mono(f: torch.Tensor) -> torch.Tensor:
    u = f.view(torch.int32)
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def _mono_bits(u: torch.Tensor) -> torch.Tensor:
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def _mono_inv(k: torch.Tensor) -> torch.Tensor:
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _pool_loop_plain(index: DeviceFmIndex, n, split, cutoff_scale,
                     cutoff_thresh, repr_mm, params: SearchParams,
                     config: PoolConfig, slut, boundary_log=None):
    """Plain PyTorch K2 and K8: the lock-step pool loop and, with store
    generations, the loop over them (extraction, chain log and store compaction at
    every boundary).  Returns the loop state `_extract_chains_plain` reads.
    `boundary_log`: a list that receives the seconds of every compaction."""
    dev = n.device
    i32 = torch.int32
    # the store holds whole frames in the interval type: with a big index
    # the int32 fields ride sign-extended in int64 words (the layout of the
    # store is free; PoolResult is what matches)
    idt = index.idx_dtype
    R = n.shape[0]
    M = config.max_len
    L = config.lanes
    S = config.total_steps
    ROOT = S * CANDS
    CAP = config.read_step_cap
    RB = min(S, CAP + 1)
    bidir = not config.backward_only
    lanes = torch.arange(L, device=dev)
    cand_iota = torch.arange(CANDS, dtype=i32, device=dev)[None, :]
    slot_iota = torch.arange(RB, dtype=i32, device=dev)[None, :]
    NEG_INF = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    pgo_pge = params.pgo_pge.to(dev)
    pge = params.pge.to(dev)
    gde = params.gap_dist_ends.to(dev)
    max_gaps = params.max_gaps.to(dev)

    consts = torch.stack(
        [n.to(i32), split.to(i32), cutoff_scale.view(i32),
         cutoff_thresh.view(i32), repr_mm.view(i32)], dim=1,
    )
    consts_pad = torch.cat([consts, torch.zeros((L, 5), dtype=i32,
                                                device=dev)])

    consumed = torch.zeros((L, RB), dtype=i32, device=dev)
    bm_key = torch.full((L, RB), INT_MIN, dtype=i32, device=dev)
    lane_start = torch.zeros(L, dtype=i32, device=dev)
    # block b holds slots b*9..b*9+8; block S is the all-zero ROOT block
    store = torch.zeros((L, S + 1, CANDS, NF), dtype=idt, device=dev)

    read_id = torch.where(lanes < R, lanes, R).to(i32)
    fresh = read_id < R
    next_read = min(L, R)
    lane_done = read_id >= R
    lane_age = torch.zeros(L, dtype=i32, device=dev)
    row0 = consts[torch.clamp(read_id, 0, R - 1).long()]
    c_n, c_split = row0[:, 0], row0[:, 1]
    c_scale = row0[:, 2].view(torch.float32)
    c_thresh = row0[:, 3].view(torch.float32)
    c_repr = row0[:, 4].view(torch.float32)
    best_score = torch.full((L,), float("-inf"), dtype=torch.float32,
                            device=dev)
    best_size = torch.zeros(L, dtype=idt, device=dev)
    hcount = torch.zeros(L, dtype=i32, device=dev)
    fin_log = torch.full((L, S if config.track_read_steps else 1), -1,
                         dtype=i32, device=dev)
    step = 0

    def reject(v):
        return (v / c_scale) < c_thresh

    def gaps_word(gb, gf, ng):
        return gb | (gf << 2) | (ng << 4)

    def body():
        """One step of every lane (`body` of the JAX package)."""
        nonlocal consumed, bm_key, lane_start, read_id, fresh, lane_done
        nonlocal next_read, lane_age, c_n, c_split, c_scale, c_thresh
        nonlocal c_repr, best_score, best_size, hcount, step
        active = ~lane_done
        # --- pop: dense ring scan (key max, then LIFO = min ring age) ---
        age = torch.remainder(step - 1 - slot_iota, RB)
        t_s = step - 1 - age
        keym = torch.where(
            (t_s >= lane_start[:, None]) & (bm_key > INT_MIN), bm_key,
            INT_MIN,
        )
        kstar = keym.max(dim=1).values
        popped = kstar > INT_MIN
        agem = torch.where(keym == kstar[:, None], age, RB)
        astar = agem.min(dim=1).values
        pstep = step - 1 - astar
        sel_slot = torch.remainder(pstep, RB)
        sel_col = slot_iota == sel_slot[:, None]
        cword = consumed.gather(1, sel_slot[:, None].long())[:, 0]

        finish_empty = active & ~fresh & ~popped
        working = active & (fresh | popped)
        do_pop = working & ~fresh

        # --- the popped block's 9 stored candidates ---
        blk_full = torch.clamp(S - 1 - pstep, 0, S - 1)
        rows9 = store[lanes, blk_full.long()]  # (L, 9, NF)
        op9s = rows9[:, :, F_OP].to(i32)
        live9 = ((op9s & OP_PUSHED_BIT) != 0) & (
            ((cword[:, None] >> cand_iota) & 1) == 0
        )
        key9 = torch.where(live9,
                           _mono_bits(rows9[:, :, F_SCOREBITS].to(i32)),
                           INT_MIN)
        off = torch.argmax(key9, dim=1).to(i32)  # first max
        f_mono = key9.max(dim=1).values
        sel = blk_full * CANDS + off

        newbit = torch.where(do_pop, 1 << off, 0)
        cword2 = cword | newbit
        live9b = live9 & (cand_iota != off[:, None])
        newkey = torch.where(live9b, key9, INT_MIN).max(dim=1).values
        updm = sel_col & do_pop[:, None]
        consumed = torch.where(updm, cword2[:, None], consumed)
        bm_key = torch.where(updm, newkey[:, None], bm_key)

        frame = rows9[lanes, off.long()]  # (L, NF)
        f_score = torch.where(fresh, torch.zeros_like(best_score),
                              _mono_inv(f_mono))
        zero = torch.zeros_like(read_id)
        zero_i = torch.zeros(L, dtype=idt, device=dev)
        f_lower = torch.where(fresh, zero_i, frame[:, F_LOWER])
        f_lrev = torch.where(fresh, zero_i, frame[:, F_LREV])
        f_size = torch.where(fresh, zero_i + index.text_len,
                             frame[:, F_SIZE])
        startlen = frame[:, F_STARTLEN].to(i32)
        f_start = torch.where(fresh, c_split, startlen >> 16)
        f_len = torch.where(fresh, zero, startlen & 0xFFFF)
        gaps = torch.where(fresh, zero, frame[:, F_GAPS].to(i32))
        parent = torch.where(fresh, zero + ROOT, sel)
        f_gapb = gaps & 3
        f_gapf = (gaps >> 2) & 3
        f_ngaps = (gaps >> 4) & 0xFF
        fresh = torch.zeros_like(fresh)

        nn = c_n
        if bidir:
            # the side with the shorter remainder is extended next
            fwd = f_start <= nn - f_start - f_len
            j = torch.where(fwd, f_start + f_len, f_start - 1)
            d_k = torch.where(fwd, f_start, f_start - 1)
            d_l = torch.where(fwd, f_start + f_len, f_start + f_len - 1)
            ext_lower = torch.where(fwd, f_lrev, f_lower)
            ext_lrev = torch.where(fwd, f_lower, f_lrev)
            gap_state = torch.where(fwd, f_gapf, f_gapb)

            def pick(fv, bv):
                return torch.where(fwd, fv, bv)
        else:
            j = f_start - 1
            d_k = f_start - 1
            ext_lower, ext_lrev = f_lower, f_lrev
            gap_state = f_gapb

            def pick(fv, bv):
                return bv

        ins_score = torch.where(gap_state == GAP_INSERTION, pge,
                                pgo_pge) + f_score
        del_score = torch.where(gap_state == GAP_DELETION, pge,
                                pgo_pge) + f_score
        ngaps_inc = torch.where(gap_state == GAP_CLOSED, f_ngaps + 1,
                                f_ngaps)

        rid_c = torch.clamp(read_id, 0, R - 1)
        j_c = torch.clamp(j, 0, M - 1)
        base = rid_c * M
        row_j = slut[(base + j_c).long()]  # (L, 6)
        no_bound = torch.zeros_like(f_score)
        if bidir:
            bk = torch.clamp(d_k, 0, M - 1)
            t = nn - (1 + d_l)
            ci = torch.clamp(t + c_split, 0, M - 1)
            d_rev = torch.where((d_k >= 0) & (d_k < nn),
                                slut[(base + bk).long(), 5], no_bound)
            d_fwd = torch.where((t >= 0) & (t + c_split < nn),
                                slut[(base + ci).long(), 5], no_bound)
            lb = d_rev + d_fwd
        else:
            # bk == j_c, and split == n makes the forward bound 0
            d_rev = torch.where((d_k >= 0) & (d_k < nn), row_j[:, 5],
                                no_bound)
            lb = d_rev + 0.0
        Sj = row_j[:, :4]
        pat_j = row_j[:, 4].to(i32)

        stop = (f_score + lb) < best_score + c_repr
        abandon = working & (lane_age >= CAP)
        finish_stop = working & stop & ~abandon
        still = working & ~stop & ~abandon

        ch_lower, ch_lrev, ch_size = extend_batch_plain(
            index, ext_lower, ext_lrev, f_size
        )
        if bidir:
            out_lower = torch.where(fwd[:, None], ch_lrev, ch_lower)
            out_lrev = torch.where(fwd[:, None], ch_lower, ch_lrev)
        else:
            out_lower, out_lrev = ch_lower, ch_lrev
        ins_allowed = torch.minimum(j, nn - j - 1) >= gde
        d5 = pick(j, j + 1)
        del_allowed = torch.minimum(d5, nn - d5) >= gde
        next_start = pick(f_start, f_start - 1)
        del_rej = reject(del_score + lb)
        ins_rej = reject(ins_score + lb)

        def full(v):
            return torch.as_tensor(v, dtype=i32, device=dev).expand(L)

        c_ok = [still & ~ins_rej & ins_allowed & (ngaps_inc <= max_gaps)]
        c_score = [ins_score]
        cl_lower, cl_lrev, cl_size = [f_lower], [f_lrev], [f_size]
        c_startlen = [(next_start << 16) | (f_len + 1)]
        c_gaps = [gaps_word(pick(f_gapb, GAP_INSERTION),
                            pick(GAP_INSERTION, f_gapf), ngaps_inc)]
        c_op = [full(pack_op(OP_INSERTION, j_c, 0))]
        for slot in range(4):
            s_size = ch_size[:, slot]
            nonzero = s_size >= 1
            if bidir:
                code = torch.where(fwd, slot, 3 - slot).to(i32)
                # the JAX package sums a one-hot select of Sj; a score is
                # never -0.0 (sums starting at +0.0), so the gather agrees
                sj_c = Sj.gather(1, code[:, None].long())[:, 0]
            else:
                code = 3 - slot
                sj_c = Sj[:, code]
            mm_score = sj_c + f_score
            c_ok.append(still & nonzero & ~del_rej & del_allowed
                        & (ngaps_inc <= max_gaps))
            c_score.append(del_score)
            cl_lower.append(out_lower[:, slot])
            cl_lrev.append(out_lrev[:, slot])
            cl_size.append(s_size)
            c_startlen.append((f_start << 16) | f_len)
            c_gaps.append(gaps_word(pick(f_gapb, GAP_DELETION),
                                    pick(GAP_DELETION, f_gapf), ngaps_inc))
            c_op.append(full(pack_op(OP_DELETION, j_c, code)))

            c_ok.append(still & nonzero & ~reject(mm_score + lb))
            c_score.append(mm_score)
            cl_lower.append(out_lower[:, slot])
            cl_lrev.append(out_lrev[:, slot])
            cl_size.append(s_size)
            c_startlen.append((next_start << 16) | (f_len + 1))
            c_gaps.append(gaps_word(pick(f_gapb, GAP_CLOSED),
                                    pick(GAP_CLOSED, f_gapf), f_ngaps))
            kind = torch.where(pat_j == code, OP_MATCH, OP_MISMATCH)
            c_op.append(full(pack_op(kind, j_c, code)))

        score9 = torch.stack(c_score, dim=1)
        size9 = torch.stack(cl_size, dim=1)
        startlen9 = torch.stack(c_startlen, dim=1)
        len9 = startlen9 & 0xFFFF
        ok_cols, comp_cols = [], []
        run_best, run_size = best_score, best_size
        for k in range(CANDS):
            ok_k = c_ok[k] & ~(score9[:, k] < run_best + c_repr)
            comp_k = ok_k & (len9[:, k] == nn)
            upd = comp_k & (score9[:, k] > run_best)
            run_size = torch.where(upd, size9[:, k], run_size)
            run_best = torch.where(upd, score9[:, k], run_best)
            ok_cols.append(ok_k)
            comp_cols.append(comp_k)
        best_score, best_size = run_best, run_size
        ok9 = torch.stack(ok_cols, dim=1)
        comp9 = torch.stack(comp_cols, dim=1)
        push9 = ok9 & ~comp9

        op9 = (torch.stack(c_op, dim=1)
               | torch.where(comp9, OP_COMP_BIT, 0)
               | torch.where(push9, OP_PUSHED_BIT, 0)).to(i32)
        op9[:, 0] = torch.where(abandon, OP_VALID_BIT | OP_ABANDON_BIT,
                                op9[:, 0])
        record9 = comp9.clone()
        record9[:, 0] |= abandon
        gaps9 = torch.stack(c_gaps, dim=1)
        gaps9 = torch.where(record9, read_id[:, None], gaps9)
        pack9 = torch.stack(
            [f.to(idt) for f in (
                torch.stack(cl_lower, 1), torch.stack(cl_lrev, 1), size9,
                parent[:, None].expand(L, CANDS), startlen9, gaps9, op9,
                score9.view(i32))],
            dim=2,
        )
        store[:, S - 1 - step] = pack9.flip(1)
        mono9 = torch.where(push9, _mono(score9), INT_MIN).flip(1)
        ring_slot = step % RB
        bm_key[:, ring_slot] = mono9.max(dim=1).values
        consumed[:, ring_slot] = 0

        hcount = hcount + comp9.sum(dim=1, dtype=i32)
        finish_hits = still & ((hcount > 9) | (best_size > 1))

        # --- refill finished lanes from the pool, in lane order ---
        finish = finish_empty | finish_stop | finish_hits | abandon
        fi = finish.to(i32)
        rank = torch.cumsum(fi, 0, dtype=i32) - fi
        new_rid = next_read + rank
        act = active.to(i32)
        if config.track_read_steps:
            fin_log[:, step] = torch.where(
                finish,
                torch.clamp(read_id, 0, R) * 4096
                + torch.clamp(lane_age + act, max=4095),
                -1,
            )
        read_id = torch.where(finish, torch.clamp(new_rid, max=R), read_id)
        win = consts_pad[next_read : next_read + L]
        next_read = min(next_read + int(fi.sum()), R)
        fresh = finish & (new_rid < R)
        lane_done = lane_done | (finish & (new_rid >= R))
        lane_start = torch.where(finish, step + 1, lane_start).to(i32)
        lane_age = torch.where(finish, 0, lane_age + act).to(i32)
        best_score = torch.where(finish, NEG_INF, best_score)
        best_size = torch.where(finish, 0, best_size).to(idt)
        hcount = torch.where(finish, 0, hcount).to(i32)
        nc = win[rank.long()]
        c_n = torch.where(finish, nc[:, 0], c_n)
        c_split = torch.where(finish, nc[:, 1], c_split)
        c_scale = torch.where(finish, nc[:, 2].view(torch.float32), c_scale)
        c_thresh = torch.where(finish, nc[:, 3].view(torch.float32),
                               c_thresh)
        c_repr = torch.where(finish, nc[:, 4].view(torch.float32), c_repr)
        step += 1

    # --- the generations loop (search_pool2.py:739-919 of the JAX
    # package; with one generation the loop below runs once) ---
    GENS = max(1, int(config.generations))
    MIN_LIVE = max(1, int(config.min_live))
    SPILL = max(0, int(config.spill_steps))
    delta = S - CAP  # every live frame is at most CAP steps old
    acc = _ChainLog(config, idt, dev)
    acc_rs = torch.full((R + 1,), -1, dtype=i32, device=dev)
    cum_shift = 0
    # debug_fixed_steps: exactly that many steps (at most S), done or not
    fixed = int(config.debug_fixed_steps)
    gen_limit = min(S, fixed) if fixed else S

    def boundary():
        """Plain PyTorch K8 (after the extraction): move the window of the
        last CAP steps to the top of the store, remap parents, clear the
        marks, rotate the rings, roll the step counters back."""
        nonlocal store, consumed, bm_key, lane_start, step
        shifted = torch.zeros_like(store)
        shifted[:, delta:S] = store[:, : S - delta]
        ops_f = shifted[..., F_OP]
        par_f = shifted[..., F_PARENT]
        shifted[..., F_PARENT] = torch.where(
            ((ops_f & OP_VALID_BIT) != 0) & (par_f != ROOT),
            par_f + CANDS * delta, par_f,
        )
        shifted[..., F_OP] = ops_f & ~(OP_COMP_BIT | OP_ABANDON_BIT)
        store = shifted
        # ring slot s holds step t with t = s (mod RB); steps drop by delta
        consumed = torch.roll(consumed, -(delta % RB), dims=1)
        bm_key = torch.roll(bm_key, -(delta % RB), dims=1)
        lane_start = torch.clamp(lane_start - delta, min=0)
        step -= delta

    gen = 0
    while gen == 0 or (gen < GENS and step < gen_limit
                       and not bool(lane_done.all())):
        while step < gen_limit and (fixed or not bool(lane_done.all())):
            body()
        live = int((~lane_done).sum())
        if step >= S and live >= MIN_LIVE and gen + 1 < GENS:
            acc.append(*_extract_plain(store, config, cum_shift * CANDS))
            if config.track_read_steps:
                _fold_read_steps(fin_log, acc_rs, R)
                fin_log.fill_(-1)
            # capped spill: this generation runs at most SPILL more steps
            gen_limit = min(S, step - delta + SPILL) if SPILL else S
            timing = boundary_log is not None and dev.type == "cuda"
            if timing:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            boundary()
            if timing:
                torch.cuda.synchronize(dev)
            if boundary_log is not None:
                boundary_log.append(time.perf_counter() - t0)
            cum_shift += delta
        gen += 1

    lane_unfinished = ~lane_done & (read_id < R)
    return (store, fin_log, read_id, lane_unfinished, lane_age, next_read,
            step, R, cum_shift, acc, acc_rs)


def _extract_plain(store, config, slot_shift=0):
    """Plain PyTorch extraction of one store: the first C completion /
    abandon entries in ascending (lane, slot) order, their fields and
    ancestor walks (`extract_chains` of the JAX package).  `slot_shift`
    (9 x the steps compacted away so far) makes the slots global, so a
    read's hits keep their completion order over a store boundary.
    Returns (n_ext, n_chains, fields) with every field C long."""
    dev = store.device
    i32 = torch.int32
    S = config.total_steps
    C = config.max_chains
    MW = config.max_len + 16
    ROOT = S * CANDS
    mark = (store[..., F_OP] & (OP_COMP_BIT | OP_ABANDON_BIT)) != 0
    n_chains = mark.sum(dtype=i32)
    idx = mark.nonzero()  # row-major: ascending (lane, block, candidate)
    k = min(idx.shape[0], C)
    # unused entries point at candidate 0 of the first marked block (what
    # JAX's top_k padding selects), or (lane 0, slot 0) when none is marked
    if idx.shape[0]:
        lane0, blk0 = int(idx[0, 0]), int(idx[0, 1])
    else:
        lane0, blk0 = 0, 0
    c_lane = torch.full((C,), lane0, dtype=torch.long, device=dev)
    c_slot = torch.full((C,), blk0 * CANDS, dtype=torch.long, device=dev)
    c_lane[:k] = idx[:k, 0]
    c_slot[:k] = idx[:k, 1] * CANDS + idx[:k, 2]
    valid = torch.arange(C, device=dev) < k
    rows_c = store[c_lane, c_slot // CANDS, c_slot % CANDS]  # (C, NF)
    e_op = rows_c[:, F_OP].to(i32)
    c_abandon = ((e_op & OP_ABANDON_BIT) != 0) & valid
    c_read = torch.where(valid, rows_c[:, F_GAPS], -1).to(i32)
    walk_valid = valid & ~c_abandon
    node = torch.where(walk_valid, rows_c[:, F_PARENT], ROOT).long()
    words = [torch.where(walk_valid, e_op, 0).to(i32)]
    for _ in range(MW - 1):
        at_root = node == ROOT
        r = store[c_lane, node // CANDS, node % CANDS]
        words.append(torch.where(at_root, 0, r[:, F_OP]).to(i32))
        node = torch.where(at_root, ROOT, r[:, F_PARENT].long())
    fields = dict(
        read=c_read, slot=(c_slot - slot_shift).to(i32), ab=c_abandon,
        lower=rows_c[:, F_LOWER].contiguous(),
        lrev=rows_c[:, F_LREV].contiguous(),
        size=rows_c[:, F_SIZE].contiguous(),
        score=rows_c[:, F_SCOREBITS].to(i32).contiguous().view(
            torch.float32),
        ops=torch.stack(words, dim=1),
    )
    return k, n_chains, fields


def _fold_read_steps(fin_log, acc_rs, R):
    """Max-reduce the finish log's (read, steps) events into the (R+1,)
    per-read step accumulator (`fold_read_steps` of the JAX package)."""
    ev = fin_log.reshape(-1)
    rid = torch.where(ev >= 0, torch.div(ev, 4096, rounding_mode="floor"),
                      R).long()
    acc_rs.scatter_reduce_(0, rid, torch.remainder(ev, 4096), "amax")


class _ChainLog:
    """The chain accumulator of the generations loop (`acc0` /
    `append_acc` of the JAX package): a 2C window, every extraction written
    whole at offset min(chains so far, C), the result its first C entries.
    With one generation it holds the one extraction."""

    def __init__(self, config, idt, dev):
        C2 = 2 * config.max_chains
        MW = config.max_len + 16
        i32 = torch.int32
        self.C = config.max_chains
        self.n = 0
        self.nch = torch.zeros((), dtype=i32, device=dev)
        self.f = dict(
            read=torch.full((C2,), -1, dtype=i32, device=dev),
            slot=torch.zeros(C2, dtype=i32, device=dev),
            ab=torch.zeros(C2, dtype=torch.bool, device=dev),
            lower=torch.zeros(C2, dtype=idt, device=dev),
            lrev=torch.zeros(C2, dtype=idt, device=dev),
            size=torch.zeros(C2, dtype=idt, device=dev),
            score=torch.zeros(C2, dtype=torch.float32, device=dev),
            ops=torch.zeros((C2, MW), dtype=i32, device=dev),
        )

    def append(self, n_ext, n_chains, fields):
        wr = min(self.n, self.C)
        for name, val in fields.items():
            self.f[name][wr : wr + self.C] = val
        self.n += n_ext
        self.nch = self.nch + n_chains

    def clone(self):
        other = copy.copy(self)
        other.f = {name: val.clone() for name, val in self.f.items()}
        return other


def _extract_chains_plain(store, fin_log, read_id, lane_unfinished,
                          lane_age, next_read, steps, R, cum_shift, acc,
                          acc_rs, config):
    """Plain PyTorch K3 after the loop: the last extraction appended to the
    chain log, the per-read step fold and the PoolResult tail."""
    dev = store.device
    i32 = torch.int32
    C = config.max_chains
    # the loop state stays as it is: the extraction can be repeated
    acc, acc_rs = acc.clone(), acc_rs.clone()
    acc.append(*_extract_plain(store, config, cum_shift * CANDS))
    if config.track_read_steps:
        _fold_read_steps(fin_log, acc_rs, R)
        # unfinished lanes report the steps their held read consumed so far
        ur = torch.where(lane_unfinished, torch.clamp(read_id, 0, R),
                         R).long()
        acc_rs.scatter_reduce_(0, ur, lane_age, "amax")
        read_steps = acc_rs[:R]
    else:
        read_steps = torch.full((R,), -1, dtype=i32, device=dev)
    f = acc.f
    return PoolResult(
        c_read=f["read"][:C], c_slot=f["slot"][:C], c_abandon=f["ab"][:C],
        c_lower=f["lower"][:C], c_lrev=f["lrev"][:C], c_size=f["size"][:C],
        c_score=f["score"][:C], c_ops=f["ops"][:C], n_chains=acc.nch,
        lane_read=read_id.to(i32), lane_unfinished=lane_unfinished,
        next_read=torch.tensor(next_read, dtype=i32, device=dev),
        # every step run, over all generations
        steps=torch.tensor(steps + cum_shift, dtype=i32, device=dev),
        read_steps=read_steps,
    )


# --- CUDA path ---------------------------------------------------------

# lane-state rows of the (N_LANE_STATE, L) int32 state tensor; the order
# is shared with csrc/common.cuh
N_LANE_STATE = 16
NFP_BIG = NF + 3  # words of a stored frame with int64 intervals
# glob[]: the device-side loop counters (enum Glob of csrc/common.cuh)
G_STEP, G_NEXT_READ, G_DONE, G_LIMIT, G_LIVE = 0, 1, 2, 3, 4
G_BASE, G_CUM, G_ACC_N, G_ACC_NCH = 5, 6, 7, 8
N_GLOB = 12


class _PoolArgs(ctypes.Structure):
    """Mirror of `struct PoolArgs` in csrc/common.cuh."""

    _fields_ = [
        ("rows", ctypes.c_void_p), ("less", ctypes.c_void_p),
        ("sent", ctypes.c_void_p), ("nb", ctypes.c_int),
        ("occ_k", ctypes.c_int), ("big", ctypes.c_int),
        ("text_len", ctypes.c_longlong),
        ("slut", ctypes.c_void_p), ("n", ctypes.c_void_p),
        ("split", ctypes.c_void_p), ("scale", ctypes.c_void_p),
        ("thresh", ctypes.c_void_p), ("repr", ctypes.c_void_p),
        ("R", ctypes.c_int), ("M", ctypes.c_int), ("L", ctypes.c_int),
        ("S", ctypes.c_int), ("CAP", ctypes.c_int), ("RB", ctypes.c_int),
        ("track", ctypes.c_int), ("pgo_pge", ctypes.c_float),
        ("pge", ctypes.c_float), ("gap_dist_ends", ctypes.c_int),
        ("max_gaps", ctypes.c_int),
        ("store", ctypes.c_void_p), ("bmask", ctypes.c_void_p),
        ("consumed", ctypes.c_void_p), ("bm_key", ctypes.c_void_p),
        ("lane", ctypes.c_void_p), ("glob", ctypes.c_void_p),
        ("fin_log", ctypes.c_void_p),
        ("bidir", ctypes.c_int), ("fixed", ctypes.c_int),
    ]


class _CompactArgs(ctypes.Structure):
    """Mirror of `struct CompactArgs` in csrc/common.cuh."""

    _fields_ = [
        ("store", ctypes.c_void_p),
        ("consumed", ctypes.c_void_p), ("bm_key", ctypes.c_void_p),
        ("consumed_next", ctypes.c_void_p), ("bm_key_next", ctypes.c_void_p),
        ("lane", ctypes.c_void_p), ("glob", ctypes.c_void_p),
        ("L", ctypes.c_int), ("S", ctypes.c_int), ("CAP", ctypes.c_int),
        ("RB", ctypes.c_int), ("spill", ctypes.c_int), ("big", ctypes.c_int),
    ]


# the result and scratch pointers of `struct ExtractArgs`, in its order
_EXT_PTRS = ("lane_cnt", "lane_first", "c_lane", "e_slot", "round_cnt",
             "c_read", "c_slot", "c_abandon", "c_lower", "c_lrev", "c_size",
             "c_score", "c_ops", "n_chains", "lane_read", "lane_unfinished",
             "next_read", "steps", "read_steps")


class _ExtractArgs(ctypes.Structure):
    """Mirror of `struct ExtractArgs` in csrc/common.cuh."""

    _fields_ = [
        ("store", ctypes.c_void_p), ("bmask", ctypes.c_void_p),
        ("lane", ctypes.c_void_p), ("glob", ctypes.c_void_p),
        ("fin_log", ctypes.c_void_p),
        ("R", ctypes.c_int), ("L", ctypes.c_int), ("S", ctypes.c_int),
        ("C", ctypes.c_int), ("MW", ctypes.c_int), ("track", ctypes.c_int),
        ("big", ctypes.c_int), ("first", ctypes.c_int),
        ("final", ctypes.c_int), ("flags", ctypes.c_void_p),
    ] + [(name, ctypes.c_void_p) for name in _EXT_PTRS]


# the launch plan of K2 (csrc/pool_search.cu): a warp a lane
WARP = 32
MAX_LANES_PER_BLOCK = 16  # csrc/pool_search.cu MAX_LANES_PER_BLOCK
STAGE_BYTES = 2 * CANDS * NFP_BIG * 4  # a lane's staged blocks (STAGE_WORDS)


class PoolPlan(NamedTuple):
    """Where K2's lanes run: `lanes_per_block` warps a block, `blocks`
    blocks (all co-resident), the key rings in shared memory or not, and
    the dynamic shared memory of a block (the rings, if there, and each
    lane's staged blocks).  Mirrors `struct PoolPlan` in
    csrc/pool_search.cu."""

    lanes_per_block: int
    blocks: int
    ring_shared: bool
    smem: int


def pool_plan(L: int, RB: int, sms: int, smem_block: int, smem_sm: int,
              blocks_per_sm, static_smem: int = 0,
              reserved_smem: int = 0) -> PoolPlan:
    """K2's launch plan for L lanes with key rings of RB slots, on a card
    of `sms` SMs whose block may opt into `smem_block` bytes of shared
    memory and whose SM holds `smem_sm`.  `blocks_per_sm(threads, smem)`:
    the blocks of that shape one SM holds at once (the occupancy query,
    with the kernel's registers); `static_smem`: the kernel's own shared
    memory, `reserved_smem`: the runtime's reserve a block.

    The lanes spread over the SMs, one block each: ceil(L / sms) lanes a
    block.  The rings go into shared memory where a block's rings, its
    staging and the rest fit a block and an SM and the card then still
    holds every block at once; else they stay in global memory.  Raises
    where no grid of the card holds every lane at once."""
    require(1 <= L <= 1024, "the pool search runs 1 to 1024 lanes")
    lpb = -(-L // sms)
    require(lpb <= MAX_LANES_PER_BLOCK,
            f"{L} lanes need more than {MAX_LANES_PER_BLOCK} warps a block "
            f"on {sms} SMs")
    blocks = -(-L // lpb)
    threads = WARP * lpb
    stage = lpb * STAGE_BYTES
    ring = lpb * RB * 4
    shared = (stage + ring + static_smem <= smem_block
              and stage + ring + static_smem + reserved_smem <= smem_sm)
    if shared and blocks > blocks_per_sm(threads, stage + ring) * sms:
        shared = False
    smem = stage + (ring if shared else 0)
    require(blocks <= blocks_per_sm(threads, smem) * sms,
            f"the card cannot hold {blocks} blocks of {threads} threads and "
            f"{smem} B of shared memory at once")
    return PoolPlan(lpb, blocks, shared, smem)


class _PoolPlanC(ctypes.Structure):
    """Mirror of `struct PoolPlan` in csrc/pool_search.cu."""

    _fields_ = [("lanes_per_block", ctypes.c_int), ("blocks", ctypes.c_int),
                ("ring_shared", ctypes.c_int), ("smem", ctypes.c_int)]


def card_plan(dev: torch.device, L: int, RB: int, big: bool,
              bidir: bool) -> PoolPlan:
    """`pool_plan` with the figures of the card `dev` and of the kernel
    form that runs (a few queries of the runtime, no launch)."""
    card = cuda_function("pool_search", "pool_card",
                         [ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)])
    occupancy = cuda_function("pool_search", "pool_occupancy",
                              [ctypes.c_int] * 4
                              + [ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(dev):
        fig = (ctypes.c_int * 5)()
        check(card(int(big), int(bidir), fig), "pool_card")
        sms, smem_block, smem_sm, static, reserved = list(fig)

        def blocks_per_sm(threads, smem):
            out = ctypes.c_int(0)
            check(occupancy(int(big), int(bidir), threads, smem,
                            ctypes.byref(out)), "pool_occupancy")
            return out.value

        return pool_plan(L, RB, sms, smem_block, smem_sm, blocks_per_sm,
                         static, reserved)


def _pool_loop_cuda(index: DeviceFmIndex, n, split, cutoff_scale,
                    cutoff_thresh, repr_mm, params: SearchParams,
                    config: PoolConfig, slut, boundary_log=None):
    """K2 and K8 wrapper: one launch of the persistent step kernel a store
    generation; with store generations, run K3 and K8 at every boundary
    and go on.  Returns the loop state `_extract_chains_cuda` reads:
    (store, bmask, lane, glob, fin_log, R, big, its `_Extraction`).
    `boundary_log`: a list that receives a (start, end) pair of CUDA events
    around every K8 call."""
    dev = n.device
    i32 = torch.int32
    R = n.shape[0]
    M = config.max_len
    L = config.lanes
    S = config.total_steps
    RB = min(S, config.read_step_cap + 1)
    GENS = max(1, int(config.generations))
    MIN_LIVE = max(1, int(config.min_live))
    big = bool(index.big)
    bidir = not config.backward_only
    rec = CANDS * (NFP_BIG if big else NF)
    require(R >= 1 and slut.shape == (R * M, 6), "pool search shapes")
    for t, dt in ((n, i32), (split, i32), (cutoff_scale, torch.float32),
                  (cutoff_thresh, torch.float32), (repr_mm, torch.float32),
                  (slut, torch.float32), (index.rows, i32),
                  (index.less, index.idx_dtype),
                  (index.sentinels, index.idx_dtype)):
        require(t.is_cuda and t.dtype == dt and t.is_contiguous(),
                "the pool search takes contiguous CUDA tensors")
    require(all(t.shape == (R,) for t in (split, cutoff_scale,
                                          cutoff_thresh, repr_mm)),
            "per-read consts must be (R,)")
    track = bool(config.track_read_steps)
    # the barrier's step tags, (steps so far + 1) << 5
    require(S * GENS < 1 << 26, "too many pool steps for the step tags")
    plan = _PoolPlanC(*card_plan(dev, L, RB, big, bidir))

    def empty(*shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device=dev)

    store = empty(L, S + 1, rec)
    bmask = empty(L, S)
    # with generations a second pair of rings: K8 rotates into it
    rings = [(empty(L, RB), empty(L, RB)) for _ in range(2 if GENS > 1 else 1)]
    lane = empty(N_LANE_STATE, L)
    glob = empty(N_GLOB)
    fin_log = empty(L, S) if track else None
    # each block's tagged count of finished lanes, by step parity, then
    # K3's barrier slots (zeroed: no tag is 0)
    k2_flags = 2 * (-(-L // 4) * 4)
    flags = torch.zeros(k2_flags + EXT_FLAGS, dtype=i32, device=dev)
    args = _PoolArgs(
        index.rows.data_ptr(), index.less.data_ptr(),
        index.sentinels.data_ptr(), index.rows.shape[0], index.occ_k,
        int(big), index.text_len, slut.data_ptr(), n.data_ptr(),
        split.data_ptr(),
        cutoff_scale.data_ptr(), cutoff_thresh.data_ptr(),
        repr_mm.data_ptr(), R, M, L, S, config.read_step_cap, RB,
        int(track), float(params.pgo_pge), float(params.pge),
        int(params.gap_dist_ends), int(params.max_gaps),
        store.data_ptr(), bmask.data_ptr(), rings[0][0].data_ptr(),
        rings[0][1].data_ptr(), lane.data_ptr(), glob.data_ptr(),
        fin_log.data_ptr() if track else None,
        int(bidir), int(config.debug_fixed_steps),
    )
    stream = torch.cuda.current_stream(dev)
    P = ctypes.POINTER(_PoolArgs)
    pool_init = cuda_function("pool_search", "pool_init",
                              [P, ctypes.c_void_p])
    pool_run = cuda_function("pool_search", "pool_run",
                             [P, ctypes.POINTER(_PoolPlanC), ctypes.c_void_p,
                              ctypes.c_void_p])
    sfx = "_i64" if big else ""
    name = "pool_search" + ("_bidir" if bidir else "") + sfx
    k1_name = "extend_batch" + sfx
    LAUNCHES.add(name)
    check(pool_init(ctypes.byref(args), stream.cuda_stream), "pool_init")

    def run_generation():
        """One launch runs the generation's steps until the step limit or
        the done flag; K1 runs inline in it."""
        LAUNCHES.add(name)
        LAUNCHES.add(k1_name)
        check(pool_run(ctypes.byref(args), ctypes.byref(plan),
                       flags.data_ptr(), stream.cuda_stream), name)

    ext = _Extraction(store, bmask, lane, glob, fin_log, R, big, config,
                      flags[k2_flags:])
    state = (store, bmask, lane, glob, fin_log, R, big, ext)
    while True:
        run_generation()
        boundaries = ext.boundaries
        if boundaries + 1 >= GENS:
            break
        # the spill test of the JAX package's outer loop: a full store,
        # enough lanes still live, a generation left
        g = glob.tolist()
        if not (g[G_STEP] >= S and not g[G_DONE] and g[G_LIVE] >= MIN_LIVE):
            break
        _extract_chains_cuda(*state, config, final=False)
        k8 = "pool_compact" + sfx
        compact = cuda_function(
            "pool_compact", "pool_compact",
            [ctypes.POINTER(_CompactArgs), ctypes.POINTER(ctypes.c_int),
             ctypes.c_void_p])
        cur, nxt = rings[boundaries % 2], rings[(boundaries + 1) % 2]
        c_args = _CompactArgs(
            store.data_ptr(), cur[0].data_ptr(), cur[1].data_ptr(),
            nxt[0].data_ptr(), nxt[1].data_ptr(), lane.data_ptr(),
            glob.data_ptr(), L, S, config.read_step_cap, RB,
            max(0, int(config.spill_steps)), int(big))
        launched = ctypes.c_int(0)
        if boundary_log is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
        rc = compact(ctypes.byref(c_args), ctypes.byref(launched),
                     stream.cuda_stream)
        # the window moves in one launch or, where source and destination
        # overlap, in several: the library reports how many it made
        LAUNCHES.add(k8, launched.value)
        check(rc, k8)
        if boundary_log is not None:
            ev[1].record(stream)
            boundary_log.append(ev)
        # the step kernels go on in the rotated rings
        args.consumed, args.bm_key = c_args.consumed_next, c_args.bm_key_next
        ext.boundaries += 1
    return state


# the launch plan of K3 (csrc/extract_chains.cu)
EXT_WARPS = 8           # EXT_MAX_WARPS: warps a block
EXT_BLOCKS_PER_SM = 2   # the most blocks the plan puts on an SM
EXT_MAX_BLOCKS = 1024   # slots of its grid barrier
EXT_STAGE = 32 * 33     # a warp's staged op words (32 rows of 32, padded)
EXT_MISC = 40           # a block's warp totals, total and first lane
EXT_FLAGS = 1 + EXT_MAX_BLOCKS


class ExtractPlan(NamedTuple):
    """Where K3 runs: `blocks` blocks of `warps` warps, all co-resident,
    and the dynamic shared memory of a block (the L + 1 lane offsets, the
    block's totals and each warp's staged op words).  Mirrors `struct
    ExtractPlan` in csrc/extract_chains.cu."""

    blocks: int
    warps: int
    smem: int


def extract_plan(L: int, C: int, MW: int, sms: int, smem_block: int,
                 blocks_per_sm) -> ExtractPlan:
    """K3's launch plan for L lanes, C entries of MW op words, on a card of
    `sms` SMs whose block may use `smem_block` bytes of shared memory
    without opting in.  `blocks_per_sm(threads, smem)`: the blocks of that
    shape one SM holds at once (the occupancy query, with the registers of
    the kernel form that runs: the frame width, NFW, enters there).

    A warp counts and emits a lane, walks 1 to 32 entries (as few as the
    warps allow: a hop waits for the slowest load of the warp) or folds a
    lane's finish log, so the grid wants C + L warps; it takes at most two
    blocks an SM, as many as the SM holds at once (all co-resident), and
    at least one block.  MW sets only the walk's rounds of 32 columns, not
    the shape.  Raises where a block does not fit a block's or an SM's
    limits."""
    require(1 <= L <= 1024, "the chain extraction runs 1 to 1024 lanes")
    require(C >= 1 and MW >= 1 and C * MW < 2**31,
            "the chain log must hold 1 to 2^31 - 1 op words")
    warps = EXT_WARPS
    smem = 4 * (((L + 4) & ~3) + EXT_MISC + warps * EXT_STAGE)
    require(smem <= smem_block,
            f"{smem} B of shared memory exceed a block's {smem_block}")
    per_sm = min(blocks_per_sm(32 * warps, smem), EXT_BLOCKS_PER_SM)
    require(per_sm >= 1,
            f"an SM cannot hold a block of {32 * warps} threads and {smem} "
            "B of shared memory")
    blocks = max(1, min(per_sm * sms, EXT_MAX_BLOCKS, -(-(C + L) // warps)))
    return ExtractPlan(blocks, warps, smem)


class _ExtractPlanC(ctypes.Structure):
    """Mirror of `struct ExtractPlan` in csrc/extract_chains.cu."""

    _fields_ = [("blocks", ctypes.c_int), ("warps", ctypes.c_int),
                ("smem", ctypes.c_int)]


_ext_plans: dict = {}


def extract_card_plan(dev: torch.device, L: int, C: int, MW: int,
                      big: bool) -> ExtractPlan:
    """`extract_plan` with the figures of the card `dev` and of the kernel
    form that runs, cached by shape (a few queries of the runtime, no
    launch)."""
    key = (dev.index, L, C, MW, bool(big))
    plan = _ext_plans.get(key)
    if plan is not None:
        return plan
    card = cuda_function("extract_chains", "extract_card",
                         [ctypes.POINTER(ctypes.c_int)])
    occupancy = cuda_function("extract_chains", "extract_occupancy",
                              [ctypes.c_int] * 3
                              + [ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(dev):
        fig = (ctypes.c_int * 2)()
        check(card(fig), "extract_card")

        def blocks_per_sm(threads, smem):
            out = ctypes.c_int(0)
            check(occupancy(int(big), threads, smem, ctypes.byref(out)),
                  "extract_occupancy")
            return out.value

        plan = _ext_plans[key] = extract_plan(L, C, MW, fig[0], fig[1],
                                              blocks_per_sm)
    return plan


def _align4(n: int) -> int:
    return (n + 3) & ~3


def _packed_words(C, MW, L, R, big=False) -> int:
    """int32 words of the packed result (K5, ops/engine.py): the head
    fields, C x ceil(MW / K) int64 of wire ops, the tail; R = 0 where the
    result has no read_steps."""
    _opbits, K, _pb = _wire_opbits(MW)
    return (10 if big else 7) * C + C * (-(-MW // K)) * 2 + 3 + 2 * L + R


class _Layout(NamedTuple):
    words: int      # int32 words of the allocation
    at: dict        # name -> word offset of each part
    ptrs: tuple     # byte offset of each pointer of _EXT_PTRS
    pack: tuple     # byte offsets of the PoolResult fields, then `packed`


@functools.lru_cache(maxsize=64)
def _result_layout(L: int, C: int, MW: int, R: int, S: int,
                   big: bool) -> _Layout:
    """K3's result and scratch in one int32 allocation, each part at a
    16-byte boundary: the C-long rows of read, slot and score, those of
    lower, lrev and size (int64 rows of twice the words with `big`),
    c_ops, read_steps (R + 1), lane_read, the three scalars (n_chains,
    next_read, steps), the bool rows (c_abandon, then lane_unfinished at
    byte Cp), then the scratch: lane_cnt and lane_first (four parts a
    lane), c_lane, e_slot and round_cnt (S // 128 + 2 rounds of mask words
    a lane); last the packed result K5 writes on the engine's path."""
    Cp = _align4(C)
    k = 2 if big else 1
    at, words = {}, 0
    for name, n in (("rows", 3 * Cp), ("iv", 3 * Cp * k), ("c_ops", C * MW),
                    ("read_steps", R + 1), ("lane_read", L), ("scalars", 3),
                    ("bools", (Cp + L + 3) // 4), ("lane_cnt", 4 * L),
                    ("lane_first", 4 * L), ("c_lane", C), ("e_slot", C),
                    ("round_cnt", L * (S // 128 + 2)),
                    ("packed", _packed_words(C, MW, L, R, big))):
        at[name] = words
        words += _align4(n)
    b = {name: 4 * w for name, w in at.items()}
    b.update(
        c_read=b["rows"], c_slot=b["rows"] + 4 * Cp,
        c_score=b["rows"] + 8 * Cp, c_lower=b["iv"],
        c_lrev=b["iv"] + 4 * k * Cp, c_size=b["iv"] + 8 * k * Cp,
        n_chains=b["scalars"], next_read=b["scalars"] + 4,
        steps=b["scalars"] + 8, c_abandon=b["bools"],
        lane_unfinished=b["bools"] + Cp)
    return _Layout(words, at, tuple(b[name] for name in _EXT_PTRS),
                   tuple(b[name] for name in PoolResult._fields)
                   + (b["packed"],))


def _alloc_result(config, R, big, dev):
    """One allocation for K3's result and scratch (`_result_layout`)."""
    lay = _result_layout(config.lanes, config.max_chains,
                         config.max_len + 16, R, config.total_steps,
                         bool(big))
    return torch.empty(lay.words, dtype=torch.int32, device=dev)


def _pool_result(buf, config, R, big) -> PoolResult:
    """The PoolResult fields: views of K3's one allocation."""
    L, C, MW = config.lanes, config.max_chains, config.max_len + 16
    at = _result_layout(L, C, MW, R, config.total_steps, bool(big)).at
    Cp = _align4(C)

    def rows(t, n):
        t = t.view(n, Cp)
        return (t if Cp == C else t[:, :C]).unbind(0)

    r0 = at["rows"]
    if big:
        read, slot, score = rows(buf[r0 : r0 + 3 * Cp], 3)
        lower, lrev, size = rows(
            buf[at["iv"] : at["iv"] + 6 * Cp].view(torch.int64), 3)
    else:  # the interval rows follow the other three
        read, slot, score, lower, lrev, size = rows(buf[r0 : r0 + 6 * Cp], 6)
    n_chains, next_read, steps = buf[at["scalars"] : at["scalars"] + 3
                                     ].unbind(0)
    flags = buf[at["bools"] : at["bools"] + (Cp + L + 3) // 4].view(torch.bool)
    return PoolResult(
        c_read=read, c_slot=slot, c_abandon=flags[:C], c_lower=lower,
        c_lrev=lrev, c_size=size, c_score=score.view(torch.float32),
        c_ops=buf[at["c_ops"] : at["c_ops"] + C * MW].view(C, MW),
        n_chains=n_chains,
        lane_read=buf[at["lane_read"] : at["lane_read"] + L],
        lane_unfinished=flags[Cp : Cp + L], next_read=next_read, steps=steps,
        read_steps=buf[at["read_steps"] : at["read_steps"] + R],
    )


_ext_fn = None


class _Extraction:
    """K3's launches on one invocation's loop state: the argument block,
    filled once (then a call sets `first`, `final` and the result's
    pointers), the launch plan, the grid barrier's slots (`flags`, zeroed
    once), the result the store boundaries write into (None before the
    first) and how many boundaries there were."""

    def __init__(self, store, bmask, lane, glob, fin_log, R, big, config,
                 flags):
        global _ext_fn
        if _ext_fn is None:
            _ext_fn = cuda_function(
                "extract_chains", "extract_chains",
                [ctypes.POINTER(_ExtractArgs),
                 ctypes.POINTER(_ExtractPlanC), ctypes.c_void_p])
        L, C, MW = config.lanes, config.max_chains, config.max_len + 16
        self.flags = flags
        self.plan = _ExtractPlanC(*extract_card_plan(store.device, L, C, MW,
                                                     big))
        self.args = _ExtractArgs(
            store.data_ptr(), bmask.data_ptr(), lane.data_ptr(),
            glob.data_ptr(),
            fin_log.data_ptr() if fin_log is not None else None,
            R, L, config.total_steps, C, MW, int(fin_log is not None),
            int(big), 0, 0, flags.data_ptr())
        self.ptrs = (ctypes.c_void_p * len(_EXT_PTRS)).from_buffer(
            self.args, _ExtractArgs.lane_cnt.offset)
        self.offsets = _result_layout(L, C, MW, R, config.total_steps,
                                      bool(big)).ptrs
        self.name = "extract_chains_i64" if big else "extract_chains"
        self.out = None
        self.boundaries = 0

    def launch(self, out, final, fn=None):
        """One extraction into `out` (`_alloc_result`'s), on the current
        stream; `fn`: another build's entry of the same form."""
        a = self.args
        a.first = self.boundaries == 0
        a.final = final
        base = out.data_ptr()
        self.ptrs[:] = [base + b for b in self.offsets]
        rc = (fn or _ext_fn)(a, self.plan, current_raw_stream())
        if rc:
            check(rc, "extract_chains")


def _extract_chains_cuda(store, bmask, lane, glob, fin_log, R, big, ext,
                         config, final=True, views=True):
    """K3 wrapper: compaction, ancestor walk and step fold on the card in
    one launch.  `ext`: the loop state's `_Extraction`.  Not `final`: an
    extraction at a store boundary, which appends its chains into the
    result the boundaries share and folds its steps, and leaves the tail
    fields to the last one.  Not `views`: the final result as the one
    allocation (`_result_layout`), no PoolResult made of it."""
    out = ext.out
    if out is None:
        out = _alloc_result(config, R, big, store.device)
        if not final:
            ext.out = out
    LAUNCHES.add(ext.name)
    ext.launch(out, final)
    if not final:
        return None
    return _pool_result(out, config, R, big) if views else out


def _dense_slut(index: DeviceFmIndex, dense, n, split, config: PoolConfig,
                bid_steps=None, plain: bool = False):
    """The dense-input entry's prologue (search_pool2.py:159-171 of the JAX
    package): Bi-D composite from the pattern and penalty rows (K7, or its
    plain version with `plain`), then the (R*M, 6) f32 rows [score4 | code
    | Bi-D]."""
    pattern_rank, pattern_code, score_lut, pen = dense
    R, M = pattern_rank.shape
    require(M == config.max_len and score_lut.shape == (R, M, 4)
            and pattern_code.shape == pen.shape == (R, M),
            "dense pool search inputs must be (R, max_len)")
    bid = (compute_bi_d_plain if plain else compute_bi_d)(
        index, pattern_rank, pen, n, split,
        compute_forward_part=config.compute_forward_part, steps=bid_steps)
    return torch.cat(
        [score_lut.reshape(R * M, 4),
         pattern_code.reshape(R * M, 1).to(torch.float32),
         bid.reshape(R * M, 1)],
        dim=1,
    )


def k_mismatch_search_pool2(index: DeviceFmIndex, n, split, cutoff_scale,
                            cutoff_thresh, repr_mm, params: SearchParams,
                            config: PoolConfig, slut=None, dense=None,
                            bid_steps=None, views: bool = True):
    """One pool invocation over R reads: K2 then K3, with K3 and K8 at
    every store boundary when `config.generations` allows more than one.

    Inputs are the unpacked prep arrays (ops/engine.py): n, split (R,) i32;
    cutoff_scale, cutoff_thresh, repr_mm (R,) f32; and either `slut`, the
    (R*M, 6) f32 rows [score4 | code | Bi-D] with M = config.max_len, or
    `dense` = (pattern_rank (R, M) i32, pattern_code (R, M) i32, score_lut
    (R, M, 4) f32, pen (R, M) f32), from which the rows are made on the
    device (K7); `bid_steps` then carries the host-known longest parts
    (ops/bi_d.py).  CPU tensors take the plain versions, CUDA tensors the
    kernels.  Returns the PoolResult, or with `views=False` (the engine's
    path, which packs it with K5) the one allocation of `_result_layout`
    that holds it: K3's own on the card, the plain result copied into one
    on the CPU."""
    _check_config(config, n.shape[0])
    require((slut is None) != (dense is None),
            "pass either the packed LUT/Bi-D rows or the dense inputs")
    if dense is not None:
        slut = _dense_slut(index, dense, n, split, config, bid_steps)
    args = (index, n, split, cutoff_scale, cutoff_thresh, repr_mm, params,
            config, slut)
    if n.is_cuda:
        return _extract_chains_cuda(*_pool_loop_cuda(*args), config,
                                    views=views)
    res = _extract_chains_plain(*_pool_loop_plain(*args), config)
    if views:
        return res
    big = res.c_lower.dtype == torch.int64
    buf = _alloc_result(config, n.shape[0], big, n.device)
    for part, field in zip(_pool_result(buf, config, n.shape[0], big), res):
        part.copy_(field)
    return buf
