"""Search constants, the op-word format, the search parameters and the
fixed-batch best-first search (kernel K10).

Counterpart of mapad_tpu/ops/search.py.  The frame and op-word layouts are
the contract between the searches, the chain extraction, the result wire
format and the host decoders, so they are kept bit for bit.

K10 (`search_batch`, csrc/search_batch.cu) replaces
`k_mismatch_search_batch` (mapad_tpu/ops/search.py:99-411): every lane
runs its own best-first search over an append-only frame store of
9*S + 1 rows (the root at slot 9*S, the 9 candidates of step s written in
reverse at 9*(S-1-s)), pops the highest monotone key (ties: the lowest
slot, i.e. the latest push), and after the loop collects its first H
completions and walks their chains into op-word tracks.  The JAX loop runs
all lanes in lock step until every lane is done; lanes never read each
other's state, and a done lane writes nothing that reaches the result, so
the kernel gives each lane a warp that runs its loop to its own end.  The
only values across lanes are `steps` (the most iterations any lane needed,
S for a lane still live) and the stop of the whole loop, which is that
maximum.  The pop has two levels: each lane keeps in shared memory the
maximum (key, then lowest slot) of every chunk of C consecutive key slots,
takes the best chunk from those maxima, and reads that chunk's C keys
beside the popped row to update its maximum; the lane's code, score-LUT
and Bi-D rows sit in shared memory beside them.  `batch_plan` lays this
out: the chunk width C and the lanes a block.  Bound: bytes -- the inputs
once (24 B a cell: codes, score LUT, Bi-D composite), per lane-step the
popped row, 9 frames and 9 keys written and K1's two index rows (the
whole index at most), the outputs once.  The popped chunk's keys (4 x C B
a pop) are this kernel's own traffic beyond that.  The composite comes
from K7 (ops/bi_d.py), launched by the wrapper first.

`k_mismatch_search_batch_plain` is the JAX loop transcribed to PyTorch; the
wrapper `k_mismatch_search_batch` takes it for CPU tensors only (the
tests), and `chip_smoke.py` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .._build import LAUNCHES, check, cuda_function, require
from .bi_d import bi_d_get, compute_bi_d, compute_bi_d_plain
from .fm import DeviceFmIndex, extend_batch_plain

GAP_CLOSED, GAP_INSERTION, GAP_DELETION = 0, 1, 2
OP_MATCH, OP_MISMATCH, OP_INSERTION, OP_DELETION = 0, 1, 2, 3

# packed frame layout in the store's trailing axis
F_LOWER, F_LREV, F_SIZE, F_PARENT, F_STARTLEN, F_GAPS, F_OP, F_SCOREBITS = range(8)
NF = 8
CANDS = 9  # 1 insertion + 4 x (deletion, match/mismatch)

OP_VALID_BIT = 1 << 20  # distinguishes real op words from chain terminators
OP_COMP_BIT = 1 << 21  # marks store entries that completed as hits

INT_MIN = -(2**31)


def pack_op(kind, pos, base):
    return OP_VALID_BIT | (kind << 17) | (pos << 2) | base


def unpack_op_kind(word):
    return word >> 17


def unpack_op_pos(word):
    return (word >> 2) & 0x7FFF


def unpack_op_base(word):
    return word & 3


class SearchConfig(NamedTuple):
    max_len: int = 128  # M: padded read length
    max_steps: int = 2048  # S: step budget == frame-store rows / CANDS
    hit_cap: int = 24  # H: hit slots per lane
    compute_forward_part: bool = False  # center-start models need both halves


class SearchParams(NamedTuple):
    """Scalar search parameters as 0-d tensors on the engine's device."""

    pgo_pge: torch.Tensor  # f32: penalty_gap_open + penalty_gap_extend
    pge: torch.Tensor  # f32: penalty_gap_extend
    gap_dist_ends: torch.Tensor  # i32
    max_gaps: torch.Tensor  # i32
    stack_limit_abort: torch.Tensor  # bool (escalation covers abort semantics)

    @classmethod
    def from_alignment(cls, p, device) -> "SearchParams":
        return cls(
            pgo_pge=torch.tensor(
                float(np.float32(p.penalty_gap_open + p.penalty_gap_extend)),
                dtype=torch.float32, device=device,
            ),
            pge=torch.tensor(float(np.float32(p.penalty_gap_extend)),
                             dtype=torch.float32, device=device),
            gap_dist_ends=torch.tensor(int(p.gap_dist_ends),
                                       dtype=torch.int32, device=device),
            max_gaps=torch.tensor(int(p.max_num_gaps_open),
                                  dtype=torch.int32, device=device),
            stack_limit_abort=torch.tensor(bool(p.stack_limit_abort),
                                           device=device),
        )


class SearchResult(NamedTuple):
    h_score: torch.Tensor  # (L, H) f32
    h_lower: torch.Tensor  # (L, H) i32
    h_lrev: torch.Tensor  # (L, H) i32
    h_size: torch.Tensor  # (L, H) i32
    hcount: torch.Tensor  # (L,) i32
    h_ops: torch.Tensor  # (L, H, MW) i32 op words, 0-terminated chains
    escalate: torch.Tensor  # (L,) bool
    steps: torch.Tensor  # () i32


def _mono(f):
    """Order-preserving int32 key of an f32 (self-inverse transform)."""
    u = f.view(torch.int32)
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def _mono_inv(k):
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _search_batch_plain(index: DeviceFmIndex, pattern_code, n, score_lut,
                        bid, split, cutoff_scale, cutoff_thresh, repr_mm,
                        params: SearchParams,
                        config: SearchConfig) -> SearchResult:
    """Plain PyTorch K10 from the Bi-D composite on: the JAX loop (all lanes
    in lock step), hit collection and chain walk, line by line."""
    L, M = pattern_code.shape
    S = config.max_steps
    SLOTS = S * CANDS + 1
    ROOT = SLOTS - 1  # the store grows downward from the root
    H = config.hit_cap
    dev = pattern_code.device
    i32, f32 = torch.int32, torch.float32
    lanes = torch.arange(L, device=dev)
    pgo_pge, pge = params.pgo_pge.to(dev), params.pge.to(dev)
    gde, max_gaps = params.gap_dist_ends.to(dev), params.max_gaps.to(dev)
    n = n.to(i32)
    split = split.to(i32)
    code_of = pattern_code.to(i32)

    st_mono = torch.full((L, SLOTS), INT_MIN, dtype=i32, device=dev)
    st_mono[:, ROOT] = 0  # the key of 0.0
    st_pack = torch.zeros((L, SLOTS, NF), dtype=i32, device=dev)
    st_pack[:, ROOT, F_SIZE] = index.text_len
    st_pack[:, ROOT, F_STARTLEN] = split << 16

    hcount = torch.zeros(L, dtype=i32, device=dev)
    done = n <= 0
    escalate = torch.zeros(L, dtype=torch.bool, device=dev)
    best_score = torch.full((L,), float("-inf"), dtype=f32, device=dev)
    best_size = torch.zeros(L, dtype=i32, device=dev)

    def reject(v):
        return (v / cutoff_scale) < cutoff_thresh

    def gaps_word(gb, gf, ng):
        return gb | (gf << 2) | (ng << 4)

    def where(c, a, b):
        return torch.where(c, torch.as_tensor(a, device=dev),
                           torch.as_tensor(b, device=dev))

    step = 0
    while step < S and not bool(done.all()):
        # --- pop the best frame: argmax, first occurrence == latest push ---
        sel = torch.argmax(st_mono, dim=1)
        f_mono = st_mono[lanes, sel]
        done = done | ~(f_mono > INT_MIN)
        active = ~done
        st_mono[lanes[active], sel[active]] = INT_MIN
        frame = st_pack[lanes, sel]
        f_score = _mono_inv(f_mono)
        f_lower = frame[:, F_LOWER]
        f_lrev = frame[:, F_LREV]
        f_size = frame[:, F_SIZE]
        f_start = frame[:, F_STARTLEN] >> 16
        f_len = frame[:, F_STARTLEN] & 0xFFFF
        gaps = frame[:, F_GAPS]
        f_gapb = gaps & 3
        f_gapf = (gaps >> 2) & 3
        f_ngaps = (gaps >> 4) & 0xFF

        # --- direction (mapping.rs:1077-1097) ---
        fwd = f_start <= n - f_start - f_len
        j = where(fwd, f_start + f_len, f_start - 1)
        d_k = where(fwd, f_start, f_start - 1)
        d_l = where(fwd, f_start + f_len, f_start + f_len - 1)
        ext_lower = where(fwd, f_lrev, f_lower)
        ext_lrev = where(fwd, f_lower, f_lrev)
        gap_state = where(fwd, f_gapf, f_gapb)

        ins_score = where(gap_state == GAP_INSERTION, pge, pgo_pge) + f_score
        del_score = where(gap_state == GAP_DELETION, pge, pgo_pge) + f_score
        ngaps_inc = where(gap_state == GAP_CLOSED, f_ngaps + 1, f_ngaps)

        j_c = torch.clamp(j, 0, M - 1)
        Sj = score_lut[lanes, j_c.long()]  # (L, 4)
        pat_j = code_of[lanes, j_c.long()]
        lb = bi_d_get(bid, split, n, d_k, d_l)

        # best-first global stop (mapping.rs:1201-1208)
        stop = (f_score + lb) < best_score + repr_mm
        done = done | (active & stop)
        still = active & ~stop

        # --- extension sweep ---
        ch_lower, ch_lrev, ch_size = extend_batch_plain(
            index, ext_lower, ext_lrev, f_size)
        out_lower = torch.where(fwd[:, None], ch_lrev, ch_lower)
        out_lrev = torch.where(fwd[:, None], ch_lower, ch_lrev)

        ins_allowed = torch.minimum(j, n - j - 1) >= gde
        d5 = where(fwd, j, j + 1)
        del_allowed = torch.minimum(d5, n - d5) >= gde
        next_start = where(fwd, f_start, f_start - 1)
        del_rej = reject(del_score + lb)
        ins_rej = reject(ins_score + lb)
        gaps_ok = ngaps_inc <= max_gaps

        # --- the 9 candidates (order: ins, then (del, mm) per slot) ---
        c_ok = [still & ~ins_rej & ins_allowed & gaps_ok]
        c_score = [ins_score]
        c_lower, c_lrev, c_size = [f_lower], [f_lrev], [f_size]
        c_startlen = [(next_start << 16) | (f_len + 1)]
        c_gaps = [gaps_word(where(fwd, f_gapb, GAP_INSERTION),
                            where(fwd, GAP_INSERTION, f_gapf), ngaps_inc)]
        c_op = [pack_op(OP_INSERTION, j_c, 0)]
        for slot in range(4):
            s_lower = out_lower[:, slot]
            s_lrev = out_lrev[:, slot]
            s_size = ch_size[:, slot]
            nonzero = s_size >= 1
            code = where(fwd, slot, 3 - slot).to(i32)
            mm_score = Sj.gather(1, code.long()[:, None])[:, 0] + f_score
            # deletion
            c_ok.append(still & nonzero & ~del_rej & del_allowed & gaps_ok)
            c_score.append(del_score)
            c_lower.append(s_lower)
            c_lrev.append(s_lrev)
            c_size.append(s_size)
            c_startlen.append((f_start << 16) | f_len)
            c_gaps.append(gaps_word(where(fwd, f_gapb, GAP_DELETION),
                                    where(fwd, GAP_DELETION, f_gapf),
                                    ngaps_inc))
            c_op.append(pack_op(OP_DELETION, j_c, code))
            # match / mismatch
            c_ok.append(still & nonzero & ~reject(mm_score + lb))
            kind = where(code == pat_j, OP_MATCH, OP_MISMATCH).to(i32)
            c_score.append(mm_score)
            c_lower.append(s_lower)
            c_lrev.append(s_lrev)
            c_size.append(s_size)
            c_startlen.append((next_start << 16) | (f_len + 1))
            c_gaps.append(gaps_word(where(fwd, f_gapb, GAP_CLOSED),
                                    where(fwd, GAP_CLOSED, f_gapf), f_ngaps))
            c_op.append(pack_op(kind, j_c, code))

        # reject_iterative at push time (mapping.rs:956-963): later
        # candidates see the best hit updated by earlier completions of the
        # same step
        ok_cols, comp_cols = [], []
        run_best, run_size = best_score, best_size
        for k in range(CANDS):
            ok_k = c_ok[k] & ~(c_score[k] < run_best + repr_mm)
            comp_k = ok_k & ((c_startlen[k] & 0xFFFF) == n)
            upd = comp_k & (c_score[k] > run_best)
            run_size = torch.where(upd, c_size[k], run_size)
            run_best = torch.where(upd, c_score[k], run_best)
            ok_cols.append(ok_k)
            comp_cols.append(comp_k)
        best_score, best_size = run_best, run_size
        comp9 = torch.stack(comp_cols, dim=1)
        push9 = torch.stack(ok_cols, dim=1) & ~comp9
        score9 = torch.stack(c_score, dim=1)

        # --- write the 9 frames reversed below the last step's (lower slot
        # == later push); completions carry OP_COMP_BIT ---
        pack9 = torch.stack([
            torch.stack(c_lower, dim=1),
            torch.stack(c_lrev, dim=1),
            torch.stack(c_size, dim=1),
            sel.to(i32)[:, None].expand(L, CANDS),
            torch.stack(c_startlen, dim=1),
            torch.stack(c_gaps, dim=1),
            torch.stack(c_op, dim=1) | torch.where(
                comp9, OP_COMP_BIT, 0).to(i32),
            score9.view(i32),
        ], dim=2)
        base = ROOT - (step + 1) * CANDS
        st_pack[:, base : base + CANDS] = pack9.flip(1)
        st_mono[:, base : base + CANDS] = torch.where(
            push9, _mono(score9), INT_MIN).flip(1)

        hcount = hcount + comp9.sum(dim=1, dtype=i32)
        # multi-hit / >9 hits early return (mapping.rs:1341-1355)
        done = done | (still & ((hcount > 9) | (best_size > 1)))
        done = done | (still & escalate)
        step += 1
    escalate = escalate | ~done

    # --- hits: the COMP-marked slots, highest slot == earliest completion
    comp_mask = (st_pack[:, :, F_OP] & OP_COMP_BIT) != 0
    slot_iota = torch.arange(SLOTS, dtype=i32, device=dev)
    hit_key = torch.where(comp_mask, slot_iota[None, :], -1)
    hit_slots = torch.clamp(torch.topk(hit_key, H, dim=1).values, min=0)
    hit_rows = st_pack[lanes[:, None], hit_slots.long()]  # (L, H, NF)
    valid = torch.arange(H, device=dev)[None, :] < hcount[:, None]
    h_score = torch.where(valid, hit_rows[:, :, F_SCOREBITS].view(f32),
                          float("-inf"))

    # --- walk each hit's chain: MW-1 parents in lock step ---
    MW = M + 16  # ops per chain <= read_len + max deletions + slack
    hit_lane = lanes.repeat_interleave(H)
    node = torch.where(valid, hit_rows[:, :, F_PARENT], ROOT).reshape(-1)
    words = [torch.where(valid, hit_rows[:, :, F_OP], 0).reshape(-1)]
    for _ in range(MW - 1):
        entry = st_pack[hit_lane, node.long()]
        at_root = node == ROOT
        words.append(torch.where(at_root, 0, entry[:, F_OP]))
        node = torch.where(at_root, ROOT, entry[:, F_PARENT])
    h_ops = torch.stack(words, dim=1).reshape(L, H, MW)

    zero = torch.zeros((), dtype=i32, device=dev)
    return SearchResult(
        h_score=h_score,
        h_lower=torch.where(valid, hit_rows[:, :, F_LOWER], zero),
        h_lrev=torch.where(valid, hit_rows[:, :, F_LREV], zero),
        h_size=torch.where(valid, hit_rows[:, :, F_SIZE], zero),
        hcount=hcount,
        h_ops=h_ops,
        escalate=escalate,
        steps=torch.tensor(step, dtype=i32, device=dev),
    )


def k_mismatch_search_batch_plain(index: DeviceFmIndex, pattern_rank,
                                  pattern_code, n, score_lut, pen, split,
                                  cutoff_scale, cutoff_thresh, repr_mm,
                                  params: SearchParams,
                                  config: SearchConfig) -> SearchResult:
    """Plain PyTorch K7 + K10: the JAX function on the same inputs."""
    bid = compute_bi_d_plain(index, pattern_rank, pen, n, split,
                             config.compute_forward_part)
    return _search_batch_plain(index, pattern_code, n, score_lut, bid, split,
                               cutoff_scale, cutoff_thresh, repr_mm, params,
                               config)


class _BatchArgs(ctypes.Structure):
    """Mirror of `struct BatchArgs` in csrc/search_batch.cu."""

    _fields_ = [
        ("rows", ctypes.c_void_p), ("less", ctypes.c_void_p),
        ("sent", ctypes.c_void_p), ("nb", ctypes.c_int),
        ("occ_k", ctypes.c_int), ("text_len", ctypes.c_int),
        ("code", ctypes.c_void_p), ("slut", ctypes.c_void_p),
        ("bid", ctypes.c_void_p), ("n", ctypes.c_void_p),
        ("split", ctypes.c_void_p), ("scale", ctypes.c_void_p),
        ("thresh", ctypes.c_void_p), ("repr", ctypes.c_void_p),
        ("L", ctypes.c_int), ("M", ctypes.c_int), ("S", ctypes.c_int),
        ("H", ctypes.c_int), ("MW", ctypes.c_int),
        ("pgo_pge", ctypes.c_float), ("pge", ctypes.c_float),
        ("gap_dist_ends", ctypes.c_int), ("max_gaps", ctypes.c_int),
        ("store", ctypes.c_void_p), ("keys", ctypes.c_void_p),
        ("hit_slot", ctypes.c_void_p), ("lane_steps", ctypes.c_void_p),
        ("h_score", ctypes.c_void_p), ("h_lower", ctypes.c_void_p),
        ("h_lrev", ctypes.c_void_p), ("h_size", ctypes.c_void_p),
        ("hcount", ctypes.c_void_p), ("h_ops", ctypes.c_void_p),
        ("escalate", ctypes.c_void_p), ("steps", ctypes.c_void_p),
    ]


# the launch plan of K10 (csrc/search_batch.cu): a warp a lane
WARP = 32
MAX_LANES_PER_BLOCK = 16  # csrc/search_batch.cu MAX_LANES_PER_BLOCK
MIN_CHUNK = 32  # slots a chunk at least: one key a thread of the warp
MAX_CHUNKS = 1024  # chunk maxima a lane keeps at most (8 KB)
CELL_BYTES = 24  # a lane's staged inputs a position: 4 + 1 f32, 1 i32


class BatchPlan(NamedTuple):
    """Where K10's lanes run and how a lane's pop is laid out: a block of
    `lanes_per_block` warps, `blocks` blocks; the keys cut into `chunks`
    chunks of `chunk` slots; `lane_smem` bytes of shared memory a lane (its
    chunk maxima, then its staged inputs), `smem` a block; `resident` 1
    where the card holds every block at once.  Mirrors `struct BatchPlan`
    in csrc/search_batch.cu."""

    lanes_per_block: int
    blocks: int
    chunk: int
    chunks: int
    lane_smem: int
    smem: int
    resident: int


def batch_plan(L: int, S: int, M: int, sms: int, smem_block: int,
               smem_sm: int, blocks_per_sm, static_smem: int = 0,
               reserved_smem: int = 0) -> BatchPlan:
    """K10's launch plan for L lanes of S steps over reads padded to M, on
    a card of `sms` SMs whose block may opt into `smem_block` bytes of
    shared memory and whose SM holds `smem_sm`.  `blocks_per_sm(threads,
    smem)`: the blocks of that shape one SM holds at once (the occupancy
    query, with the kernel's registers); `static_smem`: the kernel's own
    shared memory, `reserved_smem`: the runtime's reserve a block.

    The chunk width is the least power of two, 32 or more, that cuts the
    9S+1 key slots into at most MAX_CHUNKS chunks.  The lanes spread over
    the SMs: ceil(L / sms) lanes a block, fewer where a block's shared
    memory would not hold them.  Raises where no block holds one lane."""
    require(L >= 1, "the batch search runs one lane or more")
    require(S >= 1 and CANDS * S + 1 < 2**31, "the batch search's steps")
    require(1 <= M <= 0x7FFF, "the batch search's read length")
    slots = CANDS * S + 1
    chunk = MIN_CHUNK
    while -(-slots // chunk) > MAX_CHUNKS:
        chunk *= 2
    chunks = -(-slots // chunk)
    lane_smem = -(-(8 * chunks + CELL_BYTES * M) // 16) * 16
    room = min(smem_block - static_smem,
               smem_sm - static_smem - reserved_smem)
    require(lane_smem <= room,
            f"a lane needs {lane_smem} B of shared memory; a block may "
            f"have {room}")
    lpb = min(-(-L // sms), room // lane_smem, MAX_LANES_PER_BLOCK)
    blocks = -(-L // lpb)
    per_sm = blocks_per_sm(WARP * lpb, lpb * lane_smem)
    require(per_sm >= 1,
            f"the card holds no block of {WARP * lpb} threads and "
            f"{lpb * lane_smem} B of shared memory")
    return BatchPlan(lpb, blocks, chunk, chunks, lane_smem, lpb * lane_smem,
                     int(blocks <= per_sm * sms))


class _BatchPlanC(ctypes.Structure):
    """Mirror of `struct BatchPlan` in csrc/search_batch.cu."""

    _fields_ = [(f, ctypes.c_int) for f in BatchPlan._fields]


def batch_card_plan(dev: torch.device, L: int, S: int, M: int) -> BatchPlan:
    """`batch_plan` with the figures of the card `dev` and of K10's kernel
    (a few queries of the runtime, no launch)."""
    card = cuda_function("search_batch", "batch_card",
                         [ctypes.POINTER(ctypes.c_int)])
    occupancy = cuda_function("search_batch", "batch_occupancy",
                              [ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(dev):
        fig = (ctypes.c_int * 5)()
        check(card(fig), "batch_card")
        sms, smem_block, smem_sm, static, reserved = list(fig)

        def blocks_per_sm(threads, smem):
            out = ctypes.c_int(0)
            check(occupancy(threads, smem, ctypes.byref(out)),
                  "batch_occupancy")
            return out.value

        return batch_plan(L, S, M, sms, smem_block, smem_sm, blocks_per_sm,
                          static, reserved)


def _search_batch_cuda(index: DeviceFmIndex, pattern_code, n, score_lut,
                       bid, split, cutoff_scale, cutoff_thresh, repr_mm,
                       params: SearchParams, config: SearchConfig):
    """K10 on the card from the Bi-D composite on -> (SearchResult, (L,)
    int32 iterations each lane ran).  The frame store and the keys are
    scratch of this call (1.36 GB at L=2048, S=2048): the caching allocator
    hands the same memory to the next call on the stream."""
    L, M = pattern_code.shape
    i32, f32 = torch.int32, torch.float32
    require(not index.big, "the batch search takes a small (int32) index; "
            "use mode='pool'")
    for t, dt in ((pattern_code, i32), (n, i32), (score_lut, f32),
                  (bid, f32), (split, i32), (cutoff_scale, f32),
                  (cutoff_thresh, f32), (repr_mm, f32), (index.rows, i32),
                  (index.less, i32), (index.sentinels, i32)):
        require(t.is_cuda and t.dtype == dt and t.is_contiguous(),
                "search_batch takes contiguous CUDA tensors")
    require(score_lut.shape == (L, M, 4) and bid.shape == (L, M)
            and n.shape == split.shape == cutoff_scale.shape
            == cutoff_thresh.shape == repr_mm.shape == (L,),
            "search_batch shapes")
    S, H = config.max_steps, config.hit_cap
    require(1 <= S and CANDS * S + 1 < 2**31 and 1 <= H and M <= 0x7FFF,
            "search_batch config")
    MW = M + 16
    SLOTS = S * CANDS + 1
    dev = pattern_code.device

    def empty(*shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device=dev)

    store, keys = empty(L, SLOTS, NF), empty(L, SLOTS)
    hit_slot, lane_steps = empty(L, H), empty(L)
    res = SearchResult(
        h_score=empty(L, H, dtype=f32), h_lower=empty(L, H),
        h_lrev=empty(L, H), h_size=empty(L, H), hcount=empty(L),
        h_ops=empty(L, H, MW), escalate=empty(L, dtype=torch.bool),
        steps=torch.zeros((), dtype=i32, device=dev),
    )
    if L == 0:
        return res, lane_steps
    plan = _BatchPlanC(*batch_card_plan(dev, L, S, M))
    args = _BatchArgs(
        index.rows.data_ptr(), index.less.data_ptr(),
        index.sentinels.data_ptr(), index.rows.shape[0], index.occ_k,
        index.text_len, pattern_code.data_ptr(), score_lut.data_ptr(),
        bid.data_ptr(), n.data_ptr(), split.data_ptr(),
        cutoff_scale.data_ptr(), cutoff_thresh.data_ptr(),
        repr_mm.data_ptr(), L, M, S, H, MW, float(params.pgo_pge),
        float(params.pge), int(params.gap_dist_ends), int(params.max_gaps),
        store.data_ptr(), keys.data_ptr(), hit_slot.data_ptr(),
        lane_steps.data_ptr(), *[t.data_ptr() for t in res],
    )
    fn = cuda_function("search_batch", "search_batch",
                       [ctypes.POINTER(_BatchArgs),
                        ctypes.POINTER(_BatchPlanC), ctypes.c_void_p])
    LAUNCHES.add("search_batch")
    LAUNCHES.add("extend_batch")  # K1 runs inline in the lane loop
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(args), ctypes.byref(plan),
                torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "search_batch")
    return res, lane_steps


def k_mismatch_search_batch(index: DeviceFmIndex, pattern_rank,
                            pattern_code, n, score_lut, pen, split,
                            cutoff_scale, cutoff_thresh, repr_mm,
                            params: SearchParams, config: SearchConfig,
                            bid_steps=None) -> SearchResult:
    """K7 + K10 wrapper: the plain versions for CPU tensors, the kernels for
    CUDA tensors (never a fallback).  Small (int32) index only.

    pattern_rank, pattern_code: (L, M) i32; n, split: (L,) i32; score_lut
    (L, M, 4), pen (L, M), cutoff_scale, cutoff_thresh, repr_mm (L,) f32.
    `bid_steps` = (max(split), max(n - split)) where the caller knows them
    on the host; else K7 reads them back from the card."""
    if not pattern_code.is_cuda:
        return k_mismatch_search_batch_plain(
            index, pattern_rank, pattern_code, n, score_lut, pen, split,
            cutoff_scale, cutoff_thresh, repr_mm, params, config)
    bid = compute_bi_d(index, pattern_rank, pen, n, split,
                       config.compute_forward_part, bid_steps)
    return _search_batch_cuda(index, pattern_code, n, score_lut, bid, split,
                              cutoff_scale, cutoff_thresh, repr_mm, params,
                              config)[0]
