// K10: the fixed-batch best-first search, one warp per lane, K1 inline.
//
// Replaces mapad_tpu/ops/search.py `k_mismatch_search_batch` (99-411) from
// the Bi-D composite on (the wrapper launches K7, csrc/bi_d.cu, first).
// Plain version: ops/search.py `_search_batch_plain`.  Small (int32) index
// only, as in the JAX engine.
//
// What it computes, per lane: an append-only frame store of SLOTS = 9S+1
// rows of 8 words with the root at ROOT = 9S; step s pops the row with the
// highest monotone score key (ties: the lowest slot, the latest push),
// tests the best-first stop against the Bi-D bound, extends the popped
// interval by the four symbols (backward, or forward as the backward
// extension of the swapped interval when the right remainder is the
// shorter), builds 9 candidates in the order insertion, then (deletion,
// match/mismatch) per symbol, runs the reference's reject_iterative over
// them in that order, and writes the 9 rows reversed at ROOT - 9(s+1).
// Completions carry OP_COMP_BIT and no key.  More than 9 completions or a
// best hit on more than one position end the lane.  After the loop: the
// first H completions in completion order (JAX's top_k of the COMP slots)
// and, for each, MW op words: its own, then those of MW-1 ancestors (0 at
// and past the root, so a longer chain is cut, not ended).
//
// Design: JAX steps every lane in lock step until all are done; a done
// lane's later rows there never reach the result (no COMP bit, no key, no
// chain leads to them), and lanes share nothing but `steps`, the largest
// number of iterations any lane needed (S for a lane still live).  So each
// lane is a warp that runs its loop to its own end, in one launch, and
// `steps` is an atomicMax.  All 32 threads of a warp hold the lane's state
// in registers (redundantly, like K7's walks): the pop is a warp scan of
// the written key window [ROOT - 9s, ROOT] (unwritten and popped slots
// hold INT_MIN) as one u64 max of (key, SLOTS-1-slot); K1 is two
// occ4_warp queries; thread t < 9 writes store row ROOT - 9(s+1) + t.  The
// keys and rows live in device memory (the keys of one lane, 73.7 KB at
// S=2048, would fit in shared memory: later work).
//
// Bound on the card: bytes -- the inputs once (24 B a cell), per lane-step
// the popped row, 9 rows and 9 keys written (356 B) and K1's two index
// rows (the whole index at most), the outputs once.  The key window the
// pop scans (4 B x (9s+1) at step s) is this kernel's own traffic beyond
// that.  f32 arithmetic: --fmad=false, IEEE division (`reject`), the JAX
// op order.
#include "common.cuh"

using namespace mapad;

struct BatchArgs {
  const int* rows;
  const int* less;
  const int* sent;
  int nb, occ_k, text_len;
  const int* code;      // (L, M) symbol codes 0..3, 4 = non-ACGT
  const float* slut;    // (L, M, 4) score LUT
  const float* bid;     // (L, M) Bi-D composite (K7)
  const int* n;         // (L,)
  const int* split;     // (L,)
  const float* scale;   // (L,)
  const float* thresh;  // (L,)
  const float* repr;    // (L,)
  int L, M, S, H, MW;
  float pgo_pge, pge;
  int gap_dist_ends, max_gaps;
  int* store;       // (L, SLOTS, NF) scratch
  int* keys;        // (L, SLOTS) scratch
  int* hit_slot;    // (L, H) scratch: slots of the first H completions
  int* lane_steps;  // (L,) iterations each lane ran
  float* h_score;   // (L, H)
  int* h_lower;     // (L, H)
  int* h_lrev;      // (L, H)
  int* h_size;      // (L, H)
  int* hcount;      // (L,)
  int* h_ops;       // (L, H, MW)
  uint8_t* escalate;  // (L,)
  int* steps;       // () zeroed by the caller
};

constexpr int WARPS = 4;  // lanes per block

static __global__ void __launch_bounds__(WARPS * 32)
search_batch_kernel(BatchArgs a) {
  const int lane = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (lane >= a.L) return;  // the whole warp
  const int S = a.S, M = a.M, H = a.H;
  const int SLOTS = S * CANDS + 1, ROOT = SLOTS - 1;
  int* st = a.store + (size_t)lane * SLOTS * NF;
  int* key = a.keys + (size_t)lane * SLOTS;
  int* hs = a.hit_slot + (size_t)lane * H;
  const int nn = a.n[lane], sp = a.split[lane];
  const float c_scale = a.scale[lane], c_thresh = a.thresh[lane],
              c_repr = a.repr[lane];
  const int* code_row = a.code + (size_t)lane * M;
  const float* slut_row = a.slut + (size_t)lane * M * 4;
  const float* bid_row = a.bid + (size_t)lane * M;
  if (t < NF) {
    // the root frame: whole text, empty match at the alignment start
    const int root[NF] = {0, 0, a.text_len, 0, wshl(sp, 16), 0, 0, 0};
#pragma unroll
    for (int f = 0; f < NF; ++f)
      if (t == f) st[(size_t)ROOT * NF + f] = root[f];
    if (t == 0) key[ROOT] = 0;  // the key of 0.0f
  }
  __syncwarp();

  bool done = nn <= 0;
  float best_score = -__int_as_float(0x7f800000);
  int best_size = 0, hcount = 0, lane_steps = 0;
  for (int step = 0; !done && step < S; ++step) {
    // --- pop: the max key of the written window, first occurrence ---
    unsigned long long best = 0;
    const int lo = ROOT - CANDS * step;
#pragma unroll 8
    for (int s = lo + t; s <= ROOT; s += 32) {
      const unsigned long long v =
          ((unsigned long long)((unsigned)key[s] ^ 0x80000000u) << 32) |
          (unsigned)(ROOT - s);
      best = v > best ? v : best;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, d);
      best = o > best ? o : best;
    }
    const int f_mono = (int)((unsigned)(best >> 32) ^ 0x80000000u);
    const int sel = ROOT - (int)(unsigned)(best & 0xffffffffu);
    if (f_mono == INT_MIN32) {  // nothing left to pop
      done = true;
      lane_steps = step + 1;
      break;
    }
    const int* fr = st + (size_t)sel * NF;
    const int f_lower = fr[F_LOWER], f_lrev = fr[F_LREV], f_size = fr[F_SIZE];
    const int f_start = fr[F_STARTLEN] >> 16, f_len = fr[F_STARTLEN] & 0xFFFF;
    const int gaps = fr[F_GAPS];
    __syncwarp();  // every thread has read the popped row and its key
    if (t == 0) key[sel] = INT_MIN32;
    const float f_score = __int_as_float(mono_bits(f_mono));
    const int f_gapb = gaps & 3, f_gapf = (gaps >> 2) & 3,
              f_ngaps = (gaps >> 4) & 0xFF;

    // --- direction (mapping.rs:1077-1097) ---
    const bool fwd = f_start <= nn - f_start - f_len;
    const int j = fwd ? f_start + f_len : f_start - 1;
    const int d_k = fwd ? f_start : f_start - 1;
    const int d_l = fwd ? f_start + f_len : f_start + f_len - 1;
    const int ext_lower = fwd ? f_lrev : f_lower;
    const int ext_lrev = fwd ? f_lower : f_lrev;
    const int gap_state = fwd ? f_gapf : f_gapb;
    const float ins_score =
        (gap_state == GAP_INSERTION ? a.pge : a.pgo_pge) + f_score;
    const float del_score =
        (gap_state == GAP_DELETION ? a.pge : a.pgo_pge) + f_score;
    const int ngaps_inc = gap_state == GAP_CLOSED ? f_ngaps + 1 : f_ngaps;

    const int j_c = j < 0 ? 0 : (j > M - 1 ? M - 1 : j);
    const float Sj[4] = {slut_row[j_c * 4 + 0], slut_row[j_c * 4 + 1],
                         slut_row[j_c * 4 + 2], slut_row[j_c * 4 + 3]};
    const int pat_j = code_row[j_c];
    // bi_d_get: the bound of both remainders
    const int bk = d_k < 0 ? 0 : (d_k > M - 1 ? M - 1 : d_k);
    const int tt = nn - (1 + d_l);
    const int ci = tt + sp;
    const int ci_c = ci < 0 ? 0 : (ci > M - 1 ? M - 1 : ci);
    const float d_rev = (d_k >= 0 && d_k < nn) ? bid_row[bk] : 0.0f;
    const float d_fwd = (tt >= 0 && ci < nn) ? bid_row[ci_c] : 0.0f;
    const float lb = d_rev + d_fwd;

    // best-first global stop (mapping.rs:1201-1208)
    if ((f_score + lb) < best_score + c_repr) {
      done = true;
      lane_steps = step + 1;
      break;
    }

    // --- K1: rank of both interval ends, then the extension sweep ---
    int occ1[4], occ2[4];
    occ4_warp<int>(a.rows, a.nb, a.occ_k, occ_query_lower<int>(ext_lower),
                   occ1);
    occ4_warp<int>(a.rows, a.nb, a.occ_k,
                   occ_query_upper<int>(ext_lower, f_size), occ2);
    int ch_lower[4], ch_lrev[4], ch_size[4];
    extend_from_occ<int>(a.less, a.sent, ext_lower, ext_lrev, f_size, occ1,
                         occ2, ch_lower, ch_lrev, ch_size);

    const int gde = a.gap_dist_ends;
    const bool ins_allowed = min(j, nn - j - 1) >= gde;
    const int d5 = fwd ? j : j + 1;
    const bool del_allowed = min(d5, nn - d5) >= gde;
    const int next_start = fwd ? f_start : f_start - 1;
    const bool del_rej = ((del_score + lb) / c_scale) < c_thresh;
    const bool ins_rej = ((ins_score + lb) / c_scale) < c_thresh;
    const bool gaps_ok = ngaps_inc <= a.max_gaps;
    // the gap state of the side not extended rides along unchanged
    auto gaps_word = [&](int state, int ng) {
      return (fwd ? f_gapb : state) | ((fwd ? state : f_gapf) << 2) |
             wshl(ng, 4);
    };

    // --- the 9 candidates (order: ins, then (del, mm) per slot) ---
    bool ok[CANDS];
    float score[CANDS];
    int lo9[CANDS], lr9[CANDS], sz9[CANDS], sl9[CANDS], gp9[CANDS],
        op9[CANDS];
    ok[0] = !ins_rej && ins_allowed && gaps_ok;
    score[0] = ins_score;
    lo9[0] = f_lower;
    lr9[0] = f_lrev;
    sz9[0] = f_size;
    sl9[0] = wshl(next_start, 16) | (f_len + 1);
    gp9[0] = gaps_word(GAP_INSERTION, ngaps_inc);
    op9[0] = OP_VALID_BIT | (OP_INSERTION << 17) | (j_c << 2);
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) {
      const int code = fwd ? slot : 3 - slot;
      const bool nonzero = ch_size[slot] >= 1;
      const float mm_score = Sj[code] + f_score;
      const int kd = 1 + 2 * slot, km = 2 + 2 * slot;
      ok[kd] = nonzero && !del_rej && del_allowed && gaps_ok;
      score[kd] = del_score;
      sl9[kd] = wshl(f_start, 16) | f_len;
      gp9[kd] = gaps_word(GAP_DELETION, ngaps_inc);
      op9[kd] = OP_VALID_BIT | (OP_DELETION << 17) | (j_c << 2) | code;
      ok[km] = nonzero && !(((mm_score + lb) / c_scale) < c_thresh);
      score[km] = mm_score;
      sl9[km] = wshl(next_start, 16) | (f_len + 1);
      gp9[km] = gaps_word(GAP_CLOSED, f_ngaps);
      op9[km] = OP_VALID_BIT |
                ((code == pat_j ? OP_MATCH : OP_MISMATCH) << 17) |
                (j_c << 2) | code;
      lo9[kd] = lo9[km] = fwd ? ch_lrev[slot] : ch_lower[slot];
      lr9[kd] = lr9[km] = fwd ? ch_lower[slot] : ch_lrev[slot];
      sz9[kd] = sz9[km] = ch_size[slot];
    }

    // --- reject_iterative in candidate order (mapping.rs:956-963), and
    // the rows written reversed: candidate k at base + 8 - k ---
    const int base = ROOT - (step + 1) * CANDS;
#pragma unroll
    for (int k = 0; k < CANDS; ++k) {
      const bool ok_k = ok[k] && !(score[k] < best_score + c_repr);
      const bool comp = ok_k && (sl9[k] & 0xFFFF) == nn;
      if (comp && score[k] > best_score) {
        best_size = sz9[k];
        best_score = score[k];
      }
      const int slot = base + CANDS - 1 - k;
      if (comp) {
        if (t == 0 && hcount < H) hs[hcount] = slot;
        ++hcount;
      }
      if (t == CANDS - 1 - k) {
        int4* row = reinterpret_cast<int4*>(st + (size_t)slot * NF);
        row[0] = make_int4(lo9[k], lr9[k], sz9[k], sel);
        row[1] = make_int4(sl9[k], gp9[k], op9[k] | (comp ? OP_COMP_BIT : 0),
                           __float_as_int(score[k]));
        key[slot] = ok_k && !comp ? mono_bits(__float_as_int(score[k]))
                                  : INT_MIN32;
      }
    }
    __syncwarp();  // the rows and keys of this step before the next scan
    // multi-hit / >9 hits early return (mapping.rs:1341-1355)
    if (hcount > 9 || best_size > 1) {
      done = true;
      lane_steps = step + 1;
    }
  }
  if (!done) lane_steps = S;  // still live at the step budget: escalates
  __syncwarp();

  // --- the first H completions and their chains (0-terminated) ---
  const int MW = a.MW;
  for (int h = t; h < H; h += 32) {
    const size_t o = (size_t)lane * H + h;
    int* ops = a.h_ops + o * MW;
    int node = ROOT;
    if (h < hcount) {
      const int* row = st + (size_t)hs[h] * NF;
      a.h_score[o] = __int_as_float(row[F_SCOREBITS]);
      a.h_lower[o] = row[F_LOWER];
      a.h_lrev[o] = row[F_LREV];
      a.h_size[o] = row[F_SIZE];
      ops[0] = row[F_OP];
      node = row[F_PARENT];
    } else {
      a.h_score[o] = -__int_as_float(0x7f800000);
      a.h_lower[o] = 0;
      a.h_lrev[o] = 0;
      a.h_size[o] = 0;
      ops[0] = 0;
    }
    for (int i = 1; i < MW; ++i) {
      const bool at_root = node == ROOT;
      const int* e = st + (size_t)node * NF;
      ops[i] = at_root ? 0 : e[F_OP];
      node = at_root ? ROOT : e[F_PARENT];
    }
  }
  if (t == 0) {
    a.hcount[lane] = hcount;
    a.escalate[lane] = done ? 0 : 1;
    a.lane_steps[lane] = lane_steps;
    atomicMax(a.steps, lane_steps);
  }
}

extern "C" int search_batch(const BatchArgs* a, cudaStream_t stream) {
  if (a->L <= 0) return 0;
  LAUNCH(search_batch_kernel, (a->L + WARPS - 1) / WARPS, WARPS * 32, stream,
         *a);
  CHECK_LAUNCH();
  return 0;
}
