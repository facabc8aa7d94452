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
// in registers (redundantly, like K7's walks), but split a step's
// candidates: the six cutoff tests (one IEEE division each) run one a
// thread and a ballot gathers them, every thread runs reject_iterative on
// the resulting bit masks, and thread t < 9 builds and stores the row and
// key of slot ROOT - 9(s+1) + t.  The launch plan
// (ops/search.py `batch_plan`) gives a block `lanes_per_block` warps and
// each warp `lane_smem` bytes of dynamic shared memory.
//
// The pop has two levels.  The key array (global memory) is cut into
// chunks of C = 2^k consecutive slots (C >= 32, larger for a long store so
// that a lane keeps at most 1,024 chunks), and each lane keeps in shared
// memory the maximum of every chunk as the u64 (key ^ 2^31) << 32 |
// (ROOT - slot): the key first, then the lowest slot, so ties across
// chunks still go to the lowest slot.  A chunk that holds no key yet, or
// only INT_MIN keys, reads as key INT_MIN.  A pop is a warp max over the
// maxima of the chunks the store has reached; its slot is the popped one,
// so the popped row and the popped chunk's C keys are read at once, and
// the chunk's new maximum (the popped slot and the slots not yet written
// left out: the key scratch is never initialised) is reduced from those
// keys.  The 9 new keys of a step are contiguous, so they land in one or
// two chunks, whose maxima take them after the popped chunk's update.
// Completed and rejected candidates write INT_MIN and so never raise a
// maximum.  The lane's code, score-LUT and Bi-D rows are staged in shared
// memory when the lane starts (24 B a position), so after the popped row a
// step reads only K1's two index rows from global memory, in one
// `occ4_pair` (the two halves of the warp rank the interval's two ends at
// once).
//
// Bound on the card: bytes -- the inputs once (24 B a cell), per lane-step
// the popped row, 9 rows and 9 keys written (356 B) and K1's two index
// rows (the whole index at most), the outputs once.  The popped chunk's C
// keys (4C B a pop) are this kernel's own traffic beyond that.  f32
// arithmetic: --fmad=false, IEEE division (`reject`), the JAX op order.
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

// the launch plan (ops/search.py BatchPlan): a lane's shared memory is its
// chunk maxima (u64, `chunks` of them), then the score LUT (M x 4 f32),
// the Bi-D row (M f32) and the codes (M i32), `lane_smem` bytes in all
struct BatchPlan {
  int lanes_per_block, blocks, chunk, chunks, lane_smem, smem, resident;
};

// at most this many lanes (warps) a block (ops/search.py batch_plan)
constexpr int MAX_LANES_PER_BLOCK = 16;

// a slot's pop key: the monotone key, then the lowest slot
static __device__ __forceinline__ unsigned long long pop_key(int key,
                                                            int rslot) {
  return ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
         (unsigned)rslot;
}

static __device__ __forceinline__ unsigned long long warp_max(
    unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, d);
    v = o > v ? o : v;
  }
  return v;
}

static __global__ void __launch_bounds__(MAX_LANES_PER_BLOCK * 32)
search_batch_kernel(BatchArgs a, BatchPlan p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int w = threadIdx.x >> 5;
  const int lane = blockIdx.x * p.lanes_per_block + w;
  const int t = threadIdx.x & 31;
  if (lane >= a.L) return;  // the whole warp
  const int S = a.S, M = a.M, H = a.H;
  const int SLOTS = S * CANDS + 1, ROOT = SLOTS - 1;
  const int CW = p.chunk, NC = p.chunks;
  const int csh = __ffs(CW) - 1;  // C is a power of two
  int* st = a.store + (size_t)lane * SLOTS * NF;
  int* key = a.keys + (size_t)lane * SLOTS;
  int* hs = a.hit_slot + (size_t)lane * H;
  unsigned char* mine = dyn + (size_t)w * p.lane_smem;
  unsigned long long* cmax = reinterpret_cast<unsigned long long*>(mine);
  float* s_slut = reinterpret_cast<float*>(mine + (size_t)8 * NC);
  float* s_bid = s_slut + (size_t)4 * M;
  int* s_code = reinterpret_cast<int*>(s_bid + M);
  const int nn = a.n[lane], sp = a.split[lane];
  const float c_scale = a.scale[lane], c_thresh = a.thresh[lane],
              c_repr = a.repr[lane];

  // --- the lane's inputs on chip, every chunk empty ---
  {
    const float* slut_row = a.slut + (size_t)lane * M * 4;
    const float* bid_row = a.bid + (size_t)lane * M;
    const int* code_row = a.code + (size_t)lane * M;
    for (int i = t; i < 4 * M; i += 32) s_slut[i] = slut_row[i];
    for (int i = t; i < M; i += 32) {
      s_bid[i] = bid_row[i];
      s_code[i] = code_row[i];
    }
    for (int c = t; c < NC; c += 32) cmax[c] = 0;
  }
  if (t < NF) {
    // the root frame: whole text, empty match at the alignment start
    const int root[NF] = {0, 0, a.text_len, 0, wshl(sp, 16), 0, 0, 0};
#pragma unroll
    for (int f = 0; f < NF; ++f)
      if (t == f) st[(size_t)ROOT * NF + f] = root[f];
    if (t == 0) key[ROOT] = 0;  // the key of 0.0f
  }
  __syncwarp();
  if (t == 0) cmax[ROOT >> csh] = pop_key(0, 0);
  __syncwarp();

  bool done = nn <= 0;
  float best_score = -__int_as_float(0x7f800000);
  int best_size = 0, hcount = 0, lane_steps = 0;
  for (int step = 0; !done && step < S; ++step) {
    // --- pop, level 1: the max over the chunks the store has reached ---
    const int lo = ROOT - CANDS * step;  // the lowest written slot
    unsigned long long best = 0;
#pragma unroll 4
    for (int c = (lo >> csh) + t; c < NC; c += 32) {
      const unsigned long long v = cmax[c];
      best = v > best ? v : best;
    }
    best = warp_max(best);
    const int f_mono = (int)((unsigned)(best >> 32) ^ 0x80000000u);
    const int sel = ROOT - (int)(unsigned)(best & 0xffffffffu);
    if (f_mono == INT_MIN32) {  // nothing left to pop
      done = true;
      lane_steps = step + 1;
      break;
    }
    // --- level 2, beside the popped row's read: the popped chunk's keys,
    // its new maximum without the popped slot ---
    const int* fr = st + (size_t)sel * NF;
    const int f_lower = fr[F_LOWER], f_lrev = fr[F_LREV], f_size = fr[F_SIZE];
    const int f_startlen = fr[F_STARTLEN], gaps = fr[F_GAPS];
    const int c0 = (sel >> csh) << csh;
    unsigned long long rest = 0;
    for (int i = t; i < CW; i += 32) {
      const int s = c0 + i;
      const bool live = s >= lo && s <= ROOT && s != sel;
      const unsigned long long v = pop_key(live ? key[s] : INT_MIN32,
                                           ROOT - s);
      rest = v > rest ? v : rest;
    }
    rest = warp_max(rest);
    __syncwarp();  // every thread has read the popped row and the chunk
    if (t == 0) {
      key[sel] = INT_MIN32;
      cmax[sel >> csh] = rest;
    }
    const int f_start = f_startlen >> 16, f_len = f_startlen & 0xFFFF;
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

    // --- K1: the two halves of the warp rank the interval's two ends ---
    int occ1[4], occ2[4];
    occ4_pair<int>(a.rows, a.nb, a.occ_k, occ_query_lower<int>(ext_lower),
                   occ_query_upper<int>(ext_lower, f_size), occ1, occ2);

    // the LUT and Bi-D rows from shared memory
    const int j_c = j < 0 ? 0 : (j > M - 1 ? M - 1 : j);
    const float Sj[4] = {s_slut[j_c * 4 + 0], s_slut[j_c * 4 + 1],
                         s_slut[j_c * 4 + 2], s_slut[j_c * 4 + 3]};
    const int pat_j = s_code[j_c];
    // bi_d_get: the bound of both remainders
    const int bk = d_k < 0 ? 0 : (d_k > M - 1 ? M - 1 : d_k);
    const int tt = nn - (1 + d_l);
    const int ci = tt + sp;
    const int ci_c = ci < 0 ? 0 : (ci > M - 1 ? M - 1 : ci);
    const float d_rev = (d_k >= 0 && d_k < nn) ? s_bid[bk] : 0.0f;
    const float d_fwd = (tt >= 0 && ci < nn) ? s_bid[ci_c] : 0.0f;
    const float lb = d_rev + d_fwd;

    // best-first global stop (mapping.rs:1201-1208)
    if ((f_score + lb) < best_score + c_repr) {
      done = true;
      lane_steps = step + 1;
      break;
    }

    int ch_lower[4], ch_lrev[4], ch_size[4];
    extend_from_occ<int>(a.less, a.sent, ext_lower, ext_lrev, f_size, occ1,
                         occ2, ch_lower, ch_lrev, ch_size);

    const int gde = a.gap_dist_ends;
    const bool ins_allowed = min(j, nn - j - 1) >= gde;
    const int d5 = fwd ? j : j + 1;
    const bool del_allowed = min(d5, nn - d5) >= gde;
    const int next_start = fwd ? f_start : f_start - 1;
    const bool gaps_ok = ngaps_inc <= a.max_gaps;
    // the gap state of the side not extended rides along unchanged
    auto gaps_word = [&](int state, int ng) {
      return (fwd ? f_gapb : state) | ((fwd ? state : f_gapf) << 2) |
             wshl(ng, 4);
    };
    // the match/mismatch score of each child slot (symbol fwd ? slot : 3 -
    // slot)
    float mm_score[4];
#pragma unroll
    for (int slot = 0; slot < 4; ++slot)
      mm_score[slot] = Sj[fwd ? slot : 3 - slot] + f_score;

    // --- the cutoff of the six distinct scores, one a thread (0 the
    // deletion, 1 the insertion, 2 + slot a slot's match/mismatch), in one
    // IEEE division each; a ballot gathers the rejections ---
    const int q = t < 6 ? t : 0;
    const float sq = q == 0   ? del_score
                     : q == 1 ? ins_score
                     : q == 2 ? mm_score[0]
                     : q == 3 ? mm_score[1]
                     : q == 4 ? mm_score[2]
                              : mm_score[3];
    const unsigned rej =
        __ballot_sync(0xffffffffu, ((sq + lb) / c_scale) < c_thresh);

    // --- the 9 candidates (order: ins, then (del, mm) per slot): which
    // pass the cutoff, then reject_iterative in candidate order
    // (mapping.rs:956-963), in every thread ---
    unsigned pass = !(rej & 2u) && ins_allowed && gaps_ok ? 1u : 0u;
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) {
      const bool nonzero = ch_size[slot] >= 1;
      if (nonzero && !(rej & 1u) && del_allowed && gaps_ok)
        pass |= 1u << (1 + 2 * slot);
      if (nonzero && !((rej >> (2 + slot)) & 1u)) pass |= 1u << (2 + 2 * slot);
    }
    const bool len_del = (f_len & 0xFFFF) == nn,
               len_ext = ((f_len + 1) & 0xFFFF) == nn;
    // the rows go reversed: candidate k at base + 8 - k; the new keys'
    // maxima of the (one or two) chunks they land in
    const int base = ROOT - (step + 1) * CANDS;
    const int c_lo = base >> csh;
    unsigned long long new_lo = 0, new_hi = 0;
    unsigned kept = 0, comps = 0;
    const int hits_before = hcount;
#pragma unroll
    for (int k = 0; k < CANDS; ++k) {
      const float sk = k == 0 ? ins_score
                              : ((k & 1) ? del_score : mm_score[(k - 2) >> 1]);
      const bool ok_k = ((pass >> k) & 1u) && !(sk < best_score + c_repr);
      const bool comp = ok_k && ((k & 1) ? len_del : len_ext);
      if (comp && sk > best_score) {
        best_size = k == 0 ? f_size : ch_size[(k - 1) >> 1];
        best_score = sk;
      }
      kept |= ok_k ? 1u << k : 0u;
      comps |= comp ? 1u << k : 0u;
      const int slot = base + CANDS - 1 - k;
      const unsigned long long v = pop_key(
          ok_k && !comp ? mono_bits(__float_as_int(sk)) : INT_MIN32,
          ROOT - slot);
      if ((slot >> csh) == c_lo)
        new_lo = v > new_lo ? v : new_lo;
      else
        new_hi = v > new_hi ? v : new_hi;
    }
    hcount += __popc(comps);

    // --- thread t writes slot base + t: candidate k = 8 - t, its row, its
    // key and, where it completes, its place among the hits ---
    if (t < CANDS) {
      const int k = CANDS - 1 - t, slot = base + t;
      const bool ins = k == 0, del = k & 1;
      const int cs = ins ? 0 : (k - 1) >> 1;  // the child slot
      const int code = fwd ? cs : 3 - cs;
      int c_lower = ch_lower[0], c_lrev = ch_lrev[0], c_size = ch_size[0];
      float c_mm = mm_score[0];
#pragma unroll
      for (int s = 1; s < 4; ++s)
        if (cs == s) {
          c_lower = ch_lower[s];
          c_lrev = ch_lrev[s];
          c_size = ch_size[s];
          c_mm = mm_score[s];
        }
      const float sc = ins ? ins_score : (del ? del_score : c_mm);
      const bool comp = (comps >> k) & 1u;
      const int op =
          OP_VALID_BIT | (j_c << 2) |
          (ins ? OP_INSERTION << 17
               : (del ? (OP_DELETION << 17)
                      : ((code == pat_j ? OP_MATCH : OP_MISMATCH) << 17)) |
                     code);
      int4* row = reinterpret_cast<int4*>(st + (size_t)slot * NF);
      row[0] = make_int4(ins ? f_lower : (fwd ? c_lrev : c_lower),
                         ins ? f_lrev : (fwd ? c_lower : c_lrev),
                         ins ? f_size : c_size, sel);
      row[1] = make_int4(
          del ? wshl(f_start, 16) | f_len : wshl(next_start, 16) | (f_len + 1),
          ins ? gaps_word(GAP_INSERTION, ngaps_inc)
              : (del ? gaps_word(GAP_DELETION, ngaps_inc)
                     : gaps_word(GAP_CLOSED, f_ngaps)),
          op | (comp ? OP_COMP_BIT : 0), __float_as_int(sc));
      key[slot] = ((kept >> k) & 1u) && !comp ? mono_bits(__float_as_int(sc))
                                             : INT_MIN32;
      if (comp) {
        const int h = hits_before + __popc(comps & ((1u << k) - 1u));
        if (h < H) hs[h] = slot;
      }
    }
    // after the popped chunk's update (the same thread, in order): a new
    // key may land in the popped slot's chunk
    if (t == 0) {
      unsigned long long* m = cmax + c_lo;
      if (new_lo > m[0]) m[0] = new_lo;
      if (((base + CANDS - 1) >> csh) != c_lo && new_hi > m[1])
        m[1] = new_hi;
    }
    __syncwarp();  // the rows, keys and maxima of this step before the next
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

// The card's figures for the plan: SMs, the shared memory a block may opt
// into, an SM's shared memory, the kernel's static shared memory and the
// runtime's reserve a block.  Lets the kernel take all the dynamic shared
// memory a block may have (the same value from every caller, so two host
// threads never race on it).
extern "C" int batch_card(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &out[2], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[4],
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, search_batch_kernel);
  if (e == cudaSuccess) {
    out[3] = (int)fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(search_batch_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out[1] - out[3]);
  }
  return (int)e;
}

// blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that one SM holds at once (after batch_card)
extern "C" int batch_occupancy(int threads, int smem, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, search_batch_kernel, threads, (size_t)smem);
}

// One launch runs every lane to its end.  A launch the card refuses
// returns its error; nothing else is tried.
extern "C" int search_batch(const BatchArgs* a, const BatchPlan* plan,
                            cudaStream_t stream) {
  if (a->L <= 0) return 0;
  search_batch_kernel<<<plan->blocks, plan->lanes_per_block * 32,
                        (size_t)plan->smem, stream>>>(*a, *plan);
  CHECK_LAUNCH();
  return 0;
}
