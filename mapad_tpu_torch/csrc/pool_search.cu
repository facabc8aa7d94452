// K2: the persistent best-first pool search, one step per launch pair,
// with K1 (occ4_warp, common.cuh) inline.
//
// Replaces mapad_tpu/ops/search_pool2.py `k_mismatch_search_pool2` setup
// and loop body (lines 99-612; the LUT/Bi-D rows come packed from the host
// or are assembled on the card after K7).  Plain version:
// ops/search_pool2.py `_pool_loop_plain`.
// Every kernel is a template on the interval type (common.cuh): int32, or
// int64 for a big index, whose frames carry three high words.  The lane
// kernel is also a template on the extension mode: backward-only (the aDNA
// model; one LUT row per step, no direction selects), or bidirectional
// (center-start models: the side with the shorter remainder is extended,
// which swaps the interval's two ends around K1 and takes the Bi-D bound
// from two more LUT rows).
//
// Design: the JAX loop carries every lane in lock step; here the step is a
// launch of `pool_lane_kernel` (one block per lane) followed by
// `pool_refill_kernel` (one block), because the refill of finished lanes
// is a lane-order exclusive scan across all lanes (search_pool2.py:558-560):
// an atomicAdd on next_read would hand out other read ids and slots.
// Both kernels return at once when the device done flag is set or the step
// budget is spent, so the host may queue steps ahead and poll the flag
// rarely; the step counter then stops exactly where the JAX while_loop
// stops (`step < limit && !all(lane_done)`; the limit is S, or what K8 set
// for a capped spill generation, csrc/pool_compact.cu).
//
// Bound on the card: the pop scan reads the lane's bm_key ring, 4 x RB
// bytes per lane per step (6.3 MB per step at L=512, CAP=3072, ~1.9 us at
// 3.35 TB/s; `consumed` is read at the popped slot only); the rest is a
// few dependent 32 B reads (store block, LUT row, two L2-resident occ
// rows) and a 288 B store write per lane (396 B with int64 intervals).  A
// first kernel that is right:
// the ring is not yet kept in shared memory and the steps are not yet a
// CUDA graph.
#include "common.cuh"

using namespace mapad;

static __global__ void pool_init_kernel(PoolArgs a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t ring = (size_t)a.L * a.RB;
  if (i < ring) {
    a.consumed[i] = 0;
    a.bm_key[i] = INT_MIN32;
  }
  if (i < (size_t)a.L) {
    const int l = (int)i, L = a.L, R = a.R;
    int* ls = a.lane;
    const int rid = l < R ? l : R;
    int rc = rid < R - 1 ? rid : R - 1;
    if (rc < 0) rc = 0;
    ls[LS_READ_ID * L + l] = rid;
    ls[LS_FRESH * L + l] = rid < R;
    ls[LS_DONE * L + l] = rid >= R;
    ls[LS_START * L + l] = 0;
    ls[LS_AGE * L + l] = 0;
    ls[LS_N * L + l] = a.n[rc];
    ls[LS_SPLIT * L + l] = a.split[rc];
    ls[LS_SCALE * L + l] = __float_as_int(a.scale[rc]);
    ls[LS_THRESH * L + l] = __float_as_int(a.thresh[rc]);
    ls[LS_REPR * L + l] = __float_as_int(a.repr[rc]);
    ls[LS_BEST * L + l] = __float_as_int(-__int_as_float(0x7f800000));
    ls[LS_BEST_SIZE * L + l] = 0;
    ls[LS_BEST_SIZE_HI * L + l] = 0;
    ls[LS_HCOUNT * L + l] = 0;
    ls[LS_FINISH * L + l] = 0;
    ls[LS_ACTIVE * L + l] = 0;
  }
  if (i == 0) {
    a.glob[G_STEP] = 0;
    a.glob[G_NEXT_READ] = a.L < a.R ? a.L : a.R;
    a.glob[G_DONE] = a.R == 0;
    a.glob[G_LIMIT] = a.S;
    a.glob[G_LIVE] = a.L < a.R ? a.L : a.R;
    for (int k = G_BASE; k < N_GLOB; ++k) a.glob[k] = 0;
  }
}

constexpr int LANE_THREADS = 256;

// best_size of a lane: two state rows (the high one is zero with int32)
template <typename I>
static __device__ __forceinline__ I best_size_get(const int* ls, int L,
                                                  int lane) {
  return (I)(((uint64_t)(uint32_t)ls[LS_BEST_SIZE_HI * L + lane] << 32) |
             (uint64_t)(uint32_t)ls[LS_BEST_SIZE * L + lane]);
}
template <typename I>
static __device__ __forceinline__ void best_size_put(int* ls, int L, int lane,
                                                     I v) {
  const uint64_t u = (uint64_t)(int64_t)v;
  ls[LS_BEST_SIZE * L + lane] = (int)(uint32_t)(u & 0xffffffffu);
  ls[LS_BEST_SIZE_HI * L + lane] = (int)(uint32_t)(u >> 32);
}

template <typename I, bool BIDIR>
static __global__ void __launch_bounds__(LANE_THREADS)
pool_lane_kernel(PoolArgs a) {
  constexpr int NFW = Idx<I>::NFW;
  constexpr int REC = CANDS * NFW;  // int32 words per store block
  const int step = a.glob[G_STEP];
  if (a.glob[G_DONE] || step >= a.glob[G_LIMIT]) return;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = a.L, S = a.S, RB = a.RB, M = a.M, R = a.R;
  int* ls = a.lane;
  __shared__ unsigned long long red[LANE_THREADS / 32];
  __shared__ I sh_occ[8];
  __shared__ int rec[REC];

  // --- pop: dense ring scan, key max then minimum ring age (LIFO) ---
  const int lane_start = ls[LS_START * L + lane];
  const int* bk = a.bm_key + (size_t)lane * RB;
  unsigned long long best = 0;
  for (int s = tid; s < RB; s += LANE_THREADS) {
    const int age = floor_mod(step - 1 - s, RB);
    const int t_s = step - 1 - age;
    const int key = bk[s];
    const int keym = (t_s >= lane_start && key > INT_MIN32) ? key : INT_MIN32;
    const unsigned long long v =
        ((unsigned long long)((unsigned)keym ^ 0x80000000u) << 32) |
        (unsigned)(RB - age);
    best = v > best ? v : best;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, d);
    best = o > best ? o : best;
  }
  if ((tid & 31) == 0) red[tid >> 5] = best;
  __syncthreads();

  // phase A (warps 0 and 1 redundantly): popped frame and K1 inputs
  int kstar = 0, astar = 0, cword = 0, off = 0, newkey = INT_MIN32;
  int read_id = 0, fresh = 0, active = 0, lane_age = 0, c_n = 0;
  float c_scale = 0.f, c_thresh = 0.f, c_repr = 0.f, best_score = 0.f;
  I best_size = 0;
  int hcount = 0, sel_slot = 0;
  bool popped = false, working = false, do_pop = false, finish_empty = false;
  float f_score = 0.f;
  I f_lower = 0, f_lrev = 0, f_size = 0;
  int f_start = 0, f_len = 0, gaps = 0, parent = 0, c_split = 0;
  bool fwd = false;  // bidirectional: extend forward (always false else)
  if (tid < 64) {
    unsigned long long b = red[0];
    for (int w = 1; w < LANE_THREADS / 32; ++w) b = red[w] > b ? red[w] : b;
    kstar = (int)((unsigned)(b >> 32) ^ 0x80000000u);
    astar = RB - (int)(unsigned)(b & 0xffffffffu);
    popped = kstar > INT_MIN32;
    const int pstep = step - 1 - astar;
    sel_slot = floor_mod(pstep, RB);
    cword = a.consumed[(size_t)lane * RB + sel_slot];
    read_id = ls[LS_READ_ID * L + lane];
    fresh = ls[LS_FRESH * L + lane];
    active = !ls[LS_DONE * L + lane];
    lane_age = ls[LS_AGE * L + lane];
    c_n = ls[LS_N * L + lane];
    c_split = ls[LS_SPLIT * L + lane];
    c_scale = __int_as_float(ls[LS_SCALE * L + lane]);
    c_thresh = __int_as_float(ls[LS_THRESH * L + lane]);
    c_repr = __int_as_float(ls[LS_REPR * L + lane]);
    best_score = __int_as_float(ls[LS_BEST * L + lane]);
    best_size = best_size_get<I>(ls, L, lane);
    hcount = ls[LS_HCOUNT * L + lane];
    finish_empty = active && !fresh && !popped;
    working = active && (fresh || popped);
    do_pop = working && !fresh;

    int blk_full = S - 1 - pstep;
    blk_full = blk_full < 0 ? 0 : (blk_full > S - 1 ? S - 1 : blk_full);
    // blocks of steps not yet run this invocation read as zero (the JAX
    // store starts zeroed; this store is reused uninitialised)
    const bool written = blk_full >= S - step;
    const int* brow = a.store + ((size_t)lane * (S + 1) + blk_full) * REC;
    int key9[CANDS];
    bool live9[CANDS];
    int f_mono = INT_MIN32;
#pragma unroll
    for (int c = 0; c < CANDS; ++c) {
      const int op = written ? brow[c * NFW + F_OP] : 0;
      const int sb = written ? brow[c * NFW + F_SCOREBITS] : 0;
      live9[c] = (op & OP_PUSHED_BIT) != 0 && ((cword >> c) & 1) == 0;
      key9[c] = live9[c] ? mono_bits(sb) : INT_MIN32;
      if (c == 0 || key9[c] > f_mono) {  // first max (argmax)
        f_mono = key9[c];
        off = c;
      }
    }
#pragma unroll
    for (int c = 0; c < CANDS; ++c)
      if (live9[c] && c != off && key9[c] > newkey) newkey = key9[c];
    int fr[NFW];
#pragma unroll
    for (int f = 0; f < NFW; ++f) fr[f] = written ? brow[off * NFW + f] : 0;
    f_score = fresh ? 0.0f : __int_as_float(mono_bits(f_mono));
    f_lower = fresh ? (I)0 : frame_get<I>(fr, F_LOWER);
    f_lrev = fresh ? (I)0 : frame_get<I>(fr, F_LREV);
    f_size = fresh ? (I)a.text_len : frame_get<I>(fr, F_SIZE);
    f_start = fresh ? c_split : (fr[F_STARTLEN] >> 16);
    f_len = fresh ? 0 : (fr[F_STARTLEN] & 0xFFFF);
    gaps = fresh ? 0 : fr[F_GAPS];
    parent = fresh ? S * CANDS : blk_full * CANDS + off;
    // a forward extension is a backward one of the reverse interval
    if (BIDIR) fwd = f_start <= c_n - f_start - f_len;
    const I ext_lower = fwd ? f_lrev : f_lower;
    // K1: warp 0 ranks the interval's lower end, warp 1 its upper end
    const I r1q = occ_query_lower<I>(ext_lower);
    const I r2q = occ_query_upper<I>(ext_lower, f_size);
    I occ[4];
    occ4_warp<I>(a.rows, a.nb, a.occ_k, tid < 32 ? r1q : r2q, occ);
    if ((tid & 31) == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sh_occ[(tid >> 5) * 4 + c] = occ[c];
    }
  }
  __syncthreads();

  if (tid == 0) {
    // consume the popped candidate (after every thread read the rings)
    if (do_pop) {
      a.consumed[(size_t)lane * RB + sel_slot] = cword | (1 << off);
      a.bm_key[(size_t)lane * RB + sel_slot] = newkey;
    }
    const int f_gapb = gaps & 3, f_gapf = (gaps >> 2) & 3,
              f_ngaps = (gaps >> 4) & 0xFF;
    const int nn = c_n;
    const int j = fwd ? f_start + f_len : f_start - 1;
    const int d_k = fwd ? f_start : f_start - 1;
    const int gap_state = fwd ? f_gapf : f_gapb;
    const float ins_score =
        (gap_state == GAP_INSERTION ? a.pge : a.pgo_pge) + f_score;
    const float del_score =
        (gap_state == GAP_DELETION ? a.pge : a.pgo_pge) + f_score;
    const int ngaps_inc = gap_state == GAP_CLOSED ? f_ngaps + 1 : f_ngaps;

    int rid_c = read_id < 0 ? 0 : (read_id > R - 1 ? R - 1 : read_id);
    const int j_c = j < 0 ? 0 : (j > M - 1 ? M - 1 : j);
    const float* row_j = a.slut + ((size_t)rid_c * M + j_c) * 6;
    float d_rev, d_fwd;
    if (BIDIR) {
      // the Bi-D bound of both remainders: rows d_k and t + split
      const int d_l = fwd ? f_start + f_len : f_start + f_len - 1;
      const int bk = d_k < 0 ? 0 : (d_k > M - 1 ? M - 1 : d_k);
      const int t = nn - (1 + d_l);
      int ci = t + c_split;
      ci = ci < 0 ? 0 : (ci > M - 1 ? M - 1 : ci);
      const float* rows_r = a.slut + (size_t)rid_c * M * 6;
      d_rev = (d_k >= 0 && d_k < nn) ? rows_r[(size_t)bk * 6 + 5] : 0.0f;
      d_fwd = (t >= 0 && t + c_split < nn) ? rows_r[(size_t)ci * 6 + 5]
                                            : 0.0f;
    } else {
      // d_k == j, and split == n makes the forward bound identically 0
      d_rev = (d_k >= 0 && d_k < nn) ? row_j[5] : 0.0f;
      d_fwd = 0.0f;
    }
    const float lb = d_rev + d_fwd;
    const float Sj[4] = {row_j[0], row_j[1], row_j[2], row_j[3]};
    const int pat_j = (int)row_j[4];

    const bool stop = (f_score + lb) < best_score + c_repr;
    const bool abandon = working && lane_age >= a.CAP;
    const bool finish_stop = working && stop && !abandon;
    const bool still = working && !stop && !abandon;

    I occ1[4], occ2[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      occ1[c] = sh_occ[c];
      occ2[c] = sh_occ[4 + c];
    }
    I ch_lower[4], ch_lrev[4], ch_size[4];
    extend_from_occ<I>((const I*)a.less, (const I*)a.sent,
                       fwd ? f_lrev : f_lower, fwd ? f_lower : f_lrev, f_size,
                       occ1, occ2, ch_lower, ch_lrev, ch_size);

    const int gde = a.gap_dist_ends;
    const bool ins_allowed = min(j, nn - j - 1) >= gde;
    const int d5 = fwd ? j : j + 1;
    const bool del_allowed = min(d5, nn - d5) >= gde;
    const int next_start = fwd ? f_start : f_start - 1;
    // the gap state of the side not extended rides along unchanged
    const int keep_b = fwd ? f_gapb : -1, keep_f = fwd ? -1 : f_gapf;
    auto gaps_word = [&](int state, int ng) {
      return (keep_b >= 0 ? keep_b : state) |
             ((keep_f >= 0 ? keep_f : state) << 2) | wshl(ng, 4);
    };
    const bool del_rej = ((del_score + lb) / c_scale) < c_thresh;
    const bool ins_rej = ((ins_score + lb) / c_scale) < c_thresh;
    const bool gaps_ok = ngaps_inc <= a.max_gaps;

    bool ok[CANDS];
    float score[CANDS];
    I lo[CANDS], lr[CANDS], sz[CANDS];
    int sl[CANDS], gp[CANDS], op[CANDS];
    ok[0] = still && !ins_rej && ins_allowed && gaps_ok;
    score[0] = ins_score;
    lo[0] = f_lower;
    lr[0] = f_lrev;
    sz[0] = f_size;
    sl[0] = wshl(next_start, 16) | (f_len + 1);
    gp[0] = gaps_word(GAP_INSERTION, ngaps_inc);
    op[0] = OP_VALID_BIT | (OP_INSERTION << 17) | (j_c << 2);
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) {
      const int code = fwd ? slot : 3 - slot;
      const bool nonzero = ch_size[slot] >= 1;
      const float mm_score = Sj[code] + f_score;
      const int kd = 1 + 2 * slot, km = 2 + 2 * slot;
      ok[kd] = still && nonzero && !del_rej && del_allowed && gaps_ok;
      score[kd] = del_score;
      sl[kd] = wshl(f_start, 16) | f_len;
      gp[kd] = gaps_word(GAP_DELETION, ngaps_inc);
      op[kd] = OP_VALID_BIT | (OP_DELETION << 17) | (j_c << 2) | code;
      ok[km] = still && nonzero && !(((mm_score + lb) / c_scale) < c_thresh);
      score[km] = mm_score;
      sl[km] = wshl(next_start, 16) | (f_len + 1);
      gp[km] = gaps_word(GAP_CLOSED, f_ngaps);
      op[km] = OP_VALID_BIT |
               ((code == pat_j ? OP_MATCH : OP_MISMATCH) << 17) |
               (j_c << 2) | code;
      lo[kd] = lo[km] = fwd ? ch_lrev[slot] : ch_lower[slot];
      lr[kd] = lr[km] = fwd ? ch_lower[slot] : ch_lrev[slot];
      sz[kd] = sz[km] = ch_size[slot];
    }

    // running best over the 9 candidates, in candidate order
    float run_best = best_score;
    I run_size = best_size;
    int n_comp = 0, mask = 0, ring_key = INT_MIN32;
#pragma unroll
    for (int k = 0; k < CANDS; ++k) {
      const bool ok_k = ok[k] && !(score[k] < run_best + c_repr);
      const bool comp = ok_k && (sl[k] & 0xFFFF) == nn;
      if (comp && score[k] > run_best) {
        run_size = sz[k];
        run_best = score[k];
      }
      const bool push = ok_k && !comp;
      op[k] |= (comp ? OP_COMP_BIT : 0) | (push ? OP_PUSHED_BIT : 0);
      bool record = comp;
      if (k == 0 && abandon) {
        op[0] = OP_VALID_BIT | OP_ABANDON_BIT;
        record = true;
      }
      if (record) {
        gp[k] = read_id;
        mask |= 1 << (CANDS - 1 - k);
      }
      n_comp += comp;
      if (push) {
        const int key = mono_bits(__float_as_int(score[k]));
        ring_key = key > ring_key ? key : ring_key;
      }
      // stored position 8-k: the block's candidates are kept reversed
      int* e = rec + (CANDS - 1 - k) * NFW;
      frame_put(e, F_LOWER, lo[k]);
      frame_put(e, F_LREV, lr[k]);
      frame_put(e, F_SIZE, sz[k]);
      e[F_PARENT] = parent;
      e[F_STARTLEN] = sl[k];
      e[F_GAPS] = gp[k];
      e[F_OP] = op[k];
      e[F_SCOREBITS] = __float_as_int(score[k]);
    }
    const int blk = S - 1 - step;
    a.bmask[(size_t)lane * S + blk] = mask;
    const int ring_slot = step % RB;
    a.bm_key[(size_t)lane * RB + ring_slot] = ring_key;
    a.consumed[(size_t)lane * RB + ring_slot] = 0;

    hcount += n_comp;
    const bool finish_hits = still && (hcount > 9 || run_size > 1);
    const bool finish = finish_empty || finish_stop || finish_hits || abandon;
    ls[LS_BEST * L + lane] = __float_as_int(run_best);
    best_size_put<I>(ls, L, lane, run_size);
    ls[LS_HCOUNT * L + lane] = hcount;
    ls[LS_FRESH * L + lane] = 0;
    ls[LS_FINISH * L + lane] = finish;
    ls[LS_ACTIVE * L + lane] = active;
  }
  __syncthreads();
  if (tid < REC)
    a.store[((size_t)lane * (S + 1) + (S - 1 - step)) * REC + tid] = rec[tid];
  static_assert(REC <= LANE_THREADS, "one thread per store word");
}

constexpr int REFILL_THREADS = 1024;

static __global__ void __launch_bounds__(REFILL_THREADS)
pool_refill_kernel(PoolArgs a) {
  const int step = a.glob[G_STEP];
  if (a.glob[G_DONE] || step >= a.glob[G_LIMIT]) return;
  __shared__ int scan[REFILL_THREADS];
  const int t = threadIdx.x, L = a.L, R = a.R;
  int* ls = a.lane;
  const int fin = t < L ? ls[LS_FINISH * L + t] : 0;
  scan[t] = fin;
  __syncthreads();
  for (int d = 1; d < REFILL_THREADS; d <<= 1) {
    const int v = t >= d ? scan[t - d] : 0;
    __syncthreads();
    scan[t] += v;
    __syncthreads();
  }
  const int rank = scan[t] - fin;  // lane-order exclusive scan
  const int total = scan[REFILL_THREADS - 1];
  const int next_read = a.glob[G_NEXT_READ];
  int done_l = 1;
  if (t < L) {
    const int read_id = ls[LS_READ_ID * L + t];
    const int active = ls[LS_ACTIVE * L + t];
    const int age = ls[LS_AGE * L + t];
    int lane_done = ls[LS_DONE * L + t];
    const int new_rid = next_read + rank;
    if (a.track) {
      const int rid = read_id < 0 ? 0 : (read_id > R ? R : read_id);
      const int used = age + active < 4095 ? age + active : 4095;
      a.fin_log[(size_t)t * a.S + step] = fin ? rid * 4096 + used : -1;
    }
    if (fin) {
      ls[LS_READ_ID * L + t] = new_rid < R ? new_rid : R;
      ls[LS_START * L + t] = step + 1;
      ls[LS_AGE * L + t] = 0;
      ls[LS_BEST * L + t] = __float_as_int(-__int_as_float(0x7f800000));
      ls[LS_BEST_SIZE * L + t] = 0;
      ls[LS_BEST_SIZE_HI * L + t] = 0;
      ls[LS_HCOUNT * L + t] = 0;
      const bool got = new_rid < R;
      ls[LS_N * L + t] = got ? a.n[new_rid] : 0;
      ls[LS_SPLIT * L + t] = got ? a.split[new_rid] : 0;
      ls[LS_SCALE * L + t] = got ? __float_as_int(a.scale[new_rid]) : 0;
      ls[LS_THRESH * L + t] = got ? __float_as_int(a.thresh[new_rid]) : 0;
      ls[LS_REPR * L + t] = got ? __float_as_int(a.repr[new_rid]) : 0;
      if (!got) lane_done = 1;
      ls[LS_FRESH * L + t] = got;
    } else {
      ls[LS_AGE * L + t] = age + active;
      ls[LS_FRESH * L + t] = 0;
    }
    ls[LS_DONE * L + t] = lane_done;
    done_l = lane_done;
  }
  const int live = __syncthreads_count(!done_l);
  if (t == 0) {
    const int nr = next_read + total;
    a.glob[G_NEXT_READ] = nr < R ? nr : R;
    a.glob[G_STEP] = step + 1;
    a.glob[G_LIVE] = live;
    if (live == 0) a.glob[G_DONE] = 1;
  }
}

// K1 alone: one block of two warps per lane (rank of each interval end),
// then the extension sweep.  Used only to check K1 against its plain
// version (ops/fm.py extend_batch); the pool search calls occ4_warp inline.
template <typename I>
static __global__ void k1_extend_kernel(const int* rows, const I* less,
                                        const I* sent, int nb, int occ_k,
                                        const I* lower, const I* lrev,
                                        const I* size, I* out_lower,
                                        I* out_lrev, I* out_size) {
  const int l = blockIdx.x, tid = threadIdx.x;
  __shared__ I occ_s[8];
  const I lw = lower[l], sz = size[l];
  const I q = tid < 32 ? occ_query_lower<I>(lw) : occ_query_upper<I>(lw, sz);
  I occ[4];
  occ4_warp<I>(rows, nb, occ_k, q, occ);
  if ((tid & 31) == 0)
    for (int c = 0; c < 4; ++c) occ_s[(tid >> 5) * 4 + c] = occ[c];
  __syncthreads();
  if (tid == 0) {
    I cl[4], cr[4], cs[4];
    extend_from_occ<I>(less, sent, lw, lrev[l], sz, occ_s, occ_s + 4, cl, cr,
                       cs);
    for (int s = 0; s < 4; ++s) {
      out_lower[l * 4 + s] = cl[s];
      out_lrev[l * 4 + s] = cr[s];
      out_size[l * 4 + s] = cs[s];
    }
  }
}

extern "C" int pool_init(const PoolArgs* a, cudaStream_t stream) {
  const size_t n = (size_t)a->L * a->RB > (size_t)a->L
                       ? (size_t)a->L * a->RB : (size_t)a->L;
  LAUNCH(pool_init_kernel, (unsigned)((n + 255) / 256), 256, stream, *a);
  CHECK_LAUNCH();
  return 0;
}

extern "C" int pool_steps(const PoolArgs* a, int nsteps,
                          cudaStream_t stream) {
  void (*lane_kernel)(PoolArgs) =
      a->big ? (a->bidir ? pool_lane_kernel<int64_t, true>
                         : pool_lane_kernel<int64_t, false>)
             : (a->bidir ? pool_lane_kernel<int32_t, true>
                         : pool_lane_kernel<int32_t, false>);
  for (int i = 0; i < nsteps; ++i) {
    LAUNCH(lane_kernel, a->L, LANE_THREADS, stream, *a);
    CHECK_LAUNCH();
    LAUNCH(pool_refill_kernel, 1, REFILL_THREADS, stream, *a);
    CHECK_LAUNCH();
  }
  return 0;
}

extern "C" int k1_extend_batch(const int* rows, const void* less,
                               const void* sent, int nb, int occ_k, int big,
                               const void* lower, const void* lrev,
                               const void* size, void* out_lower,
                               void* out_lrev, void* out_size, int L,
                               cudaStream_t stream) {
  if (L <= 0) return 0;
  if (big) {
    using I = int64_t;
    LAUNCH(k1_extend_kernel<I>, L, 64, stream, rows, (const I*)less,
           (const I*)sent, nb, occ_k, (const I*)lower, (const I*)lrev,
           (const I*)size, (I*)out_lower, (I*)out_lrev, (I*)out_size);
  } else {
    using I = int32_t;
    LAUNCH(k1_extend_kernel<I>, L, 64, stream, rows, (const I*)less,
           (const I*)sent, nb, occ_k, (const I*)lower, (const I*)lrev,
           (const I*)size, (I*)out_lower, (I*)out_lrev, (I*)out_size);
  }
  CHECK_LAUNCH();
  return 0;
}
