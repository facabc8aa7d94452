// K2: the persistent best-first pool search, one cooperative launch a
// store generation, with K1 (occ4_pair, common.cuh) inline.
//
// Replaces mapad_tpu/ops/search_pool2.py `k_mismatch_search_pool2` setup
// and loop body (lines 99-612, the refill 558-576; the LUT/Bi-D rows come
// packed from the host or are assembled on the card after K7).  Plain
// version: ops/search_pool2.py `_pool_loop_plain`.
// The kernel is a template on the interval type (common.cuh): int32, or
// int64 for a big index, whose frames carry three high words; and on the
// extension mode: backward-only (the aDNA model; one LUT row per step, no
// direction selects), or bidirectional (center-start models: the side with
// the shorter remainder is extended, which swaps the interval's two ends
// around K1 and takes the Bi-D bound from two more LUT rows).
//
// Design: the JAX loop carries every lane in lock step and refills the
// lanes that finished in lane order (an exclusive scan of the finish flags
// hands out the next read ids; an atomicAdd would hand out others).  Here
// one cooperative launch runs every step of a store generation: a warp
// carries a lane, a block `lanes_per_block` lanes, and the grid, all
// co-resident, carries the L lanes (the plan: ops/search_pool2.py
// `pool_plan`).  A step of a lane: the pop (the lane's ring of block keys,
// scanned over the ages of its read's steps only: max key, then minimum
// ring age), the popped block staged in shared memory (the first max
// candidate and the next key of the block), K1's two rank queries in the
// two halves of the warp with the LUT/Bi-D row loads in flight beside
// them, the 9 candidates on lanes 0-8 of the warp, the running best a
// short serial pass over them in candidate order (the f32 results and
// tie-breaks of the plain version), the block written to the store.
//
// The refill sits behind the one grid barrier a step, and the barrier is
// the refill's own data: each block writes how many of its lanes finished,
// tagged with the step (a tag that never repeats in an invocation: the
// step plus the steps K8 compacted away, plus one), into a slot
// double-buffered by step parity; warp 0 of every block reads all the
// slots until each carries this step's tag, and sums the counts of the
// blocks before it and of all.  So every block carries the same next read,
// step, live count and done state, and each lane takes its rank (the
// block's offset plus its finished warps before it), its new read and its
// consts in registers.  No block reads anything else another block wrote
// while the kernel runs, so the barrier needs no acquire, and the SM's L1
// keeps the lane's own store blocks (the popped block, written a step or
// a few before, hits there).  On an H100 the step ran 0.6-0.7 us faster
// than with a cooperative-groups grid sync, its popped-block read in half
// the cycles (PERF.md).  A block overwrites a slot only two steps
// later, after every block has read it.
//
// Lane state lives in registers for the whole generation; the key ring in
// shared memory where the plan places it (else, the same body, in global
// memory); `consumed` stays in global memory (read at the popped slot
// only).  Launch and exit move the lane state rows, the rings and the
// counters between the PoolArgs buffers and the chip, so K3 and K8
// (between launches) read and rewrite what they always did; block 0
// writes glob[].  The loop stops exactly where the JAX while_loop stops:
// `step < limit && !all(lane_done)` (the limit is S, or what K8 set for a
// capped spill generation, csrc/pool_compact.cu); with PoolConfig's
// debug_fixed_steps (one generation only) at `step < min(S, fixed)`, the
// steps past the last lane's end run as every done lane's step does.  Each
// step keeps its own barrier tag either way.
//
// Bound on the card: the bytes that must cross HBM, the inputs once and a
// 288 B store block (396 B with int64 intervals), a mask and a finish-log
// word per lane a step; the ring stays on chip where it fits.  In
// practice the step is a chain of dependent reads (the popped block, then
// the index rows and the LUT row) and the grid barrier: P1
// (csrc/probe_dma.cu), a gather and a grid sync a step without the work,
// is its floor.
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
    a.glob[G_LIMIT] = a.fixed > 0 && a.fixed < a.S ? a.fixed : a.S;
    a.glob[G_LIVE] = a.L < a.R ? a.L : a.R;
    for (int k = G_BASE; k < N_GLOB; ++k) a.glob[k] = 0;
  }
}

// at most this many lanes (warps) a block (ops/search_pool2.py pool_plan),
// and blocks a grid (a lane a block at the most lanes)
constexpr int MAX_LANES_PER_BLOCK = 16;
constexpr int MAX_BLOCKS = 1024;
// a lane's staging in shared memory: the popped block and the block it
// writes, at the widest frames
constexpr int STAGE_WORDS = 2 * CANDS * (NF + 3);

// the launch plan (ops/search_pool2.py PoolPlan)
struct PoolPlan {
  int lanes_per_block, blocks, ring_shared, smem;
};

// the lane state a warp carries through a generation in registers (every
// lane of the warp holds the same values)
template <typename I>
struct Lane {
  int read_id, fresh, done, start, age, n, split, hcount, finish, active;
  float scale, thresh, repr, best;
  I best_size;
};

template <typename I>
static __device__ __forceinline__ I shfl_i(I v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

// The pop's scan of a lane's key ring over the ages 0..lim of its read's
// steps (age a lives in slot (p - a) mod RB), by one warp: each lane takes
// every 32nd age in increasing order into four running bests (whole groups
// of four ages, then the rest into the first), keeping the first of equal
// keys (the minimum age), with selects and no branch.  Returns the lane's
// best packed as (key ^ 2^31) << 32 | (RB - age), or (0, RB), the empty pop
// (key INT_MIN at age 0), where no key is set.  Called with the ring in
// shared or in global memory, so that each has its own loads.
static __device__ __forceinline__ void pop_take(const int* ring, int p,
                                                int RB, int age, int& bk,
                                                int& ba) {
  int s = p - age;
  s += s < 0 ? RB : 0;
  const int key = ring[s];
  const bool up = key > bk;
  ba = up ? age : ba;
  bk = up ? key : bk;
}

static __device__ __forceinline__ unsigned long long pop_scan(
    const int* ring, int p, int lim, int RB, int tl) {
  int bk[4] = {INT_MIN32, INT_MIN32, INT_MIN32, INT_MIN32};
  int ba[4] = {0, 0, 0, 0};
  int age = tl;
  for (; age + 96 <= lim; age += 128) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pop_take(ring, p, RB, age + 32 * q, bk[q], ba[q]);
  }
  for (; age <= lim; age += 32) pop_take(ring, p, RB, age, bk[0], ba[0]);
  unsigned long long best = (unsigned)RB;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned long long v =
        ((unsigned long long)((unsigned)bk[q] ^ 0x80000000u) << 32) |
        (unsigned)(RB - ba[q]);
    best = v > best ? v : best;
  }
  return best;
}

template <typename I, bool BIDIR>
static __global__ void __launch_bounds__(MAX_LANES_PER_BLOCK * 32)
pool_search_kernel(PoolArgs a, int* flags, int ring_shared) {
  constexpr int NFW = Idx<I>::NFW;
  constexpr int REC = CANDS * NFW;  // int32 words per store block
  extern __shared__ int dyn[];      // [rings (lpb, RB)] | (lpb, STAGE_WORDS)
  // refill, by step parity: each lane's finish flag, and the finished
  // lanes before this block's first lane and in all
  __shared__ int sh_fin[2][MAX_LANES_PER_BLOCK];
  __shared__ int sh_before[2], sh_total[2];
  const int w = threadIdx.x >> 5, tl = threadIdx.x & 31;
  const int lpb = blockDim.x >> 5;
  const int lane0 = blockIdx.x * lpb;
  const int lane = lane0 + w;
  const int L = a.L, S = a.S, RB = a.RB, M = a.M, R = a.R;
  const bool has_lane = lane < L;
  const int l_c = has_lane ? lane : L - 1;
  const int Lpad = (L + 3) & ~3;
  int* ls = a.lane;
  int* ring = ring_shared ? dyn + (size_t)w * RB : a.bm_key + (size_t)l_c * RB;
  int* stage_in = dyn + (ring_shared ? (size_t)lpb * RB : 0) +
                  (size_t)w * STAGE_WORDS;
  int* stage_out = stage_in + CANDS * (NF + 3);
  int* consumed = a.consumed + (size_t)l_c * RB;
  int* store = a.store + (size_t)l_c * (S + 1) * REC;

  Lane<I> st;
  st.read_id = ls[LS_READ_ID * L + l_c];
  st.fresh = ls[LS_FRESH * L + l_c];
  st.done = ls[LS_DONE * L + l_c];
  st.start = ls[LS_START * L + l_c];
  st.age = ls[LS_AGE * L + l_c];
  st.n = ls[LS_N * L + l_c];
  st.split = ls[LS_SPLIT * L + l_c];
  st.scale = __int_as_float(ls[LS_SCALE * L + l_c]);
  st.thresh = __int_as_float(ls[LS_THRESH * L + l_c]);
  st.repr = __int_as_float(ls[LS_REPR * L + l_c]);
  st.best = __int_as_float(ls[LS_BEST * L + l_c]);
  st.best_size =
      (I)(((uint64_t)(uint32_t)ls[LS_BEST_SIZE_HI * L + l_c] << 32) |
          (uint64_t)(uint32_t)ls[LS_BEST_SIZE * L + l_c]);
  st.hcount = ls[LS_HCOUNT * L + l_c];
  st.finish = ls[LS_FINISH * L + l_c];
  st.active = ls[LS_ACTIVE * L + l_c];
  if (ring_shared && has_lane)
    for (int s = tl; s < RB; s += 32) ring[s] = a.bm_key[(size_t)lane * RB + s];
  int step = a.glob[G_STEP], next_read = a.glob[G_NEXT_READ];
  int gdone = a.glob[G_DONE], live = a.glob[G_LIVE];
  const int limit = a.glob[G_LIMIT], cum = a.glob[G_CUM];
  __syncthreads();

  while (step < limit && (a.fixed > 0 || !gdone)) {
    const int par = step & 1;
    if (has_lane) {
      const int active = !st.done;
      // --- pop: the ring over the ages of this read's steps (a step t
      // lives in slot t mod RB), key max then minimum age ---
      const int p = floor_mod(step - 1, RB);
      const int lim = min(step - 1 - st.start, RB - 1);
      unsigned long long best =
          ring_shared ? pop_scan(dyn + (size_t)w * RB, p, lim, RB, tl)
                      : pop_scan(ring, p, lim, RB, tl);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, d);
        best = o > best ? o : best;
      }
      const int kstar = (int)((unsigned)(best >> 32) ^ 0x80000000u);
      const int astar = RB - (int)(unsigned)(best & 0xffffffffu);
      const bool popped = kstar > INT_MIN32;
      const int pstep = step - 1 - astar;
      const int sel_slot = floor_mod(pstep, RB);
      const int cword = consumed[sel_slot];
      const bool finish_empty = active && !st.fresh && !popped;
      const bool working = active && (st.fresh || popped);
      const bool do_pop = working && !st.fresh;

      // --- the popped block, staged; blocks of steps not yet run this
      // invocation read as zero (the JAX store starts zeroed; this store
      // is reused uninitialised) ---
      int blk_full = S - 1 - pstep;
      blk_full = blk_full < 0 ? 0 : (blk_full > S - 1 ? S - 1 : blk_full);
      const bool written = blk_full >= S - step;
      const int* brow = store + (size_t)blk_full * REC;
      for (int i = tl; i < REC; i += 32) stage_in[i] = written ? brow[i] : 0;
      __syncwarp();
      // lane c < 9: candidate c's key; the first max, and the best of the rest
      int key = INT_MIN32;
      bool live_c = false;
      if (tl < CANDS) {
        const int op = stage_in[tl * NFW + F_OP];
        live_c = (op & OP_PUSHED_BIT) != 0 && ((cword >> tl) & 1) == 0;
        key = live_c ? mono_bits(stage_in[tl * NFW + F_SCOREBITS]) : INT_MIN32;
      }
      unsigned long long kv =
          ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
          (unsigned)(31 - tl);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, kv, d);
        kv = o > kv ? o : kv;
      }
      const int f_mono = (int)((unsigned)(kv >> 32) ^ 0x80000000u);
      const int off = 31 - (int)(unsigned)(kv & 0xffffffffu);
      const int newkey = __reduce_max_sync(
          0xffffffffu, (live_c && tl != off) ? key : INT_MIN32);
      const int* fr = stage_in + off * NFW;
      const float f_score = st.fresh ? 0.0f : __int_as_float(mono_bits(f_mono));
      const I f_lower = st.fresh ? (I)0 : frame_get<I>(fr, F_LOWER);
      const I f_lrev = st.fresh ? (I)0 : frame_get<I>(fr, F_LREV);
      const I f_size = st.fresh ? (I)a.text_len : frame_get<I>(fr, F_SIZE);
      const int f_start = st.fresh ? st.split : (fr[F_STARTLEN] >> 16);
      const int f_len = st.fresh ? 0 : (fr[F_STARTLEN] & 0xFFFF);
      const int gaps = st.fresh ? 0 : fr[F_GAPS];
      const int parent = st.fresh ? S * CANDS : blk_full * CANDS + off;
      // a forward extension is a backward one of the reverse interval
      const bool fwd = BIDIR && f_start <= st.n - f_start - f_len;
      const int f_gapb = gaps & 3, f_gapf = (gaps >> 2) & 3,
                f_ngaps = (gaps >> 4) & 0xFF;
      const int nn = st.n;
      const int j = fwd ? f_start + f_len : f_start - 1;
      const int d_k = fwd ? f_start : f_start - 1;

      // --- the LUT/Bi-D row loads, issued before K1's ---
      const int rid_c =
          st.read_id < 0 ? 0 : (st.read_id > R - 1 ? R - 1 : st.read_id);
      const int j_c = j < 0 ? 0 : (j > M - 1 ? M - 1 : j);
      const float* rows_r = a.slut + (size_t)rid_c * M * 6;
      const float* row_j = rows_r + (size_t)j_c * 6;
      const float Sj[4] = {row_j[0], row_j[1], row_j[2], row_j[3]};
      const float pat_f = row_j[4];
      float d_rev, d_fwd;
      if (BIDIR) {
        // the Bi-D bound of both remainders: rows d_k and t + split
        const int d_l = fwd ? f_start + f_len : f_start + f_len - 1;
        const int bk = d_k < 0 ? 0 : (d_k > M - 1 ? M - 1 : d_k);
        const int t = nn - (1 + d_l);
        int ci = t + st.split;
        ci = ci < 0 ? 0 : (ci > M - 1 ? M - 1 : ci);
        d_rev = (d_k >= 0 && d_k < nn) ? rows_r[(size_t)bk * 6 + 5] : 0.0f;
        d_fwd = (t >= 0 && t + st.split < nn) ? rows_r[(size_t)ci * 6 + 5]
                                              : 0.0f;
      } else {
        // d_k == j, and split == n makes the forward bound identically 0
        d_rev = (d_k >= 0 && d_k < nn) ? row_j[5] : 0.0f;
        d_fwd = 0.0f;
      }

      // --- K1: the two halves rank the interval's two ends ---
      const I ext_lower = fwd ? f_lrev : f_lower;
      I occ1[4], occ2[4];
      occ4_pair<I>(a.rows, a.nb, a.occ_k, occ_query_lower<I>(ext_lower),
                   occ_query_upper<I>(ext_lower, f_size), occ1, occ2);
      I ch_lower[4], ch_lrev[4], ch_size[4];
      extend_from_occ<I>((const I*)a.less, (const I*)a.sent, ext_lower,
                         fwd ? f_lower : f_lrev, f_size, occ1, occ2,
                         ch_lower, ch_lrev, ch_size);

      const int gap_state = fwd ? f_gapf : f_gapb;
      const float ins_score =
          (gap_state == GAP_INSERTION ? a.pge : a.pgo_pge) + f_score;
      const float del_score =
          (gap_state == GAP_DELETION ? a.pge : a.pgo_pge) + f_score;
      const int ngaps_inc = gap_state == GAP_CLOSED ? f_ngaps + 1 : f_ngaps;
      const float lb = d_rev + d_fwd;
      const int pat_j = (int)pat_f;
      const bool stop = (f_score + lb) < st.best + st.repr;
      const bool abandon = working && st.age >= a.CAP;
      const bool finish_stop = working && stop && !abandon;
      const bool still = working && !stop && !abandon;
      const int gde = a.gap_dist_ends;
      const bool ins_allowed = min(j, nn - j - 1) >= gde;
      const int d5 = fwd ? j : j + 1;
      const bool del_allowed = min(d5, nn - d5) >= gde;
      const int next_start = fwd ? f_start : f_start - 1;
      // the gap state of the side not extended rides along unchanged
      const int keep_b = fwd ? f_gapb : -1, keep_f = fwd ? -1 : f_gapf;
      const bool gaps_ok = ngaps_inc <= a.max_gaps;

      // --- lane k < 9 of the warp: candidate k (0 the insertion, then a
      // deletion and a match/mismatch per child slot) ---
      const int k = tl;
      bool ok = false;
      float score = 0.0f;
      I lo = 0, lr = 0, sz = 0;
      int sl = 0, gstate = GAP_CLOSED, ng = f_ngaps, op = 0;
      if (k == 0) {
        ok = still && !(((ins_score + lb) / st.scale) < st.thresh) &&
             ins_allowed && gaps_ok;
        score = ins_score;
        lo = f_lower;
        lr = f_lrev;
        sz = f_size;
        sl = wshl(next_start, 16) | (f_len + 1);
        gstate = GAP_INSERTION;
        ng = ngaps_inc;
        op = OP_VALID_BIT | (OP_INSERTION << 17) | (j_c << 2);
      } else if (k < CANDS) {
        const int slot = (k - 1) >> 1;
        I c_lo = 0, c_lr = 0, c_sz = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q == slot) {
            c_lo = ch_lower[q];
            c_lr = ch_lrev[q];
            c_sz = ch_size[q];
          }
        const int code = fwd ? slot : 3 - slot;
        float sj = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q == code) sj = Sj[q];
        const bool nonzero = c_sz >= 1;
        lo = fwd ? c_lr : c_lo;
        lr = fwd ? c_lo : c_lr;
        sz = c_sz;
        if (k & 1) {  // the deletion
          ok = still && nonzero &&
               !(((del_score + lb) / st.scale) < st.thresh) && del_allowed &&
               gaps_ok;
          score = del_score;
          sl = wshl(f_start, 16) | f_len;
          gstate = GAP_DELETION;
          ng = ngaps_inc;
          op = OP_VALID_BIT | (OP_DELETION << 17) | (j_c << 2) | code;
        } else {  // the match or mismatch
          const float mm_score = sj + f_score;
          ok = still && nonzero &&
               !(((mm_score + lb) / st.scale) < st.thresh);
          score = mm_score;
          sl = wshl(next_start, 16) | (f_len + 1);
          op = OP_VALID_BIT |
               ((code == pat_j ? OP_MATCH : OP_MISMATCH) << 17) |
               (j_c << 2) | code;
        }
      }
      int gp = (keep_b >= 0 ? keep_b : gstate) |
               ((keep_f >= 0 ? keep_f : gstate) << 2) | wshl(ng, 4);

      // --- the running best over the 9 candidates, in candidate order ---
      const int okc = (int)ok | (((sl & 0xFFFF) == nn) << 1);
      float run_best = st.best;
      I run_size = st.best_size;
      // where no candidate can complete the read, the best stays and each
      // candidate's test against it is its own (int64 intervals take the
      // serial pass always: the shortcut cost them ~1.2 us a step on an
      // H100, PERF.md)
      bool my_ok = ok && !(score < run_best + st.repr), my_comp = false;
      if (sizeof(I) == 8 || __any_sync(0xffffffffu, okc == 3)) {
#pragma unroll
        for (int c = 0; c < CANDS; ++c) {
          const float sc = __shfl_sync(0xffffffffu, score, c);
          const int oc = __shfl_sync(0xffffffffu, okc, c);
          const I szc = shfl_i<I>(sz, c);
          const bool ok_c = (oc & 1) && !(sc < run_best + st.repr);
          const bool comp = ok_c && (oc & 2);
          if (comp && sc > run_best) {
            run_size = szc;
            run_best = sc;
          }
          if (k == c) {
            my_ok = ok_c;
            my_comp = comp;
          }
        }
      }
      const bool push = my_ok && !my_comp;
      op |= (my_comp ? OP_COMP_BIT : 0) | (push ? OP_PUSHED_BIT : 0);
      bool record = my_comp;
      if (k == 0 && abandon) {
        op = OP_VALID_BIT | OP_ABANDON_BIT;
        record = true;
      }
      if (record) gp = st.read_id;
      const unsigned rec_bits = __ballot_sync(0xffffffffu, record);
      const int n_comp = __popc(__ballot_sync(0xffffffffu, my_comp));
      const int ring_key = __reduce_max_sync(
          0xffffffffu,
          push ? mono_bits(__float_as_int(score)) : INT_MIN32);
      if (k < CANDS) {
        // stored position 8-k: the block's candidates are kept reversed
        int* e = stage_out + (CANDS - 1 - k) * NFW;
        frame_put(e, F_LOWER, lo);
        frame_put(e, F_LREV, lr);
        frame_put(e, F_SIZE, sz);
        e[F_PARENT] = parent;
        e[F_STARTLEN] = sl;
        e[F_GAPS] = gp;
        e[F_OP] = op;
        e[F_SCOREBITS] = __float_as_int(score);
      }
      __syncwarp();
      const int blk = S - 1 - step;
      int* out = store + (size_t)blk * REC;
      for (int i = tl; i < REC; i += 32) out[i] = stage_out[i];
      if (tl == 0) {
        // bit 8-k of the mask: candidate k recorded
        a.bmask[(size_t)lane * S + blk] = (int)(__brev(rec_bits) >> 23);
        if (do_pop) {
          consumed[sel_slot] = cword | (1 << off);
          ring[sel_slot] = newkey;
        }
        const int ring_slot = step % RB;
        ring[ring_slot] = ring_key;
        consumed[ring_slot] = 0;
      }
      st.hcount += n_comp;
      const bool finish_hits = still && (st.hcount > 9 || run_size > 1);
      st.finish = finish_empty || finish_stop || finish_hits || abandon;
      st.best = run_best;
      st.best_size = run_size;
      st.fresh = 0;
      st.active = active;
      if (tl == 0) sh_fin[par][w] = st.finish;
    }

    // --- refill behind the one grid barrier: each block publishes how
    // many of its lanes finished, tagged with the step's tag, in a slot
    // double-buffered by step parity; the slots are the barrier: warp 0 of
    // every block reads all of them until each carries this step's tag,
    // and sums those of the blocks before it and of all ---
    __syncthreads();
    const int tag = (step + cum + 1) << 5;
    if (threadIdx.x == 0) {
      int c = 0;
      for (int q = 0; q < lpb && lane0 + q < L; ++q) c += sh_fin[par][q];
      __stcg(flags + par * Lpad + blockIdx.x, tag | c);
    }
    if (w == 0) {
      const int4* fl = reinterpret_cast<const int4*>(flags + par * Lpad);
      const int nq = (int)(gridDim.x + 3) / 4, G = (int)gridDim.x;
      const int me = (int)blockIdx.x;
      int tot, bef;
      bool all;
      do {
        tot = 0;
        bef = 0;
        all = true;
#pragma unroll
        for (int i = 0; i < MAX_BLOCKS / 128; ++i) {
          const int q = tl + 32 * i;
          if (q < nq) {
            const int4 v = __ldcv(fl + q);
            const int b = 4 * q;
            const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (b + k < G) {
                all = all && (e[k] & ~31) == tag;
                tot += e[k] & 31;
                bef += b + k < me ? e[k] & 31 : 0;
              }
            }
          }
        }
      } while (!__all_sync(0xffffffffu, all));
      tot = __reduce_add_sync(0xffffffffu, tot);
      bef = __reduce_add_sync(0xffffffffu, bef);
      if (tl == 0) {
        sh_total[par] = tot;
        sh_before[par] = bef;
      }
    }
    __syncthreads();
    const int total = sh_total[par];
    if (has_lane) {
      int rank = sh_before[par];
      for (int q = 0; q < w; ++q) rank += sh_fin[par][q];
      if (a.track && tl == 0) {
        const int rid = st.read_id < 0 ? 0 : (st.read_id > R ? R : st.read_id);
        const int used = st.age + st.active < 4095 ? st.age + st.active : 4095;
        a.fin_log[(size_t)lane * S + step] = st.finish ? rid * 4096 + used : -1;
      }
      if (st.finish) {
        const int new_rid = next_read + rank;
        const bool got = new_rid < R;
        st.read_id = got ? new_rid : R;
        st.start = step + 1;
        st.age = 0;
        st.best = -__int_as_float(0x7f800000);
        st.best_size = 0;
        st.hcount = 0;
        st.n = got ? a.n[new_rid] : 0;
        st.split = got ? a.split[new_rid] : 0;
        st.scale = got ? a.scale[new_rid] : 0.0f;
        st.thresh = got ? a.thresh[new_rid] : 0.0f;
        st.repr = got ? a.repr[new_rid] : 0.0f;
        if (!got) st.done = 1;
        st.fresh = got;
      } else {
        st.age += st.active;
      }
    }
    // finished lanes that got a read stay live; the others are done
    const int handed = min(total, max(R - next_read, 0));
    live += handed - total;
    next_read = min(next_read + total, R);
    gdone = live == 0;
    ++step;
  }

  if (has_lane) {
    const int row[N_LANE_STATE] = {
        st.read_id, st.fresh, st.done, st.start, st.age, st.n, st.split,
        __float_as_int(st.scale), __float_as_int(st.thresh),
        __float_as_int(st.repr), __float_as_int(st.best),
        (int)(uint32_t)((uint64_t)(int64_t)st.best_size & 0xffffffffu),
        st.hcount, st.finish, st.active,
        (int)(uint32_t)((uint64_t)(int64_t)st.best_size >> 32)};
#pragma unroll
    for (int r = 0; r < N_LANE_STATE; ++r)
      if (tl == r) ls[r * L + lane] = row[r];
    if (ring_shared) {
      __syncwarp();
      for (int s = tl; s < RB; s += 32)
        a.bm_key[(size_t)lane * RB + s] = ring[s];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.glob[G_STEP] = step;
    a.glob[G_NEXT_READ] = next_read;
    a.glob[G_DONE] = gdone;
    a.glob[G_LIVE] = live;
  }
}

// K1 alone: one warp per lane (the two halves rank the interval's two
// ends, as in the pool search), then the extension sweep.  Used only to
// check K1 against its plain version (ops/fm.py extend_batch).
template <typename I>
static __global__ void k1_extend_kernel(const int* rows, const I* less,
                                        const I* sent, int nb, int occ_k,
                                        const I* lower, const I* lrev,
                                        const I* size, I* out_lower,
                                        I* out_lrev, I* out_size) {
  const int l = blockIdx.x;
  const I lw = lower[l], sz = size[l];
  I occ1[4], occ2[4];
  occ4_pair<I>(rows, nb, occ_k, occ_query_lower<I>(lw),
               occ_query_upper<I>(lw, sz), occ1, occ2);
  if (threadIdx.x == 0) {
    I cl[4], cr[4], cs[4];
    extend_from_occ<I>(less, sent, lw, lrev[l], sz, occ1, occ2, cl, cr, cs);
    for (int s = 0; s < 4; ++s) {
      out_lower[l * 4 + s] = cl[s];
      out_lrev[l * 4 + s] = cr[s];
      out_size[l * 4 + s] = cs[s];
    }
  }
}

// K1's rank query alone (ops/fm.py occ4_batch): one warp a position, the
// counts of ranks 1..4 in bwt[0..=r] from lane 0.
template <typename I>
static __global__ void k1_occ4_kernel(const int* rows, int nb, int occ_k,
                                      const I* r, I* out, int N) {
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= N) return;  // whole warps leave together
  I occ[4];
  occ4_warp<I>(rows, nb, occ_k, r[i], occ);
  if ((threadIdx.x & 31) == 0)
    for (int s = 0; s < 4; ++s) out[(size_t)i * 4 + s] = occ[s];
}

using PoolKernel = void (*)(PoolArgs, int*, int);

static PoolKernel pool_kernel(int big, int bidir) {
  return big ? (bidir ? pool_search_kernel<int64_t, true>
                      : pool_search_kernel<int64_t, false>)
             : (bidir ? pool_search_kernel<int32_t, true>
                      : pool_search_kernel<int32_t, false>);
}

// The card's figures for the plan: SMs, the shared memory a block may opt
// into, an SM's shared memory, the kernel's static shared memory and the
// runtime's reserve a block.  Lets the kernel take all the dynamic shared
// memory a block may have (the same value from every caller, so two host
// threads never race on it).
extern "C" int pool_card(int big, int bidir, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const PoolKernel k = pool_kernel(big, bidir);
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
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k);
  if (e == cudaSuccess) {
    out[3] = (int)fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out[1] - out[3]);
  }
  return (int)e;
}

// blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that one SM holds at once (after pool_card)
extern "C" int pool_occupancy(int big, int bidir, int threads, int smem,
                              int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, pool_kernel(big, bidir), threads, (size_t)smem);
}

extern "C" int pool_init(const PoolArgs* a, cudaStream_t stream) {
  const size_t n = (size_t)a->L * a->RB > (size_t)a->L
                       ? (size_t)a->L * a->RB : (size_t)a->L;
  LAUNCH(pool_init_kernel, (unsigned)((n + 255) / 256), 256, stream, *a);
  CHECK_LAUNCH();
  return 0;
}

// One store generation: every step until the step limit or the done flag,
// in one cooperative launch (the barrier needs every block resident).
// `flags`: 2 x ((L + 3) & ~3) ints, zeroed by the caller once an
// invocation: each block's tagged count of finished lanes, by step parity
// (the padding past the blocks is never written).  A launch the card
// refuses returns its error; nothing else is tried.
extern "C" int pool_run(const PoolArgs* a, const PoolPlan* plan, int* flags,
                        cudaStream_t stream) {
  PoolArgs args = *a;
  int shared = plan->ring_shared;
  void* params[] = {&args, &flags, &shared};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)pool_kernel(a->big, a->bidir), plan->blocks,
      plan->lanes_per_block * 32, params, (size_t)plan->smem, stream);
  if (e != cudaSuccess) return (int)e;
  CHECK_LAUNCH();
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
    LAUNCH(k1_extend_kernel<I>, L, 32, stream, rows, (const I*)less,
           (const I*)sent, nb, occ_k, (const I*)lower, (const I*)lrev,
           (const I*)size, (I*)out_lower, (I*)out_lrev, (I*)out_size);
  } else {
    using I = int32_t;
    LAUNCH(k1_extend_kernel<I>, L, 32, stream, rows, (const I*)less,
           (const I*)sent, nb, occ_k, (const I*)lower, (const I*)lrev,
           (const I*)size, (I*)out_lower, (I*)out_lrev, (I*)out_size);
  }
  CHECK_LAUNCH();
  return 0;
}

extern "C" int k1_occ4(const int* rows, int nb, int occ_k, int big,
                       const void* r, void* out, int N,
                       cudaStream_t stream) {
  if (N <= 0) return 0;
  const unsigned blocks = (unsigned)((N + 7) / 8);
  if (big)
    LAUNCH(k1_occ4_kernel<int64_t>, blocks, 256, stream, rows, nb, occ_k,
           (const int64_t*)r, (int64_t*)out, N);
  else
    LAUNCH(k1_occ4_kernel<int32_t>, blocks, 256, stream, rows, nb, occ_k,
           (const int32_t*)r, (int32_t*)out, N);
  CHECK_LAUNCH();
  return 0;
}
