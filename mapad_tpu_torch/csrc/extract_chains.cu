// K3: chain extraction after the pool loop, the per-read step fold and the
// PoolResult tail, in one cooperative launch.
//
// Replaces mapad_tpu/ops/search_pool2.py `extract_chains` (617-726),
// `fold_read_steps` (728-737), `append_acc` (792-810) and the tail
// (921-971).  Plain version: ops/search_pool2.py `_extract_plain`,
// `_ChainLog`, `_extract_chains_plain`.  With a big index (int64
// intervals, 11-word frames) `c_lower`, `c_lrev` and `c_size` are int64:
// the kernel is a template on the interval type.
//
// JAX compacts the completion/abandon entries with two top_k passes over
// negated (lane, block) keys, which yields the first C marked entries in
// ascending (lane, slot) order.  Here the step kernel's 9-bit block masks
// (bmask, written at every step) give the same order without a sort.  One
// launch of `blocks` x `warps` warps, all co-resident (the plan:
// ops/search_pool2.py `extract_plan`), runs three phases behind two grid
// barriers:
//   A. count:  up to four warps a lane (its rounds of 128 mask words dealt
//              over them, a 16-byte load a thread, four rounds in flight)
//              sum the popcounts, keep each round's count and find the
//              lane's first marked block; the step fold's accumulator is
//              reset (first extraction of an invocation) and the per-lane
//              tail written (final);
//   B. emit:   every block scans the L lane counts itself (lane-order
//              offsets, the total, the first marked lane); a warp takes 32
//              rounds of a lane, their first entries from the round counts
//              (a warp prefix by shuffles), and reloads only the rounds
//              that hold marks, four at a time, writing (lane, slot) of
//              their entries in ascending slot order, stopping at C; block
//              0 writes the counters and the tail scalars;
//   C. walk:   the first warps take `we` entries each, one a thread (we =
//              the entries over the warps the fold leaves, 1 to 32: a
//              warp's hop waits for the slowest of its loads, so the fewer
//              a warp the shorter the hop); a hop loads only the frame's
//              F_OP and F_PARENT words and ends at ROOT; the op words
//              gather in shared memory, 32 columns a row, and leave as row
//              segments, the rows' tails as zeros.  The warps from the
//              last one down run the step fold (the finish log's (read,
//              steps) events max-reduced into read_steps with atomicMax: a
//              max is order-free, so exact) and the unused entries.
// Unused entries (past min(n_chains, C)) copy candidate 0 of the first
// marked block, as JAX's top_k padding selects (lane 0, slot 0 where no
// block is marked).
//
// The grid barrier is each block's slot tagged with the barrier's number,
// as K2's (csrc/pool_search.cu): thread 0 fences the block's writes and
// stores the tag; warp 0 reads every slot until each carries it (or a
// later one), then fences.  The tags go on from call to call: block 0
// keeps the last one in slot 0 of `flags`, which the caller zeroes once
// for the loop state the calls share.
//
// With store generations the extraction also runs at every store boundary
// (before K8, csrc/pool_compact.cu, moves the store).  An extraction scans
// only the steps run since the last boundary (glob[G_BASE]..glob[G_STEP]:
// K8 clears the marks of the frames it moves, so their masks count as
// empty), writes its entries at offset min(entries so far, C) and drops
// what falls past C (the JAX package's 2C window and `[:C]`), reports
// slots minus 9 x the steps compacted away (glob[G_CUM]), adds to n_chains
// and lets the step fold accumulate.  Only the last extraction (`final`)
// writes the unused entries and the per-lane tail, and it leaves the
// counters in glob[] alone, so it can be repeated.  A walk of more than
// MW-1 hops is cut at MW words, as the JAX `scan` of fixed length cuts it.
//
// Bound on the card: the bytes (the masks and the finish log, 4 B each a
// lane a step run, the frames walked, the PoolResult written), or the
// walk's latency: the deepest chain's hops, each a dependent load of a
// frame written by K2 long before (the store is far past the L2).  The
// design keeps every other part beside or before that chase.
#include "common.cuh"

using namespace mapad;

constexpr unsigned FULL = 0xffffffffu;
constexpr int EXT_MAX_WARPS = 8;
constexpr int EXT_MAX_BLOCKS = 1024;  // slots of the grid barrier
constexpr int STAGE_LD = 33;          // a staged row of 32 op words, padded
constexpr int EXT_MISC = 40;          // warp totals, total, first lane

// Mirrors ops/search_pool2.py `ExtractPlan`.
struct ExtractPlan {
  int blocks, warps, smem;
};

static __device__ __forceinline__ bool block_written(int blk, int S,
                                                     int steps) {
  return blk >= S - steps && blk < S;
}

// words q..q+3 of p (q a multiple of 4), those outside [lo, hi) as 0
static __device__ __forceinline__ int4 load4(const int* p, long long q,
                                             long long lo, long long hi) {
  if (q >= lo && q + 4 <= hi)
    return *reinterpret_cast<const int4*>(p + q);
  int4 v;
  v.x = q >= lo && q < hi ? p[q] : 0;
  v.y = q + 1 >= lo && q + 1 < hi ? p[q + 1] : 0;
  v.z = q + 2 >= lo && q + 2 < hi ? p[q + 2] : 0;
  v.w = q + 3 >= lo && q + 3 < hi ? p[q + 3] : 0;
  return v;
}

// Every block of the grid at barrier `tag`; what each block wrote before
// it is visible to every block after it (read it with __ldcg, or with a
// plain load where the reading SM read none of those lines before: its L1
// then holds no stale copy).
static __device__ void grid_barrier(int* flags, int tag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    __stcg(flags + 1 + blockIdx.x, tag);
  }
  if (threadIdx.x < 32) {
    const int G = (int)gridDim.x;
    bool all;
    do {
      all = true;
      for (int b = (int)threadIdx.x; b < G; b += 32)
        all = all && (int)((unsigned)__ldcv(flags + 1 + b) -
                           (unsigned)tag) >= 0;
    } while (!__all_sync(FULL, all));
    __threadfence();
  }
  __syncthreads();
}

// One warp's `we` entries [we j, we j + we) of this extraction (those
// below n_walk), one a thread: the fields of each entry's frame, then the
// ancestor walks, their op words staged in shared memory 32 columns at a
// time and written out as row segments of the consecutive rows.
template <typename I>
static __device__ void walk_batch(const ExtractArgs& a, int j, int we,
                                  int n_walk, int pad2, int cum, int steps,
                                  int* stage) {
  constexpr int NFW = Idx<I>::NFW;
  constexpr int REC = CANDS * NFW;
  const int tl = (int)threadIdx.x & 31;
  const int S = a.S, MW = a.MW, ROOT = S * CANDS;
  const int e = j * we + tl;
  const bool mine = tl < we && e < n_walk;
  const int o = pad2 + e;
  int lane = 0, slot = 0;
  if (mine) {
    lane = __ldcg(a.c_lane + e);
    slot = __ldcg(a.e_slot + e);
  }
  const int* ls = a.store + (size_t)lane * (S + 1) * REC;
  int rec[NFW];
  const bool written = mine && block_written(slot / CANDS, S, steps);
#pragma unroll
  for (int f = 0; f < NFW; ++f)
    rec[f] = written ? ls[(size_t)slot * NFW + f] : 0;
  const int e_op = rec[F_OP];
  const bool abandon = (e_op & OP_ABANDON_BIT) != 0;
  if (mine) {
    a.c_slot[o] = slot - CANDS * cum;
    a.c_read[o] = rec[F_GAPS];
    a.c_abandon[o] = abandon;
    ((I*)a.c_lower)[o] = frame_get<I>(rec, F_LOWER);
    ((I*)a.c_lrev)[o] = frame_get<I>(rec, F_LREV);
    ((I*)a.c_size)[o] = frame_get<I>(rec, F_SIZE);
    a.c_score[o] = __int_as_float(rec[F_SCOREBITS]);
  }
  const bool walk = mine && !abandon;
  int node = walk ? rec[F_PARENT] : ROOT;
  stage[tl * STAGE_LD] = walk ? e_op : 0;
  const int nrows = n_walk - j * we < we ? n_walk - j * we : we;
  int* ops0 = a.c_ops + (size_t)(pad2 + j * we) * MW;
  int t = 1, col0 = 0;
  for (;;) {
    const int cend = col0 + 32 < MW ? col0 + 32 : MW;
    for (; t < cend; ++t) {
      if (!__any_sync(FULL, node != ROOT)) break;
      int v = 0;
      if (node != ROOT) {
        const int* r = ls + (size_t)node * NFW;
        v = r[F_OP];
        node = r[F_PARENT];
      }
      stage[tl * STAGE_LD + (t - col0)] = v;
    }
    __syncwarp();
    const int ncols = t - col0;
    for (int r = 0; r < nrows; ++r)
      if (tl < ncols)
        ops0[(size_t)r * MW + col0 + tl] = stage[r * STAGE_LD + tl];
    __syncwarp();
    if (t < cend || t >= MW) break;  // every chain at ROOT, or rows full
    col0 += 32;
  }
  // past the deepest chain of the 32: zeros
  for (int r = 0; r < nrows; ++r)
    for (int c = t + tl; c < MW; c += 32) ops0[(size_t)r * MW + c] = 0;
}

template <typename I>
static __global__ void __launch_bounds__(EXT_MAX_WARPS * 32)
extract_kernel(ExtractArgs a) {
  constexpr int NFW = Idx<I>::NFW;
  constexpr int REC = CANDS * NFW;
  extern __shared__ __align__(16) int ext_smem[];
  const int W = (int)blockDim.x >> 5, wid = (int)threadIdx.x >> 5;
  const int tl = (int)threadIdx.x & 31;
  const int NW = (int)gridDim.x * W, gw = (int)blockIdx.x * W + wid;
  const int NT = NW * 32, gt = gw * 32 + tl;
  // the work of the last phase's other warps, from the last warp down
  const int rw = NW - 1 - gw, rt = rw * 32 + tl;
  const int L = a.L, S = a.S, C = a.C, MW = a.MW, R = a.R;
  const int steps = __ldcg(a.glob + G_STEP), base = __ldcg(a.glob + G_BASE);
  const int cum = __ldcg(a.glob + G_CUM);
  const int acc_n = __ldcg(a.glob + G_ACC_N);
  const int acc_nch = __ldcg(a.glob + G_ACC_NCH);
  const int tag = __ldcg(a.flags);
  const int lo = S - steps, hi = S - base;  // the blocks of this extraction
  int* const s_off = ext_smem;              // (L + 1) lane-order offsets
  int* const misc = s_off + ((L + 4) & ~3);
  int* const stage = misc + EXT_MISC + wid * 32 * STAGE_LD;

  // --- A: each lane's marks, by round, and first marked block; a lane's
  // rounds dealt over P warps where the grid has them ---
  const int RMAX = (S >> 7) + 2;  // rounds of 128 words a lane at most
  const int P = NW >= 4 * L ? 4 : (NW >= 2 * L ? 2 : 1);
  for (int u = gw; u < L * P; u += NW) {
    const int l = u / P, p = u - l * P;
    const long long row = (long long)l * S;
    const long long g0 = row + lo, g1 = row + hi, q0 = g0 & ~3LL;
    const int nr = (int)((g1 - q0 + 127) >> 7);
    int* const rc = a.round_cnt + (size_t)l * RMAX;
    int c = 0, f = S;
    for (int r0 = p; r0 < nr; r0 += 4 * P) {
      int4 m[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = r0 + k * P;
        m[k] = r < nr ? load4(a.bmask, q0 + 128LL * r + 4 * tl, g0, g1)
                      : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = r0 + k * P;
        const int w4[4] = {m[k].x, m[k].y, m[k].z, m[k].w};
        const int b0 = (int)(q0 - row) + 128 * r + 4 * tl;
        int n = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          n += __popc(w4[i]);
          if (w4[i] != 0 && b0 + i < f) f = b0 + i;
        }
        n = __reduce_add_sync(FULL, n);
        if (tl == 0 && r < nr) rc[r] = n;
        c += n;
      }
    }
    f = __reduce_min_sync(FULL, f);
    if (tl == 0) {
      // a lane's parts at a stride of 4, the unused ones empty
      a.lane_cnt[l * 4 + p] = c;
      a.lane_first[l * 4 + p] = f;
      for (int q = P; p == 0 && q < 4; ++q) {
        a.lane_cnt[l * 4 + q] = 0;
        a.lane_first[l * 4 + q] = S;
      }
    }
  }
  if (a.first)
    for (int i = gt; i <= R; i += NT) a.read_steps[i] = -1;
  if (a.final)
    for (int l = gt; l < L; l += NT) {
      const int rid = a.lane[LS_READ_ID * L + l];
      a.lane_read[l] = rid;
      a.lane_unfinished[l] = !a.lane[LS_DONE * L + l] && rid < R;
    }
  grid_barrier(a.flags, tag + 1);

  // --- B: lane-order offsets in every block, then the entries.  Every
  // block reads all the counts: plain loads, so each SM takes them from
  // the L2 once (its L1 holds none of them before this barrier) ---
  {
    const int T = (int)blockDim.x, tid = (int)threadIdx.x;
    const int per = (L + T - 1) / T, l0 = tid * per;  // at most 4
    int4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = k < per && l0 + k < L
                 ? *reinterpret_cast<const int4*>(a.lane_cnt + (l0 + k) * 4)
                 : make_int4(0, 0, 0, 0);
    int cl[4], sum = 0, firstl = L;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cl[k] = v[k].x + v[k].y + v[k].z + v[k].w;
      if (cl[k] > 0 && l0 + k < firstl) firstl = l0 + k;
      sum += cl[k];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (tl >= d) incl += v;
    }
    firstl = __reduce_min_sync(FULL, firstl);
    if (tl == 31) misc[wid] = incl;
    if (tl == 0) misc[32 + wid] = firstl;
    __syncthreads();
    int before = 0, total = 0, pl = L;
    for (int w = 0; w < W; ++w) {
      before += w < wid ? misc[w] : 0;
      total += misc[w];
      pl = misc[32 + w] < pl ? misc[32 + w] : pl;
    }
    int run = before + incl - sum;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < per && l0 + k < L) s_off[l0 + k] = run;
      run += cl[k];
    }
    if (tid == 0) s_off[L] = total;
    __syncthreads();
    if (tid == 0) misc[32] = pl;  // after every read of misc[32..]
    __syncthreads();
  }
  const int total = s_off[L];
  const int n_ext = total < C ? total : C;
  const int pad2 = acc_n < C ? acc_n : C;
  const int n_walk = n_ext < C - pad2 ? n_ext : C - pad2;
  const int pad_lane = misc[32] < L ? misc[32] : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (a.final) {
      a.n_chains[0] = acc_nch + total;
      a.next_read[0] = __ldcg(a.glob + G_NEXT_READ);
      // every step run, over all generations
      a.steps[0] = steps + cum;
    } else {
      // every block read these before the first barrier
      a.glob[G_ACC_N] = acc_n + n_ext;
      a.glob[G_ACC_NCH] = acc_nch + total;
    }
  }
  // each lane's rounds in chunks of 32, a warp a chunk: the chunk's first
  // entry from the counts of the rounds before it, then only its rounds
  // with marks reloaded, four at a time
  const int NCH = (RMAX + 31) >> 5;
  for (int u = gw; u < L * NCH; u += NW) {
    const int l = u / NCH, r0 = (u - l * NCH) * 32;
    const int end = s_off[l + 1] < C ? s_off[l + 1] : C;
    int off = s_off[l];
    const long long row = (long long)l * S;
    const long long g0 = row + lo, g1 = row + hi, q0 = g0 & ~3LL;
    const int nr = (int)((g1 - q0 + 127) >> 7);
    if (off >= end || r0 >= nr) continue;
    const int* const rc = a.round_cnt + (size_t)l * RMAX;
    const int n = r0 + tl < nr ? rc[r0 + tl] : 0;
    int before = 0;
    for (int r = tl; r < r0; r += 32) before += rc[r];
    off += __reduce_add_sync(FULL, before);
    if (off >= end) continue;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (tl >= d) incl += v;
    }
    const int first_e = off + incl - n;
    // the rounds with marks whose entries are not all past C
    unsigned todo = __ballot_sync(FULL, n > 0 && first_e < end);
    while (todo) {
      int ks[4];
      int4 m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ks[i] = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
        m[i] = ks[i] >= 0 ? load4(a.bmask, q0 + 128LL * (r0 + ks[i]) + 4 * tl,
                                  g0, g1)
                          : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ks[i] < 0) break;
        const int w4[4] = {m[i].x, m[i].y, m[i].z, m[i].w};
        const int n4 = __popc(w4[0]) + __popc(w4[1]) + __popc(w4[2]) +
                       __popc(w4[3]);
        int inc4 = n4;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(FULL, inc4, d);
          if (tl >= d) inc4 += v;
        }
        int e = __shfl_sync(FULL, first_e, ks[i]) + inc4 - n4;
        const int b0 = (int)(q0 - row) + 128 * (r0 + ks[i]) + 4 * tl;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // the word's set bits, lowest first
          for (unsigned bits = (unsigned)w4[k]; bits != 0u && e < C;
               bits &= bits - 1u, ++e) {
            a.c_lane[e] = l;
            a.e_slot[e] = (b0 + k) * CANDS + __ffs(bits) - 1;
          }
        }
      }
    }
  }
  if (a.track && a.final)
    // unfinished lanes report the steps their held read consumed so far
    for (int l = gt; l < L; l += NT) {
      const int rid = a.lane[LS_READ_ID * L + l];
      if (!a.lane[LS_DONE * L + l] && rid < R)
        atomicMax(&a.read_steps[rid < 0 ? 0 : rid], a.lane[LS_AGE * L + l]);
    }
  grid_barrier(a.flags, tag + 2);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.flags[0] = tag + 2;

  // --- C: the walks on the first warps, `we` entries a warp ---
  const int folders = a.track && NW > L ? L : 0;
  const int walkers = NW - folders;
  int we = (n_walk + walkers - 1) / walkers;
  we = we < 1 ? 1 : (we > 32 ? 32 : we);
  const int nbatch = (n_walk + we - 1) / we;
  for (int j = gw; j < nbatch; j += NW)
    walk_batch<I>(a, j, we, n_walk, pad2, cum, steps, stage);
  // ... the step fold and the unused entries from the last warp down
  if (a.track)
    for (int l = rw; l < L; l += NW) {
      const long long row = (long long)l * S;
      const long long g0 = row + base, g1 = row + steps, q0 = g0 & ~3LL;
      const int nr = (int)((g1 - q0 + 127) >> 7);
      for (int r0 = 0; r0 < nr; r0 += 4) {
        int4 u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          u[k] = r0 + k < nr
                     ? load4(a.fin_log, q0 + 128LL * (r0 + k) + 4 * tl, g0, g1)
                     : make_int4(-1, -1, -1, -1);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ev4[4] = {u[k].x, u[k].y, u[k].z, u[k].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const long long w = q0 + 128LL * (r0 + k) + 4 * tl + i;
            if (w >= g0 && w < g1 && ev4[i] >= 0)
              atomicMax(&a.read_steps[ev4[i] >> 12], ev4[i] & 4095);
          }
        }
      }
    }
  if (!a.final) return;
  const int pad_lo = pad2 + n_ext < C ? pad2 + n_ext : C;
  if (pad_lo >= C) return;
  {
    int pad_blk = 0;
    if (misc[32] < L) {
      const int4 f = *reinterpret_cast<const int4*>(a.lane_first +
                                                    pad_lane * 4);
      pad_blk = min(min(f.x, f.y), min(f.z, f.w));
    }
    const int slot = pad_blk * CANDS;
    const int* fr = a.store + (size_t)pad_lane * (S + 1) * REC +
                    (size_t)slot * NFW;
    int rec[NFW];
    const bool written = block_written(pad_blk, S, steps);
#pragma unroll
    for (int f = 0; f < NFW; ++f) rec[f] = written ? fr[f] : 0;
    const I lower = frame_get<I>(rec, F_LOWER);
    const I lrev = frame_get<I>(rec, F_LREV);
    const I size = frame_get<I>(rec, F_SIZE);
    for (int o = pad_lo + rt; o < C; o += NT) {
      a.c_slot[o] = slot - CANDS * cum;
      a.c_read[o] = -1;
      a.c_abandon[o] = 0;
      ((I*)a.c_lower)[o] = lower;
      ((I*)a.c_lrev)[o] = lrev;
      ((I*)a.c_size)[o] = size;
      a.c_score[o] = __int_as_float(rec[F_SCOREBITS]);
    }
  }
  // their op rows: zeros, 16 B a store (c_ops is 16-byte aligned)
  const long long w0 = (long long)pad_lo * MW, w1 = (long long)C * MW;
  const long long v0 = (w0 + 3) & ~3LL, v1 = w1 & ~3LL;
  const int4 z = make_int4(0, 0, 0, 0);
  for (long long q = v0 + 4LL * rt; q + 4 <= v1; q += 4LL * NT)
    *reinterpret_cast<int4*>(a.c_ops + q) = z;
  if (rt < 4) {
    if (w0 + rt < v0 && w0 + rt < w1) a.c_ops[w0 + rt] = 0;
    if (v1 + rt < w1 && v1 + rt >= v0) a.c_ops[v1 + rt] = 0;
  }
}

using ExtractKernel = void (*)(ExtractArgs);

static ExtractKernel extract_kernel_of(int big) {
  return big ? extract_kernel<int64_t> : extract_kernel<int32_t>;
}

// The card's figures for the plan: SMs and the shared memory a block may
// use without opting in.
extern "C" int extract_card(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlock,
                               dev);
  return (int)e;
}

// blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that one SM holds at once
extern "C" int extract_occupancy(int big, int threads, int smem,
                                 int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, extract_kernel_of(big), threads, (size_t)smem);
}

// One extraction in one cooperative launch (the barriers need every block
// resident).  `a->flags`: 1 + plan->blocks ints, zeroed by the caller once
// for the loop state the calls share.  A launch the card refuses returns
// its error; nothing else is tried.
extern "C" int extract_chains(const ExtractArgs* a, const ExtractPlan* plan,
                              cudaStream_t stream) {
  if (a->L < 1 || a->L > 1024 || plan->blocks < 1 ||
      plan->blocks > EXT_MAX_BLOCKS || plan->warps < 1 ||
      plan->warps > EXT_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  ExtractArgs args = *a;
  void* params[] = {&args};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)extract_kernel_of(a->big), plan->blocks, plan->warps * 32,
      params, (size_t)plan->smem, stream);
  if (e != cudaSuccess) return (int)e;
  CHECK_LAUNCH();
  return 0;
}
