// K7: the Bi-D lower-bound array of every read of a block, on the card.
//
// Replaces mapad_tpu/ops/bi_d.py `_walk_part` / `compute_bi_d` (27-156).
// Plain version: ops/bi_d.py `compute_bi_d_plain`.
//
// Per read part, 15 walks (walk w skips the first w positions) extend the
// FMD interval perfectly, symbol by symbol.  A walk keeps the running
// maximum `rm` of the penalty elements seen since its last failure; when
// the interval empties it adds rm to its f32 sum z (in walk order: the add
// is not associative), resets the interval to the whole text and rm to the
// lowest f32.  Column i of a walk is z after step i-1, for w < i <=
// n_steps, and 0 elsewhere, where n_steps is the longest part of the WHOLE
// block of reads (the JAX loop runs all walks in lock step that far).  The
// part's D array is the minimum over the walks and 0.  Part 1 walks
// pattern[:split] through the swapped interval with the complement symbol
// (a forward extension); part 2, if asked for, walks pattern[split:]
// reversed with backward extensions and is re-indexed into the composite
// with clipping (bi_d.py:143-156).
//
// Bound on the card: bytes -- two 512 B index rows per walk step (L2
// resident for a small index) plus the (R, M) inputs and output.  A walk is
// a chain of dependent row reads, so the kernel is bound by latency and, with
// enough walks in flight, by the SM's issue slots.  The design:
// - block b takes read b, with `plan.warps` warps (ops/bi_d.py `bid_plan`):
//   the block scheduler starts the next read wherever a block ends, and the
//   launch bounds keep BID_MIN_BLOCKS blocks of up to BID_WARPS warps on an
//   SM (45 warps at 15 a block, 48 at 16);
// - a walk of a part is a unit of work; the block's warps take its units in
//   turn from a shared counter, walk 0 of each part first (the longest walks
//   first), so both parts of the read run on their own warps and a warp
//   that ends a short walk takes the next;
// - a read's rank (as bytes) and penalty rows are staged in shared memory
//   once, part 2's reversed, so a step's only global reads are K1's rows;
// - a walk extends in one direction, so it carries the lower end it ranks
//   and the size, not the other lower end (which never reaches its output);
//   a step's K1 (`occ_sym_step`) counts the walk's symbol at both ends at
//   once (SWAR compares): where both fall in one row (a narrow interval)
//   the warp reads that row once, r1's prefix and the words between the
//   ends; else each half-warp counts its own end's prefix over its own row;
//   the whole text's children, where every walk starts and restarts, are
//   the block's, computed once;
// - the row number r / occ_k is a multiply-high by a constant the host
//   proves exact over every non-negative value (ops/bi_d.py `occ_divisor`).
// Each walk folds its z into its part's shared array with an atomicMin on
// the order-preserving int key of the f32 (a minimum is order-free, so the
// result does not depend on which warp ran which walk; the array starts at
// the key of 0.0).
#include "common.cuh"

using namespace mapad;

constexpr int MAX_OFFSET = 15;
constexpr int BID_MAX_M = 1024;
constexpr int BID_WARPS = 16;      // warps a block at most
constexpr int BID_MIN_BLOCKS = 3;  // blocks an SM the registers leave room for
constexpr int F32_LOWEST_BITS = (int)0xff7fffff;  // -3.4028235e38

struct BidArgs {
  const int* rows;
  const void* less;
  int nb, occ_k, big;
  long long text_len;
  const int* rank;   // (R, M) symbol ranks 1..4, 0 invalid
  const float* pen;  // (R, M) penalty elements
  const int* n;      // (R,)
  const int* split;  // (R,)
  int R, M, steps_back, steps_fwd, forward_part;
  float* out;  // (R, M)
};

// Mirror of ops/bi_d.py `_BidPlanC`: a block of `warps` warps takes a read,
// staged in `smem` bytes of dynamic shared memory; the row number of a rank
// r is umulhi(r, div_magic) >> div_shift.
struct BidPlan {
  int warps, smem, div_shift;
  unsigned long long div_magic;
};

// r / occ_k for 0 <= r, by the host's constant
template <typename I>
__device__ __forceinline__ I occ_div(I r, unsigned long long magic, int sh);
template <>
__device__ __forceinline__ int32_t occ_div<int32_t>(int32_t r,
                                                    unsigned long long magic,
                                                    int sh) {
  return (int32_t)(__umulhi((unsigned)r, (unsigned)magic) >> sh);
}
template <>
__device__ __forceinline__ int64_t occ_div<int64_t>(int64_t r,
                                                    unsigned long long magic,
                                                    int sh) {
  return (int64_t)(__umul64hi((unsigned long long)r, magic) >> sh);
}

// The occurrences of symbol s (1..4) among a word's eight nibbles, by SWAR
// masks: bit 3 of a nibble of ((x & 7) + 8 - t) | x is set iff the nibble
// is >= t, and [= s] = [>= s] - [>= s+1], a subset of the first, so an XOR;
// a nibble 0 (a word past a prefix, or cut from it) counts in neither.
struct Swar {
  unsigned ks, ks1;
  __device__ __forceinline__ explicit Swar(int s)
      : ks((unsigned)(8 - s) * 0x11111111u),
        ks1((unsigned)(7 - s) * 0x11111111u) {}
  __device__ __forceinline__ int eq(unsigned x) const {
    const unsigned lo = x & 0x77777777u;
    return __popc((((lo + ks) | x) ^ ((lo + ks1) | x)) & 0x88888888u);
  }
};

// the nibbles of a prefix's last word that lie in the prefix, which ends
// at nibble `off` of its row
__device__ __forceinline__ unsigned last_mask(int off) {
  const int nv = (off & 7) + 1;
  return nv == 8 ? ~0u : (1u << (4 * nv)) - 1u;
}

// K1 for one extension by symbol s (1..4) of the interval whose ends rank
// r1 (lower) and r2 (upper): -> eq1, the occurrences of s in bwt[0..=r1]
// (0 for r1 < 0), and d_eq, those in bwt(r1, r2] -- what `occ4_warp`'s
// counts of rank s at both ends give the extension's lower end and size.
// Every lane gets both.
//
// The lower half-warp finds r1's row and offset, the upper half r2's (a
// multiply-high by the host's constant; a row number is an int32, a
// negative one counts from the end, and the gather clamps like XLA's).
// Where both ends fall in one row, r1 >= 0 and r1's offset is not past
// r2's (a narrow interval: most of a walk's steps), the whole warp reads
// that row once: r1's prefix, and the words of the range between the two
// offsets.  Else each half-warp counts its own end's prefix over its own
// row, at once.
template <typename I>
__device__ __forceinline__ void occ_sym_step(const int* __restrict__ rows,
                                             int nb, int k,
                                             unsigned long long magic, int sh,
                                             int s, I r1, I r2, I& eq1,
                                             I& d_eq) {
  constexpr int N_CP = Idx<I>::N_CP;
  constexpr int NW = ROW_WORDS - N_CP;  // symbol words of a row
  const unsigned FULL = 0xffffffffu;
  const bool upper = (threadIdx.x & 16) != 0;
  const int lane = threadIdx.x & 31, hl = lane & 15;
  const I r = upper ? r2 : r1;
  const I r_safe = r > 0 ? r : 0;
  const I q = occ_div<I>(r_safe, magic, sh);
  int blk = (int)q;
  if (blk < 0) blk += nb;
  blk = blk < 0 ? 0 : (blk > nb - 1 ? nb - 1 : blk);
  const int off = (int)((unsigned)r_safe - (unsigned)q * (unsigned)k);
  const int o_blk = __shfl_xor_sync(FULL, blk, 16);
  const int o_off = __shfl_xor_sync(FULL, off, 16);
  const int blk1 = upper ? o_blk : blk, off1 = upper ? o_off : off;
  const int blk2 = upper ? blk : o_blk, off2 = upper ? off : o_off;
  const Swar sw(s);
  if (blk1 == blk2 && r1 >= 0 && off1 <= off2) {
    constexpr int PER = (NW + 31) / 32;  // word rounds of the warp
    const int* row = rows + (size_t)blk1 * ROW_WORDS + N_CP;
    const int wl1 = off1 >> 3, wl2 = off2 >> 3;
    const unsigned m1 = last_mask(off1), m2 = last_mask(off2);
    // every load first: the checkpoint of s, r1's prefix words, and the
    // first 32 words of the range (off1, off2], a lane each
    const I cp = row_checkpoint<I>(row - N_CP, s - 1);
    const int* lw = row + lane;  // the lane's words: lw[32 * i]
    unsigned pw[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i)
      pw[i] = lane + 32 * i <= wl1 ? (unsigned)__ldg(lw + 32 * i) : 0u;
    const int wr = wl1 + lane;
    const unsigned rw = wr <= wl2 ? (unsigned)__ldg(row + wr) : 0u;
    int c1 = 0;  // s in r1's prefix
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (32 * i > wl1) break;
      c1 += sw.eq(lane + 32 * i == wl1 ? pw[i] & m1 : pw[i]);
    }
    // s in the range: its words past r1's prefix, up to r2's last nibble
    int cr = sw.eq((wr == wl2 ? rw & m2 : rw) & (wr == wl1 ? ~m1 : ~0u));
    for (int w = wr + 32; w - lane <= wl2; w += 32)
      if (w <= wl2)
        cr += sw.eq(w == wl2 ? (unsigned)__ldg(row + w) & m2
                             : (unsigned)__ldg(row + w));
    int cnt = c1 + (cr << 16);  // a row holds fewer than 2^16 symbols
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) cnt += __shfl_xor_sync(FULL, cnt, d);
    eq1 = wadd<I>((I)(cnt & 0xffff), cp);
    d_eq = (I)(cnt >> 16);
    return;
  }
  // each half over its own end's row (wl < NW: k <= 8 NW, ops/bi_d.py)
  constexpr int PER = (NW + 15) / 16;  // words a lane
  const int* row = rows + (size_t)blk * ROW_WORDS;
  const int* lw = row + N_CP + hl;  // the lane's words: lw[16 * i]
  const int wl = off >> 3;
  const int imax = max(wl >> 4, __shfl_xor_sync(FULL, wl >> 4, 16));
  // every load first: the checkpoint of s, then the prefix's words
  const I cp = row_checkpoint<I>(row, s - 1);
  unsigned words[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    words[i] = hl + 16 * i <= wl ? (unsigned)__ldg(lw + 16 * i) : 0u;
  const unsigned m = last_mask(off);
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (i > imax) break;
    cnt += sw.eq(hl + 16 * i == wl ? words[i] & m : words[i]);
  }
#pragma unroll
  for (int d = 8; d > 0; d >>= 1) cnt += __shfl_xor_sync(FULL, cnt, d);
  const I eq = r < 0 ? (I)0 : wadd<I>((I)cnt, cp);
  const I o_eq = __shfl_xor_sync(FULL, eq, 16);
  eq1 = upper ? o_eq : eq;
  d_eq = upper ? wsub<I>(eq, o_eq) : wsub<I>(o_eq, eq);
}

// One walk of one part, by one warp: `swapped` is part 1's forward
// extension.  Position idx of the part is ranks[idx] / pens[idx] of the
// part's staged rows.
//
// A walk extends in one direction only, so of the interval's two lower
// ends it ranks one, x (lower, or lower_rev when swapped), and the other
// never reaches a rank query or the output: the walk carries x and the
// size alone.  The child by symbol s is (less[s] + occ(s, x - 1), occ(s,
// x + size - 1) - occ(s, x - 1)), as fm.py extend_batch sweeps it.
// root[s - 1]: the size of the whole text's child by s (the block computes
// it once: a walk starts there and returns there at each failure).
template <typename I, bool SWAPPED>
__device__ __forceinline__ void walk_part(const BidArgs& a, const BidPlan& p,
                                          const I* less, const I* root,
                                          const unsigned char* ranks,
                                          const float* pens, int plen,
                                          int n_steps, int skip, int* acc) {
  const I text_len = (I)a.text_len;
  const int M = a.M;
  const bool lead = (threadIdx.x & 31) == 0;
  const int last = plen < n_steps ? plen : n_steps;
  if (skip >= last) return;  // z stays 0: the array's starting key
  I x = 0, size = text_len;
  float z = 0.0f, rm = __int_as_float(F32_LOWEST_BITS);
  for (int idx = skip; idx < last; ++idx) {
    const int c = ranks[idx];
    rm = fmaxf(rm, pens[idx]);
    bool dead = true;
    if (c != 0) {
      // the symbol (its complement when swapped)
      const int s = SWAPPED ? 5 - c : c;
      if (x == 0 && size == text_len) {
        x = less[s];  // the whole text's child
        size = root[s - 1];
      } else {
        I eq1, d_eq;
        occ_sym_step<I>(a.rows, a.nb, a.occ_k, p.div_magic, p.div_shift, s,
                        occ_query_lower<I>(x), occ_query_upper<I>(x, size),
                        eq1, d_eq);
        x = wadd<I>(less[s], eq1);
        size = d_eq;
      }
      dead = size < 1;
    }
    if (dead) {
      z = z + rm;
      x = 0;
      size = text_len;
      rm = __int_as_float(F32_LOWEST_BITS);
    }
    if (lead && idx + 1 < M)
      atomicMin(&acc[idx + 1], mono_bits(__float_as_int(z)));
  }
  // past the part's end the walk idles: z stays to column n_steps
  const int key = mono_bits(__float_as_int(z));
  for (int i = last + 1 + (threadIdx.x & 31); i <= n_steps && i < M; i += 32)
    atomicMin(&acc[i], key);
}

template <typename I>
static __global__ void __launch_bounds__(BID_WARPS * 32, BID_MIN_BLOCKS)
bi_d_kernel(BidArgs a, BidPlan p) {
  // the parts' D arrays as int keys, their penalty rows and their rank rows
  // as bytes (0 where the rank is invalid); part 2's rows are the read's
  // tail reversed
  extern __shared__ __align__(16) int keys[];
  __shared__ I s_less[5];
  __shared__ I s_root[4];
  __shared__ int s_next;
  const int tid = threadIdx.x, nthreads = blockDim.x, M = a.M;
  const int parts = a.forward_part ? 2 : 1;
  float* pens = (float*)(keys + parts * M);
  unsigned char* ranks = (unsigned char*)(pens + parts * M);
  const size_t base = (size_t)blockIdx.x * M;
  const int nn = a.n[blockIdx.x], sp = a.split[blockIdx.x];
  if (tid < 5) s_less[tid] = ((const I*)a.less)[tid];
  if (tid == 0) s_next = 0;
  for (int i = tid; i < M; i += nthreads) {
    int c = a.rank[base + i];
    keys[i] = 0;  // the key of 0.0f: the final minimum with zero
    pens[i] = a.pen[base + i];
    ranks[i] = (unsigned char)(c >= 1 && c <= 4 ? c : 0);
    if (parts == 2) {
      int col = nn - 1 - i;
      col = col < 0 ? 0 : (col > M - 1 ? M - 1 : col);
      c = a.rank[base + col];
      keys[M + i] = 0;
      pens[M + i] = a.pen[base + col];
      ranks[M + i] = (unsigned char)(c >= 1 && c <= 4 ? c : 0);
    }
  }
  if (tid < 32) {
    // the sizes of the whole text's children, by the walks' own K1
    const I text_len = (I)a.text_len;
    for (int s = 1; s <= 4; ++s) {
      I eq1, d_eq;
      occ_sym_step<I>(a.rows, a.nb, a.occ_k, p.div_magic, p.div_shift, s,
                      occ_query_lower<I>((I)0),
                      occ_query_upper<I>((I)0, text_len), eq1, d_eq);
      if (tid == 0) s_root[s - 1] = d_eq;
    }
  }
  __syncthreads();
  // the walks: unit u is walk u / parts of part u % parts
  const int units = parts * MAX_OFFSET;
  for (;;) {
    int u = 0;
    if ((tid & 31) == 0) u = atomicAdd(&s_next, 1);
    u = __shfl_sync(0xffffffffu, u, 0);
    if (u >= units) break;
    const int w = u / parts;
    if (u - w * parts == 1)
      walk_part<I, false>(a, p, s_less, s_root, ranks + M, pens + M,
                          nn - sp, a.steps_fwd, w, keys + M);
    else
      walk_part<I, true>(a, p, s_less, s_root, ranks, pens, sp,
                         a.steps_back, w, keys);
  }
  __syncthreads();
  for (int j = tid; j < M; j += nthreads) {
    int key = keys[j];
    if (parts == 2 && j >= sp) {
      int k = j - sp;
      k = k < 0 ? 0 : (k > M - 1 ? M - 1 : k);
      key = keys[M + k];
    }
    a.out[base + j] = __int_as_float(mono_bits(key));
  }
}

// blocks of `threads` threads and `smem` bytes of dynamic shared memory of
// the int32 (or, with `big`, the int64) kernel that one SM holds at once
extern "C" int bid_occupancy(int big, int threads, int smem, int* per_sm) {
  if (big)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, bi_d_kernel<int64_t>, threads, (size_t)smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, bi_d_kernel<int32_t>, threads, (size_t)smem);
}

// One launch computes every read's composite, a block a read.  A launch
// the card refuses returns its error; nothing else is tried.
extern "C" int bi_d(const BidArgs* a, const BidPlan* p, cudaStream_t stream) {
  if (a->R <= 0) return 0;
  if (a->M > BID_MAX_M || p->warps < 1 || p->warps > BID_WARPS)
    return (int)cudaErrorInvalidValue;
  if (a->big)
    bi_d_kernel<int64_t><<<a->R, p->warps * 32, (size_t)p->smem, stream>>>(
        *a, *p);
  else
    bi_d_kernel<int32_t><<<a->R, p->warps * 32, (size_t)p->smem, stream>>>(
        *a, *p);
  CHECK_LAUNCH();
  return 0;
}
