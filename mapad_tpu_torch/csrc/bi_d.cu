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
// part's D array is the minimum over the walks and 0.
//
// Design: one block per read, one warp per walk.  A warp walks its part
// alone with K1 inline (occ4_warp: two fused 512 B row reads a step, every
// lane of the warp ends with the same counts, so the interval, z and rm
// live in registers, redundantly per lane).  Lane 0 folds z into the
// part's shared array with an atomicMin on the order-preserving int key of
// the f32 (a minimum is order-free, so exact; the array starts at the key
// of 0.0).  Part 1 walks pattern[:split] through the swapped interval with
// the complement symbol (a forward extension); part 2, if asked for, walks
// pattern[split:] reversed with backward extensions and is re-indexed into
// the composite with clipping (bi_d.py:143-156).
//
// Bound on the card: bytes -- two 512 B index rows per walk step (L2
// resident for a small index) plus the (R, M) inputs and output.
#include "common.cuh"

using namespace mapad;

constexpr int MAX_OFFSET = 15;
constexpr int BID_MAX_M = 1024;
constexpr int F32_LOWEST_BITS = (int)0xff7fffff;  // -3.4028235e38

struct BidArgs {
  const int* rows;
  const void* less;
  const void* sent;
  int nb, occ_k, big;
  long long text_len;
  const int* rank;   // (R, M) symbol ranks 1..4, 0 invalid
  const float* pen;  // (R, M) penalty elements
  const int* n;      // (R,)
  const int* split;  // (R,)
  int R, M, steps_back, steps_fwd, forward_part;
  float* out;  // (R, M)
};

// One walk of one part.  `swapped`: part 1's forward extension.  Position
// idx of the part reads column idx (part 1) or n-1-idx (part 2) of the read.
template <typename I>
static __device__ __forceinline__ void walk_part(
    const BidArgs& a, const int* rank, const float* pen, int nn, int plen,
    int n_steps, bool swapped, int skip, int* acc) {
  const I* less = (const I*)a.less;
  const I* sent = (const I*)a.sent;
  const I text_len = (I)a.text_len;
  const int M = a.M;
  const bool lead = (threadIdx.x & 31) == 0;
  I lower = 0, lrev = 0, size = text_len;
  float z = 0.0f, rm = __int_as_float(F32_LOWEST_BITS);
  const int last = plen < n_steps ? plen : n_steps;
  for (int idx = skip; idx < last; ++idx) {
    int col = idx;
    if (!swapped) {
      col = nn - 1 - idx;
      col = col < 0 ? 0 : (col > M - 1 ? M - 1 : col);
    }
    const int c = rank[col];
    const float p = pen[col];
    const bool valid = c >= 1 && c <= 4;
    const I in_lower = swapped ? lrev : lower;
    const I in_lrev = swapped ? lower : lrev;
    I occ1[4], occ2[4];
    occ4_warp<I>(a.rows, a.nb, a.occ_k, occ_query_lower<I>(in_lower), occ1);
    occ4_warp<I>(a.rows, a.nb, a.occ_k, occ_query_upper<I>(in_lower, size),
                 occ2);
    I ch_lower[4], ch_lrev[4], ch_size[4];
    extend_from_occ<I>(less, sent, in_lower, in_lrev, size, occ1, occ2,
                       ch_lower, ch_lrev, ch_size);
    // child of the symbol (its complement when swapped): slot 4 - rank
    const int sel = valid ? (swapped ? 5 - c : c) : 0;
    I sl = 0, slr = 0, ss = 0;
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) {
      if (valid && slot == 4 - sel) {
        sl = ch_lower[slot];
        slr = ch_lrev[slot];
        ss = ch_size[slot];
      }
    }
    lower = swapped ? slr : sl;
    lrev = swapped ? sl : slr;
    size = ss;
    rm = fmaxf(rm, p);
    if (size < 1) {
      z = z + rm;
      lower = 0;
      lrev = 0;
      size = text_len;
      rm = __int_as_float(F32_LOWEST_BITS);
    }
    if (lead && idx + 1 < M)
      atomicMin(&acc[idx + 1], mono_bits(__float_as_int(z)));
  }
  // past the part's end the walk idles: z stays to column n_steps
  const int from = (last > skip ? last : skip) + 1;
  const int key = mono_bits(__float_as_int(z));
  for (int i = from + (threadIdx.x & 31); i <= n_steps && i < M; i += 32)
    atomicMin(&acc[i], key);
}

template <typename I>
static __global__ void __launch_bounds__(MAX_OFFSET * 32)
bi_d_kernel(BidArgs a) {
  __shared__ int d_back[BID_MAX_M];
  __shared__ int d_fwd[BID_MAX_M];
  const int r = blockIdx.x, tid = threadIdx.x, M = a.M;
  const int w = tid >> 5;
  const int nn = a.n[r], sp = a.split[r];
  const int* rank = a.rank + (size_t)r * M;
  const float* pen = a.pen + (size_t)r * M;
  for (int i = tid; i < M; i += blockDim.x) {
    d_back[i] = 0;  // the key of 0.0f: the final minimum with zero
    d_fwd[i] = 0;
  }
  __syncthreads();
  walk_part<I>(a, rank, pen, nn, sp, a.steps_back, true, w, d_back);
  if (a.forward_part)
    walk_part<I>(a, rank, pen, nn, nn - sp, a.steps_fwd, false, w, d_fwd);
  __syncthreads();
  float* out = a.out + (size_t)r * M;
  for (int j = tid; j < M; j += blockDim.x) {
    int key = d_back[j];
    if (a.forward_part && j >= sp) {
      int k = j - sp;
      k = k < 0 ? 0 : (k > M - 1 ? M - 1 : k);
      key = d_fwd[k];
    }
    out[j] = __int_as_float(mono_bits(key));
  }
}

extern "C" int bi_d(const BidArgs* a, cudaStream_t stream) {
  if (a->R <= 0) return 0;
  if (a->M > BID_MAX_M) return (int)cudaErrorInvalidValue;
  if (a->big)
    LAUNCH(bi_d_kernel<int64_t>, a->R, MAX_OFFSET * 32, stream, *a);
  else
    LAUNCH(bi_d_kernel<int32_t>, a->R, MAX_OFFSET * 32, stream, *a);
  CHECK_LAUNCH();
  return 0;
}
