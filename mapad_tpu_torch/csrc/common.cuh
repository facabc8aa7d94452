// Shared definitions of the port's CUDA kernels (sm_90a, built with
// --fmad=false: every f32 add/compare/divide rounds exactly as the plain
// PyTorch versions and the JAX reference do).
//
// K1 lives here as the warp-cooperative __device__ function `occ4_warp`:
// the rank query of mapad_tpu/ops/fm.py `_row_occ4` over one fused
// 512 B row.  Every function that touches an FMD interval is a template on
// the interval type I:
//   int32_t  small genomes: 6 checkpoint words + 122 words of 4-bit BWT
//            symbols (k = 976 per row), stored frames of 8 words;
//   int64_t  big genomes (text of 2^31-1 symbols or more): 6 lo + 6 hi
//            checkpoint words + 116 symbol words (k = 928), stored frames
//            of 11 words (the three interval fields' high halves follow
//            the 8 words of the small layout).
// The entry points take a `big` flag and launch the matching instance.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)

// Every library links its own CUDA runtime: the host wrapper makes the
// caller's torch device this runtime's current device before each call
// (_build.cuda_function), so a thread driving one card of several launches
// there.  Each library is one translation unit, so this is defined once.
extern "C" int set_device(int device) { return (int)cudaSetDevice(device); }

#define CHECK_LAUNCH()                        \
  do {                                        \
    cudaError_t e_ = cudaGetLastError();      \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

namespace mapad {

constexpr int CANDS = 9;
constexpr int NF = 8;
constexpr int ROW_WORDS = 128;
constexpr int INT_MIN32 = (-2147483647 - 1);

template <typename I>
struct Idx;
template <>
struct Idx<int32_t> {
  using U = uint32_t;
  static constexpr int N_CP = 6;  // checkpoint words of a fused row
  static constexpr int NFW = NF;  // int32 words of a stored frame
};
template <>
struct Idx<int64_t> {
  using U = uint64_t;
  static constexpr int N_CP = 12;
  static constexpr int NFW = NF + 3;
};

// frame fields
constexpr int F_LOWER = 0, F_LREV = 1, F_SIZE = 2, F_PARENT = 3,
              F_STARTLEN = 4, F_GAPS = 5, F_OP = 6, F_SCOREBITS = 7;
constexpr int GAP_CLOSED = 0, GAP_INSERTION = 1, GAP_DELETION = 2;
constexpr int OP_MATCH = 0, OP_MISMATCH = 1, OP_INSERTION = 2,
              OP_DELETION = 3;
constexpr int OP_VALID_BIT = 1 << 20;
constexpr int OP_COMP_BIT = 1 << 21;
constexpr int OP_ABANDON_BIT = 1 << 22;
constexpr int OP_PUSHED_BIT = 1 << 23;

// rows of the (N_LANE_STATE, L) lane-state tensor (ops/search_pool2.py)
enum LaneState {
  LS_READ_ID = 0, LS_FRESH, LS_DONE, LS_START, LS_AGE, LS_N, LS_SPLIT,
  LS_SCALE, LS_THRESH, LS_REPR, LS_BEST, LS_BEST_SIZE, LS_HCOUNT,
  LS_FINISH, LS_ACTIVE, LS_BEST_SIZE_HI, N_LANE_STATE
};
// glob[]: device-side loop counters (ops/search_pool2.py reads the first
// five from the host).  G_LIMIT: the step at which this store generation
// stops (S, or less under a capped spill); G_LIVE: lanes not yet done;
// G_BASE: the first step whose marks and finish events K3 has not seen;
// G_CUM: steps compacted away by K8 so far; G_ACC_N / G_ACC_NCH: chains
// K3 appended and counted at the boundaries so far.
enum Glob {
  G_STEP = 0, G_NEXT_READ = 1, G_DONE = 2, G_LIMIT = 3, G_LIVE = 4,
  G_BASE = 5, G_CUM = 6, G_ACC_N = 7, G_ACC_NCH = 8, N_GLOB = 12
};

struct PoolArgs {
  const int* rows;
  const void* less;  // int32 / int64 with big
  const void* sent;
  int nb, occ_k, big;
  long long text_len;
  const float* slut;  // (R*M, 6)
  const int* n;
  const int* split;
  const float* scale;
  const float* thresh;
  const float* repr;
  int R, M, L, S, CAP, RB, track;
  float pgo_pge, pge;
  int gap_dist_ends, max_gaps;
  int* store;     // (L, S+1, 9, NFW)
  int* bmask;     // (L, S) 9-bit completion/abandon mask per block
  int* consumed;  // (L, RB)
  int* bm_key;    // (L, RB)
  int* lane;      // (N_LANE_STATE, L)
  int* glob;      // (N_GLOB,)
  int* fin_log;   // (L, S) or null
  int bidir;      // bidirectional extension (center-start models)
  int fixed;      // > 0: exactly min(S, fixed) steps, done or not
};

// K8 (csrc/pool_compact.cu): what one store boundary reads and rewrites
struct CompactArgs {
  int* store;          // (L, S+1, 9, NFW)
  const int* consumed; // (L, RB) the rings as the step kernels left them
  const int* bm_key;
  int* consumed_next;  // (L, RB) the buffers the rotation writes
  int* bm_key_next;
  int* lane;           // (N_LANE_STATE, L)
  int* glob;           // (N_GLOB,)
  int L, S, CAP, RB;
  int spill;  // step cap of a generation after a boundary, 0 = none
  int big;
};

struct ExtractArgs {
  const int* store;
  const int* bmask;
  const int* lane;
  int* glob;  // K3 at a store boundary adds to G_ACC_N / G_ACC_NCH
  const int* fin_log;
  int R, L, S, C, MW, track, big;
  int first;  // no store boundary before this extraction
  int final;  // the extraction after the loop (else: at a store boundary)
  // (1 + blocks,) the grid barrier's slots: the last tag, then a block's
  // (zeroed once for the loop state the extractions share)
  int* flags;
  // (4L,) scratch: marked entries of each of the (at most 4) parts of a
  // lane's rounds, and each part's first marked block (or S)
  int* lane_cnt;
  int* lane_first;
  int* c_lane;      // (C,) scratch: lane of each compacted entry
  int* e_slot;      // (C,) scratch: its in-store slot
  // (L, S / 128 + 2) scratch: marked entries of each round of 128 mask
  // words of a lane
  int* round_cnt;
  int* c_read;
  int* c_slot;
  uint8_t* c_abandon;
  void* c_lower;  // int32 / int64 with big
  void* c_lrev;
  void* c_size;
  float* c_score;
  int* c_ops;
  int* n_chains;
  int* lane_read;
  uint8_t* lane_unfinished;
  int* next_read;
  int* steps;
  int* read_steps;  // (R+1,)
};

// two's-complement wrapping arithmetic (JAX wraps; lanes that hold no read
// compute on garbage and must not hit signed-overflow UB)
template <typename I>
__device__ __forceinline__ I wadd(I a, I b) {
  using U = typename Idx<I>::U;
  return (I)((U)a + (U)b);
}
template <typename I>
__device__ __forceinline__ I wsub(I a, I b) {
  using U = typename Idx<I>::U;
  return (I)((U)a - (U)b);
}
__device__ __forceinline__ int wshl(int a, int s) {
  return (int)((unsigned)a << s);
}
__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}
// order-preserving int32 key of an f32 (ops/search_pool2.py mono)
__device__ __forceinline__ int mono_bits(int u) {
  return u ^ ((u >> 31) & 0x7FFFFFFF);
}

// an interval field (F_LOWER, F_LREV, F_SIZE) of a stored frame
template <typename I>
__device__ __forceinline__ I frame_get(const int* fr, int f);
template <>
__device__ __forceinline__ int32_t frame_get<int32_t>(const int* fr, int f) {
  return fr[f];
}
template <>
__device__ __forceinline__ int64_t frame_get<int64_t>(const int* fr, int f) {
  return (int64_t)(((uint64_t)(uint32_t)fr[NF + f] << 32) |
                   (uint64_t)(uint32_t)fr[f]);
}
__device__ __forceinline__ void frame_put(int* fr, int f, int32_t v) {
  fr[f] = v;
}
__device__ __forceinline__ void frame_put(int* fr, int f, int64_t v) {
  fr[f] = (int)(uint32_t)((uint64_t)v & 0xffffffffu);
  fr[NF + f] = (int)(uint32_t)((uint64_t)v >> 32);
}

// checkpoint count of rank s+1 in a fused row
template <typename I>
__device__ __forceinline__ I row_checkpoint(const int* row, int s);
template <>
__device__ __forceinline__ int32_t row_checkpoint<int32_t>(const int* row,
                                                           int s) {
  return row[1 + s];
}
template <>
__device__ __forceinline__ int64_t row_checkpoint<int64_t>(const int* row,
                                                           int s) {
  return (int64_t)(((uint64_t)(uint32_t)row[7 + s] << 32) |
                   (uint64_t)(uint32_t)row[1 + s]);
}

// K1: counts of ranks 1..4 in bwt[0..=r] (0 for r < 0), from one fused
// row.  Every lane of a group of W aligned lanes of the calling warp
// (W = 32: the whole warp; W = 16: a half, see occ4_pair) passes the same
// r and receives the same counts; the whole warp calls it together.  Each
// lane counts 128 / W of the symbol words with SWAR nibble compares; a
// butterfly over the group sums them.
template <typename I, int W = 32>
__device__ __forceinline__ void occ4_warp(const int* __restrict__ rows,
                                          int nb, int k, I r, I out[4]) {
  static_assert(W == 32 || W == 16, "a warp or a half warp");
  constexpr int N_CP = Idx<I>::N_CP;
  constexpr int PER = (ROW_WORDS - N_CP + W - 1) / W;  // words a lane
  const int lane = threadIdx.x & (W - 1);
  const I r_safe = r > 0 ? r : 0;
  // the block number is an int32 (a garbage int64 position wraps), a
  // negative one counts from the end, and the gather clamps like XLA's
  int blk = (int)(r_safe / k);
  if (blk < 0) blk += nb;
  blk = blk < 0 ? 0 : (blk > nb - 1 ? nb - 1 : blk);
  const int off = (int)(r_safe % k);
  const int* row = rows + (size_t)blk * ROW_WORDS;
  // every load of the row first (one round trip), then the counts
  I cp[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) cp[s] = row_checkpoint<I>(row, s);
  unsigned words[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int w = lane + i * W;
    words[i] = w < ROW_WORDS - N_CP ? (unsigned)row[N_CP + w] : 0u;
  }
  int c[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int w = lane + i * W;
    const int nv = off - w * 8 + 1;  // symbols of this word in the prefix
    if (nv <= 0 || w >= ROW_WORDS - N_CP) continue;
    const unsigned m =
        nv >= 8 ? 0x11111111u : (0x11111111u & ((1u << (4 * nv)) - 1u));
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      unsigned x = words[i] ^ ((unsigned)(s + 1) * 0x11111111u);
      unsigned t = x | (x >> 1);
      t |= t >> 2;  // bit 0 of each nibble: nibble != symbol
      c[s] += __popc(~t & m);
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int d = W / 2; d > 0; d >>= 1)
      c[s] += __shfl_xor_sync(0xffffffffu, c[s], d);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
    out[s] = r >= 0 ? wadd<I>((I)c[s], cp[s]) : (I)0;
}

// K1's two rank queries of one extension in one warp: the lower half
// ranks r1 and the upper half r2, each over its own fused row at once;
// every lane receives both sets of counts.
template <typename I>
__device__ __forceinline__ void occ4_pair(const int* __restrict__ rows,
                                          int nb, int k, I r1, I r2,
                                          I occ1[4], I occ2[4]) {
  I out[4];
  occ4_warp<I, 16>(rows, nb, k, (threadIdx.x & 16) ? r2 : r1, out);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    occ1[s] = __shfl_sync(0xffffffffu, out[s], 0);
    occ2[s] = __shfl_sync(0xffffffffu, out[s], 16);
  }
}

template <typename I>
__device__ __forceinline__ I sentinel_count(const I* sent, I r) {
  return (I)((r >= sent[0] ? 1 : 0) + (r >= sent[1] ? 1 : 0));
}

// the extension sweep of fm.py extend_batch from the two rank queries:
// child intervals in slot order [T, G, C, A] (ranks 4, 3, 2, 1)
template <typename I>
__device__ __forceinline__ void extend_from_occ(
    const I* less, const I* sent, I lower, I lower_rev, I size,
    const I occ1[4], const I occ2[4], I ch_lower[4], I ch_lrev[4],
    I ch_size[4]) {
  const I r1 = wsub<I>(lower, 1);
  const I r2 = wsub<I>(wadd<I>(lower, size), 1);
  const I sent1 = lower == 0 ? (I)0 : sentinel_count<I>(sent, r1);
  const I sent2 = sentinel_count<I>(sent, r2);
  I s_run = sent2 - sent1;
  I l_run = lower_rev;
#pragma unroll
  for (int slot = 0; slot < 4; ++slot) {
    const int c = 4 - slot;
    l_run = wadd<I>(l_run, s_run);
    const I o = occ1[c - 1];
    s_run = wsub<I>(occ2[c - 1], o);
    ch_lower[slot] = wadd<I>(less[c], o);
    ch_lrev[slot] = l_run;
    ch_size[slot] = s_run;
  }
}

// the two rank queries of an extension: the interval's lower and upper end
template <typename I>
__device__ __forceinline__ I occ_query_lower(I lower) {
  return lower == 0 ? (I)-1 : wsub<I>(lower, 1);
}
template <typename I>
__device__ __forceinline__ I occ_query_upper(I lower, I size) {
  return wsub<I>(wadd<I>(lower, size), 1);
}

// asynchronous global -> shared copies (sm_80+ `cp.async`): the counterpart
// of a TPU kernel's `make_async_copy(...).start()`; `cp_async_wait_all` is
// its semaphore wait.  16-byte copies need both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Hopper's bulk asynchronous copies (the TMA engine) between global and
// shared memory, counted by an mbarrier: the counterpart of a TPU kernel's
// whole-block `make_async_copy`.  Both addresses 16-byte aligned, the size
// a multiple of 16 bytes.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the mbarrier of a block's bulk loads: one arrival (the caller's, which
// also announces the bytes), then the copies' completions
__device__ __forceinline__ void bar_init(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(bar)
      : "memory");
}

// the threads' writes to shared memory, before the copy engine reads them
// (then a __syncthreads before the bulk store is issued)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared -> global, the same conditions
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(gmem), "r"(smem_addr(smem)), "r"(bytes)
               : "memory");
}

// the bulk stores issued by this thread have read shared memory
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

}  // namespace mapad
