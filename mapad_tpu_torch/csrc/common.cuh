// Shared definitions of the port's CUDA kernels (sm_90a, built with
// --fmad=false: every f32 add/compare/divide rounds exactly as the plain
// PyTorch versions and the JAX reference do).
//
// K1 lives here as the warp-cooperative __device__ function `occ4_warp`:
// the rank query of mapad_tpu/ops/fm.py `_row_occ4` over one fused
// 512 B row (6 checkpoint words + 122 words of 4-bit BWT symbols, k=976).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)

#define CHECK_LAUNCH()                        \
  do {                                        \
    cudaError_t e_ = cudaGetLastError();      \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

namespace mapad {

constexpr int CANDS = 9;
constexpr int NF = 8;
constexpr int REC = CANDS * NF;  // int32 words per store block
constexpr int ROW_WORDS = 128;
constexpr int N_CP = 6;
constexpr int INT_MIN32 = (-2147483647 - 1);

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
  LS_FINISH, LS_ACTIVE, N_LANE_STATE
};
// glob[]: device-side loop counters
enum Glob { G_STEP = 0, G_NEXT_READ = 1, G_DONE = 2 };

struct PoolArgs {
  const int* rows;
  const int* less;
  const int* sent;
  int nb, occ_k, text_len;
  const float* slut;  // (R*M, 6)
  const int* n;
  const int* split;
  const float* scale;
  const float* thresh;
  const float* repr;
  int R, M, L, S, CAP, RB, track;
  float pgo_pge, pge;
  int gap_dist_ends, max_gaps;
  int* store;     // (L, S+1, 9, 8)
  int* bmask;     // (L, S) 9-bit completion/abandon mask per block
  int* consumed;  // (L, RB)
  int* bm_key;    // (L, RB)
  int* lane;      // (N_LANE_STATE, L)
  int* glob;      // (4,)
  int* fin_log;   // (L, S) or null
};

struct ExtractArgs {
  const int* store;
  const int* bmask;
  const int* lane;
  const int* glob;
  const int* fin_log;
  int R, L, S, C, MW, track;
  int* lane_cnt;    // (L,) scratch: marked entries per lane
  int* lane_off;    // (L,) scratch: lane-order exclusive prefix sum
  int* lane_first;  // (L,) scratch: first marked block per lane (or S)
  int* c_lane;      // (C,) scratch: lane of each compacted entry
  int* pad;         // (2,) scratch: lane and block of the first mark
  int* c_read;
  int* c_slot;
  uint8_t* c_abandon;
  int* c_lower;
  int* c_lrev;
  int* c_size;
  float* c_score;
  int* c_ops;
  int* n_chains;
  int* lane_read;
  uint8_t* lane_unfinished;
  int* next_read;
  int* steps;
  int* read_steps;  // (R+1,)
};

// two's-complement wrapping int32 arithmetic (JAX wraps; lanes that hold
// no read compute on garbage and must not hit signed-overflow UB)
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
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

// K1: counts of ranks 1..4 in bwt[0..=r] (0 for r < 0), from one fused
// row.  Every lane of the calling warp passes the same r and receives the
// same counts.  Each lane counts 4 of the 122 symbol words with SWAR
// nibble compares; a 5-step butterfly sums them.
__device__ __forceinline__ void occ4_warp(const int* __restrict__ rows,
                                          int nb, int k, int r,
                                          int out[4]) {
  const int lane = threadIdx.x & 31;
  const int r_safe = r > 0 ? r : 0;
  int blk = r_safe / k;
  if (blk > nb - 1) blk = nb - 1;  // clamp like XLA's gather
  const int off = r_safe % k;
  const int* row = rows + (size_t)blk * ROW_WORDS;
  int c[4] = {0, 0, 0, 0};
  for (int w = lane; w < ROW_WORDS - N_CP; w += 32) {
    const int nv = off - w * 8 + 1;  // symbols of this word in the prefix
    if (nv <= 0) continue;
    const unsigned m =
        nv >= 8 ? 0x11111111u : (0x11111111u & ((1u << (4 * nv)) - 1u));
    const unsigned word = (unsigned)row[N_CP + w];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      unsigned x = word ^ ((unsigned)(s + 1) * 0x11111111u);
      unsigned t = x | (x >> 1);
      t |= t >> 2;  // bit 0 of each nibble: nibble != symbol
      c[s] += __popc(~t & m);
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) c[s] += __shfl_xor_sync(0xffffffffu, c[s], d);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) out[s] = r >= 0 ? wadd(c[s], row[1 + s]) : 0;
}

__device__ __forceinline__ int sentinel_count(const int* sent, int r) {
  return (r >= sent[0] ? 1 : 0) + (r >= sent[1] ? 1 : 0);
}

// the extension sweep of fm.py extend_batch from the two rank queries:
// child intervals in slot order [T, G, C, A] (ranks 4, 3, 2, 1)
__device__ __forceinline__ void extend_from_occ(
    const int* less, const int* sent, int lower, int lower_rev, int size,
    const int occ1[4], const int occ2[4], int ch_lower[4], int ch_lrev[4],
    int ch_size[4]) {
  const int r1 = wsub(lower, 1);
  const int r2 = wsub(wadd(lower, size), 1);
  const int sent1 = lower == 0 ? 0 : sentinel_count(sent, r1);
  const int sent2 = sentinel_count(sent, r2);
  int s_run = sent2 - sent1;
  int l_run = lower_rev;
#pragma unroll
  for (int slot = 0; slot < 4; ++slot) {
    const int c = 4 - slot;
    l_run = wadd(l_run, s_run);
    const int o = occ1[c - 1];
    s_run = wsub(occ2[c - 1], o);
    ch_lower[slot] = wadd(less[c], o);
    ch_lrev[slot] = l_run;
    ch_size[slot] = s_run;
  }
}

}  // namespace mapad
