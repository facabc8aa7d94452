// K5: flatten a PoolResult into the one int32 buffer the host copies back.
//
// Replaces mapad_tpu/ops/engine.py `_pack_result` (1589-1634).  Plain
// version: ops/engine.py `_pack_result_plain`; the host reader is the
// numpy `_unpack_result` of ops/prep.py.
//
// Fields in PoolResult order, each as int32 words: i32 fields as they are,
// f32 as their bits, int64 fields (c_lower, c_lrev, c_size with a big
// index) as little-endian int32 pairs, bools widened to 0/1, and c_ops
// narrowed to wire ops
// (base[0:2] | pos | kind | VALID in 5 + pb bits, pb = ceil(log2 MW)),
// K = 64 / opbits of them per little-endian int64 (12-bit ops, 5 per int64
// at MW <= 128).  One thread per output word; a c_ops word's thread builds
// its whole int64 and keeps its half.
//
// Bound on the card: bytes -- it reads C*MW*4 B of op words (8.4 MB at
// C=16384, MW=128) and writes a fifth of that.
#include "common.cuh"

using namespace mapad;

struct PackArgs {
  const int* c_read;
  const int* c_slot;
  const uint8_t* c_abandon;
  const int* c_lower;  // (C,) int32, or (C,) int64 read as (2C,) words
  const int* c_lrev;
  const int* c_size;
  const int* c_score;  // f32 bits
  const int* c_ops;    // (C, MW)
  const int* n_chains;
  const int* lane_read;
  const uint8_t* lane_unfinished;
  const int* next_read;
  const int* steps;
  const int* read_steps;  // (R,)
  int C, MW, L, R;
  int opbits, K, pb, big;
  int* out;
};

static __device__ __forceinline__ long long narrow_op(int w, int pb) {
  w &= 0x1FFFFF;
  return (long long)((w & 3) | (((w >> 2) & ((1 << pb) - 1)) << 2) |
                     (((w >> 17) & 3) << (2 + pb)) |
                     (((w >> 20) & 1) << (4 + pb)));
}

static __global__ void pack_result_kernel(PackArgs a, size_t total) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t C = a.C;
  const int G = (a.MW + a.K - 1) / a.K;  // int64 words per chain
  const size_t n_ops = C * G * 2;
  int v;
  const size_t W = a.big ? 2 * C : C;  // words of an interval field
  const size_t head = 4 * C + 3 * W;
  if (i < head) {
    if (i < C) {
      v = a.c_read[i];
    } else if (i < 2 * C) {
      v = a.c_slot[i - C];
    } else if (i < 3 * C) {
      v = a.c_abandon[i - 2 * C] ? 1 : 0;
    } else if (i < 3 * C + W) {
      v = a.c_lower[i - 3 * C];
    } else if (i < 3 * C + 2 * W) {
      v = a.c_lrev[i - 3 * C - W];
    } else if (i < 3 * C + 3 * W) {
      v = a.c_size[i - 3 * C - 2 * W];
    } else {
      v = a.c_score[i - 3 * C - 3 * W];
    }
  } else if ((i -= head) < n_ops) {
    const size_t p = i >> 1;
    const size_t row = p / G;
    const int g = (int)(p % G);
    long long w64 = 0;
    for (int k = 0; k < a.K; ++k) {
      const int col = g * a.K + k;
      if (col < a.MW)
        w64 |= narrow_op(a.c_ops[row * a.MW + col], a.pb) << (k * a.opbits);
    }
    v = (i & 1) ? (int)(w64 >> 32) : (int)(w64 & 0xffffffffLL);
  } else if ((i -= n_ops) < 1) {
    v = a.n_chains[0];
  } else if ((i -= 1) < (size_t)a.L) {
    v = a.lane_read[i];
  } else if ((i -= a.L) < (size_t)a.L) {
    v = a.lane_unfinished[i] ? 1 : 0;
  } else if ((i -= a.L) < 1) {
    v = a.next_read[0];
  } else if ((i -= 1) < 1) {
    v = a.steps[0];
  } else {
    v = a.read_steps[i - 1];
  }
  a.out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = v;
}

extern "C" int pack_result(const PackArgs* a, long long total,
                           cudaStream_t stream) {
  if (total <= 0) return 0;
  LAUNCH(pack_result_kernel, (unsigned)((total + 255) / 256), 256, stream, *a,
         (size_t)total);
  CHECK_LAUNCH();
  return 0;
}
