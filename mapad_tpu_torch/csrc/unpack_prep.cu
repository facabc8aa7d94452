// K4 and K6: unpack one invocation's upload blob into the pool search's
// inputs.  K4 (host Bi-D) writes the LUT/Bi-D rows; K6 (Bi-D on the card)
// writes the dense per-read inputs that K7 and the row assembly read.
//
// K4
// replaces mapad_tpu/ops/engine.py `_unpack_prep_lut` (230-288) with
// `_unpack_cq10` (220-227).  Plain version: ops/engine.py
// `_unpack_prep_lut_plain`.
//
// Blob layout (int32 words): n | split | scale | thresh | repr_mm (R each),
// then the Bi-D -- with rle, 8 words of u8 break positions and 32 f32 run
// values per read; without, R*M raw f32 -- then the (class, qual) cells,
// three 10-bit cells per word.  One thread per (read, position) cell: a
// pure bit copy and gather.  Cell j's Bi-D is vals[count(j >= break)] over
// the 31 breaks (255 = unused); its 4 scores are row
// off[n] + (j*5 + cls)*Q + q of the all-length table, or the table's zero
// row (the last) for padding cells j >= n.
//
// Bound on the card: bytes -- 24 B written per cell (25 MB at R=8192,
// M=128) plus the blob and ~16 B of L2-resident table per cell.
//
// K6 replaces `_unpack_prep_full` (mapad_tpu/ops/engine.py:291-323).  Plain
// version: ops/engine.py `_unpack_prep_full_plain`.  The blob is the five
// consts and the (class, qual) cells only.  One thread per cell decodes its
// 10-bit cell as K4 does, gathers the 16 B score row and the 4 B penalty
// of the same table row, and writes rank (class + 1, 0 for a non-ACGT
// class), code (the class), the four scores and the penalty.
//
// Bound on the card: bytes -- 28 B written per cell (14.7 MB at R=4096,
// M=128) plus the blob (0.7 MB) and ~20 B of L2-resident table per cell.
#include "common.cuh"

using namespace mapad;

constexpr int BID_SEG = 32;

struct UnpackArgs {
  const int* blob;
  const float* tab;  // (tab_rows, 4)
  const int* off;    // (n_off,)
  int tab_rows, n_off, R, M, Q, rle;
  float* slut;  // (R*M, 6)
};

// table row of cell (r, j): off[n] + (j*5 + cls)*Q + q, or the table's
// zero row (the last) for padding cells j >= n; gathers clamp like XLA's
static __device__ __forceinline__ int table_row(const int* off, int n_off,
                                                int tab_rows, int n, int j,
                                                int cls, int q, int Q) {
  const int ni = n < 0 ? 0 : (n > n_off - 1 ? n_off - 1 : n);
  const int idx = j < n ? off[ni] + (j * 5 + cls) * Q + q : tab_rows - 1;
  return idx < 0 ? 0 : (idx > tab_rows - 1 ? tab_rows - 1 : idx);
}

static __global__ void unpack_prep_kernel(UnpackArgs a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t RM = (size_t)a.R * a.M;
  if (i >= RM) return;
  const int R = a.R, M = a.M;
  const int r = (int)(i / M), j = (int)(i % M);
  const int n = a.blob[r];
  float bid;
  size_t cq_base;
  if (a.rle) {
    const int* w4 = a.blob + 5 * (size_t)R + (size_t)r * (BID_SEG / 4);
    int seg = 0;
    for (int k = 0; k < BID_SEG - 1; ++k) {
      const int b = (w4[k >> 2] >> (8 * (k & 3))) & 0xFF;
      seg += j >= b;
    }
    bid = __int_as_float(
        a.blob[(5 + BID_SEG / 4) * (size_t)R + (size_t)r * BID_SEG + seg]);
    cq_base = (5 + BID_SEG / 4 + BID_SEG) * (size_t)R;
  } else {
    bid = __int_as_float(a.blob[5 * (size_t)R + i]);
    cq_base = 5 * (size_t)R + RM;
  }
  const int w = a.blob[cq_base + i / 3];
  const int cq = (w >> (10 * (int)(i % 3))) & 0x3FF;
  const int cls = cq >> 7, q = cq & 0x7F;
  const int idx = table_row(a.off, a.n_off, a.tab_rows, n, j, cls, q, a.Q);
  float* out = a.slut + i * 6;
  const float* t = a.tab + (size_t)idx * 4;
  out[0] = t[0];
  out[1] = t[1];
  out[2] = t[2];
  out[3] = t[3];
  out[4] = (float)cls;
  out[5] = bid;
}

struct UnpackFullArgs {
  const int* blob;
  const float* tab;      // (tab_rows, 4)
  const float* pen_tab;  // (tab_rows,)
  const int* off;        // (n_off,)
  int tab_rows, n_off, R, M, Q;
  int* rank;         // (R, M)
  int* code;         // (R, M)
  float* score_lut;  // (R, M, 4)
  float* pen;        // (R, M)
};

static __global__ void unpack_prep_full_kernel(UnpackFullArgs a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t RM = (size_t)a.R * a.M;
  if (i >= RM) return;
  const int r = (int)(i / a.M), j = (int)(i % a.M);
  const int n = a.blob[r];
  const int w = a.blob[5 * (size_t)a.R + i / 3];
  const int cq = (w >> (10 * (int)(i % 3))) & 0x3FF;
  const int cls = cq >> 7, q = cq & 0x7F;
  const int idx = table_row(a.off, a.n_off, a.tab_rows, n, j, cls, q, a.Q);
  const float4 t = *reinterpret_cast<const float4*>(a.tab + (size_t)idx * 4);
  *reinterpret_cast<float4*>(a.score_lut + i * 4) = t;
  a.pen[i] = a.pen_tab[idx];
  a.code[i] = cls;
  a.rank[i] = cls < 4 ? cls + 1 : 0;
}

extern "C" int unpack_prep_full(const UnpackFullArgs* a,
                                cudaStream_t stream) {
  const size_t RM = (size_t)a->R * a->M;
  if (RM == 0) return 0;
  LAUNCH(unpack_prep_full_kernel, (unsigned)((RM + 255) / 256), 256, stream,
         *a);
  CHECK_LAUNCH();
  return 0;
}

extern "C" int unpack_prep(const UnpackArgs* a, cudaStream_t stream) {
  const size_t RM = (size_t)a->R * a->M;
  if (RM == 0) return 0;
  LAUNCH(unpack_prep_kernel, (unsigned)((RM + 255) / 256), 256, stream, *a);
  CHECK_LAUNCH();
  return 0;
}
