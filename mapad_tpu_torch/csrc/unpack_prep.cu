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
// three 10-bit cells per word.  Cell j's Bi-D is vals[count(j >= break)]
// over the 31 breaks (255 = unused); its 4 scores are row
// off[n] + (j*5 + cls)*Q + q of the all-length table, or the table's zero
// row (the last) for padding cells j >= n.
//
// Bound on the card: bytes -- 24 B written per cell (25 MB at R=8192,
// M=128) plus the blob and ~16 B of L2-resident table per cell.
//
// A block takes `reads` whole reads (the launch plan, ops/engine.py
// `unpack_plan`: about 1,024 cells), all index math in 32 bits.  It stages
// in shared memory what its cells read -- the reads' n, their cell words
// (which straddle read boundaries: three cells a word over the flat R*M
// index), the run values or the raw Bi-D -- by 16-byte loads where the
// words are 16-byte aligned (`stage_words`), and the break bytes as
// 16-bit lanes, so a cell's segment is the count of its j >= b over the
// 31 bytes in 16 subtractions (`rle_seg`).  A thread a cell gathers its
// table row as one float4 through the read-only path and writes its 24-byte
// row into a copy of the block's output span in shared memory, laid out at
// the same 16-byte phase as the span in global memory; the span leaves by
// one bulk store (the TMA engine) and at most two 8-byte stores for its
// ragged ends.
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

// mirrors ops/engine.py `UnpackPlan`: the grid, and a block's shared memory
// by its parts' word offsets (the staged output at 0)
struct UnpackPlan {
  int blocks, reads, threads, smem;
  int cq_at, n_at, bid_at, brk_at;
};

// src[0, n) -> dst[lead + k], lead the word offset of src inside its 16-byte
// line (dst 16-byte aligned): the aligned interior by 16-byte loads, the
// ragged ends a word at a time.  Returns lead.
static __device__ int stage_words(int* dst, const int* src, int n) {
  const int lead = (int)(((uintptr_t)src >> 2) & 3);
  const int* a = src - lead;
  const int total = lead + n;
  for (int q = threadIdx.x; 4 * q < total; q += blockDim.x) {
    const int w = 4 * q;
    if (w >= lead && w + 4 <= total) {
      *(int4*)(dst + w) = __ldg((const int4*)(a + w));
    } else {
      for (int e = max(w, lead); e < min(w + 4, total); ++e)
        dst[e] = __ldg(a + e);
    }
  }
  return lead;
}

// a read's break bytes as 16-bit lanes: h[2w] = bytes 0 and 2 of break word
// w, h[2w + 1] = bytes 1 and 3 (byte 31, past the 31 breaks, made 255)
static __device__ __forceinline__ void rle_lanes(unsigned* h, unsigned x,
                                                 int w) {
  if (w == BID_SEG / 4 - 1) x |= 0xFF000000u;
  h[2 * w] = x & 0x00FF00FFu;
  h[2 * w + 1] = (x >> 8) & 0x00FF00FFu;
}

// count(j >= b) over a read's 31 breaks: 256 + j - b in each 16-bit lane
// has bit 8 set exactly where j >= b (j <= 254, b <= 255)
static __device__ __forceinline__ int rle_seg(const unsigned* h, int j) {
  const unsigned J = (unsigned)j * 0x00010001u + 0x01000100u;
  unsigned acc = 0;
#pragma unroll
  for (int k = 0; k < BID_SEG / 2; ++k) acc += (J - h[k]) & 0x01000100u;
  return (int)(((acc >> 8) & 0xFF) + (acc >> 24));
}

static __global__ void unpack_prep_kernel(UnpackArgs a, UnpackPlan p) {
  extern __shared__ __align__(16) int sm[];
  const int R = a.R, M = a.M;
  const int r0 = blockIdx.x * p.reads;
  const int nr = min(p.reads, R - r0);
  const int c0 = r0 * M, cells = nr * M;  // R * M * 6 < 2^31 (the wrapper)
  const int cq_base =
      a.rle ? (5 + BID_SEG / 4 + BID_SEG) * R : 5 * R + R * M;
  const int w0 = c0 / 3;
  const int cq_lead = stage_words(sm + p.cq_at, a.blob + cq_base + w0,
                                  (c0 + cells - 1) / 3 - w0 + 1);
  const int n_lead = stage_words(sm + p.n_at, a.blob + r0, nr);
  const int* cq = sm + p.cq_at + cq_lead - w0;
  const int* ns = sm + p.n_at + n_lead;
  unsigned* h = (unsigned*)(sm + p.brk_at);
  int bid_lead;
  if (a.rle) {
    bid_lead = stage_words(sm + p.bid_at,
                           a.blob + (5 + BID_SEG / 4) * R + r0 * BID_SEG,
                           nr * BID_SEG);
    const int* brk = a.blob + 5 * R + r0 * (BID_SEG / 4);
    for (int t = threadIdx.x; t < nr * (BID_SEG / 4); t += blockDim.x)
      rle_lanes(h + (t / (BID_SEG / 4)) * (BID_SEG / 2),
                (unsigned)__ldg(brk + t), t % (BID_SEG / 4));
  } else {
    bid_lead = stage_words(sm + p.bid_at, a.blob + 5 * R + c0, cells);
  }
  const float* bidv = (const float*)(sm + p.bid_at + bid_lead);
  __syncthreads();
  // the output span [g0, g1) words of slut, staged at the same 16-byte
  // phase: word g at stage[pre + g - g0]
  const int g0 = 6 * c0, g1 = 6 * (c0 + cells);
  const int pre = g0 & 3;
  float* stage = (float*)sm;
  for (int q = threadIdx.x; q < cells; q += blockDim.x) {
    const int r = q / M, j = q - r * M;
    const int c = c0 + q;
    const int v = (cq[c / 3] >> (10 * (c % 3))) & 0x3FF;
    const int cls = v >> 7;
    const int idx =
        table_row(a.off, a.n_off, a.tab_rows, ns[r], j, cls, v & 0x7F, a.Q);
    const float4 t = __ldg((const float4*)(a.tab + 4 * idx));
    const float bid =
        a.rle ? bidv[r * BID_SEG + rle_seg(h + r * (BID_SEG / 2), j)]
              : bidv[q];
    float2* o = (float2*)(stage + pre + 6 * q);
    o[0] = make_float2(t.x, t.y);
    o[1] = make_float2(t.z, t.w);
    o[2] = make_float2((float)cls, bid);
  }
  fence_proxy_async();
  __syncthreads();
  // [a0, e0) 16-byte aligned and at least 16 bytes (a block has a cell)
  const int a0 = (g0 + 3) & ~3, e0 = g1 & ~3;
  if (threadIdx.x == 0) {
    bulk_store(a.slut + a0, stage + pre + (a0 - g0), (unsigned)(e0 - a0) * 4u);
    bulk_store_wait();
  } else if (threadIdx.x == 32 && a0 > g0) {
    *(float2*)(a.slut + g0) = *(const float2*)(stage + pre);
  } else if (threadIdx.x == 64 && g1 > e0) {
    *(float2*)(a.slut + e0) = *(const float2*)(stage + pre + (e0 - g0));
  }
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

extern "C" int unpack_prep(const UnpackArgs* a, const UnpackPlan* p,
                           cudaStream_t stream) {
  if (p->blocks <= 0) return 0;
  unpack_prep_kernel<<<p->blocks, p->threads, p->smem, stream>>>(*a, *p);
  CHECK_LAUNCH();
  return 0;
}
