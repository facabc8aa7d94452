// P2-P4: a 2-D slice staged through shared memory, in either direction.
//
// Replaces the TPU DMA/compiler probes that copy a slice of an HBM array
// through a VMEM scratch:
//   tools/_probe_shapes.py `src_slice` (26-41, kernel `k` 29-32) and
//   `dst_slice` (43-57, kernel `k` 44-47), at the eight shapes of 58-70;
//   tools/_t9.py `k9` (10-15, launched by `t9` 17-25): row 7 of (1024, 32);
//   tools/_dump_pair.py `k_src` (32-37) and `k_dst` (39-43, `in + 1`).
// The strided side is an (R, C) int32 view (a 3-D array is viewed as
// (R, prod(rest))) and the slice is rows [row0, row0 + nrows) x columns
// [col0, col0 + ncols); the other side is dense (nrows, ncols).
//   copy_src_slice: strided slice -> shared -> dense output
//   copy_dst_slice: dense input -> shared -> (+ addend) -> strided slice;
//                   everything outside the slice stays as it was
// A block stages up to SCRATCH_WORDS words (static shared memory, 36 KB:
// the probes' largest slice, (72, 128), in one block).  Two routes, which
// the launch chooses (`copy_route`):
// - bulk: where every row of the slice and both bases are 16-byte aligned
//   and a row is a multiple of 16 bytes (ncols, col0 and C multiples of 4),
//   Hopper's bulk asynchronous copies (the TMA engine, the counterpart of
//   the TPU's DMA): one bulk copy a row into shared memory (one for the
//   whole slice where its rows are contiguous), issued by the lanes of
//   warp 0 and counted by one mbarrier, then one bulk copy a row out (one
//   for a dense side); the threads touch the words only to add a nonzero
//   addend;
// - words: any other slice, 4-byte `cp.async` moves into shared memory and
//   4-byte stores out, a warp a row.
// No index is divided: the threads walk rows and columns.
//
// Bound on the card: bytes (the slice read once and written once); the
// probes' slices are a few KB, so a call is a launch.
#include "common.cuh"

using mapad::bar_init;
using mapad::bar_wait;
using mapad::bulk_load;
using mapad::bulk_store;
using mapad::bulk_store_wait;
using mapad::cp_async4;
using mapad::cp_async_wait_all;
using mapad::fence_proxy_async;
using mapad::smem_addr;

// every field 8 bytes: the wrapper fills them as one int64 array
struct CopyArgs {
  const int* src;
  int* dst;
  cudaStream_t stream;
  long long ld;  // words per row of the strided side
  long long row0, col0, nrows, ncols;
  long long addend;  // copy_dst_slice only
};

constexpr int COPY_THREADS = 256;
constexpr int COPY_WARPS = COPY_THREADS / 32;
constexpr int SCRATCH_WORDS = 72 * 128;

__device__ __forceinline__ int add_wrap(int v, int d) {
  return (int)((unsigned)v + (unsigned)d);
}

extern "C" __global__ void __launch_bounds__(COPY_THREADS)
    copy_src_slice_kernel(CopyArgs a, int rows_per_block, int bulk) {
  __shared__ __align__(128) int scratch[SCRATCH_WORDS];
  __shared__ __align__(8) unsigned long long bar;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, (int)a.nrows - r0);
  const int nc = (int)a.ncols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* src = a.src + (a.row0 + r0) * a.ld + a.col0;
  int* out = a.dst + (size_t)r0 * nc;
  if (bulk) {
    if (warp != 0) return;
    const unsigned b = smem_addr(&bar);
    const unsigned row_bytes = (unsigned)nc * 4u;
    if (lane == 0) bar_init(b, row_bytes * rows);
    __syncwarp();
    if (a.ld == nc) {
      if (lane == 0) bulk_load(scratch, src, row_bytes * rows, b);
    } else {
      for (int r = lane; r < rows; r += 32)
        bulk_load(scratch + r * nc, src + r * a.ld, row_bytes, b);
    }
    if (lane == 0) {
      bar_wait(b);
      fence_proxy_async();
      bulk_store(out, scratch, row_bytes * rows);
      bulk_store_wait();
    }
    return;
  }
  for (int r = warp; r < rows; r += COPY_WARPS)
    for (int c = lane; c < nc; c += 32)
      cp_async4(scratch + r * nc + c, src + r * a.ld + c);
  cp_async_wait_all();
  __syncthreads();
  for (int k = threadIdx.x; k < rows * nc; k += COPY_THREADS)
    out[k] = scratch[k];
}

extern "C" __global__ void __launch_bounds__(COPY_THREADS)
    copy_dst_slice_kernel(CopyArgs a, int rows_per_block, int bulk) {
  __shared__ __align__(128) int scratch[SCRATCH_WORDS];
  __shared__ __align__(8) unsigned long long bar;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, (int)a.nrows - r0);
  const int nc = (int)a.ncols, n = rows * nc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* in = a.src + (size_t)r0 * nc;
  int* dst = a.dst + (a.row0 + r0) * a.ld + a.col0;
  if (bulk) {
    if (a.addend == 0 && warp != 0) return;
    const unsigned b = smem_addr(&bar);
    const unsigned row_bytes = (unsigned)nc * 4u;
    if (threadIdx.x == 0) {
      bar_init(b, row_bytes * rows);
      bulk_load(scratch, in, row_bytes * rows, b);
    }
    if (a.addend != 0) {
      __syncthreads();  // the barrier is initialised before anyone waits
      bar_wait(b);
      for (int k = threadIdx.x * 4; k < n; k += COPY_THREADS * 4) {
        int4 v = *reinterpret_cast<const int4*>(scratch + k);
        v.x = add_wrap(v.x, (int)a.addend);
        v.y = add_wrap(v.y, (int)a.addend);
        v.z = add_wrap(v.z, (int)a.addend);
        v.w = add_wrap(v.w, (int)a.addend);
        *reinterpret_cast<int4*>(scratch + k) = v;
      }
      // the threads' writes, before the copy engine reads them
      fence_proxy_async();
      __syncthreads();
      if (warp != 0) return;
    } else {
      __syncwarp();
      bar_wait(b);
    }
    if (a.ld == nc) {
      if (lane == 0) bulk_store(dst, scratch, row_bytes * rows);
    } else {
      for (int r = lane; r < rows; r += 32)
        bulk_store(dst + r * a.ld, scratch + r * nc, row_bytes);
    }
    bulk_store_wait();
    return;
  }
  for (int k = threadIdx.x; k < n; k += COPY_THREADS)
    cp_async4(scratch + k, in + k);
  cp_async_wait_all();
  __syncthreads();
  for (int r = warp; r < rows; r += COPY_WARPS)
    for (int c = lane; c < nc; c += 32)
      dst[r * a.ld + c] = add_wrap(scratch[r * nc + c], (int)a.addend);
}

// 1 (the bulk route) where the bulk copies can move the slice: both bases
// 16-byte aligned and every row of the slice a multiple of 16 bytes that
// starts 16-byte aligned (ncols, col0 and ld multiples of 4 words); else 0
// (the 4-byte route)
extern "C" int copy_route(const CopyArgs* a) {
  return a->ncols % 4 == 0 && a->col0 % 4 == 0 && a->ld % 4 == 0 &&
         (size_t)a->src % 16 == 0 && (size_t)a->dst % 16 == 0;
}

static int launch_copy(void (*kernel)(CopyArgs, int, int),
                       const CopyArgs* a) {
  if (a->nrows < 1 || a->ncols < 1 || a->ncols > SCRATCH_WORDS ||
      a->nrows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int fit = SCRATCH_WORDS / (int)a->ncols;  // >= 1 by the check above
  const int rpb = a->nrows < fit ? (int)a->nrows : fit;
  LAUNCH(kernel, ((int)a->nrows + rpb - 1) / rpb, COPY_THREADS, a->stream,
         *a, rpb, copy_route(a));
  CHECK_LAUNCH();
  return 0;
}

extern "C" int copy_src_slice(const CopyArgs* a) {
  return launch_copy(copy_src_slice_kernel, a);
}

extern "C" int copy_dst_slice(const CopyArgs* a) {
  return launch_copy(copy_dst_slice_kernel, a);
}
