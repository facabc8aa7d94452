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
// the probes' largest slice, (72, 128), in one block) with `cp.async`:
// 16-byte moves where every row of the slice and both bases are 16-byte
// aligned (ncols, col0 and C multiples of 4), else 4-byte moves; a 128-byte
// row (C = 32, P3) takes the 16-byte path, a column slice that is not
// aligned the 4-byte one.
//
// Bound on the card: bytes (the slice read once and written once); the
// probes' slices are a few KB, so a call is a launch.
#include "common.cuh"

using mapad::cp_async16;
using mapad::cp_async4;
using mapad::cp_async_wait_all;

struct CopyArgs {
  const int* src;
  int* dst;
  int ld;  // words per row of the strided side
  int row0, col0, nrows, ncols;
  int addend;  // copy_dst_slice only
};

constexpr int COPY_THREADS = 256;
constexpr int SCRATCH_WORDS = 72 * 128;

// the slice's word k (row-major over the slice) in the strided array
__device__ __forceinline__ size_t strided(const CopyArgs& a, int r0, int k) {
  return (size_t)(a.row0 + r0 + k / a.ncols) * a.ld + a.col0 + k % a.ncols;
}

extern "C" __global__ void __launch_bounds__(COPY_THREADS)
    copy_src_slice_kernel(CopyArgs a, int rows_per_block, int vec) {
  __shared__ __align__(16) int scratch[SCRATCH_WORDS];
  const int r0 = blockIdx.x * rows_per_block;
  const int n = min(rows_per_block, a.nrows - r0) * a.ncols;
  if (vec) {
    for (int k = threadIdx.x * 4; k < n; k += COPY_THREADS * 4)
      cp_async16(scratch + k, a.src + strided(a, r0, k));
  } else {
    for (int k = threadIdx.x; k < n; k += COPY_THREADS)
      cp_async4(scratch + k, a.src + strided(a, r0, k));
  }
  cp_async_wait_all();
  __syncthreads();
  int* out = a.dst + (size_t)r0 * a.ncols;
  if (vec) {
    for (int k = threadIdx.x * 4; k < n; k += COPY_THREADS * 4)
      *reinterpret_cast<int4*>(out + k) =
          *reinterpret_cast<const int4*>(scratch + k);
  } else {
    for (int k = threadIdx.x; k < n; k += COPY_THREADS) out[k] = scratch[k];
  }
}

__device__ __forceinline__ int add_wrap(int v, int d) {
  return (int)((unsigned)v + (unsigned)d);
}

extern "C" __global__ void __launch_bounds__(COPY_THREADS)
    copy_dst_slice_kernel(CopyArgs a, int rows_per_block, int vec) {
  __shared__ __align__(16) int scratch[SCRATCH_WORDS];
  const int r0 = blockIdx.x * rows_per_block;
  const int n = min(rows_per_block, a.nrows - r0) * a.ncols;
  const int* in = a.src + (size_t)r0 * a.ncols;
  if (vec) {
    for (int k = threadIdx.x * 4; k < n; k += COPY_THREADS * 4)
      cp_async16(scratch + k, in + k);
  } else {
    for (int k = threadIdx.x; k < n; k += COPY_THREADS)
      cp_async4(scratch + k, in + k);
  }
  cp_async_wait_all();
  __syncthreads();
  if (vec) {
    for (int k = threadIdx.x * 4; k < n; k += COPY_THREADS * 4) {
      int4 v = *reinterpret_cast<const int4*>(scratch + k);
      v.x = add_wrap(v.x, a.addend);
      v.y = add_wrap(v.y, a.addend);
      v.z = add_wrap(v.z, a.addend);
      v.w = add_wrap(v.w, a.addend);
      *reinterpret_cast<int4*>(a.dst + strided(a, r0, k)) = v;
    }
  } else {
    for (int k = threadIdx.x; k < n; k += COPY_THREADS)
      a.dst[strided(a, r0, k)] = add_wrap(scratch[k], a.addend);
  }
}

static int launch_copy(void (*kernel)(CopyArgs, int, int), const CopyArgs* a,
                       cudaStream_t stream) {
  if (a->nrows < 1 || a->ncols < 1 || a->ncols > SCRATCH_WORDS)
    return (int)cudaErrorInvalidValue;
  const int vec = a->ncols % 4 == 0 && a->col0 % 4 == 0 && a->ld % 4 == 0 &&
                  (size_t)a->src % 16 == 0 && (size_t)a->dst % 16 == 0;
  const int fit = SCRATCH_WORDS / a->ncols;  // >= 1 by the check above
  const int rpb = a->nrows < fit ? a->nrows : fit;
  LAUNCH(kernel, (a->nrows + rpb - 1) / rpb, COPY_THREADS, stream, *a, rpb,
         vec);
  CHECK_LAUNCH();
  return 0;
}

extern "C" int copy_src_slice(const CopyArgs* a, cudaStream_t stream) {
  return launch_copy(copy_src_slice_kernel, a, stream);
}

extern "C" int copy_dst_slice(const CopyArgs* a, cudaStream_t stream) {
  return launch_copy(copy_dst_slice_kernel, a, stream);
}
