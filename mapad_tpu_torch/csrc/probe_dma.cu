// P1: T dependent steps of a scattered row gather, the design probe of the
// pool step (K2 fetches each lane's 512 B index rows at indices that the
// previous step's intervals decide).
//
// Replaces tools/bench_dma.py `scatter_dma_kernel` (34-55), launched by
// `run_scatter` (57-73) as one `pallas_call`.  Each step t:
//   idx_i = (blk[i] + 1237 t + int32(acc) mod 7) mod NB     for i < L
//   copy rows[idx_i] (W int32 words each) into an (L, W) scratch, wait,
//   acc += f32 sum of scratch[:, 0]
// `int32(acc)` truncates toward zero and both `mod`s are floor-mods, as
// jnp's are.  The wrapper (mapad_tpu_torch/tools/dma.py `gather_steps`)
// holds L * max|rows[:, 0]| below 2^24, so a step's sum is exact in f32 in
// any order and is summed here in int32; `acc + s` is one f32 add, rounded
// to nearest, as in the TPU kernel (acc itself passes 2^24 and rounds).
// Beside acc the kernel XORs every word it moved into `chk`, so no load is
// dead; the plain version computes the same checksum.
//
// Design: one cooperative launch for all T steps, as the TPU kernel is one
// `pallas_call`.  The whole (L, W) scratch (512 KB at the probe's L=1024,
// W=128) does not fit one block's 227 KB of shared memory, so the L lanes
// are split over a grid that is all co-resident (occupancy x SMs); a warp
// moves a lane's whole row with 16-byte `cp.async` (4-byte where the row
// is not 16-byte aligned) and `cp.async.wait_all` stands for the DMA
// semaphores.  A block reduces column 0 and writes its partial to a
// double-buffered array indexed by step parity (a fast block never
// overwrites a partial a slow block still reads); after the grid barrier
// every block sums the partials in block order, so every block carries the
// same acc.  `per_step` launches the same kernel once a step instead (one
// step each, acc and chk carried on the card): the form K2 runs in today.
//
// Bound on the card: bytes, L * W * 4 a step over the memory rate (a
// dependent gather: in practice latency and the barrier between steps
// bound it, which is what the probe measures).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using mapad::cp_async16;
using mapad::cp_async4;
using mapad::cp_async_wait_all;
using mapad::floor_mod;

struct GatherArgs {
  const int* rows;  // (NB, W)
  const int* blk;   // (L,)
  float* acc;       // (1,) carried in and out
  int* chk;         // (1,) XOR of every word moved, carried in and out
  int* partials;    // (2, L): a block's column-0 sum, by step parity
  int NB, W, L, t0, steps;
};

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
    gather_steps_kernel(GatherArgs a, int lanes_per_block, int vec) {
  extern __shared__ __align__(16) int scratch[];  // (lanes_per_block, W)
  __shared__ int red[WARPS];
  __shared__ int total;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  const int lane0 = blockIdx.x * lanes_per_block;
  const int nl = max(0, min(lanes_per_block, a.L - lane0));
  const int warp = threadIdx.x / 32, tl = threadIdx.x % 32;
  float acc = a.acc[0];
  int chk = 0;
  for (int s = 0; s < a.steps; ++s) {
    const int t = a.t0 + s;
    const int a7 = floor_mod(__float2int_rz(acc), 7);
    for (int j = warp; j < nl; j += WARPS) {
      const int idx = floor_mod(a.blk[lane0 + j] + t * 1237 + a7, a.NB);
      const int* src = a.rows + (size_t)idx * a.W;
      int* dst = scratch + (size_t)j * a.W;
      if (vec) {
        for (int c = tl * 4; c < a.W; c += 128) cp_async16(dst + c, src + c);
      } else {
        for (int c = tl; c < a.W; c += 32) cp_async4(dst + c, src + c);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    int part = 0;
    for (int j = threadIdx.x; j < nl; j += THREADS) part += scratch[j * a.W];
    for (int k = threadIdx.x; k < nl * a.W; k += THREADS) chk ^= scratch[k];
    part = warp_sum(part);
    if (tl == 0) red[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      int p = 0;
      for (int w = 0; w < WARPS; ++w) p += red[w];
      a.partials[(s & 1) * G + blockIdx.x] = p;
    }
    grid.sync();
    if (warp == 0) {
      int v = 0;
      for (int b = tl; b < G; b += 32) v += __ldcg(a.partials + (s & 1) * G + b);
      v = warp_sum(v);
      if (tl == 0) total = v;
    }
    __syncthreads();
    acc = acc + (float)total;
  }
  for (int o = 16; o; o >>= 1) chk ^= __shfl_xor_sync(0xffffffffu, chk, o);
  if (tl == 0) atomicXor(a.chk, chk);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.acc[0] = acc;
}

// One cooperative launch of all `steps` (per_step = 0), or one launch per
// step (per_step = 1).  The grid is the fewest blocks of whole warps' lanes
// that are all co-resident; lanes per block grow until they are.
extern "C" int probe_dma_gather(const GatherArgs* in, int per_step,
                                cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int vec = in->W % 4 == 0 && (size_t)in->rows % 16 == 0;
  int lpb = WARPS, grid = 0;
  size_t smem = 0;
  for (;;) {
    smem = (size_t)lpb * in->W * sizeof(int);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(gather_steps_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_steps_kernel, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    grid = (in->L + lpb - 1) / lpb;
    if (per_sm > 0 && grid <= per_sm * sms) break;
    const int fit = (per_sm > 0 ? per_sm : 1) * sms;
    const int need = (in->L + fit - 1) / fit;
    lpb = need > lpb ? need : lpb + 1;
  }
  const int launches = per_step ? in->steps : 1;
  for (int i = 0; i < launches; ++i) {
    GatherArgs a = *in;
    if (per_step) {
      a.t0 = in->t0 + i;
      a.steps = 1;
    }
    void* params[] = {&a, &lpb, (void*)&vec};
    e = cudaLaunchCooperativeKernel((void*)gather_steps_kernel, grid, THREADS,
                                    params, smem, stream);
    if (e != cudaSuccess) return (int)e;
  }
  CHECK_LAUNCH();
  return 0;
}
