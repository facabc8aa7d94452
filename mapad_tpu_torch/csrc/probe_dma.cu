// P1: T dependent steps of a scattered row gather, the design probe of the
// pool step (K2 fetches each lane's 512 B index rows at indices that the
// previous step's intervals decide), and so the floor K2's step is read
// against.
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
// Design: one launch for all T steps, as the TPU kernel is one
// `pallas_call`, and as K2 runs a store generation's steps.  The whole
// (L, W) scratch (512 KB at the probe's L=1024, W=128) does not fit one
// block's 227 KB of shared memory, so the L lanes are split over a grid
// that is all co-resident (the plan: tools/dma.py `gather_plan`; the
// launch is cooperative only to have the runtime refuse a grid that is
// not).  A warp moves a lane's row with 16-byte `cp.async` (4-byte where
// the row is not 16-byte aligned), `cp.async.wait_all` standing for the
// DMA semaphores.  (tools/p1_time.py times it against a form that moves
// each row with one bulk copy on an mbarrier, built there as a variant of
// this source.)
// The dependency on acc stays: a step's rows are known only after the
// last step's sum, so no row is fetched ahead.
//
// The grid barrier is the reduction, as K2's (csrc/pool_search.cu): each
// block publishes {tag, its column-0 sum} in one 8-byte slot, double-
// buffered by the tag's parity; warp 0 of every block reads the slots, two
// a 16-byte `__ldcv`, until each carries this step's tag, and sums them;
// the total reaches the block through shared memory.  So every block
// carries the same acc, with one L2 round trip a step and no
// cooperative-groups sync.  Tags never repeat from call to call: slot
// word 0 keeps the steps run so far (block 0 writes it after the last
// barrier, when every block has read it), a step's tag is that count plus
// the step plus one, and the wrapper zeroes the slots once, when it makes
// them.  A block overwrites a slot two steps later, after every block has
// read it.  `launch_per_step` launches the same kernel once a step (one
// step each, acc and chk carried on the card).
//
// Bound on the card: bytes, L * W * 4 a step over the memory rate; in
// practice the step is a chain of dependent latencies (the rows' load,
// the slot's store and the slots' read), which is what the probe measures.
#include "common.cuh"

using mapad::cp_async16;
using mapad::cp_async4;
using mapad::cp_async_wait_all;
using mapad::floor_mod;

struct GatherArgs {
  const int* rows;  // (NB, W)
  const int* blk;   // (L,)
  float* acc;       // (1,) carried in and out
  int* chk;         // (1,) XOR of every word moved, carried in and out
  int* slots;       // 4 words (word 0: steps run so far), then 2 x stride
                    // 8-byte slots {tag, block sum} by tag parity
  int NB, W, L, t0, steps;
};

// mirrors tools/dma.py `GatherPlan`
struct GatherPlan {
  int blocks;           // all co-resident
  int lanes_per_block;  // rows a block gathers a step
  int smem;             // dynamic shared memory: lanes_per_block * W words
  int stride;           // slots a parity: blocks rounded up to even
};

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
    gather_steps_kernel(GatherArgs a, GatherPlan p) {
  extern __shared__ __align__(16) int scratch[];  // (lanes_per_block, W)
  __shared__ int red[WARPS];
  __shared__ int total;
  const int G = (int)gridDim.x;
  const int lpb = p.lanes_per_block;
  const int lane0 = blockIdx.x * lpb;
  const int nl = max(0, min(lpb, a.L - lane0));
  const int warp = threadIdx.x / 32, tl = threadIdx.x % 32;
  const bool vec = (a.W & 3) == 0 && ((uintptr_t)a.rows & 15) == 0;
  // every block reads the steps run so far before the first barrier
  const int base = __ldcv(a.slots);
  long long* const slot = reinterpret_cast<long long*>(a.slots + 4);
  float acc = a.acc[0];
  int chk = 0;
  for (int s = 0; s < a.steps; ++s) {
    const int t = a.t0 + s;
    const int tag = base + s + 1;
    const int par = tag & 1;
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
    if (warp == 0) {
      // publish {tag, the block's sum}; then read every block's slot of
      // this parity until each carries the tag
      int v = tl < WARPS ? red[tl] : 0;
      v = warp_sum(v);
      if (tl == 0)
        __stcg(slot + par * p.stride + blockIdx.x,
               (long long)(((unsigned long long)(unsigned)v << 32) |
                           (unsigned)tag));
      const longlong2* sl =
          reinterpret_cast<const longlong2*>(slot + par * p.stride);
      int sum;
      bool all;
      do {
        sum = 0;
        all = true;
        for (int q = tl; 2 * q < G; q += 32) {
          const longlong2 w = __ldcv(sl + q);
          all = all && (int)w.x == tag;
          sum += (int)(w.x >> 32);
          if (2 * q + 1 < G) {
            all = all && (int)w.y == tag;
            sum += (int)(w.y >> 32);
          }
        }
      } while (!__all_sync(FULL, all));
      sum = __reduce_add_sync(FULL, sum);
      if (tl == 0) total = sum;
    }
    __syncthreads();
    acc = acc + (float)total;
  }
  for (int o = 16; o; o >>= 1) chk ^= __shfl_xor_sync(FULL, chk, o);
  if (tl == 0) atomicXor(a.chk, chk);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.acc[0] = acc;
    a.slots[0] = base + a.steps;
  }
}

// The card's figures the plan needs: SMs, and (after making the whole of
// a block's opt-in shared memory available to the kernel) the most
// dynamic shared memory a block of it may take.
extern "C" int gather_card(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, gather_steps_kernel);
  if (e == cudaSuccess) {
    out[1] -= (int)fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(gather_steps_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out[1]);
  }
  return (int)e;
}

// blocks of `smem` bytes of dynamic shared memory one SM holds at once
// (after gather_card)
extern "C" int gather_occupancy(int smem, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gather_steps_kernel, THREADS, (size_t)smem);
}

// One launch of all `steps` (per_step = 0), or one launch a step
// (per_step = 1), of the plan's grid.  A launch the card refuses returns
// its error; nothing else is tried.
extern "C" int probe_dma_gather(const GatherArgs* in, const GatherPlan* plan,
                                int per_step, cudaStream_t stream) {
  const int launches = per_step ? in->steps : 1;
  GatherPlan p = *plan;
  for (int i = 0; i < launches; ++i) {
    GatherArgs a = *in;
    if (per_step) {
      a.t0 = in->t0 + i;
      a.steps = 1;
    }
    void* params[] = {&a, &p};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (void*)gather_steps_kernel, p.blocks, THREADS, params,
        (size_t)p.smem, stream);
    if (e != cudaSuccess) return (int)e;
  }
  CHECK_LAUNCH();
  return 0;
}

// The card's dependent-load latency: one thread follows `hops` links of a
// cycle through `next`, starting from at[0] and leaving where it stopped
// there (so a call goes on where the last one stopped and no hop repeats).
// K3's walk (csrc/extract_chains.cu) is a chain of such loads: its floor
// is the deepest chain's hops times this.
static __global__ void chase_kernel(const int* next, int hops, int* at) {
  int p = at[0];
  for (int i = 0; i < hops; ++i) p = next[p];
  at[0] = p;
}

extern "C" int probe_chase(const int* next, int hops, int* at,
                           cudaStream_t stream) {
  LAUNCH(chase_kernel, 1, 1, stream, next, hops, at);
  CHECK_LAUNCH();
  return 0;
}
