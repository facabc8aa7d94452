// K3: chain extraction after the pool loop, the per-read step fold and the
// PoolResult tail.
//
// Replaces mapad_tpu/ops/search_pool2.py `extract_chains` (617-726),
// `fold_read_steps` (728-737), `append_acc` (792-810) and the tail
// (921-971).  Plain version: ops/search_pool2.py `_extract_plain`,
// `_ChainLog`, `_extract_chains_plain`.  With a big
// index (int64 intervals, 11-word frames) `c_lower`, `c_lrev` and `c_size`
// are int64: the chain kernel is a template on the interval type.
//
// JAX compacts the completion/abandon entries with two top_k passes over
// negated (lane, block) keys, which yields the first C marked entries in
// ascending (lane, slot) order.  Here the step kernel's 9-bit block masks
// (bmask, written at every step) give the same order without a sort:
//   1. count:  one block per lane sums the popcounts of its masks and
//              finds its first marked block;
//   2. scan:   one block takes the lane-order exclusive prefix sum (the
//              compacted offset of each lane's first entry), n_chains, the
//              padding entry and the per-lane tail fields;
//   3. emit:   one block per lane writes (lane, slot) of its entries in
//              ascending slot order, stopping at C;
//   4. chains: one thread per entry gathers its fields and walks MW-1
//              ancestors into c_ops;
//   5. fold:   the finish log's (read, steps) events are max-reduced into
//              read_steps with atomicMax (a max is order-free, so exact).
// Unused entries (past min(n_chains, C)) copy candidate 0 of the first
// marked block, as JAX's top_k padding selects.
//
// With store generations the extraction also runs at every store boundary
// (before K8, csrc/pool_compact.cu, moves the store).  An extraction scans
// only the steps run since the last boundary (glob[G_BASE]..glob[G_STEP]:
// K8 clears the marks of the frames it moves, so their masks count as
// empty), writes its entries at offset min(entries so far, C) and drops
// what falls past C (the JAX package's 2C window and `[:C]`), reports
// slots minus 9 x the steps compacted away (glob[G_CUM]), adds to n_chains
// and lets the step fold accumulate.  Only the last extraction (`final`)
// writes the unused entries and the per-lane tail, and it leaves the
// counters in glob[] alone, so it can be repeated.
//
// Bound on the card: bytes.  The masks are 4 B per lane per executed step
// (16.8 MB at L=512, S=8192) and each chain reads ~MW dependent 32 B
// (44 B with int64) frame records; the finish log is another 4 B per lane per step.
#include "common.cuh"

using namespace mapad;

constexpr int EXT_THREADS = 256;

static __device__ __forceinline__ bool block_written(int blk, int S,
                                                     int steps) {
  return blk >= S - steps && blk < S;
}

static __global__ void __launch_bounds__(EXT_THREADS)
ext_count_kernel(ExtractArgs a) {
  const int l = blockIdx.x, tid = threadIdx.x, S = a.S;
  const int steps = a.glob[G_STEP], base = a.glob[G_BASE];
  __shared__ int s_cnt[EXT_THREADS / 32], s_first[EXT_THREADS / 32];
  int cnt = 0, first = S;
  for (int b = S - steps + tid; b < S - base; b += EXT_THREADS) {
    const int m = a.bmask[(size_t)l * S + b];
    cnt += __popc(m);
    if (m != 0 && b < first) first = b;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
    first = min(first, __shfl_xor_sync(0xffffffffu, first, d));
  }
  if ((tid & 31) == 0) {
    s_cnt[tid >> 5] = cnt;
    s_first[tid >> 5] = first;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0, f = S;
    for (int w = 0; w < EXT_THREADS / 32; ++w) {
      c += s_cnt[w];
      f = min(f, s_first[w]);
    }
    a.lane_cnt[l] = c;
    a.lane_first[l] = f;
  }
}

constexpr int SCAN_THREADS = 1024;

static __global__ void __launch_bounds__(SCAN_THREADS)
ext_scan_kernel(ExtractArgs a) {
  const int t = threadIdx.x, L = a.L, R = a.R, S = a.S;
  __shared__ int scan[SCAN_THREADS];
  __shared__ int s_pad;
  const int cnt = t < L ? a.lane_cnt[t] : 0;
  scan[t] = cnt;
  if (t == 0) s_pad = L;
  __syncthreads();
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {
    const int v = t >= d ? scan[t - d] : 0;
    __syncthreads();
    scan[t] += v;
    __syncthreads();
  }
  if (t < L) {
    a.lane_off[t] = scan[t] - cnt;
    if (a.lane_first[t] < S) atomicMin(&s_pad, t);
    if (a.final) {
      const int rid = a.lane[LS_READ_ID * L + t];
      a.lane_read[t] = rid;
      a.lane_unfinished[t] = !a.lane[LS_DONE * L + t] && rid < R;
    }
  }
  __syncthreads();
  if (t == 0) {
    const int total = scan[SCAN_THREADS - 1];
    const int n_ext = total < a.C ? total : a.C;
    const int acc_n = a.glob[G_ACC_N];
    // no mark anywhere: JAX's padding reads slot 0 of lane 0
    a.pad[0] = s_pad < L ? s_pad : 0;
    a.pad[1] = s_pad < L ? a.lane_first[s_pad] : 0;
    a.pad[2] = acc_n < a.C ? acc_n : a.C;
    a.pad[3] = n_ext;
    if (a.final) {
      a.n_chains[0] = a.glob[G_ACC_NCH] + total;
      a.next_read[0] = a.glob[G_NEXT_READ];
      // every step run, over all generations
      a.steps[0] = a.glob[G_STEP] + a.glob[G_CUM];
    } else {
      a.glob[G_ACC_N] = acc_n + n_ext;
      a.glob[G_ACC_NCH] += total;
    }
  }
}

static __global__ void __launch_bounds__(EXT_THREADS)
ext_emit_kernel(ExtractArgs a) {
  const int l = blockIdx.x, tid = threadIdx.x, S = a.S, C = a.C;
  int off = a.lane_off[l];
  if (off >= C || a.lane_cnt[l] == 0) return;
  const int steps = a.glob[G_STEP], top = S - a.glob[G_BASE];
  __shared__ int scan[EXT_THREADS];
  for (int b0 = S - steps; b0 < top && off < C; b0 += EXT_THREADS) {
    const int b = b0 + tid;
    const int m = b < top ? a.bmask[(size_t)l * S + b] : 0;
    const int cnt = __popc(m);
    scan[tid] = cnt;
    __syncthreads();
    for (int d = 1; d < EXT_THREADS; d <<= 1) {
      const int v = tid >= d ? scan[tid - d] : 0;
      __syncthreads();
      scan[tid] += v;
      __syncthreads();
    }
    int e = off + scan[tid] - cnt;
    for (int c = 0; c < CANDS && e < C; ++c) {
      if ((m >> c) & 1) {
        a.c_lane[e] = l;
        a.e_slot[e] = b * CANDS + c;
        ++e;
      }
    }
    off += scan[EXT_THREADS - 1];
    __syncthreads();
  }
}

template <typename I>
static __global__ void ext_chain_kernel(ExtractArgs a) {
  constexpr int NFW = Idx<I>::NFW;
  constexpr int REC = CANDS * NFW;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.C) return;
  const int S = a.S, MW = a.MW, ROOT = S * CANDS;
  const int steps = a.glob[G_STEP];
  const bool valid = e < a.pad[3];
  // the unused entries of an extraction at a boundary are overwritten by
  // the next one's; entries past C are dropped
  const int o = a.pad[2] + e;
  if (o >= a.C || (!valid && !a.final)) return;
  const int lane = valid ? a.c_lane[e] : a.pad[0];
  const int slot = valid ? a.e_slot[e] : a.pad[1] * CANDS;
  a.c_slot[o] = slot - CANDS * a.glob[G_CUM];
  const int* lane_store = a.store + (size_t)lane * (S + 1) * REC;
  int rec[NFW];
  const bool written = block_written(slot / CANDS, S, steps);
#pragma unroll
  for (int f = 0; f < NFW; ++f)
    rec[f] = written ? lane_store[(size_t)slot * NFW + f] : 0;
  const int e_op = rec[F_OP];
  const bool abandon = valid && (e_op & OP_ABANDON_BIT) != 0;
  a.c_read[o] = valid ? rec[F_GAPS] : -1;
  a.c_abandon[o] = abandon;
  ((I*)a.c_lower)[o] = frame_get<I>(rec, F_LOWER);
  ((I*)a.c_lrev)[o] = frame_get<I>(rec, F_LREV);
  ((I*)a.c_size)[o] = frame_get<I>(rec, F_SIZE);
  a.c_score[o] = __int_as_float(rec[F_SCOREBITS]);
  const bool walk = valid && !abandon;
  int* ops = a.c_ops + (size_t)o * MW;
  ops[0] = walk ? e_op : 0;
  int node = walk ? rec[F_PARENT] : ROOT;
  for (int t = 1; t < MW; ++t) {
    if (node == ROOT) {
      ops[t] = 0;
      continue;
    }
    const int* r = lane_store + (size_t)node * NFW;
    ops[t] = r[F_OP];
    node = r[F_PARENT];
  }
}

static __global__ void ext_fold_init_kernel(ExtractArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i <= a.R) a.read_steps[i] = -1;
}

static __global__ void ext_fold_kernel(ExtractArgs a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int S = a.S, L = a.L, R = a.R;
  const int steps = a.glob[G_STEP], base = a.glob[G_BASE];
  if (i < (size_t)L * S && (int)(i % S) >= base && (int)(i % S) < steps) {
    const int ev = a.fin_log[i];
    if (ev >= 0) atomicMax(&a.read_steps[ev >> 12], ev & 4095);
  }
  if (a.final && i < (size_t)L) {
    // unfinished lanes report the steps their held read consumed so far
    const int l = (int)i;
    const int rid = a.lane[LS_READ_ID * L + l];
    if (!a.lane[LS_DONE * L + l] && rid < R)
      atomicMax(&a.read_steps[rid < 0 ? 0 : rid], a.lane[LS_AGE * L + l]);
  }
}

extern "C" int extract_chains(const ExtractArgs* a, cudaStream_t stream) {
  if (a->L > SCAN_THREADS) return (int)cudaErrorInvalidValue;
  LAUNCH(ext_count_kernel, a->L, EXT_THREADS, stream, *a);
  CHECK_LAUNCH();
  LAUNCH(ext_scan_kernel, 1, SCAN_THREADS, stream, *a);
  CHECK_LAUNCH();
  LAUNCH(ext_emit_kernel, a->L, EXT_THREADS, stream, *a);
  CHECK_LAUNCH();
  if (a->big)
    LAUNCH(ext_chain_kernel<int64_t>, (a->C + 127) / 128, 128, stream, *a);
  else
    LAUNCH(ext_chain_kernel<int32_t>, (a->C + 127) / 128, 128, stream, *a);
  CHECK_LAUNCH();
  if (a->first) {
    LAUNCH(ext_fold_init_kernel, (a->R + 1 + 255) / 256, 256, stream, *a);
    CHECK_LAUNCH();
  }
  if (a->track) {
    const size_t n = (size_t)a->L * a->S;
    LAUNCH(ext_fold_kernel, (unsigned)((n + 255) / 256), 256, stream, *a);
    CHECK_LAUNCH();
  }
  return 0;
}
