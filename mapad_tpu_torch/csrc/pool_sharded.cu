// K9's device part: `shard_rebase`, the re-basing of one shard's pool
// result from its local read ids to the block's global ones.
//
// Replaces the id rewrite of mapad_tpu/parallel/pool_sharded.py
// `pool_search_sharded` (122-135) inside its shard_map: shard d of D ran
// its own pool loop (K4 -> K2 with K1 inline -> K3) over reads
// [d*R_local, (d+1)*R_local) of the dealt block, and its ids are made
// global before K5 packs the result:
//   c_read     -> c_read + base where >= 0, else -1
//   lane_read  -> lane_read + base where < R_local, else R (the global
//                 "no read" sentinel, so host checks `rid < len(chunk)` hold)
//   next_read  -> next_read + base
// in place, base = d * R_local.  Read ids are int32 in both interval widths.
// The orchestration around it (one host thread, card and stream per shard,
// results stacked on a leading device axis) is Python:
// mapad_tpu_torch/parallel/pool_sharded.py; plain version
// `_shard_rebase_plain` there.
//
// Bound on the card: bytes -- (C + L) int32 words read and written once
// (C = 16384 chains, L = 512 lanes: 135 KB a shard); one thread a word.
#include "common.cuh"

struct RebaseArgs {
  int* c_read;     // (C,)
  int* lane_read;  // (L,)
  int* next_read;  // ()
  int C, L, base, r_local, r_global;
};

static __global__ void shard_rebase_kernel(RebaseArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.C) {
    const int v = a.c_read[i];
    a.c_read[i] = v >= 0 ? v + a.base : -1;
  } else if (i < a.C + a.L) {
    const int v = a.lane_read[i - a.C];
    a.lane_read[i - a.C] = v < a.r_local ? v + a.base : a.r_global;
  } else if (i == a.C + a.L) {
    a.next_read[0] += a.base;
  }
}

extern "C" int shard_rebase(const RebaseArgs* a, cudaStream_t stream) {
  const int total = a->C + a->L + 1;
  LAUNCH(shard_rebase_kernel, (total + 255) / 256, 256, stream, *a);
  CHECK_LAUNCH();
  return 0;
}
