// K8: the store compaction between two store generations of the pool
// search.
//
// Replaces the `boundary` of mapad_tpu/ops/search_pool2.py (generations > 1,
// lines 739-919; the chain extraction and its append are K3's,
// csrc/extract_chains.cu, which the host runs just before).  Plain version:
// ops/search_pool2.py `_pool_loop_plain` / `boundary`.
//
// When the store is full (step == S) the blocks of the last CAP steps hold
// every frame that can still be popped or walked: a read is abandoned after
// CAP pops, so a live lane was refilled at step S - CAP or later.  K8 moves
// those CAP blocks up by delta = S - CAP blocks (the block of step s is
// block S-1-s, so step s becomes step s - delta), and in every moved frame
// adds 9 x delta to the parent slot (ROOT stays ROOT) and clears the
// completion and abandon marks that K3 has just extracted.  The two pop
// rings (L, RB) rotate by delta mod RB, lane_start and the step counter
// drop by delta, and the step limit of the next generation is set.
//
// What the JAX version does in ~2.5 passes over the whole (L, S+1, 128)
// store is here one pass over the window alone: the store is not padded to
// 128 words, blocks of steps not yet run are never read (the step kernel
// and K3 treat blocks below S - step as zero), and the masks K3 scans do
// not move, because every moved frame's marks are cleared: K3 is told in
// glob[G_BASE] the first step it has not seen.
//
// Overlap: the move is in place and towards higher addresses, and source
// and destination overlap when CAP > delta.  The window moves in chunks of
// delta blocks from the top of the store down, one launch per chunk: a
// chunk's destination is the source of the chunk before it, already
// copied, and its own source lies wholly below its destination.  With
// CAP <= delta (the production shapes: S=8192, CAP=3072) that is one
// launch.
//
// Bound on the card: bytes.  The window is read once and written once,
// 2 x L x CAP x 288 B (396 B with int64 intervals; 906 MB at L=512,
// CAP=3072, ~0.27 ms at 3.35 TB/s), plus the rings, 4 x L x RB x 4 B.
// No f32 arithmetic happens here.
#include "common.cuh"

using namespace mapad;

constexpr int MOVE_THREADS = 256;
constexpr int MOVE_ITEMS = 8;  // words per thread

// Move blocks [src_blk, src_blk + n_blk) of every lane up by delta blocks.
// One thread per word, so neighbouring threads touch neighbouring
// addresses; the thread of a parent word also reads its frame's op word.
template <typename I>
static __global__ void __launch_bounds__(MOVE_THREADS)
compact_move_kernel(int* store, int S, int src_blk, int n_blk, int delta) {
  constexpr int NFW = Idx<I>::NFW;
  constexpr int REC = CANDS * NFW;
  const int lane = blockIdx.y;
  const int ROOT = S * CANDS;
  const size_t n_words = (size_t)n_blk * REC;
  const int* src = store + ((size_t)lane * (S + 1) + src_blk) * REC;
  int* dst = store + ((size_t)lane * (S + 1) + src_blk + delta) * REC;
  const size_t first =
      ((size_t)blockIdx.x * MOVE_ITEMS) * MOVE_THREADS + threadIdx.x;
#pragma unroll
  for (int k = 0; k < MOVE_ITEMS; ++k) {
    const size_t w = first + (size_t)k * MOVE_THREADS;
    if (w >= n_words) break;
    const int f = (int)(w % NFW);
    int v = src[w];
    if (f == F_OP) {
      v &= ~(OP_COMP_BIT | OP_ABANDON_BIT);
    } else if (f == F_PARENT) {
      const int op = src[w + (F_OP - F_PARENT)];
      if ((op & OP_VALID_BIT) != 0 && v != ROOT) v += CANDS * delta;
    }
    dst[w] = v;
  }
}

// Rotate the rings into the second pair of buffers, lower lane_start and
// the loop counters.
static __global__ void compact_state_kernel(CompactArgs a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int L = a.L, RB = a.RB, S = a.S;
  const int delta = S - a.CAP;
  if (i < (size_t)L * RB) {
    // ring slot s holds step t with t = s (mod RB): after t -> t - delta
    // the entry of slot s is the one that sat at (s + delta) mod RB
    const int s = (int)(i % RB);
    const size_t from = i - s + (s + delta % RB) % RB;
    a.consumed_next[i] = a.consumed[from];
    a.bm_key_next[i] = a.bm_key[from];
  }
  if (i < (size_t)L) {
    const int ls = a.lane[LS_START * L + i] - delta;
    a.lane[LS_START * L + i] = ls > 0 ? ls : 0;
  }
  if (i == 0) {
    const int step = a.glob[G_STEP];
    a.glob[G_STEP] = step - delta;
    a.glob[G_BASE] = step - delta;
    a.glob[G_CUM] += delta;
    // capped spill: the next generation runs at most `spill` steps
    const int capped = step - delta + a.spill;
    a.glob[G_LIMIT] = (a.spill && capped < S) ? capped : S;
  }
}

// `launched` receives the number of __global__ launches made.
extern "C" int pool_compact(const CompactArgs* a, int* launched,
                            cudaStream_t stream) {
  *launched = 0;
  const int S = a->S, CAP = a->CAP, delta = S - CAP;
  if (delta < 1 || CAP < 1) return (int)cudaErrorInvalidValue;
  const int rec = CANDS * (a->big ? Idx<int64_t>::NFW : Idx<int32_t>::NFW);
  // destination blocks [delta, S), from the top down in chunks of delta
  for (int hi = S; hi > delta; hi -= delta) {
    const int lo = hi - delta > delta ? hi - delta : delta;
    const int n_blk = hi - lo;
    const size_t n_words = (size_t)n_blk * rec;
    const size_t per_block = (size_t)MOVE_THREADS * MOVE_ITEMS;
    const dim3 grid((unsigned)((n_words + per_block - 1) / per_block),
                    (unsigned)a->L);
    if (a->big)
      LAUNCH(compact_move_kernel<int64_t>, grid, MOVE_THREADS, stream,
             a->store, S, lo - delta, n_blk, delta);
    else
      LAUNCH(compact_move_kernel<int32_t>, grid, MOVE_THREADS, stream,
             a->store, S, lo - delta, n_blk, delta);
    CHECK_LAUNCH();
    ++*launched;
  }
  const size_t n = (size_t)a->L * a->RB;
  LAUNCH(compact_state_kernel, (unsigned)((n + 255) / 256), 256, stream, *a);
  CHECK_LAUNCH();
  ++*launched;
  return 0;
}
