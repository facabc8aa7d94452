// K5: flatten K3's result into the one int32 buffer the host copies back.
//
// Replaces mapad_tpu/ops/engine.py `_pack_result` (1589-1634).  Plain
// version: ops/engine.py `_pack_result_plain`; the host reader is the
// numpy `_unpack_result` of ops/prep.py.
//
// Wire fields in PoolResult order, each as int32 words: i32 fields as they
// are, f32 as their bits, int64 fields (c_lower, c_lrev, c_size with a big
// index) as little-endian int32 pairs, bools widened to 0/1, and c_ops
// narrowed to wire ops
// (base[0:2] | pos | kind | VALID in 5 + pb bits, pb = ceil(log2 MW)),
// K = 64 / opbits of them per little-endian int64 (12-bit ops, 5 per int64
// at MW <= 128; 13-bit, 4 per int64 at MW = 144).  The fields are read
// through one pointer each: the wrapper sets them to the parts of K3's one
// allocation (ops/search_pool2.py `_result_layout`, the engine's path) or
// to a PoolResult's tensors.
//
// A shard's result (the engine's mesh path) is packed with its read ids
// made global on the way, as mapad_tpu/parallel/pool_sharded.py (122-135)
// rewrites them and csrc/pool_sharded.cu `shard_rebase` does apart:
// c_read v -> v >= 0 ? v + base : -1, lane_read v -> v < r_local ? v + base
// : r_global, next_read + base.  Those words pass through the kernel
// anyway, so the rebase costs no launch and no byte; with `rebase` 0 every
// word is as before.
//
// Bound on the card: bytes -- it reads C*MW*4 B of op words (9.4 MB at
// C=16384, MW=144) and writes about half of that.
//
// One launch, its grid split into three regions by the launch plan
// (ops/engine.py `pack_plan`), all index math in 32 bits:
//   head  the seven C-long fields (c_read, c_slot, c_abandon, the three
//         interval fields of C or 2C words, c_score), four words a thread
//         by 16-byte loads and stores where both ends are 16-byte aligned
//         (K3's rows are), the c_abandon bytes widened four at a time;
//   ops   a block a tile of `rows` whole chain rows (a multiple of 4, so
//         every tile of K3's c_ops starts 16-byte aligned): one bulk copy
//         into shared memory counted by an mbarrier where the span is
//         16-byte aligned and a multiple of 16 bytes, else 16-byte (and
//         4-byte for a ragged end) `cp.async`; then a thread an int64 from
//         its K ops in shared memory (one 16-byte load at K = 4), stored
//         with one 8-byte store;
//   tail  n_chains, lane_read, lane_unfinished widened, next_read, steps,
//         read_steps (none where the result has no read_steps), a word a
//         thread.
#include "common.cuh"

using namespace mapad;

// the PoolResult fields, in PoolResult order (ops/search_pool.py)
enum PackField {
  P_READ = 0, P_SLOT, P_ABANDON, P_LOWER, P_LREV, P_SIZE, P_SCORE, P_OPS,
  P_NCHAINS, P_LANE_READ, P_LANE_UNF, P_NEXT_READ, P_STEPS, P_READ_STEPS,
  N_PACK_FIELDS
};

struct PackArgs {
  const void* f[N_PACK_FIELDS];  // each field's first element
  int* out;
  int C, MW, L, R;  // R = 0: no read_steps
  int opbits, K, pb, big;
  int rebase, base, r_local, r_global;  // the shard's id rebase, if rebase
};

// mirrors ops/engine.py `PackPlan`
struct PackPlan {
  int threads;      // a block's
  int head_blocks;  // region 1, the seven fields one after the other
  int ops_blocks;   // region 2, a tile of `rows` chain rows each
  int tail_blocks;  // region 3
  int rows;         // chain rows a tile (a multiple of 4)
  int smem;         // dynamic shared memory: rows * MW words
};

static __device__ __forceinline__ unsigned long long narrow_op(int w,
                                                               int pb) {
  w &= 0x1FFFFF;
  return (unsigned long long)((w & 3) | (((w >> 2) & ((1 << pb) - 1)) << 2) |
                              (((w >> 17) & 3) << (2 + pb)) |
                              (((w >> 20) & 1) << (4 + pb)));
}

// words of head field f on the wire
static __device__ __forceinline__ int head_words(int f, int C, int big) {
  return (big && f >= P_LOWER && f <= P_SIZE) ? 2 * C : C;
}

static __device__ void pack_head(const PackArgs& a, const PackPlan& p,
                                 int b) {
  int f = 0, at = 0, n = a.C;
  for (;; ++f) {
    n = head_words(f, a.C, a.big);
    const int nb = (((n + 3) >> 2) + p.threads - 1) / p.threads;
    if (b < nb) break;
    b -= nb;
    at += n;
  }
  const int w0 = (b * p.threads + threadIdx.x) * 4;
  if (w0 >= n) return;
  const int k = min(4, n - w0);
  int v[4];
  if (f == P_ABANDON) {
    const uint8_t* s = (const uint8_t*)a.f[f] + w0;
    if (k == 4 && ((uintptr_t)s & 3) == 0) {
      const unsigned x = __ldg((const unsigned*)s);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = ((x >> (8 * e)) & 0xFF) != 0;
    } else {
      for (int e = 0; e < k; ++e) v[e] = s[e] != 0;
    }
  } else {
    const int* s = (const int*)a.f[f] + w0;
    if (k == 4 && aligned16(s)) {
      const int4 q = __ldg((const int4*)s);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      for (int e = 0; e < k; ++e) v[e] = __ldg(s + e);
    }
    if (f == P_READ && a.rebase) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < k) v[e] = v[e] >= 0 ? v[e] + a.base : -1;
    }
  }
  int* o = a.out + at + w0;
  if (k == 4 && aligned16(o)) {
    *(int4*)o = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 0; e < k; ++e) o[e] = v[e];
  }
}

static __device__ void pack_ops(const PackArgs& a, const PackPlan& p, int b,
                                int* tile, unsigned long long* bar) {
  const int MW = a.MW, K = a.K;
  const int row0 = b * p.rows;
  const int rows = min(p.rows, a.C - row0);
  const int span = rows * MW;  // words; C * MW < 2^31 (the wrapper checks)
  const int* src = (const int*)a.f[P_OPS] + row0 * MW;
  if (aligned16(src) && (span & 3) == 0) {
    const unsigned bb = smem_addr(bar);
    if (threadIdx.x == 0) {
      bar_init(bb, (unsigned)span * 4u);
      bulk_load(tile, src, (unsigned)span * 4u, bb);
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    bar_wait(bb);
  } else {
    const int quads = aligned16(src) ? span & ~3 : 0;
    for (int w = threadIdx.x * 4; w < quads; w += p.threads * 4)
      cp_async16(tile + w, src + w);
    for (int w = quads + threadIdx.x; w < span; w += p.threads)
      cp_async4(tile + w, src + w);
    cp_async_wait_all();
    __syncthreads();
  }
  const int G = (MW + K - 1) / K;  // int64 words a chain
  const int pre = (a.big ? 10 : 7) * a.C;
  int* o = a.out + pre + row0 * G * 2;
  const bool o8 = ((uintptr_t)o & 7) == 0;
  const bool quad = K == 4 && (MW & 3) == 0;
  for (int t = threadIdx.x; t < rows * G; t += p.threads) {
    const int r = t / G, g = t - r * G;
    const int* s = tile + r * MW + g * K;
    unsigned long long w = 0;
    if (quad) {  // the K ops are one 16-byte word of the tile
      const int4 q = *(const int4*)s;
      w = narrow_op(q.x, a.pb) | narrow_op(q.y, a.pb) << a.opbits |
          narrow_op(q.z, a.pb) << (2 * a.opbits) |
          narrow_op(q.w, a.pb) << (3 * a.opbits);
    } else {
      const int kn = min(K, MW - g * K);
      for (int k = 0; k < kn; ++k)
        w |= narrow_op(s[k], a.pb) << (k * a.opbits);
    }
    if (o8) {
      *(unsigned long long*)(o + 2 * t) = w;
    } else {
      o[2 * t] = (int)(unsigned)w;
      o[2 * t + 1] = (int)(unsigned)(w >> 32);
    }
  }
}

static __device__ void pack_tail(const PackArgs& a, const PackPlan& p,
                                 int b) {
  const int i = b * p.threads + threadIdx.x;
  const int L = a.L;
  if (i >= 3 + 2 * L + a.R) return;
  int v;
  if (i == 0) {
    v = *(const int*)a.f[P_NCHAINS];
  } else if (i <= L) {
    v = ((const int*)a.f[P_LANE_READ])[i - 1];
    if (a.rebase) v = v < a.r_local ? v + a.base : a.r_global;
  } else if (i <= 2 * L) {
    v = ((const uint8_t*)a.f[P_LANE_UNF])[i - 1 - L] != 0;
  } else if (i == 2 * L + 1) {
    v = *(const int*)a.f[P_NEXT_READ];
    if (a.rebase) v += a.base;
  } else if (i == 2 * L + 2) {
    v = *(const int*)a.f[P_STEPS];
  } else {
    v = ((const int*)a.f[P_READ_STEPS])[i - 3 - 2 * L];
  }
  const int G = (a.MW + a.K - 1) / a.K;
  a.out[(a.big ? 10 : 7) * a.C + a.C * G * 2 + i] = v;
}

static __global__ void pack_result_kernel(PackArgs a, PackPlan p) {
  extern __shared__ __align__(16) int tile[];
  __shared__ __align__(8) unsigned long long bar;
  int b = blockIdx.x;
  if (b < p.head_blocks) {
    pack_head(a, p, b);
    return;
  }
  b -= p.head_blocks;
  if (b < p.ops_blocks) {
    pack_ops(a, p, b, tile, &bar);
    return;
  }
  pack_tail(a, p, b - p.ops_blocks);
}

extern "C" int pack_result(const PackArgs* a, const PackPlan* p,
                           cudaStream_t stream) {
  const int blocks = p->head_blocks + p->ops_blocks + p->tail_blocks;
  if (blocks <= 0) return 0;
  pack_result_kernel<<<blocks, p->threads, p->smem, stream>>>(*a, *p);
  CHECK_LAUNCH();
  return 0;
}
