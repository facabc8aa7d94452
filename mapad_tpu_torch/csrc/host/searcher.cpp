// Host fallback k-mismatch searcher: exact C++ port of the sequential
// search semantics (mapad_tpu/map/oracle.py, itself a port of reference
// mapping.rs:1012-1383).  Used for reads whose search space exceeds the
// device step budgets -- the deep tail that would cost seconds per read in
// Python costs milliseconds here.
//
// Float discipline: all score arithmetic is IEEE binary32 with the same
// operation order as the reference.  Build with -ffp-contract=off and no
// -ffast-math so the compiler cannot fuse or reorder.
//
// Build: g++ -O2 -ffp-contract=off -shared -fPIC -o libsearcher.so searcher.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>
#include <atomic>
#include <thread>

namespace {

struct FmIndex {
    const uint8_t* bwt;
    int64_t n;
    const int64_t* less;     // 6 entries
    const int64_t* occ_cp;   // (nb+1) * 6, exclusive prefix
    int64_t occ_k;
    int64_t sent0, sent1;    // sentinel positions in the BWT

    // occurrences of rank c in bwt[0..=r]
    inline int64_t occ(int64_t r, int c) const {
        int64_t b = r / occ_k;
        int64_t cnt = occ_cp[b * 6 + c];
        for (int64_t i = b * occ_k; i <= r; i++) cnt += (bwt[i] == c);
        return cnt;
    }
    inline int64_t sentinel_occ(int64_t pos) const {
        return (pos >= sent0) + (pos >= sent1);
    }
    // occurrences of ALL ranks in bwt[0..=r] in one scan: the 4-symbol
    // extension sweep needs every rank at the same two positions, so one
    // histogram pass replaces 8 per-symbol scans + the sentinel test
    // (bwt rank 0 IS the sentinel, so out[0] == sentinel_occ(r))
    inline void occ_all(int64_t r, int64_t out[6]) const {
        int64_t b = r / occ_k;
        for (int c = 0; c < 6; c++) out[c] = occ_cp[b * 6 + c];
        for (int64_t i = b * occ_k; i <= r; i++) out[bwt[i]]++;
    }
};

struct BiInterval {
    int64_t lower, lower_rev, size;
};

// One backward-extension sweep over ranks 4,3,2,1 (fmd_index.rs:108-182);
// two occ_all histogram scans serve all four symbols + the sentinel row
static void extend_all(const FmIndex& idx, const BiInterval& iv,
                       BiInterval out[4]) {
    int64_t lower = iv.lower, size = iv.size;
    int64_t lo_cnt[6] = {0, 0, 0, 0, 0, 0}, hi_cnt[6];
    int64_t r1 = lower - 1, r2 = lower + size - 1;
    if (lower != 0 && r1 / idx.occ_k == r2 / idx.occ_k) {
        // deep frames have tiny intervals, so both occ positions usually
        // share one checkpoint block: a single scan captures the counts
        // at r1 and continues to r2, instead of re-scanning the prefix
        int64_t b = r1 / idx.occ_k;
        for (int c = 0; c < 6; c++) lo_cnt[c] = idx.occ_cp[b * 6 + c];
        int64_t i = b * idx.occ_k;
        for (; i <= r1; i++) lo_cnt[idx.bwt[i]]++;
        for (int c = 0; c < 6; c++) hi_cnt[c] = lo_cnt[c];
        for (; i <= r2; i++) hi_cnt[idx.bwt[i]]++;
    } else {
        if (lower != 0) idx.occ_all(r1, lo_cnt);
        idx.occ_all(r2, hi_cnt);
    }
    int64_t s = hi_cnt[0] - lo_cnt[0];  // sentinel occurrences
    int64_t l = iv.lower_rev;
    int slot = 0;
    for (int c = 4; c >= 1; c--, slot++) {
        l += s;
        int64_t o = lo_cnt[c];
        s = hi_cnt[c] - o;
        out[slot] = {idx.less[c] + o, l, s};
    }
}

constexpr float F32_MIN = -3.4028235e38f;

// Bi-D array (bi_d_array.rs): 15 offset walks per half, running-max window.
//
// Walks from the same reset point are identical (a failure resets the
// interval to init, so the continuation depends only on the restart
// position), hence all 15 offset walks converge onto one shared failure
// chain after their first failure.  fail_at/win_rm memoize (first failure
// index, window penalty max) per start position; FM extends run only when
// a start is first seen (~1 chain per part + 15 short prefixes instead of
// 15 full walks).  Per-walk f32 z accumulation order is preserved exactly:
// the same window maxima are added in the same sequence.
static void compute_bi_d(const FmIndex& idx, const uint8_t* rank, int32_t n,
                         int32_t split, const float* pen,
                         std::vector<float>& composite) {
    constexpr int MAX_OFFSET = 15;
    composite.assign(n, 0.0f);
    std::vector<int32_t> fail_at;
    std::vector<float> win_rm;

    // The walks are single-direction perfect extensions and only the
    // interval SIZE is consumed (failure test), so the full FMD swap
    // bookkeeping is unnecessary: a forward walk of P equals a backward
    // walk of revcomp(P) with identical occurrence counts (the text holds
    // both strands), i.e. one 2-occ-scan LF step per extension instead of
    // extend_all's 8 scans + sentinel row.  Failure positions -- and so
    // every emitted f32 value -- are bit-identical.
    auto lf_step = [&idx](int64_t& lower, int64_t& size, int c) {
        if (c < 1 || c > 4) {
            size = 0;
            return;
        }
        int64_t o = lower == 0 ? 0 : idx.occ(lower - 1, c);
        int64_t s2 = idx.occ(lower + size - 1, c) - o;
        lower = idx.less[c] + o;
        size = s2;
    };

    // part 0: pattern[:split], forward extension, walk index == abs index
    // part 1: pattern[split:] reversed, backward extension
    for (int part = 0; part < 2; part++) {
        int32_t plen = part == 0 ? split : n - split;
        if (plen <= 0) continue;
        fail_at.assign(plen, -1);
        win_rm.assign(plen, 0.0f);
        auto chain = [&](int32_t s) {
            if (fail_at[s] >= 0) return;
            int64_t lower = 0, size = idx.n;
            float rm = F32_MIN;
            int32_t f = plen;
            for (int32_t step = s; step < plen; step++) {
                int c;
                int32_t abs_idx;
                if (part == 0) {
                    // forward ext == backward walk with complemented rank
                    abs_idx = step;
                    c = rank[abs_idx];
                    c = (c >= 1 && c <= 4) ? 5 - c : 0;
                } else {
                    abs_idx = n - 1 - step;
                    c = rank[abs_idx];
                }
                lf_step(lower, size, c);
                rm = std::max(rm, pen[abs_idx]);
                if (size < 1) {
                    f = step;
                    break;
                }
            }
            fail_at[s] = f;
            win_rm[s] = rm;
        };
        std::vector<float> dmin(plen, 0.0f);
        for (int off = 0; off < MAX_OFFSET && off < plen; off++) {
            // out[k] = z after step k-1; z constant between failures
            float z = 0.0f;
            int32_t s = off;
            while (s < plen) {
                chain(s);
                int32_t f = fail_at[s];
                int32_t hi = std::min(f, plen - 1);
                for (int32_t k = s + 1; k <= hi; k++)
                    dmin[k] = std::min(dmin[k], z);
                if (f >= plen) break;
                z = z + win_rm[s];  // f32 add, per-walk order preserved
                if (f + 1 < plen) dmin[f + 1] = std::min(dmin[f + 1], z);
                s = f + 1;
            }
        }
        for (int32_t i = 0; i < plen; i++)
            composite[(part == 0 ? 0 : split) + i] = dmin[i];
    }
}

static inline float bi_d_get(const std::vector<float>& comp, int32_t split,
                             int32_t n, int32_t bk, int32_t fwd) {
    float d_rev = (bk >= 0 && bk < n) ? comp[bk] : 0.0f;
    int32_t t = n - (1 + fwd);
    float d_fwd = 0.0f;
    if (t >= 0) {
        int32_t ci = t + split;
        if (ci < n) d_fwd = comp[ci];
    }
    return d_rev + d_fwd;
}

constexpr int OP_MATCH = 0, OP_MISMATCH = 1, OP_INSERTION = 2, OP_DELETION = 3;
constexpr int GAP_CLOSED = 0, GAP_INS = 1, GAP_DEL = 2;
constexpr uint32_t OP_VALID_BIT = 1u << 20;

struct Frame {
    BiInterval iv;
    int32_t start, len;
    int8_t gap_b, gap_f;
    int8_t ngaps;
    float score;
    int32_t node;
    int64_t counter;  // LIFO tie-break
};

struct HeapCmp {
    // max-heap by (score, counter): ties pop the latest push (LIFO)
    bool operator()(const Frame& a, const Frame& b) const {
        if (a.score != b.score) return a.score < b.score;
        return a.counter < b.counter;
    }
};

// 4-ary max-heap over (score, counter).  The comparator is a TOTAL
// order (counters are unique), so the pop sequence -- the only thing
// the search semantics observe -- is identical to any other exact
// max-heap, including std::push_heap/pop_heap; only the in-array
// layout differs.  Deep searches carry 10^5..10^6-frame frontiers
// (5-50 MB at genome scale): halving the sift depth and keeping the 4
// children of a node contiguous (3 cache lines instead of 2 scattered
// pairs per level) cuts the DRAM-latency stalls that dominate each
// pop's heap maintenance.
static inline void heap4_push(std::vector<Frame>& h, const HeapCmp& cmp) {
    size_t i = h.size() - 1;
    Frame v = h[i];
    while (i > 0) {
        size_t p = (i - 1) >> 2;
        if (!cmp(h[p], v)) break;
        h[i] = h[p];
        i = p;
    }
    h[i] = v;
}

static inline void heap4_sift_down(std::vector<Frame>& h, size_t i,
                                   size_t limit, const HeapCmp& cmp) {
    Frame v = h[i];
    for (;;) {
        size_t c0 = (i << 2) + 1;
        if (c0 >= limit) break;
        size_t best = c0;
        size_t cend = std::min(c0 + 4, limit);
        for (size_t c = c0 + 1; c < cend; c++)
            if (cmp(h[best], h[c])) best = c;
        if (!cmp(v, h[best])) break;
        h[i] = h[best];
        i = best;
    }
    h[i] = v;
}

// move the max to h.back() and re-heapify the rest (the caller reads
// h.back() then pop_back, matching the std::pop_heap protocol)
static inline void heap4_pop(std::vector<Frame>& h, const HeapCmp& cmp) {
    size_t n = h.size();
    if (n <= 1) return;
    std::swap(h[0], h[n - 1]);
    heap4_sift_down(h, 0, n - 1, cmp);
}

static inline void heap4_make(std::vector<Frame>& h, const HeapCmp& cmp) {
    if (h.size() < 2) return;
    for (size_t i = (h.size() - 2) >> 2; i + 1 > 0; i--)
        heap4_sift_down(h, i, h.size(), cmp);
}

struct SearchCtx {
    const FmIndex* idx;
    const uint8_t* rank;
    const uint8_t* code;
    int32_t n;
    const float* slut;  // n*4
    int32_t split;
    float cutoff_scale, cutoff_thresh;
    float repr_mm;  // -inf disables reject_iterative
    float pgo_pge, pge;
    int32_t gap_dist_ends, max_gaps;
    int stack_limit_abort;
    int64_t stack_limit, tree_limit;

    inline bool reject(float v) const { return (v / cutoff_scale) < cutoff_thresh; }
};

struct Hit {
    BiInterval iv;
    float score;
    std::vector<uint32_t> ops;  // packed op words, self-first ancestor order
};

}  // namespace

// Per-thread pop counter for the last search_read call (profiling only:
// tools/monster_profile.py characterizes the deep-search tail).
static thread_local int64_t g_last_pops = 0;

// Exhaustion probe for reads the device flagged as no-hit.  Runs the
// SAME static pruning as search_read (cutoff + Bi-D lookahead + gap
// rules) but in depth-first order with a plain stack: the live working
// set is O(read length * branching) instead of the best-first heap's
// whole frontier (~64 KB vs 5-50 MB on deep genome-scale searches).
//
// Soundness: the probe reports 0 ONLY when the full exact search would
// provably return zero hits.  With no hits, search_read's
// order-dependent machinery (reject_iterative, the multi-hit early
// stops, best-score tracking) never engages, so its explored frame set
// is determined by the static predicates alone and is identical under
// any pop order.  The probe bails (1) the moment either proof
// obligation breaks: a completed alignment exists (a hit -- order now
// matters for hit ranking), or total pushes reach the stack/tree
// limits (the exact search's heap size and tree length are bounded by
// total pushes, so below the limit its eviction path provably never
// fired).  Callers run the exact search on 1; on 0 the empty result is
// bit-identical.
//
// ProbeState::step() performs ONE pop so a batch driver can interleave
// K probes on one thread: each pop costs a handful of dependent
// DRAM-latency fetches (checkpoint row + bwt segment), and rotating
// through K small-working-set stacks hides that latency behind the
// other reads' compute (the same idea failed for the exact searcher --
// K best-first heaps evict each other from LLC -- but K DFS stacks fit
// in L2 together).
struct ProbeState {
    SearchCtx ctx;
    std::vector<float> bid;
    std::vector<Frame> stack;
    int64_t pushes = 0;
    int64_t push_budget = 0;
    int64_t pops = 0;
    bool bail = false;
    bool done = false;  // done && !bail => proven hitless

    void init(const SearchCtx& c, const float* pen) {
        ctx = c;
        compute_bi_d(*ctx.idx, ctx.rank, ctx.n, ctx.split, pen, bid);
        start_from_root();
    }

    void start_from_root() {
        // exact search: heap size <= pushes, tree length <= pushes + 1
        push_budget = std::min(ctx.stack_limit, ctx.tree_limit - 1);
        pushes = 0;
        pops = 0;
        bail = false;
        done = false;
        stack.clear();
        stack.reserve(4096);
        stack.push_back(Frame{{0, 0, ctx.idx->n}, ctx.split, 0, GAP_CLOSED,
                              GAP_CLOSED, 0, 0.0f, 0, 0});
    }

    inline void prefetch_top() const {
        if (stack.empty()) return;
        const FmIndex& idx = *ctx.idx;
        const Frame& f = stack.back();
        bool nfwd = f.start <= ctx.n - f.start - f.len;
        int64_t lo = nfwd ? f.iv.lower_rev : f.iv.lower;
        int64_t r1 = lo - 1, r2 = lo + f.iv.size - 1;
        if (r1 >= 0) {
            __builtin_prefetch(&idx.bwt[r1], 0, 2);
            __builtin_prefetch(&idx.occ_cp[(r1 / idx.occ_k) * 6], 0, 2);
        }
        __builtin_prefetch(&idx.bwt[r2], 0, 2);
        __builtin_prefetch(&idx.occ_cp[(r2 / idx.occ_k) * 6], 0, 2);
    }

    // one pop + its child pushes; children of each pop go on the stack
    // in ascending score order so the BEST child pops first: the
    // descent is greedy best-first along each path, which completes an
    // alignment within ~n pops when one exists (fast bail on misrouted
    // hit-ful reads).  For a truly hitless read every statically-valid
    // frame is visited regardless of order, so ordering is inert.
    void step() {
        if (done) return;
        if (bail || stack.empty()) {
            done = true;
            return;
        }
        const FmIndex& idx = *ctx.idx;
        int32_t n = ctx.n;
        Frame f = stack.back();
        stack.pop_back();
        ++pops;

        Frame batch[9];
        int nbatch = 0;
        auto push_or_bail = [&](Frame nf) {
            if (nf.ngaps > ctx.max_gaps) return;
            if (nf.len == n) {  // a qualifying alignment: hits exist
                bail = true;
                return;
            }
            if (++pushes >= push_budget) {  // can't prove no eviction
                bail = true;
                return;
            }
            batch[nbatch++] = nf;
        };

        bool fwd = f.start <= n - f.start - f.len;
        int32_t j, d_k, d_l;
        BiInterval ext;
        int8_t gap_state;
        if (fwd) {
            j = f.start + f.len;
            d_k = f.start;
            d_l = f.start + f.len;
            ext = {f.iv.lower_rev, f.iv.lower, f.iv.size};
            gap_state = f.gap_f;
        } else {
            j = f.start - 1;
            d_k = f.start - 1;
            d_l = f.start + f.len - 1;
            ext = f.iv;
            gap_state = f.gap_b;
        }

        float ins_score =
            (gap_state == GAP_INS ? ctx.pge : ctx.pgo_pge) + f.score;
        float del_score =
            (gap_state == GAP_DEL ? ctx.pge : ctx.pgo_pge) + f.score;
        int8_t ngaps_inc = gap_state == GAP_CLOSED ? f.ngaps + 1 : f.ngaps;

        float lb = bi_d_get(bid, ctx.split, n, d_k, d_l);

        BiInterval children[4];
        extend_all(idx, ext, children);

        if (!ctx.reject(ins_score + lb) &&
            std::min(j, n - j - 1) >= ctx.gap_dist_ends) {
            Frame nf = f;
            nf.start = fwd ? f.start : f.start - 1;
            nf.len = f.len + 1;
            nf.gap_b = fwd ? f.gap_b : GAP_INS;
            nf.gap_f = fwd ? GAP_INS : f.gap_f;
            nf.ngaps = ngaps_inc;
            nf.score = ins_score;
            push_or_bail(nf);
        }

        int32_t d5 = fwd ? j : j + 1;
        bool del_allowed = std::min(d5, n - d5) >= ctx.gap_dist_ends;
        bool del_rej = ctx.reject(del_score + lb);

        for (int slot = 0; slot < 4 && !bail; slot++) {
            BiInterval child = children[slot];
            if (child.size < 1) continue;
            if (fwd) child = {child.lower_rev, child.lower, child.size};
            int code = fwd ? slot : 3 - slot;
            float mm_score = ctx.slut[j * 4 + code] + f.score;

            if (!del_rej && del_allowed) {
                Frame nf = f;
                nf.iv = child;
                nf.gap_b = fwd ? f.gap_b : GAP_DEL;
                nf.gap_f = fwd ? GAP_DEL : f.gap_f;
                nf.ngaps = ngaps_inc;
                nf.score = del_score;
                push_or_bail(nf);
            }

            if (!ctx.reject(mm_score + lb)) {
                Frame nf = f;
                nf.iv = child;
                nf.start = fwd ? f.start : f.start - 1;
                nf.len = f.len + 1;
                nf.gap_b = fwd ? f.gap_b : GAP_CLOSED;
                nf.gap_f = fwd ? GAP_CLOSED : f.gap_f;
                nf.score = mm_score;
                push_or_bail(nf);
            }
        }
        if (bail) {
            done = true;
            return;
        }
        // insertion sort ascending; best lands on top of the stack
        for (int a = 1; a < nbatch; a++) {
            Frame key = batch[a];
            int b = a - 1;
            while (b >= 0 && batch[b].score > key.score) {
                batch[b + 1] = batch[b];
                b--;
            }
            batch[b + 1] = key;
        }
        for (int a = 0; a < nbatch; a++) stack.push_back(batch[a]);
        if (stack.empty()) done = true;  // exhausted: proven hitless
    }
};

static int exhaust_probe(const SearchCtx& ctx,
                         const std::vector<float>& bid) {
    ProbeState st;
    st.ctx = ctx;
    st.bid = bid;
    st.start_from_root();
    g_last_pops = 0;
    while (!st.done) st.step();
    g_last_pops = st.pops;
    return st.bail ? 1 : 0;
}

extern "C" {

// Pops (heap extractions) consumed by the calling thread's last
// search_read; the search semantics themselves are unaffected.
int64_t last_search_pops() { return g_last_pops; }

// Batch-resolve suffix-array positions via LF-walks over the sampled SA
// (reference index/mod.rs:160-187).  positions/out are n_pos-long.
int sa_lookup_batch(
    const uint8_t* bwt, int64_t bwt_len, const int64_t* less,
    const int64_t* occ_cp, int64_t occ_k, int64_t sampling_rate,
    const int64_t* sample, const int64_t* extra_keys,
    const int64_t* extra_vals, int64_t n_extra,
    const int64_t* positions, int64_t n_pos, int64_t* out) {
    FmIndex idx{bwt, bwt_len, less, occ_cp, occ_k, 0, 0};
    for (int64_t i = 0; i < n_pos; i++) {
        int64_t pos = positions[i];
        if (pos >= bwt_len || pos < 0) {
            out[i] = -1;
            continue;
        }
        int64_t offset = 0;
        for (;;) {
            if (pos % sampling_rate == 0) {
                out[i] = sample[pos / sampling_rate] + offset;
                break;
            }
            int c = bwt[pos];
            if (c == 0) {  // sentinel: cached extra row (binary search)
                int64_t lo = 0, hi = n_extra;
                while (lo < hi) {
                    int64_t mid = (lo + hi) / 2;
                    if (extra_keys[mid] < pos) lo = mid + 1; else hi = mid;
                }
                out[i] = extra_vals[lo] + offset;
                break;
            }
            pos = less[c] + idx.occ(pos - 1, c);
            offset++;
        }
    }
    return 0;
}

// Search one read; returns the number of hits (capped at max_hits).
// ops_out layout: per hit, (n + 16) uint32 op words, 0-terminated.
int search_read(
    const uint8_t* bwt, int64_t bwt_len, const int64_t* less,
    const int64_t* occ_cp, int64_t occ_k, const int64_t* sentinels,
    const uint8_t* pattern_rank, const uint8_t* pattern_code, int32_t n,
    const float* score_lut, const float* pen, int32_t split,
    float cutoff_scale, float cutoff_thresh, float repr_mm,
    float pgo_pge, float pge, int32_t gap_dist_ends, int32_t max_gaps,
    int stack_limit_abort, int64_t stack_limit, int64_t tree_limit,
    int32_t max_hits, float* hit_scores, int64_t* hit_ivals /* max_hits*3 */,
    uint32_t* ops_out, int32_t nohit_hint) {
    FmIndex idx{bwt, bwt_len, less, occ_cp, occ_k, sentinels[0], sentinels[1]};
    SearchCtx ctx{&idx,  pattern_rank, pattern_code, n,
                  score_lut, split, cutoff_scale, cutoff_thresh, repr_mm,
                  pgo_pge, pge, gap_dist_ends, max_gaps, stack_limit_abort,
                  stack_limit, tree_limit};

    std::vector<float> bid;
    compute_bi_d(idx, pattern_rank, n, split, pen, bid);

    // depth-first exhaustion probe first when the caller flagged this
    // read as (probably) hitless; shares the Bi-D above.  0 proves the
    // heap search below returns zero hits (see exhaust_probe); any hit
    // or limit falls through to the exact search.  stack_limit_abort
    // runs an order-dependent truncated search the proof doesn't cover.
    if (nohit_hint && !stack_limit_abort &&
        exhaust_probe(ctx, bid) == 0)
        return 0;

    // edit tree arena: node 0 = root
    std::vector<uint32_t> tree_op(1, 0);
    std::vector<int32_t> tree_parent(1, 0);
    std::vector<int32_t> tree_free;
    auto tree_add = [&](uint32_t op, int32_t parent) -> int32_t {
        if (!tree_free.empty()) {
            int32_t id = tree_free.back();
            tree_free.pop_back();
            tree_op[id] = op;
            tree_parent[id] = parent;
            return id;
        }
        tree_op.push_back(op);
        tree_parent.push_back(parent);
        return (int32_t)tree_op.size() - 1;
    };
    auto tree_len = [&]() {
        return (int64_t)tree_op.size() - (int64_t)tree_free.size();
    };

    std::vector<Hit> hits;
    float best_score = -std::numeric_limits<float>::infinity();
    int64_t best_size = 0;
    bool has_hit = false;

    std::vector<Frame> heap;
    HeapCmp cmp;
    int64_t counter = 0;

    auto reject_iterative = [&](float v) {
        return has_hit && v < best_score + ctx.repr_mm;
    };

    auto check_and_push = [&](Frame f, uint32_t op) {
        if (reject_iterative(f.score)) return;
        if (f.ngaps > ctx.max_gaps) return;
        f.node = tree_add(op, f.node);
        if (f.len == n) {
            Hit h;
            h.iv = f.iv;
            h.score = f.score;
            for (int32_t nd = f.node; nd != 0; nd = tree_parent[nd])
                h.ops.push_back(tree_op[nd]);
            hits.push_back(std::move(h));
            if (!has_hit || f.score > best_score) {
                best_score = f.score;
                best_size = f.iv.size;
            }
            has_hit = true;
            return;
        }
        f.counter = counter++;
        // Prefetch the occ rows this frame's NEXT extension will touch
        // (known at push time: direction from start/len).  At genome
        // scale the BWT + checkpoint arrays are many GB and each pop is
        // otherwise two dependent DRAM-latency stalls; pushes precede
        // pops by enough work to hide most of it (semantically inert).
        {
            bool nfwd = f.start <= n - f.start - f.len;
            int64_t lo = nfwd ? f.iv.lower_rev : f.iv.lower;
            int64_t r1 = lo - 1, r2 = lo + f.iv.size - 1;
            if (r1 >= 0) {
                __builtin_prefetch(&idx.bwt[r1], 0, 1);
                __builtin_prefetch(&idx.occ_cp[(r1 / idx.occ_k) * 6], 0, 1);
            }
            __builtin_prefetch(&idx.bwt[r2], 0, 1);
            __builtin_prefetch(&idx.occ_cp[(r2 / idx.occ_k) * 6], 0, 1);
        }
        heap.push_back(f);
        heap4_push(heap, cmp);
    };

    {
        Frame root{{0, 0, idx.n}, split, 0, GAP_CLOSED, GAP_CLOSED, 0, 0.0f, 0, 0};
        root.counter = counter++;
        heap.push_back(root);
    }

    g_last_pops = 0;
    while (!heap.empty()) {
        heap4_pop(heap, cmp);
        Frame f = heap.back();
        heap.pop_back();
        ++g_last_pops;
        if (!heap.empty()) {
            // Speculatively prefetch the likely NEXT pop's occ rows so
            // its two DRAM fetches overlap this frame's extension work.
            // Push-time prefetch (check_and_push) covers fresh frames,
            // but deep searches pop frames pushed long ago whose lines
            // have been evicted; heap.front() is the next pop unless a
            // push of this iteration beats it.
            const Frame& nx = heap.front();
            bool nxf = nx.start <= n - nx.start - nx.len;
            int64_t nlo = nxf ? nx.iv.lower_rev : nx.iv.lower;
            int64_t nr1 = nlo - 1, nr2 = nlo + nx.iv.size - 1;
            if (nr1 >= 0) {
                __builtin_prefetch(&idx.bwt[nr1], 0, 2);
                __builtin_prefetch(&idx.occ_cp[(nr1 / idx.occ_k) * 6], 0, 2);
            }
            __builtin_prefetch(&idx.bwt[nr2], 0, 2);
            __builtin_prefetch(&idx.occ_cp[(nr2 / idx.occ_k) * 6], 0, 2);
        }

        bool fwd = f.start <= n - f.start - f.len;
        int32_t j, d_k, d_l;
        BiInterval ext;
        int8_t gap_state;
        if (fwd) {
            j = f.start + f.len;
            d_k = f.start;
            d_l = f.start + f.len;
            ext = {f.iv.lower_rev, f.iv.lower, f.iv.size};
            gap_state = f.gap_f;
        } else {
            j = f.start - 1;
            d_k = f.start - 1;
            d_l = f.start + f.len - 1;
            ext = f.iv;
            gap_state = f.gap_b;
        }

        float ins_score = (gap_state == GAP_INS ? ctx.pge : ctx.pgo_pge) + f.score;
        float del_score = (gap_state == GAP_DEL ? ctx.pge : ctx.pgo_pge) + f.score;
        int8_t ngaps_inc = gap_state == GAP_CLOSED ? f.ngaps + 1 : f.ngaps;

        float lb = bi_d_get(bid, split, n, d_k, d_l);

        if (reject_iterative(f.score + lb)) break;

        BiInterval children[4];
        extend_all(idx, ext, children);

        // insertion
        if (!ctx.reject(ins_score + lb) &&
            std::min(j, n - j - 1) >= ctx.gap_dist_ends) {
            Frame nf = f;
            nf.start = fwd ? f.start : f.start - 1;
            nf.len = f.len + 1;
            nf.gap_b = fwd ? f.gap_b : GAP_INS;
            nf.gap_f = fwd ? GAP_INS : f.gap_f;
            nf.ngaps = ngaps_inc;
            nf.score = ins_score;
            check_and_push(nf, OP_VALID_BIT | (OP_INSERTION << 17) | ((uint32_t)j << 2));
        }

        int32_t d5 = fwd ? j : j + 1;
        bool del_allowed = std::min(d5, n - d5) >= ctx.gap_dist_ends;
        bool del_rej = ctx.reject(del_score + lb);

        for (int slot = 0; slot < 4; slot++) {
            BiInterval child = children[slot];
            if (child.size < 1) continue;
            if (fwd) child = {child.lower_rev, child.lower, child.size};
            int code = fwd ? slot : 3 - slot;
            float mm_score = ctx.slut[j * 4 + code] + f.score;

            if (!del_rej && del_allowed) {
                Frame nf = f;
                nf.iv = child;
                nf.gap_b = fwd ? f.gap_b : GAP_DEL;
                nf.gap_f = fwd ? GAP_DEL : f.gap_f;
                nf.ngaps = ngaps_inc;
                nf.score = del_score;
                check_and_push(
                    nf, OP_VALID_BIT | (OP_DELETION << 17) | ((uint32_t)j << 2) | code);
            }

            if (!ctx.reject(mm_score + lb)) {
                Frame nf = f;
                nf.iv = child;
                nf.start = fwd ? f.start : f.start - 1;
                nf.len = f.len + 1;
                nf.gap_b = fwd ? f.gap_b : GAP_CLOSED;
                nf.gap_f = fwd ? GAP_CLOSED : f.gap_f;
                nf.score = mm_score;
                int kind = (code == ctx.code[j]) ? OP_MATCH : OP_MISMATCH;
                check_and_push(
                    nf, OP_VALID_BIT | ((uint32_t)kind << 17) | ((uint32_t)j << 2) | code);
            }
        }

        if ((int64_t)hits.size() > 9 || (has_hit && best_size > 1)) break;

        if ((int64_t)heap.size() > ctx.stack_limit || tree_len() > ctx.tree_limit) {
            if (ctx.stack_limit_abort) break;
            int64_t excess = std::max((int64_t)heap.size() - ctx.stack_limit,
                                      tree_len() - ctx.tree_limit);
            for (int64_t k = 0; k < excess && !heap.empty(); k++) {
                // pop_min: linear scan for min (score, counter) -- rare
                // recovery path (matches the Python oracle's pop_min)
                size_t mi = 0;
                for (size_t i2 = 1; i2 < heap.size(); i2++) {
                    const Frame &a = heap[i2], &b = heap[mi];
                    if (a.score < b.score ||
                        (a.score == b.score && a.counter < b.counter))
                        mi = i2;
                }
                tree_free.push_back(heap[mi].node);
                heap[mi] = heap.back();
                heap.pop_back();
                heap4_make(heap, cmp);
            }
        }
    }

    // emit hits (completion order preserved)
    int32_t n_out = std::min((int32_t)hits.size(), max_hits);
    int32_t stride = n + 16;
    for (int32_t h = 0; h < n_out; h++) {
        hit_scores[h] = hits[h].score;
        hit_ivals[h * 3 + 0] = hits[h].iv.lower;
        hit_ivals[h * 3 + 1] = hits[h].iv.lower_rev;
        hit_ivals[h * 3 + 2] = hits[h].iv.size;
        int32_t k = 0;
        for (uint32_t w : hits[h].ops) {
            if (k >= stride - 1) break;
            ops_out[h * stride + k++] = w;
        }
        ops_out[h * stride + k] = 0;
    }
    return (int32_t)hits.size();
}

// K-way interleaved no-hit exhaustion probes over a batch of reads.
// ranks/codes are (B, max_n) row-major uint8; sluts (B, max_n, 4) f32;
// pens (B, max_n) f32; ns/splits (B,) int32; scales/threshs (B,) f32.
// verdicts[i]: 0 = proven hitless (exact search returns zero hits,
// see ProbeState), 1 = bail -> caller runs the exact search.
// Interleaving hides each pop's dependent DRAM fetches behind the
// other reads' compute; K stacks together stay L2-resident.
int exhaust_probe_batch(
    const uint8_t* bwt, int64_t bwt_len, const int64_t* less,
    const int64_t* occ_cp, int64_t occ_k, const int64_t* sentinels,
    const uint8_t* ranks, const uint8_t* codes, const int32_t* ns,
    int32_t max_n, const float* sluts, const float* pens,
    const int32_t* splits, const float* scales, const float* threshs,
    float pgo_pge, float pge, int32_t gap_dist_ends, int32_t max_gaps,
    int64_t stack_limit, int64_t tree_limit,
    int32_t B, int32_t K, int32_t* verdicts) {
    FmIndex idx{bwt, bwt_len, less, occ_cp, occ_k, sentinels[0],
                sentinels[1]};
    if (K < 1) K = 1;
    std::vector<ProbeState> states((size_t)std::min(K, B));
    std::vector<int32_t> who(states.size(), -1);  // read index per slot
    int32_t next_read = 0;
    int32_t live = 0;

    auto load = [&](size_t slot) -> bool {
        while (next_read < B) {
            int32_t r = next_read++;
            if (ns[r] <= 0) {  // empty rows prove trivially
                verdicts[r] = 0;
                continue;
            }
            SearchCtx ctx{&idx, ranks + (size_t)r * max_n,
                          codes + (size_t)r * max_n, ns[r],
                          sluts + (size_t)r * max_n * 4, splits[r],
                          scales[r], threshs[r],
                          -std::numeric_limits<float>::infinity(),
                          pgo_pge, pge, gap_dist_ends, max_gaps, 0,
                          stack_limit, tree_limit};
            states[slot].init(ctx, pens + (size_t)r * max_n);
            who[slot] = r;
            return true;
        }
        who[slot] = -1;
        return false;
    };
    for (size_t s = 0; s < states.size(); s++) live += load(s);

    while (live > 0) {
        for (size_t s = 0; s < states.size(); s++) {
            if (who[s] < 0) continue;
            ProbeState& st = states[s];
            st.step();
            if (st.done) {
                verdicts[who[s]] = st.bail ? 1 : 0;
                if (!load(s)) live--;
            } else {
                st.prefetch_top();
            }
        }
    }
    return 0;
}

// Batch Bi-D arrays for R reads (threaded; ctypes releases the GIL).
// ranks/pens/out are (R, M) row-major; per read only the first ns[r]
// columns are meaningful, the rest of out is zero-filled.  Exact reference
// semantics (bi_d_array.rs) via the same compute_bi_d as search_read.
int compute_bid_batch(
    const uint8_t* bwt, int64_t bwt_len, const int64_t* less,
    const int64_t* occ_cp, int64_t occ_k, const int64_t* sentinels,
    const uint8_t* ranks, const float* pens, const int32_t* ns,
    const int32_t* splits, int32_t R, int32_t M, int32_t n_threads,
    float* out) {
    FmIndex idx{bwt, bwt_len, less, occ_cp, occ_k, sentinels[0],
                sentinels[1]};
    if (n_threads < 1) n_threads = 1;
    std::atomic<int32_t> next(0);
    auto work = [&]() {
        std::vector<float> comp;
        for (;;) {
            int32_t r = next.fetch_add(1);
            if (r >= R) break;
            int32_t n = ns[r];
            float* o = out + (int64_t)r * M;
            std::fill(o, o + M, 0.0f);
            if (n <= 0) continue;
            compute_bi_d(idx, ranks + (int64_t)r * M, n, splits[r],
                         pens + (int64_t)r * M, comp);
            std::copy(comp.begin(), comp.end(), o);
        }
    };
    if (n_threads == 1) {
        work();
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; t++) ts.emplace_back(work);
        for (auto& t : ts) t.join();
    }
    return 0;
}

}
