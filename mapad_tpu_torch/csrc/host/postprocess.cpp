// Batched hit postprocessing: coordinates, MAPQ, CIGAR/MD/NM, BAM encode.
//
// Exact C++ port of mapad_tpu/map/postprocess.py + map/record.py
// to_bam_fields + map/prrange.py (themselves ports of reference
// src/map/mapping.rs:402-927, src/map/record.rs:282-438,
// src/map/prrange.rs).  Takes a whole chunk of reads with their hit
// intervals (packed op words, same format as searcher.cpp / the device
// chain log) and returns concatenated encoded BAM record bodies ready for
// the BGZF writer.  Releases the GIL via ctypes; parallelism is internal
// (std::thread over read ranges).
//
// Float discipline: scores are IEEE binary32 with the reference's op
// order; mul_add is emulated as double(a)*double(b)+double(c) rounded
// once (matching mapad_tpu/utils/f32.py), exp2/log10 computed in double
// and rounded to f32 (matching the Python postprocess).
//
// Build: g++ -O2 -ffp-contract=off -shared -fPIC -pthread -o libpostprocess.so postprocess.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// FM-index occ + sampled-SA LF-walk (same semantics as searcher.cpp)
// ---------------------------------------------------------------------------

struct SaIndex {
    const uint8_t* bwt;
    int64_t n;
    const int64_t* less;    // 6 entries
    const int64_t* occ_cp;  // (nb+1) * 6 exclusive prefix
    int64_t occ_k;
    int64_t sampling_rate;
    const int64_t* sample;
    const int64_t* extra_keys;
    const int64_t* extra_vals;
    int64_t n_extra;

    inline int64_t occ(int64_t r, int c) const {
        int64_t b = r / occ_k;
        int64_t cnt = occ_cp[b * 6 + c];
        for (int64_t i = b * occ_k; i <= r; i++) cnt += (bwt[i] == c);
        return cnt;
    }

    // index/runtime.py SampledSuffixArray.get
    int64_t get(int64_t pos) const {
        if (pos < 0 || pos >= n) return -1;
        int64_t offset = 0;
        for (;;) {
            if (pos % sampling_rate == 0) return sample[pos / sampling_rate] + offset;
            int c = bwt[pos];
            if (c == 0) {  // sentinel: cached extra row
                int64_t lo = 0, hi = n_extra;
                while (lo < hi) {
                    int64_t mid = (lo + hi) / 2;
                    if (extra_keys[mid] < pos) lo = mid + 1; else hi = mid;
                }
                return extra_vals[lo] + offset;
            }
            pos = less[c] + occ(pos - 1, c);
            offset++;
        }
    }
};

// ---------------------------------------------------------------------------
// f32 helpers (mapad_tpu/utils/f32.py)
// ---------------------------------------------------------------------------

static inline float mul_add_f32(float a, float b, float c) {
    return (float)((double)a * (double)b + (double)c);
}

static inline float exp2_f32(float x) { return (float)std::exp2((double)x); }

// Rust `f32::round() as u8`: half away from zero, NaN -> 0, saturate [0,255]
static inline int round_u8(float x) {
    if (std::isnan(x)) return 0;
    double r = x >= 0 ? std::floor((double)x + 0.5) : std::ceil((double)x - 0.5);
    if (r < 0) return 0;
    if (r > 255) return 255;
    return (int)r;
}

// ---------------------------------------------------------------------------
// SplitMix64 (map/postprocess.py SplitMixRng)
// ---------------------------------------------------------------------------

struct SplitMix {
    uint64_t state;
    uint64_t next_u64() {
        state += 0x9E3779B97F4A7C15ull;
        uint64_t z = state;
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        return z ^ (z >> 31);
    }
    uint32_t next_u32() { return (uint32_t)(next_u64() & 0xFFFFFFFFull); }
};

// ---------------------------------------------------------------------------
// PrRange (map/prrange.py, reference src/map/prrange.rs)
// ---------------------------------------------------------------------------

static bool is_prime(uint64_t n) {
    if (n <= 1) return false;
    if (n <= 3) return true;
    if (n % 2 == 0 || n % 3 == 0) return false;
    for (uint64_t i = 5; i * i <= n; i += 6)
        if (n % i == 0 || n % (i + 2) == 0) return false;
    return true;
}

static uint64_t next_prime(uint64_t n) {
    uint64_t p = n + 1;
    if (p <= 2) return 2;
    if (p % 2 == 0) p += 1;
    while (!is_prime(p)) p += 2;
    return p;
}

static uint64_t pow_mod(uint64_t base, uint64_t exponent, uint64_t modulus) {
    unsigned __int128 result = 1, b = base % modulus;
    while (exponent > 0) {
        if (exponent & 1) result = (result * b) % modulus;
        b = (b * b) % modulus;
        exponent >>= 1;
    }
    return (uint64_t)result;
}

static bool is_primitive_root(uint64_t a, uint64_t n) {
    uint64_t phi = n - 1, m = phi;
    for (uint64_t i = 2; i * i <= m; i += (i == 2 ? 1 : 2)) {
        if (m % i == 0) {
            if (pow_mod(a, phi / i, n) == 1) return false;
            while (m % i == 0) m /= i;
        }
    }
    if (m > 1 && pow_mod(a, phi / m, n) == 1) return false;
    return true;
}

struct PrRange {
    int64_t start;
    uint64_t l, m, a, x, seed;
    uint64_t count = 0;
    bool valid = false;

    static PrRange try_new(int64_t start, int64_t end, uint32_t seed_in) {
        PrRange pr;
        int64_t l = end - start;
        if (l <= 0) return pr;  // valid=false
        pr.start = start;
        pr.l = (uint64_t)l;
        pr.m = next_prime(pr.l);
        uint64_t a = 2;
        while (!is_primitive_root(a, pr.m)) a++;
        pr.a = a;
        uint64_t s = seed_in % pr.l;
        pr.seed = s == 0 ? 1 : s;
        pr.x = pr.seed;
        pr.valid = true;
        return pr;
    }

    // -> position, or -1 when exhausted
    int64_t next() {
        if (count == 0 && l == 1) {
            count++;
            return start;
        }
        for (;;) {
            uint64_t prev_x = x;
            x = (uint64_t)(((unsigned __int128)a * x) % m);
            if (count > 0 && prev_x == seed) return -1;
            if (prev_x <= l) {
                count++;
                return (int64_t)prev_x - 1 + start;
            }
        }
    }
};

// ---------------------------------------------------------------------------
// Edit operations (packed op words: kind<<17 | pos<<2 | base_code)
// ---------------------------------------------------------------------------

enum { OP_MATCH = 0, OP_MISMATCH = 1, OP_INSERTION = 2, OP_DELETION = 3 };

struct EditOp {
    uint8_t kind;
    int16_t pos;
    uint8_t base;  // ASCII; 0 for Match/Insertion
};

static const char CODE_TO_BASE[4] = {'A', 'C', 'G', 'T'};

// complement table matching rust-bio dna::complement (utils/seq.py)
static uint8_t COMP[256];
static bool comp_init = [] {
    for (int i = 0; i < 256; i++) COMP[i] = (uint8_t)i;
    const char* from = "ACGTURYSWKMBVDHN";
    const char* to = "TGCAAYRSWMKVBHDN";
    for (int i = 0; from[i]; i++) {
        COMP[(uint8_t)from[i]] = (uint8_t)to[i];
        COMP[(uint8_t)(from[i] + 32)] = (uint8_t)(to[i] + 32);
    }
    return true;
}();

// Decode a hit's op words into output-track order (ops/engine.py
// _decode_chain: bucket by pos ascending, reverse buckets right of split)
static void decode_track(const uint32_t* words, int64_t n_words, int32_t split,
                         std::vector<EditOp>& out) {
    out.clear();
    for (int64_t i = 0; i < n_words; i++) {
        uint32_t w = words[i];
        if (w == 0) break;
        uint8_t kind = (w >> 17) & 7;
        int16_t pos = (int16_t)((w >> 2) & 0x7FFF);
        uint8_t base = (kind == OP_MISMATCH || kind == OP_DELETION)
                           ? (uint8_t)CODE_TO_BASE[w & 3]
                           : 0;
        out.push_back({kind, pos, base});
    }
    std::stable_sort(out.begin(), out.end(),
                     [](const EditOp& a, const EditOp& b) { return a.pos < b.pos; });
    // reverse each equal-pos group right of the split point
    size_t i = 0;
    while (i < out.size()) {
        size_t j = i;
        while (j < out.size() && out[j].pos == out[i].pos) j++;
        if (out[i].pos >= split) std::reverse(out.begin() + i, out.begin() + j);
        i = j;
    }
}

static int effective_len(const std::vector<EditOp>& ops) {
    int n = 0;
    for (const auto& op : ops) n += (op.kind != OP_INSERTION);
    return n;
}

static int read_len_of(const std::vector<EditOp>& ops) {
    int n = 0;
    for (const auto& op : ops) n += (op.kind != OP_DELETION);
    return n;
}

// ---------------------------------------------------------------------------
// OriginalSymbols lookup (sorted positions)
// ---------------------------------------------------------------------------

struct OrigSymbols {
    const int64_t* pos;
    const uint8_t* sym;
    int64_t n;
    // -> original ASCII base or 0
    inline uint8_t get(int64_t p) const {
        if (n == 0 || p < pos[0] || p > pos[n - 1]) return 0;
        int64_t lo = 0, hi = n;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (pos[mid] < p) lo = mid + 1; else hi = mid;
        }
        return (lo < n && pos[lo] == p) ? sym[lo] : 0;
    }
};

// ---------------------------------------------------------------------------
// to_bam_fields (map/record.py:94-168, reference record.rs:282-438)
// ---------------------------------------------------------------------------

struct BamFields {
    std::vector<std::pair<int32_t, char>> cigar;  // (count, 'M'|'I'|'D')
    std::string md;
    int nm = 0;
};

static inline char kind_to_cigar(uint8_t kind) {
    switch (kind) {
        case OP_INSERTION: return 'I';
        case OP_DELETION: return 'D';
        default: return 'M';
    }
}

static void to_bam_fields(const std::vector<EditOp>& ops, bool forward,
                          int64_t absolute_pos, const OrigSymbols& orig,
                          BamFields& out) {
    out.cigar.clear();
    out.md.clear();
    out.nm = 0;
    int num_matches = 0;
    int32_t num_operations = 1;
    int last_kind = -1;  // kind of the current CIGAR run's first op
    char numbuf[16];

    auto md_flush_matches = [&]() {
        int len = snprintf(numbuf, sizeof numbuf, "%d", num_matches);
        out.md.append(numbuf, len);
    };

    const size_t n = ops.size();
    for (size_t idx = 0; idx < n; idx++) {
        EditOp op = forward ? ops[idx] : ops[n - 1 - idx];
        // original-symbol re-substitution, indexed by output-track offset
        uint8_t o = orig.n ? orig.get(absolute_pos + (int64_t)idx) : 0;
        if (o != 0) {
            if (op.kind == OP_MATCH) op = {OP_MISMATCH, op.pos, o};
            else if (op.kind == OP_DELETION) op = {OP_DELETION, op.pos, o};
            else if (op.kind == OP_MISMATCH) op = {OP_MISMATCH, op.pos, o};
        }
        if (op.kind != OP_MATCH) out.nm++;

        // MD
        if (op.kind == OP_MATCH) {
            num_matches++;
        } else if (op.kind == OP_MISMATCH) {
            uint8_t base = forward ? op.base : COMP[op.base];
            md_flush_matches();
            out.md.push_back((char)base);
            num_matches = 0;
        } else if (op.kind == OP_DELETION) {
            uint8_t base = forward ? op.base : COMP[op.base];
            if (last_kind == OP_DELETION) {
                out.md.push_back((char)base);
            } else {
                md_flush_matches();
                out.md.push_back('^');
                out.md.push_back((char)base);
            }
            num_matches = 0;
        }  // insertions ignored in MD

        // CIGAR run-length condensation
        if (last_kind >= 0) {
            if (kind_to_cigar(op.kind) == kind_to_cigar((uint8_t)last_kind)) {
                num_operations++;
            } else {
                out.cigar.push_back({num_operations, kind_to_cigar((uint8_t)last_kind)});
                num_operations = 1;
                last_kind = op.kind;
            }
        } else {
            last_kind = op.kind;
        }
    }
    if (last_kind >= 0)
        out.cigar.push_back({num_operations, kind_to_cigar((uint8_t)last_kind)});
    md_flush_matches();
}

// ---------------------------------------------------------------------------
// Contig map (index/runtime.py FastaIdPositions)
// ---------------------------------------------------------------------------

struct Contigs {
    const int64_t* starts;
    const int64_t* ends;  // inclusive
    const int32_t* name_off;
    const char* names;
    int32_t n;

    // -> tid or -1 (contig-boundary overlap)
    int32_t locate(int64_t position, int64_t pattern_length, int64_t* rel) const {
        int32_t lo = 0, hi = n;
        while (lo < hi) {
            int32_t mid = (lo + hi) / 2;
            if (ends[mid] < position) lo = mid + 1; else hi = mid;
        }
        if (lo >= n) return -1;
        if (starts[lo] <= position && position + pattern_length - 1 <= ends[lo]) {
            *rel = position - starts[lo];
            return lo;
        }
        return -1;
    }
};

// ---------------------------------------------------------------------------
// Hit model + coordinate enumeration (postprocess.py interval2coordinate)
// ---------------------------------------------------------------------------

struct Hit {
    int64_t lower, lower_rev, size;
    float score;
    std::vector<EditOp> track;
    int eff_len;
    int insertion_order;
};

struct Coord {
    int32_t tid;
    int64_t relative_pos;
    int64_t absolute_pos;
    bool forward;
    int64_t num_skipped;
    const Hit* hit;
};

// Lazy coordinate enumerator: draws its PrRange seed from the shared RNG on
// the first next() call, exactly like the Python generator's first advance.
struct CoordIter {
    const Hit* hit;
    const SaIndex* sa;
    const Contigs* contigs;
    SplitMix* rng;
    PrRange pr;
    bool started = false;
    int64_t i = 0;

    CoordIter(const Hit* h, const SaIndex* s, const Contigs* c, SplitMix* r)
        : hit(h), sa(s), contigs(c), rng(r) {}

    bool next(Coord* out) {
        if (!started) {
            started = true;
            uint32_t seed = rng->next_u32();
            pr = PrRange::try_new(hit->lower, hit->lower + hit->size, seed);
        }
        if (!pr.valid) return false;
        int64_t strand_len = sa->n / 2;
        for (;;) {
            int64_t sar_pos = pr.next();
            if (sar_pos < 0) return false;
            int64_t my_i = i++;
            int64_t absolute_pos = sa->get(sar_pos);
            if (absolute_pos < 0) continue;
            bool forward;
            if (absolute_pos < strand_len) {
                forward = true;
            } else {
                absolute_pos = sa->n - absolute_pos - hit->eff_len - 1;
                forward = false;
            }
            int64_t rel;
            int32_t tid = contigs->locate(absolute_pos, hit->eff_len, &rel);
            if (tid < 0) continue;
            *out = {tid, rel, absolute_pos, forward, my_i, hit};
            return true;
        }
    }
};

// ---------------------------------------------------------------------------
// MAPQ (postprocess.py estimate_mapping_quality, mapping.rs:655-718)
// ---------------------------------------------------------------------------

static const int MAX_MAPQ = 37;
static const int MIN_MAPQ_UNIQ = 20;

static inline bool cross_check(const Hit& a, const Hit& b) {
    return a.size == b.size && (a.lower == b.lower || a.lower_rev == b.lower_rev);
}

// remaining_frac_of_repr_mm dispatch (models/bounds.py)
// kind 0 = Discrete (a = allowed-mismatch count for this read length)
// kind 1 = Continuous (a = cutoff, b = len^exponent)
// kind 2 = TestBound (a = threshold)
static float remaining_frac(int bound_kind, float a, float b, float repr_mm,
                            float value) {
    switch (bound_kind) {
        case 0: return mul_add_f32(a, repr_mm, -value) / repr_mm;
        case 1: return (a - value / b) / (repr_mm / b);
        default: return (a - value) / repr_mm;
    }
}

static int estimate_mapq(const Hit& best, int64_t best_interval_size,
                         const std::vector<const Hit*>& others,
                         int bound_kind, float bound_a, float bound_b,
                         float repr_mm) {
    float prob_best = exp2_f32(best.score);
    float alignment_probability;
    if (best_interval_size > 1) {
        alignment_probability = 1.0f / (float)best_interval_size;
    } else {
        float weighted = 0.0f;
        for (const Hit* sub : others) {
            if (cross_check(best, *sub)) continue;
            weighted = mul_add_f32(exp2_f32(sub->score), (float)sub->size, weighted);
        }
        alignment_probability = prob_best / (prob_best + weighted);
    }
    if (alignment_probability < 0.0f) alignment_probability = 0.0f;
    if (alignment_probability > 1.0f) alignment_probability = 1.0f;

    // p == 1 -> -inf -> clamped to MAX_MAPQ; the subtraction rounds in f32
    // first, then log10 is computed in double and rounded once (matching
    // the Python postprocess)
    float one_minus = 1.0f - alignment_probability;
    float raw = -10.0f * (float)std::log10((double)one_minus);
    int mapq = round_u8(std::min(raw, (float)MAX_MAPQ));
    if (mapq == MAX_MAPQ) {
        float rem = remaining_frac(bound_kind, bound_a, bound_b, repr_mm, best.score);
        float scaled = mul_add_f32((float)(MAX_MAPQ - MIN_MAPQ_UNIQ),
                                   std::min(rem, 1.0f), (float)MIN_MAPQ_UNIQ);
        return round_u8(scaled);
    }
    return mapq;
}

// ---------------------------------------------------------------------------
// BAM record encode (io/bam.py encode_record)
// ---------------------------------------------------------------------------

static int32_t reg2bin(int64_t beg, int64_t end) {
    end -= 1;
    if (beg >> 14 == end >> 14) return (int32_t)(((1 << 15) - 1) / 7 + (beg >> 14));
    if (beg >> 17 == end >> 17) return (int32_t)(((1 << 12) - 1) / 7 + (beg >> 17));
    if (beg >> 20 == end >> 20) return (int32_t)(((1 << 9) - 1) / 7 + (beg >> 20));
    if (beg >> 23 == end >> 23) return (int32_t)(((1 << 6) - 1) / 7 + (beg >> 23));
    if (beg >> 26 == end >> 26) return (int32_t)(((1 << 3) - 1) / 7 + (beg >> 26));
    return 0;
}

static uint8_t SEQ_NIBBLE[256];
static bool nib_init = [] {
    for (int i = 0; i < 256; i++) SEQ_NIBBLE[i] = 15;
    const char* nib = "=ACMGRSVTWYHKDBN";
    for (int i = 0; nib[i]; i++) SEQ_NIBBLE[(uint8_t)nib[i]] = (uint8_t)i;
    return true;
}();

static int cigar_op_code(char op) {
    switch (op) {
        case 'M': return 0; case 'I': return 1; case 'D': return 2;
        case 'N': return 3; case 'S': return 4; case 'H': return 5;
        case 'P': return 6; case '=': return 7; default: return 8;
    }
}

struct Buf {
    std::vector<uint8_t>& v;
    void u8(uint8_t x) { v.push_back(x); }
    void u16(uint16_t x) { v.push_back(x & 0xFF); v.push_back(x >> 8); }
    void i32(int32_t x) {
        for (int i = 0; i < 4; i++) v.push_back((uint8_t)((uint32_t)x >> (8 * i)));
    }
    void u32(uint32_t x) {
        for (int i = 0; i < 4; i++) v.push_back((uint8_t)(x >> (8 * i)));
    }
    void f32(float x) {
        uint32_t u;
        memcpy(&u, &x, 4);
        u32(u);
    }
    void bytes(const uint8_t* p, size_t n) { v.insert(v.end(), p, p + n); }
    void str(const std::string& s) { bytes((const uint8_t*)s.data(), s.size()); }
};

// aux tag helpers
static void tag_f(Buf& b, const char* tag, float v) {
    b.u8(tag[0]); b.u8(tag[1]); b.u8('f'); b.f32(v);
}
static void tag_i(Buf& b, const char* tag, int32_t v) {
    b.u8(tag[0]); b.u8(tag[1]); b.u8('i'); b.i32(v);
}
static void tag_z(Buf& b, const char* tag, const std::string& v) {
    b.u8(tag[0]); b.u8(tag[1]); b.u8('Z'); b.str(v); b.u8(0);
}
static void tag_a(Buf& b, const char* tag, char v) {
    b.u8(tag[0]); b.u8(tag[1]); b.u8('A'); b.u8((uint8_t)v);
}

// BAM flag bits
static const uint16_t FLAG_PROPERLY_SEGMENTED = 0x2;
static const uint16_t FLAG_UNMAPPED = 0x4;
static const uint16_t FLAG_MATE_UNMAPPED = 0x8;
static const uint16_t FLAG_REVERSE = 0x10;
static const uint16_t FLAG_MATE_REVERSE = 0x20;
static const uint16_t FLAG_SECONDARY = 0x100;
static const uint16_t FLAG_SUPPLEMENTARY = 0x800;

struct RecordOut {
    // mapped fields; tid < 0 => unmapped
    int32_t tid = -1;
    int64_t pos = -1;
    int mapq = 0;
    bool forward = true;
    bool mapped = false;
    const BamFields* fields = nullptr;
    float as_score = 0.0f;
    std::string xa;
    int64_t x0 = 0, x1 = 0;
    float xs = 0.0f;
    char xt = 'N';
};

static void encode_record(Buf& b, const uint8_t* name, int32_t name_len,
                          uint16_t in_flags, const uint8_t* seq,
                          const uint8_t* quals, int32_t seq_len,
                          const uint8_t* aux_prefix, int32_t aux_prefix_len,
                          const RecordOut& r, float duration, bool emit_xd) {
    uint16_t flags = in_flags;
    flags &= ~(FLAG_MATE_UNMAPPED | FLAG_MATE_REVERSE | FLAG_PROPERLY_SEGMENTED |
               FLAG_SECONDARY | FLAG_SUPPLEMENTARY);
    int64_t pos = -1;
    if (r.mapped) {
        flags &= ~FLAG_UNMAPPED;
        pos = r.pos;
    } else {
        flags |= FLAG_UNMAPPED;
        flags &= ~(FLAG_REVERSE | FLAG_PROPERLY_SEGMENTED);
    }
    if (r.mapped && !r.forward) flags |= FLAG_REVERSE;
    else flags &= ~FLAG_REVERSE;

    size_t block_start = b.v.size();
    b.i32(0);  // block_size placeholder
    int32_t n_cigar = r.fields ? (int32_t)r.fields->cigar.size() : 0;
    int64_t ref_len = 0;
    if (r.fields)
        for (auto& c : r.fields->cigar)
            if (c.second == 'M' || c.second == 'D' || c.second == 'N')
                ref_len += c.first;
    int32_t bin = (pos >= 0) ? reg2bin(pos, pos + std::max<int64_t>(ref_len, 1)) : 4680;

    static const uint8_t STAR = '*';
    if (name_len == 0) { name = &STAR; name_len = 1; }
    b.i32(r.mapped ? r.tid : -1);
    b.i32((int32_t)pos);
    b.u8((uint8_t)(name_len + 1));
    b.u8((uint8_t)r.mapq);
    b.u16((uint16_t)bin);
    b.u16((uint16_t)n_cigar);
    b.u16(flags);
    b.i32(seq_len);
    b.i32(-1);  // next_refID
    b.i32(-1);  // next_pos
    b.i32(0);   // tlen
    b.bytes(name, name_len);
    b.u8(0);
    if (r.fields)
        for (auto& c : r.fields->cigar)
            b.u32(((uint32_t)c.first << 4) | cigar_op_code(c.second));
    // seq nibbles (reverse-complemented on reverse strand)
    uint8_t cur = 0;
    for (int32_t i = 0; i < seq_len; i++) {
        uint8_t base = (r.mapped && !r.forward) ? COMP[seq[seq_len - 1 - i]] : seq[i];
        uint8_t nib = SEQ_NIBBLE[base];
        if (i % 2 == 0) cur = (uint8_t)(nib << 4);
        else { cur |= nib; b.u8(cur); }
    }
    if (seq_len % 2) b.u8(cur);
    // quals (reversed on reverse strand)
    for (int32_t i = 0; i < seq_len; i++)
        b.u8((r.mapped && !r.forward) ? quals[seq_len - 1 - i] : quals[i]);
    // aux: passthrough prefix (incl. RG), then generated tags
    b.bytes(aux_prefix, aux_prefix_len);
    if (r.mapped) {
        char fbuf[32];
        tag_f(b, "AS", r.as_score);
        tag_i(b, "NM", r.fields->nm);
        tag_z(b, "MD", r.fields->md);
        if (!r.xa.empty()) tag_z(b, "XA", r.xa);
        tag_i(b, "X0", (int32_t)std::min<int64_t>(r.x0, INT32_MAX));
        tag_i(b, "X1", (int32_t)std::min<int64_t>(r.x1, INT32_MAX));
        if (r.x1 > 0) tag_f(b, "XS", r.xs);
        tag_a(b, "XT", r.xt);
        (void)fbuf;
    }
    if (emit_xd) tag_f(b, "XD", duration);
    // patch block_size
    int32_t block_size = (int32_t)(b.v.size() - block_start - 4);
    for (int i = 0; i < 4; i++)
        b.v[block_start + i] = (uint8_t)((uint32_t)block_size >> (8 * i));
}

// ---------------------------------------------------------------------------
// Per-read conversion (postprocess.py intervals_to_bam)
// ---------------------------------------------------------------------------

struct Shared {
    SaIndex sa;
    Contigs contigs;
    OrigSymbols orig;
    int bound_kind;
    float repr_mm;
    const float* bound_a;
    const float* bound_b;
    // reads
    const int32_t* name_off;
    const uint8_t* names;
    const int32_t* seq_off;
    const uint8_t* seqs;
    const uint8_t* quals;
    const uint16_t* flags;
    const uint64_t* rng_seeds;
    const float* durations;
    int emit_xd;
    const int32_t* aux_off;
    const uint8_t* aux;
    const int32_t* splits;
    // hits
    const int32_t* hit_off;
    const int64_t* hit_ivals;
    const float* hit_scores;
    const int64_t* ops_off;
    const uint32_t* ops_words;
};

static void format_xa_entry(std::string& xa, const Shared& sh, const Coord& co,
                            const BamFields& f) {
    const char* nm = sh.contigs.names + sh.contigs.name_off[co.tid];
    int32_t nm_len = sh.contigs.name_off[co.tid + 1] - sh.contigs.name_off[co.tid];
    xa.append(nm, nm_len);
    char buf[64];
    xa.push_back(',');
    xa.push_back(co.forward ? '+' : '-');
    snprintf(buf, sizeof buf, "%lld,", (long long)(co.relative_pos + 1));
    xa.append(buf);
    for (auto& c : f.cigar) {
        snprintf(buf, sizeof buf, "%d%c", c.first, c.second);
        xa.append(buf);
    }
    xa.push_back(',');
    xa.append(f.md);
    snprintf(buf, sizeof buf, ",%d,%lld,%.2f;", f.nm, (long long)co.hit->size,
             (double)co.hit->score);
    xa.append(buf);
}

static void process_read(const Shared& sh, int32_t r, std::vector<uint8_t>& out) {
    Buf b{out};
    const uint8_t* name = sh.names + sh.name_off[r];
    int32_t name_len = sh.name_off[r + 1] - sh.name_off[r];
    const uint8_t* seq = sh.seqs + sh.seq_off[r];
    const uint8_t* quals = sh.quals + sh.seq_off[r];
    int32_t seq_len = sh.seq_off[r + 1] - sh.seq_off[r];
    const uint8_t* aux_prefix = sh.aux + sh.aux_off[r];
    int32_t aux_prefix_len = sh.aux_off[r + 1] - sh.aux_off[r];
    float duration = sh.durations ? sh.durations[r] : 0.0f;
    int32_t split = sh.splits[r];

    // decode hits
    int32_t h0 = sh.hit_off[r], h1 = sh.hit_off[r + 1];
    int n_hits = h1 - h0;
    std::vector<Hit> hits((size_t)n_hits);
    for (int i = 0; i < n_hits; i++) {
        Hit& h = hits[i];
        h.lower = sh.hit_ivals[(h0 + i) * 3];
        h.lower_rev = sh.hit_ivals[(h0 + i) * 3 + 1];
        h.size = sh.hit_ivals[(h0 + i) * 3 + 2];
        h.score = sh.hit_scores[h0 + i];
        h.insertion_order = i;
        decode_track(sh.ops_words + sh.ops_off[h0 + i],
                     sh.ops_off[h0 + i + 1] - sh.ops_off[h0 + i], split, h.track);
        h.eff_len = effective_len(h.track);
    }
    // sorted ascending by (score, -insertion_order); we pop from the end
    std::vector<Hit*> sorted(hits.size());
    for (size_t i = 0; i < hits.size(); i++) sorted[i] = &hits[i];
    std::sort(sorted.begin(), sorted.end(), [](const Hit* a, const Hit* b) {
        if (a->score != b->score) return a->score < b->score;
        return a->insertion_order > b->insertion_order;
    });

    SplitMix rng{sh.rng_seeds[r]};
    RecordOut rec;
    BamFields best_fields;

    while (!sorted.empty()) {
        Hit* best = sorted.back();
        sorted.pop_back();
        CoordIter best_iter(best, &sh.sa, &sh.contigs, &rng);
        Coord best_co;
        if (!best_iter.next(&best_co)) continue;  // all positions hit boundaries

        int64_t updated_size = best->size - best_co.num_skipped;

        // XA: best's remaining positions, then suboptimal hits descending
        std::string xa;
        int xa_count = 0;
        BamFields xa_fields;
        Coord co;
        while (xa_count < 2 && best_iter.next(&co)) {
            to_bam_fields(co.hit->track, co.forward, co.absolute_pos, sh.orig,
                          xa_fields);
            format_xa_entry(xa, sh, co, xa_fields);
            xa_count++;
        }
        for (auto it = sorted.rbegin(); xa_count < 2 && it != sorted.rend(); ++it) {
            Hit* sub = *it;
            if (cross_check(*best, *sub)) continue;
            CoordIter sub_iter(sub, &sh.sa, &sh.contigs, &rng);
            while (xa_count < 2 && sub_iter.next(&co)) {
                to_bam_fields(co.hit->track, co.forward, co.absolute_pos, sh.orig,
                              xa_fields);
                format_xa_entry(xa, sh, co, xa_fields);
                xa_count++;
            }
        }

        int64_t x1 = 0;
        for (Hit* sub : sorted)
            if (!cross_check(*best, *sub)) x1 += sub->size;

        std::vector<const Hit*> others(sorted.begin(), sorted.end());
        int mapq = estimate_mapq(*best, updated_size, others, sh.bound_kind,
                                 sh.bound_a[r], sh.bound_b ? sh.bound_b[r] : 1.0f,
                                 sh.repr_mm);

        to_bam_fields(best->track, best_co.forward, best_co.absolute_pos, sh.orig,
                      best_fields);
        rec.mapped = true;
        rec.tid = best_co.tid;
        rec.pos = best_co.relative_pos;
        rec.forward = best_co.forward;
        rec.mapq = mapq;
        rec.fields = &best_fields;
        rec.as_score = best->score;
        rec.xa = std::move(xa);
        rec.x0 = std::min<int64_t>(updated_size, INT32_MAX);
        rec.x1 = std::min<int64_t>(x1, INT32_MAX);
        rec.xs = sorted.empty() ? 0.0f : sorted.back()->score;
        rec.xt = updated_size == 0 ? 'N' : (updated_size == 1 ? 'U' : 'R');
        break;
    }

    encode_record(b, name, name_len, sh.flags[r], seq, quals, seq_len, aux_prefix,
                  aux_prefix_len, rec, duration, sh.emit_xd != 0);
}

}  // namespace

extern "C" {

// Returns 0; fills *out_buf/*out_len with a malloc'd concatenation of
// encoded BAM records (read order).  Caller frees with postprocess_free.
int postprocess_batch(
    const uint8_t* bwt, int64_t bwt_len, const int64_t* less,
    const int64_t* occ_cp, int64_t occ_k, int64_t sampling_rate,
    const int64_t* sa_sample, const int64_t* sa_extra_keys,
    const int64_t* sa_extra_vals, int64_t n_sa_extra,
    const int64_t* contig_starts, const int64_t* contig_ends,
    const int32_t* contig_name_off, const char* contig_names, int32_t n_contigs,
    const int64_t* orig_pos, const uint8_t* orig_sym, int64_t n_orig,
    int32_t bound_kind, float repr_mm, const float* bound_a, const float* bound_b,
    int32_t n_reads, const int32_t* name_off, const uint8_t* names,
    const int32_t* seq_off, const uint8_t* seqs, const uint8_t* quals,
    const uint16_t* flags, const uint64_t* rng_seeds, const float* durations,
    int32_t emit_xd, const int32_t* aux_off, const uint8_t* aux,
    const int32_t* splits, const int32_t* hit_off, const int64_t* hit_ivals,
    const float* hit_scores, const int64_t* ops_off, const uint32_t* ops_words,
    int32_t n_threads, uint8_t** out_buf, int64_t* out_len) {
    Shared sh{
        {bwt, bwt_len, less, occ_cp, occ_k, sampling_rate, sa_sample,
         sa_extra_keys, sa_extra_vals, n_sa_extra},
        {contig_starts, contig_ends, contig_name_off, contig_names, n_contigs},
        {orig_pos, orig_sym, n_orig},
        bound_kind, repr_mm, bound_a, bound_b,
        name_off, names, seq_off, seqs, quals, flags, rng_seeds, durations,
        emit_xd, aux_off, aux, splits,
        hit_off, hit_ivals, hit_scores, ops_off, ops_words};

    int T = std::max(1, (int)n_threads);
    std::vector<std::vector<uint8_t>> parts((size_t)T);
    std::vector<std::thread> threads;
    int32_t per = (n_reads + T - 1) / T;
    for (int t = 0; t < T; t++) {
        int32_t lo = t * per, hi = std::min(n_reads, (t + 1) * per);
        if (lo >= hi) break;
        threads.emplace_back([&sh, &parts, t, lo, hi]() {
            auto& out = parts[(size_t)t];
            out.reserve((size_t)(hi - lo) * 256);
            for (int32_t r = lo; r < hi; r++) process_read(sh, r, out);
        });
    }
    for (auto& th : threads) th.join();

    int64_t total = 0;
    for (auto& p : parts) total += (int64_t)p.size();
    uint8_t* buf = (uint8_t*)malloc((size_t)total);
    int64_t off = 0;
    for (auto& p : parts) {
        memcpy(buf + off, p.data(), p.size());
        off += (int64_t)p.size();
    }
    *out_buf = buf;
    *out_len = total;
    return 0;
}

void postprocess_free(uint8_t* buf) { free(buf); }

}  // extern "C"
