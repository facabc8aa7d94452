// SA-IS suffix array construction (Nong, Zhang & Chan, 2009),
// implemented from the published algorithm for the index builder
// (replaces rust-bio's suffix_array(), reference src/index/indexing.rs:163).
//
// Memory-lean layout for genome-scale texts (hg19 doubled: ~6.2e9 symbols):
// the level-0 text stays uint8, and all per-level scratch (LMS names, the
// reduced string, its suffix array) lives inside the caller-provided SA
// buffer, as in the classic in-place SA-IS formulations.  Peak RSS for
// n = 6.2e9 is ~(n + 8n) bytes + a bit vector: ~57 GB, vs ~200 GB for the
// naive all-int64 version this replaces.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libsais.so sais.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using idx_t = int64_t;

template <class CharT>
static void bucket_offsets(const CharT* text, idx_t n, idx_t K,
                           std::vector<idx_t>& bkt, bool end) {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (idx_t i = 0; i < n; i++) bkt[text[i]]++;
    idx_t sum = 0;
    for (idx_t c = 0; c < K; c++) {
        sum += bkt[c];
        bkt[c] = end ? sum : sum - bkt[c];
    }
}

template <class CharT>
static void induce_l(const CharT* text, idx_t* sa, idx_t n, idx_t K,
                     const std::vector<bool>& is_s, std::vector<idx_t>& bkt) {
    bucket_offsets(text, n, K, bkt, false);
    for (idx_t i = 0; i < n; i++) {
        idx_t j = sa[i] - 1;
        if (sa[i] > 0 && !is_s[j]) sa[bkt[text[j]]++] = j;
    }
}

template <class CharT>
static void induce_s(const CharT* text, idx_t* sa, idx_t n, idx_t K,
                     const std::vector<bool>& is_s, std::vector<idx_t>& bkt) {
    bucket_offsets(text, n, K, bkt, true);
    for (idx_t i = n - 1; i >= 0; i--) {
        idx_t j = sa[i] - 1;
        if (sa[i] > 0 && is_s[j]) sa[--bkt[text[j]]] = j;
    }
}

// Core SA-IS over an integer text with alphabet [0, K).  The caller
// guarantees text[n-1] is the unique smallest symbol (explicit sentinel),
// which every recursion level preserves.
template <class CharT>
static void sais_t(const CharT* text, idx_t* sa, idx_t n, idx_t K) {
    if (n == 0) return;
    if (n == 1) {
        sa[0] = 0;
        return;
    }

    // 1) classify suffix types
    std::vector<bool> is_s(n);
    is_s[n - 1] = true;
    for (idx_t i = n - 2; i >= 0; i--)
        is_s[i] =
            text[i] < text[i + 1] || (text[i] == text[i + 1] && is_s[i + 1]);

    auto is_lms = [&](idx_t i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

    std::vector<idx_t> bkt(K);

    // 2) put LMS suffixes at bucket ends, then induce to sort LMS substrings
    std::fill(sa, sa + n, idx_t(-1));
    bucket_offsets(text, n, K, bkt, true);
    for (idx_t i = n - 1; i >= 1; i--)
        if (is_lms(i)) sa[--bkt[text[i]]] = i;
    induce_l(text, sa, n, K, is_s, bkt);
    induce_s(text, sa, n, K, is_s, bkt);

    // 3) compact sorted LMS positions into sa[0:n1]; name LMS substrings
    //    into sa[n1:] at index pos/2 (n1 + (n-1)/2 + 1 <= n always: LMS
    //    positions are non-adjacent and position 0 is never LMS)
    idx_t n1 = 0;
    for (idx_t i = 0; i < n; i++)
        if (is_lms(sa[i])) sa[n1++] = sa[i];
    idx_t* names = sa + n1;
    std::fill(names, sa + n, idx_t(-1));
    idx_t name = 0;
    idx_t prev = -1;
    for (idx_t i = 0; i < n1; i++) {
        idx_t pos = sa[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (idx_t d = 0;; d++) {
                if (text[pos + d] != text[prev + d] ||
                    is_s[pos + d] != is_s[prev + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
                    diff = !(is_lms(pos + d) && is_lms(prev + d));
                    break;
                }
            }
        }
        if (diff) {
            name++;
            prev = pos;
        }
        names[pos / 2] = name - 1;
    }
    // compact names (text order) right-to-left into s1 = sa[n - n1 : n].
    // Right-to-left is collision-free: when the read pointer is at index r,
    // the entries already moved all sat at indexes > r, so the write
    // pointer n-1-k >= r.
    {
        idx_t w = n - 1;
        for (idx_t r = n - 1; r >= n1; r--) {
            if (sa[r] >= 0) sa[w--] = sa[r];
        }
    }
    idx_t* s1 = sa + n - n1;

    // 4) sort the reduced problem (recurse if names are not unique);
    //    sa1 = sa[0:n1]
    if (name < n1) {
        sais_t<idx_t>(s1, sa, n1, name);
    } else {
        for (idx_t i = 0; i < n1; i++) sa[s1[i]] = i;
    }

    // 5) map reduced SA back to LMS positions: enumerate LMS positions in
    //    text order into s1's region (no longer needed), then gather
    {
        idx_t cnt = 0;
        for (idx_t i = 1; i < n; i++)
            if (is_lms(i)) s1[cnt++] = i;
        for (idx_t i = 0; i < n1; i++) sa[i] = s1[sa[i]];
    }

    // 6) induce the final SA from sorted LMS suffixes.  Redistribute the
    //    compacted sorted-LMS prefix to bucket ends right-to-left (the
    //    target index never precedes the read index, so no clobbering),
    //    clearing as we go.
    std::fill(sa + n1, sa + n, idx_t(-1));
    bucket_offsets(text, n, K, bkt, true);
    for (idx_t i = n1 - 1; i >= 0; i--) {
        idx_t pos = sa[i];
        sa[i] = -1;
        sa[--bkt[text[pos]]] = pos;
    }
    induce_l(text, sa, n, K, is_s, bkt);
    induce_s(text, sa, n, K, is_s, bkt);
}

}  // namespace

extern "C" {

// Build the suffix array of `text` (uint8 ranks, alphabet [0, K)).
// The text must not be empty.  Returns 0 on success.
//
// `sa_out` must have space for n + 1 entries: a unique smallest sentinel is
// appended internally (classic trick so shorter prefixes sort smaller) and
// its suffix lands in sa_out[0]; the caller reads sa_out[1 : n + 1].
int sais_u8(const uint8_t* text, int64_t* sa_out, int64_t n, int64_t K) {
    if (n <= 0 || K > 254) return -1;
    std::vector<uint8_t> t(n + 1);
    for (idx_t i = 0; i < n; i++) t[i] = uint8_t(text[i] + 1);
    t[n] = 0;
    sais_t<uint8_t>(t.data(), sa_out, n + 1, K + 1);
    return 0;
}
}
