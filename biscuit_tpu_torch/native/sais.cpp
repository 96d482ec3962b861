// SA-IS suffix array construction (Nong-Zhang-Chan induced sorting),
// written from scratch for biscuit_tpu's index construction. This replaces the
// reference's is.c/bwt_gen.c construction path (see SURVEY.md §2a): we build a
// plain suffix array of the doubled converted genome and derive the BWT +
// sampled SA from it in the Python layer.
//
// Templated on the index type so the same code serves genomes below (int32)
// and above (int64) 2^31 characters.
//
// Build: g++ -O2 -shared -fPIC sais.cpp -o libbiscuit_native.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename I, typename Char>
void get_counts(const Char *T, I *C, I n, I K) {
    for (I i = 0; i < K; ++i) C[i] = 0;
    for (I i = 0; i < n; ++i) ++C[T[i]];
}

template <typename I>
void get_buckets(const I *C, I *B, I K, bool end) {
    I sum = 0;
    for (I i = 0; i < K; ++i) {
        sum += C[i];
        B[i] = end ? sum : sum - C[i];
    }
}

// Induce L-type then S-type suffixes from sorted LMS positions already
// placed in SA (others must be -1).
template <typename I, typename Char>
void induce(const Char *T, I *SA, std::vector<I> &C, std::vector<I> &B, I n, I K,
            const std::vector<uint8_t> &stype) {
    // L-type: left-to-right
    get_counts(T, C.data(), n, K);
    get_buckets(C.data(), B.data(), K, false);
    // suffix n-1's predecessor of virtual sentinel
    I j = n - 1;
    if (j >= 0 && !stype[j]) SA[B[T[j]]++] = j;
    for (I i = 0; i < n; ++i) {
        j = SA[i] - 1;
        if (SA[i] > 0 && !stype[j]) SA[B[T[j]]++] = j;
    }
    // S-type: right-to-left
    get_counts(T, C.data(), n, K);
    get_buckets(C.data(), B.data(), K, true);
    for (I i = n - 1; i >= 0; --i) {
        j = SA[i] - 1;
        if (SA[i] > 0 && stype[j]) SA[--B[T[j]]] = j;
    }
}

template <typename I, typename Char>
void sais_core(const Char *T, I *SA, I n, I K) {
    if (n == 0) return;
    if (n == 1) { SA[0] = 0; return; }

    // classify: stype[i] = 1 if suffix i is S-type; virtual sentinel is S
    std::vector<uint8_t> stype(n);
    stype[n - 1] = 0; // last char > sentinel, so L-type
    for (I i = n - 2; i >= 0; --i)
        stype[i] = (T[i] < T[i + 1] || (T[i] == T[i + 1] && stype[i + 1])) ? 1 : 0;

    auto is_lms = [&](I i) { return i > 0 && stype[i] && !stype[i - 1]; };

    std::vector<I> C(K), B(K);

    // step 1: place LMS suffixes at the ends of their buckets, induce
    for (I i = 0; i < n; ++i) SA[i] = -1;
    get_counts(T, C.data(), n, K);
    get_buckets(C.data(), B.data(), K, true);
    for (I i = n - 1; i >= 0; --i)
        if (is_lms(i)) SA[--B[T[i]]] = i;
    induce(T, SA, C, B, n, K, stype);

    // compact sorted LMS substrings into SA[0..n1)
    I n1 = 0;
    for (I i = 0; i < n; ++i)
        if (is_lms(SA[i])) SA[n1++] = SA[i];

    // name LMS substrings
    for (I i = n1; i < n; ++i) SA[i] = -1;
    I name = 0, prev = -1;
    for (I i = 0; i < n1; ++i) {
        I pos = SA[i];
        bool diff = false;
        if (prev < 0) diff = true;
        else {
            for (I d = 0;; ++d) {
                if (pos + d >= n || prev + d >= n) { diff = (pos + d >= n) != (prev + d >= n); break; }
                if (T[pos + d] != T[prev + d] || stype[pos + d] != stype[prev + d]) { diff = true; break; }
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) { diff = !(is_lms(pos + d) && is_lms(prev + d)); break; }
            }
        }
        if (diff) { ++name; prev = pos; }
        SA[n1 + pos / 2] = name - 1;
    }
    // compact names to the tail of SA
    for (I i = n - 1, j = n - 1; i >= n1; --i)
        if (SA[i] >= 0) SA[j--] = SA[i];

    // step 2: recurse if names are not unique
    I *SA1 = SA, *T1 = SA + n - n1;
    if (name < n1) {
        sais_core<I, I>(T1, SA1, n1, name);
    } else {
        for (I i = 0; i < n1; ++i) SA1[T1[i]] = i;
    }

    // step 3: induce the full SA from sorted LMS suffixes
    // collect LMS positions in text order into T1
    I j2 = 0;
    for (I i = 1; i < n; ++i)
        if (is_lms(i)) T1[j2++] = i;
    for (I i = 0; i < n1; ++i) SA1[i] = T1[SA1[i]];
    for (I i = n1; i < n; ++i) SA[i] = -1;
    get_counts(T, C.data(), n, K);
    get_buckets(C.data(), B.data(), K, true);
    for (I i = n1 - 1; i >= 0; --i) {
        I pos = SA[i];
        SA[i] = -1;
        SA[--B[T[pos]]] = pos;
    }
    induce(T, SA, C, B, n, K, stype);
}

} // namespace

extern "C" {

// Suffix array of T[0..n) over alphabet [0,K). SA must have room for n
// entries. Returns 0 on success.
int sais_u8_i32(const uint8_t *T, int32_t *SA, int32_t n, int32_t K) {
    if (n < 0 || K <= 0) return -1;
    sais_core<int32_t, uint8_t>(T, SA, n, K);
    return 0;
}

int sais_u8_i64(const uint8_t *T, int64_t *SA, int64_t n, int64_t K) {
    if (n < 0 || K <= 0) return -1;
    sais_core<int64_t, uint8_t>(T, SA, n, K);
    return 0;
}

// Derive the BWA-style BWT from a suffix array over T (no explicit sentinel;
// the virtual sentinel $ is smallest and its rotation is EXCLUDED from SA, so
// rank r in [0,n) covers suffixes of T; the full BWT over T$ has the $ at the
// rank where SA[r]==0 — that rank+? — handled by the caller convention below).
//
// Writes bwt[0..n) = BWT string with the '$' row removed and returns primary
// = the rank (in the n+1-row matrix) of the row that starts with position 0,
// matching the reference bwt_t convention (lib/aln/is.c,
// bwtindex.c:92-103).
int64_t bwt_from_sa_i64(const uint8_t *T, const int64_t *SA, uint8_t *bwt, int64_t n) {
    // the n+1-row conceptual matrix: row 0 is "$T[0..]"-rotation's suffix "$",
    // whose BWT char is T[n-1]; rows 1..n correspond to SA[0..n) with BWT char
    // T[SA[r]-1] and the row with SA[r]==0 holding '$' (removed).
    int64_t primary = -1;
    int64_t w = 0;
    bwt[w++] = T[n - 1]; // row 0 (suffix "$")
    for (int64_t r = 0; r < n; ++r) {
        if (SA[r] == 0) {
            primary = r + 1; // this row holds the removed '$'
        } else {
            bwt[w++] = T[SA[r] - 1];
        }
    }
    return primary;
}

// int32 SA variant (strands < 2^31 chars): avoids widening the SA to int64
// just to derive the BWT, halving peak memory for 250 Mbp - 1 Gbp genomes.
int64_t bwt_from_sa_i32(const uint8_t *T, const int32_t *SA, uint8_t *bwt, int64_t n) {
    int64_t primary = -1;
    int64_t w = 0;
    bwt[w++] = T[n - 1];
    for (int64_t r = 0; r < n; ++r) {
        if (SA[r] == 0) {
            primary = r + 1;
        } else {
            bwt[w++] = T[SA[r] - 1];
        }
    }
    return primary;
}

} // extern "C"
