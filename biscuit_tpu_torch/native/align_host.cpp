// Native host glue for the aligner hot path: FM-index search, SMEM seeding,
// chaining, and banded extension for one batch of reads, multithreaded.
//
// This is a from-scratch C++ transliteration of biscuit_tpu's own Python
// modules (ops/fm.py scalar path, align/smem.py, align/chain.py,
// align/region.py, ops/sw.py sw_extend) — NOT of the reference C sources.
// The Python modules remain the ground truth; tests/test_native_engine.py
// checks region-level equality, and the E2E SAM must stay byte-identical.
//
// Returns the per-read alignment regions exactly as worker1 produces them
// BEFORE mem_merge_regions; Python handles merging, pairing and SAM.
//
// Build: part of libbiscuit_native.so (see native/__init__.py).

#include <algorithm>
#include <atomic>
#if defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
#endif
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <coroutine>
#include <mutex>
#include <sys/mman.h>
#include <thread>
#include <unordered_map>
#include <vector>

namespace bt {

// ---------------------------------------------------------------- FM index

struct StrandFM {
    const uint32_t *words;   // packed 2-bit BWT, base i at shift (15-(i&15))*2
    const int64_t *occ;      // [n_blocks+1][4] cumulative counts per 128 bases
    const int64_t *L2;       // [5]
    const void *sa;          // sampled SA every 32 ranks; uint32 (sa[0] wraps
                             // as -1) or int64 when sa_wide (big genomes)
    int64_t primary;
    int64_t seq_len;
    int64_t n_words;
    int32_t sa_wide = 0;
    // log2 of the SA sampling interval (reference format: 5 i.e. every 32;
    // our own .btidx indexes default denser — see index/fmindex.py)
    int32_t sa_shift = 5;
    // Optional interleaved occ+BWT blocks (bt_build_ilv): one 64-byte block
    // per 128 bases — [0..3] = checkpoint counts, [4..7] = the 8 BWT words
    // as 4 uint64 superwords — so occ4 touches a single cache line.
    const uint64_t *ilv = nullptr;
    // Denser variant for strands < 2^32 (bt_build_ilv2): 32-byte blocks per
    // 64 bases — uint32 counts[4] + 2 uint64 superwords; at most 2 popcount
    // rounds per query. Preferred over ilv when present.
    const uint8_t *ilv2 = nullptr;
};

static inline int popcount32(uint32_t x) { return __builtin_popcount(x); }

// --- transparent-hugepage allocation for the hot random-access arrays.
// At DRAM scale the 4 KB-page TLB misses roughly double the rank walk
// (tools/bench_mlp.cpp: 131 -> 67 ns/step serial at a 128 MB table); 2 MB
// pages recover it. Policy: BISCUIT_TPU_HUGEPAGES unset = auto (arrays
// >= 64 MB), "0" = off, anything else = force. bt_buf_free handles both
// malloc'd and mmap'd buffers via a registry.
static std::mutex g_huge_mu;
static std::unordered_map<void *, size_t> g_huge_allocs;

static int huge_mode() {
    const char *e = getenv("BISCUIT_TPU_HUGEPAGES");
    if (!e) return 1;
    return e[0] == '0' ? 0 : 2;
}

static void *huge_alloc(size_t sz) {
    int m = huge_mode();
    if (m == 0 || (m == 1 && sz < ((size_t)64 << 20))) return std::malloc(sz);
    size_t asz = (sz + ((size_t)2 << 20) - 1) & ~(((size_t)2 << 20) - 1);
    void *p = mmap(0, asz, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return std::malloc(sz);
#ifdef MADV_HUGEPAGE
    madvise(p, asz, MADV_HUGEPAGE);
#endif
    std::lock_guard<std::mutex> lk(g_huge_mu);
    g_huge_allocs[p] = asz;
    return p;
}

// --- stage profiling (BT_PROF=1): cumulative ns per stage over all threads
static std::atomic<long long> g_prof_ns[16];
static bool g_prof_on = false;
static const char *g_prof_names[16] = {
    "seed(collect_intv)", "chain(+sa)", "chain_flt", "extend(chain2region)",
    "merge_regions", "worker2(sam)", "sa_walk", "seed_fwd",
    "ls_fwdA", "ls_backB", "ls_p2C", "ls_strat1D",
    "backB_setup", "backB_occ", "backB_post", ""};
static bool g_prof_fine = false;  // BT_PROF=2: per-iteration sub-slots.
// Event counters + fine timing accumulators are THREAD-LOCAL, merged under
// a mutex at report time: they fire tens of millions of times per batch,
// and shared atomics turn the profile itself into a 3-4x cache-line
// ping-pong slowdown that inflates every seeding slot (that bug shaped two
// sessions of optimization priorities).
static const char *g_cnt_names[8] = {
    "fwd_ext", "back_ext", "back_steps", "smem1a", "strat1_ext",
    "back_vec", "", ""};
struct ProfCnt { long long c[8] = {}; long long fine_ns[4] = {}; };
static std::mutex g_cnt_mu;
static std::vector<ProfCnt *> g_cnt_all;
static long long g_cnt_dead[8];      // merged from exited threads
static long long g_fine_dead[4];
// Registration object lives in thread storage so exiting worker threads
// (spawned fresh per batch) fold their counters into g_*_dead and drop out
// of the registry — no unbounded growth across batches in long processes.
struct ProfTLReg {
    ProfCnt c;
    ProfTLReg() {
        std::lock_guard<std::mutex> lk(g_cnt_mu);
        g_cnt_all.push_back(&c);
    }
    ~ProfTLReg() {
        std::lock_guard<std::mutex> lk(g_cnt_mu);
        for (int i = 0; i < 8; ++i) g_cnt_dead[i] += c.c[i];
        for (int i = 0; i < 4; ++i) g_fine_dead[i] += c.fine_ns[i];
        g_cnt_all.erase(std::find(g_cnt_all.begin(), g_cnt_all.end(), &c));
    }
};
static ProfCnt *prof_tl() {
    static thread_local ProfTLReg r;
    return &r.c;
}
static inline void prof_count(int slot, long long n = 1) {
    if (g_prof_on) prof_tl()->c[slot] += n;
}
// The fine slots (12-14) use rdtsc (~20 cycles) instead of clock_gettime
// (a real syscall on this VM); raw TSC cycles are accumulated and scaled
// to ns at report time with a startup-calibrated TSC frequency. Fine
// slots print with a '~' prefix: they still measure a different clock
// domain than the coarse steady_clock slots.
static double tsc_ghz() {
    static const double g = [] {
        auto t0 = std::chrono::steady_clock::now();
        unsigned long long c0 = __builtin_ia32_rdtsc();
        while (std::chrono::steady_clock::now() - t0 <
               std::chrono::milliseconds(5)) {}
        unsigned long long c1 = __builtin_ia32_rdtsc();
        double ns = (double)std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - t0).count();
        return (double)(c1 - c0) / ns;
    }();
    return g;
}
struct ProfScope {
    int slot;
    std::chrono::steady_clock::time_point t0;
    unsigned long long c0;
    explicit ProfScope(int s) : slot(s) {
        if (!g_prof_on) { slot = -1; return; }
        if (slot >= 12) {
            if (!g_prof_fine) { slot = -1; return; }
            c0 = __builtin_ia32_rdtsc();
        } else t0 = std::chrono::steady_clock::now();
    }
    ~ProfScope() {
        if (slot < 0) return;
        if (slot >= 12)
            prof_tl()->fine_ns[slot - 12] +=   // raw TSC cycles; ns at report
                (long long)(__builtin_ia32_rdtsc() - c0);
        else
            g_prof_ns[slot] += std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now() - t0).count();
    }
};
static void prof_report(const char *tag) {
    if (!g_prof_on) return;
    const double ghz = tsc_ghz();
    long long cnt[8] = {};
    {
        std::lock_guard<std::mutex> lk(g_cnt_mu);
        for (int i = 0; i < 8; ++i) { cnt[i] += g_cnt_dead[i]; g_cnt_dead[i] = 0; }
        for (int i = 0; i < 4; ++i) {
            g_prof_ns[12 + i] += (long long)(g_fine_dead[i] / ghz);
            g_fine_dead[i] = 0;
        }
        for (ProfCnt *p : g_cnt_all) {
            for (int i = 0; i < 8; ++i) { cnt[i] += p->c[i]; p->c[i] = 0; }
            for (int i = 0; i < 4; ++i) {
                g_prof_ns[12 + i] += (long long)(p->fine_ns[i] / ghz);
                p->fine_ns[i] = 0;
            }
        }
    }
    long long tot = 0;
    for (int i = 0; i < 8; ++i) tot += g_prof_ns[i].load();
    fprintf(stderr, "[BT_PROF %s] total %.3fs:", tag, tot / 1e9);
    for (int i = 0; i < 16; ++i) {
        long long v = g_prof_ns[i].load();
        if (v) fprintf(stderr, " %s%s=%.3fs(%.0f%%)", i >= 12 ? "~" : "",
                       g_prof_names[i], v / 1e9, 100.0 * v / tot);
        g_prof_ns[i] = 0;
    }
    for (int i = 0; i < 8; ++i)
        if (cnt[i]) fprintf(stderr, " #%s=%lld", g_cnt_names[i], cnt[i]);
    fprintf(stderr, "\n");
}

// Behavioral emulation of the reference's ksort.h ks_introsort (ksort.h:
// 184-234): comparators are strict less-than, so the order of EQUAL keys
// comes from the partition/swap pattern (not input order). mem_chain_flt
// keeps the FIRST shadowed chain and dedup reads adjacent pairs, so exact
// SAM parity needs this element order, ties included. Mirrors the control
// flow only (median-of-3 pivot one past the midpoint parked at the right
// end, explicit stack, <=16 segments left for a final insertion pass,
// combsort on depth exhaustion).
template <typename T, typename LT>
static void ks_insertsort_emul(T *s, T *t, LT lt) {
    for (T *i = s + 1; i < t; ++i)
        for (T *j = i; j > s && lt(*j, *(j - 1)); --j) std::swap(*j, *(j - 1));
}

template <typename T, typename LT>
static void ks_combsort_emul(size_t n, T *a, LT lt) {
    const double shrink = 1.2473309501039786540366528676643;
    size_t gap = n;
    bool do_swap;
    do {
        if (gap > 2) {
            gap = (size_t)(gap / shrink);
            if (gap == 9 || gap == 10) gap = 11;
        }
        do_swap = false;
        for (T *i = a; i < a + n - gap; ++i) {
            T *j = i + gap;
            if (lt(*j, *i)) { std::swap(*i, *j); do_swap = true; }
        }
    } while (do_swap || gap > 2);
    if (gap != 1) ks_insertsort_emul(a, a + n, lt);
}

template <typename T, typename LT>
static void ks_introsort_emul(std::vector<T> &v, LT lt) {
    size_t n = v.size();
    T *a = v.data();
    if (n < 1) return;
    if (n == 2) {
        if (lt(a[1], a[0])) std::swap(a[0], a[1]);
        return;
    }
    int d = 2;
    while ((1ull << d) < n) ++d;
    struct Seg { T *left, *right; int depth; };
    std::vector<Seg> stack;
    T *s = a, *t = a + (n - 1);
    d <<= 1;
    for (;;) {
        if (s < t) {
            if (--d == 0) {
                ks_combsort_emul((size_t)(t - s + 1), s, lt);
                t = s;
                continue;
            }
            T *i = s, *j = t, *k = i + ((j - i) >> 1) + 1;
            if (lt(*k, *i)) {
                if (lt(*k, *j)) k = j;
            } else
                k = lt(*j, *i) ? i : j;
            T rp = *k;
            if (k != t) std::swap(*k, *t);
            for (;;) {
                do ++i; while (lt(*i, rp));
                do --j; while (i <= j && lt(rp, *j));
                if (j <= i) break;
                std::swap(*i, *j);
            }
            std::swap(*i, *t);
            if (i - s > t - i) {
                if (i - s > 16) stack.push_back({s, i - 1, d});
                s = (t - i > 16) ? i + 1 : t;
            } else {
                if (t - i > 16) stack.push_back({i + 1, t, d});
                t = (i - s > 16) ? i - 1 : s;
            }
        } else {
            if (stack.empty()) {
                ks_insertsort_emul(a, a + n, lt);
                return;
            }
            Seg sg = stack.back();
            stack.pop_back();
            s = sg.left; t = sg.right; d = sg.depth;
        }
    }
}

struct Occ4 { int64_t c[4]; };

static Occ4 occ4(const StrandFM &f, int64_t k) {
    Occ4 o{{0, 0, 0, 0}};
    if (k < 0) return o;
    if (k == f.seq_len) {
        for (int c = 0; c < 4; ++c) o.c[c] = f.L2[c + 1] - f.L2[c];
        return o;
    }
    if (k >= f.primary) k -= 1;
    if (f.ilv2) {
        const uint8_t *blk = f.ilv2 + ((k >> 6) << 5);
        const uint32_t *cnts = (const uint32_t *)blk;
        const uint64_t *words = (const uint64_t *)(blk + 16);
        int64_t cnt0 = cnts[0], cnt1 = cnts[1], cnt2 = cnts[2], cnt3 = cnts[3];
        const uint64_t M = 0x5555555555555555ULL;
        int sw = (int)((k >> 5) & 1);
        if (sw) {
            uint64_t y = words[0], inv = ~y;
            cnt0 += __builtin_popcountll(((inv >> 1) & inv) & M);
            cnt1 += __builtin_popcountll(((inv >> 1) & y) & M);
            cnt2 += __builtin_popcountll(((y >> 1) & inv) & M);
            cnt3 += __builtin_popcountll(((y >> 1) & y) & M);
        }
        uint64_t y = words[sw];
        int zero = 31 - (int)(k & 31);
        if (zero) {
            int sh = zero << 1;
            y = (y >> sh) << sh;
        }
        uint64_t inv = ~y;
        cnt0 += __builtin_popcountll(((inv >> 1) & inv) & M) - zero;
        cnt1 += __builtin_popcountll(((inv >> 1) & y) & M);
        cnt2 += __builtin_popcountll(((y >> 1) & inv) & M);
        cnt3 += __builtin_popcountll(((y >> 1) & y) & M);
        o.c[0] = cnt0; o.c[1] = cnt1; o.c[2] = cnt2; o.c[3] = cnt3;
        return o;
    }
    if (f.ilv) {
        const uint64_t *blk = f.ilv + ((k >> 7) << 3);
        int64_t cnt0 = (int64_t)blk[0], cnt1 = (int64_t)blk[1];
        int64_t cnt2 = (int64_t)blk[2], cnt3 = (int64_t)blk[3];
        int sw = (int)((k >> 5) & 3);
        const uint64_t M = 0x5555555555555555ULL;
        for (int j = 0; j < sw; ++j) {
            uint64_t y = blk[4 + j], inv = ~y;
            cnt0 += __builtin_popcountll(((inv >> 1) & inv) & M);
            cnt1 += __builtin_popcountll(((inv >> 1) & y) & M);
            cnt2 += __builtin_popcountll(((y >> 1) & inv) & M);
            cnt3 += __builtin_popcountll(((y >> 1) & y) & M);
        }
        uint64_t y = blk[4 + sw];
        int zero = 31 - (int)(k & 31);  // bases past k, masked off below
        if (zero) {
            int sh = zero << 1;
            y = (y >> sh) << sh;
        }
        uint64_t inv = ~y;
        cnt0 += __builtin_popcountll(((inv >> 1) & inv) & M) - zero;
        cnt1 += __builtin_popcountll(((inv >> 1) & y) & M);
        cnt2 += __builtin_popcountll(((y >> 1) & inv) & M);
        cnt3 += __builtin_popcountll(((y >> 1) & y) & M);
        o.c[0] = cnt0; o.c[1] = cnt1; o.c[2] = cnt2; o.c[3] = cnt3;
        return o;
    }
    int64_t w = k >> 4;
    uint32_t t_low = (~k) & 15;
    uint32_t word = f.words[w];
    if (t_low) {
        uint32_t sh = t_low << 1;
        word = (word >> sh) << sh;
    }
    const int64_t *base = f.occ + ((k >> 7) * 4);
    // counts inside the block, words before w
    int64_t cnt[4] = {0, 0, 0, 0};
    for (int64_t j = (k >> 7) << 3; j < w; ++j) {
        uint32_t y = f.words[j];
        uint32_t inv = ~y;
        cnt[0] += popcount32(((inv >> 1) & inv) & 0x55555555u);
        cnt[1] += popcount32(((inv >> 1) & y) & 0x55555555u);
        cnt[2] += popcount32(((y >> 1) & inv) & 0x55555555u);
        cnt[3] += popcount32(((y >> 1) & y) & 0x55555555u);
    }
    {
        uint32_t y = word;
        uint32_t inv = ~y;
        cnt[0] += popcount32(((inv >> 1) & inv) & 0x55555555u) - (int64_t)t_low;
        cnt[1] += popcount32(((inv >> 1) & y) & 0x55555555u);
        cnt[2] += popcount32(((y >> 1) & inv) & 0x55555555u);
        cnt[3] += popcount32(((y >> 1) & y) & 0x55555555u);
    }
    for (int c = 0; c < 4; ++c) o.c[c] = base[c] + cnt[c];
    return o;
}

// paired occ4 for ranks k <= l: when both fall in the same interleaved
// block, share the cache line and the full-superword prefix (fm_extend's
// two queries are usually a small interval apart).  Mirrors the intent of
// the reference's bwt_2occ4 (lib/aln/bwt.c) without copying its layout.
static void occ4_pair(const StrandFM &f, int64_t k, int64_t l,
                      Occ4 &ok, Occ4 &ol) {
    if (f.ilv2 && k >= 0 && l >= 0 && l < f.seq_len && k <= l) {
        int64_t k2 = k - (k >= f.primary ? 1 : 0);
        int64_t l2 = l - (l >= f.primary ? 1 : 0);
        if ((k2 >> 6) == (l2 >> 6)) {
            const uint8_t *blk = f.ilv2 + ((k2 >> 6) << 5);
            const uint32_t *cnts = (const uint32_t *)blk;
            const uint64_t *words = (const uint64_t *)(blk + 16);
            const uint64_t M = 0x5555555555555555ULL;
            int64_t base[4] = {cnts[0], cnts[1], cnts[2], cnts[3]};
            int swk = (int)((k2 >> 5) & 1), swl = (int)((l2 >> 5) & 1);
            auto addfull2 = [&](uint64_t y, int64_t *c) {
                uint64_t inv = ~y;
                c[0] += __builtin_popcountll(((inv >> 1) & inv) & M);
                c[1] += __builtin_popcountll(((inv >> 1) & y) & M);
                c[2] += __builtin_popcountll(((y >> 1) & inv) & M);
                c[3] += __builtin_popcountll(((y >> 1) & y) & M);
            };
            auto addpart2 = [&](uint64_t y, int64_t kk, int64_t *c) {
                int zero = 31 - (int)(kk & 31);
                if (zero) {
                    int sh = zero << 1;
                    y = (y >> sh) << sh;
                }
                uint64_t inv = ~y;
                c[0] += __builtin_popcountll(((inv >> 1) & inv) & M) - zero;
                c[1] += __builtin_popcountll(((inv >> 1) & y) & M);
                c[2] += __builtin_popcountll(((y >> 1) & inv) & M);
                c[3] += __builtin_popcountll(((y >> 1) & y) & M);
            };
            if (swk) addfull2(words[0], base);
            int64_t ck[4] = {base[0], base[1], base[2], base[3]};
            addpart2(words[swk], k2, ck);
            ok.c[0] = ck[0]; ok.c[1] = ck[1]; ok.c[2] = ck[2]; ok.c[3] = ck[3];
            if (swl > swk) addfull2(words[0], base);
            addpart2(words[swl], l2, base);
            ol.c[0] = base[0]; ol.c[1] = base[1]; ol.c[2] = base[2];
            ol.c[3] = base[3];
            return;
        }
        ok = occ4(f, k);
        ol = occ4(f, l);
        return;
    }
    if (!f.ilv || k < 0 || l < 0 || k >= f.seq_len || l >= f.seq_len
        || k > l) {
        ok = occ4(f, k);
        ol = occ4(f, l);
        return;
    }
    int64_t k2 = k >= f.primary ? k - 1 : k;
    int64_t l2 = l >= f.primary ? l - 1 : l;
    if ((k2 >> 7) != (l2 >> 7)) {
        ok = occ4(f, k);
        ol = occ4(f, l);
        return;
    }
    const uint64_t *blk = f.ilv + ((k2 >> 7) << 3);
    const uint64_t M = 0x5555555555555555ULL;
    int64_t c0 = (int64_t)blk[0], c1 = (int64_t)blk[1];
    int64_t c2 = (int64_t)blk[2], c3 = (int64_t)blk[3];
    int swk = (int)((k2 >> 5) & 3), swl = (int)((l2 >> 5) & 3);
    auto addfull = [&](uint64_t y, int64_t *c) {
        uint64_t inv = ~y;
        c[0] += __builtin_popcountll(((inv >> 1) & inv) & M);
        c[1] += __builtin_popcountll(((inv >> 1) & y) & M);
        c[2] += __builtin_popcountll(((y >> 1) & inv) & M);
        c[3] += __builtin_popcountll(((y >> 1) & y) & M);
    };
    auto addpart = [&](uint64_t y, int64_t kk, int64_t *c) {
        int zero = 31 - (int)(kk & 31);
        if (zero) {
            int sh = zero << 1;
            y = (y >> sh) << sh;
        }
        uint64_t inv = ~y;
        c[0] += __builtin_popcountll(((inv >> 1) & inv) & M) - zero;
        c[1] += __builtin_popcountll(((inv >> 1) & y) & M);
        c[2] += __builtin_popcountll(((y >> 1) & inv) & M);
        c[3] += __builtin_popcountll(((y >> 1) & y) & M);
    };
    for (int j = 0; j < swk; ++j) {
        uint64_t y = blk[4 + j], inv = ~y;
        c0 += __builtin_popcountll(((inv >> 1) & inv) & M);
        c1 += __builtin_popcountll(((inv >> 1) & y) & M);
        c2 += __builtin_popcountll(((y >> 1) & inv) & M);
        c3 += __builtin_popcountll(((y >> 1) & y) & M);
    }
    int64_t ck[4] = {c0, c1, c2, c3};
    addpart(blk[4 + swk], k2, ck);
    ok.c[0] = ck[0]; ok.c[1] = ck[1]; ok.c[2] = ck[2]; ok.c[3] = ck[3];
    int64_t cl[4] = {c0, c1, c2, c3};
    for (int j = swk; j < swl; ++j) addfull(blk[4 + j], cl);
    addpart(blk[4 + swl], l2, cl);
    ol.c[0] = cl[0]; ol.c[1] = cl[1]; ol.c[2] = cl[2]; ol.c[3] = cl[3];
}

struct Intv { int64_t x0, x1, s; int32_t end; };

// bwt_extend semantics on (x0, x1, s); is_back selects the queried axis.
static void fm_extend(const StrandFM &f, const Intv &ik, Intv out[4], bool is_back) {
    int64_t xq = is_back ? ik.x0 : ik.x1;
    int64_t xo = is_back ? ik.x1 : ik.x0;
    Occ4 tk, tl;
    occ4_pair(f, xq - 1, xq - 1 + ik.s, tk, tl);
    int64_t sizes[4], nxq[4];
    for (int c = 0; c < 4; ++c) {
        sizes[c] = tl.c[c] - tk.c[c];
        nxq[c] = f.L2[c] + 1 + tk.c[c];
    }
    int64_t crosses = (xq <= f.primary && xq + ik.s - 1 >= f.primary) ? 1 : 0;
    int64_t b3 = xo + crosses;
    int64_t b2 = b3 + sizes[3];
    int64_t b1 = b2 + sizes[2];
    int64_t b0 = b1 + sizes[1];
    int64_t nxo[4] = {b0, b1, b2, b3};
    for (int c = 0; c < 4; ++c) {
        out[c].s = sizes[c];
        if (is_back) { out[c].x0 = nxq[c]; out[c].x1 = nxo[c]; }
        else         { out[c].x0 = nxo[c]; out[c].x1 = nxq[c]; }
        out[c].end = ik.end;
    }
}

static inline int bwt_char(const StrandFM &f, int64_t k) {
    return (f.words[k >> 4] >> (((~k) & 15) << 1)) & 3;
}

// -- single-class occ: count of pairs == c ("exact") and > c ("gt") up to
// rank k inclusive.  The SMEM search only ever consumes one output class of
// bwt_extend, whose coordinates need exactly these two counts — half the
// popcount work of a full occ4.
static const uint64_t OCC_M = 0x5555555555555555ULL;
static const uint64_t OCC_MAGIC[4] = {0ULL, OCC_M, OCC_M << 1, ~0ULL};

static inline int64_t occ_exact_word(uint64_t y, int c) {
    uint64_t t = y ^ OCC_MAGIC[c];
    return __builtin_popcountll(~((t >> 1) | t) & OCC_M);
}
static inline int64_t occ_gt_word(uint64_t y, int c) {
    switch (c) {
    case 0: return __builtin_popcountll((y | (y >> 1)) & OCC_M);
    case 1: return __builtin_popcountll((y >> 1) & OCC_M);
    case 2: return __builtin_popcountll((y & (y >> 1)) & OCC_M);
    default: return 0;
    }
}

// pre: f.ilv2 != null, 0 <= k < seq_len
static inline void occ_cg_one(const StrandFM &f, int64_t k, int c,
                              int64_t &e, int64_t &g) {
    int64_t k2 = k - (k >= f.primary ? 1 : 0);
    const uint8_t *blk = f.ilv2 + ((k2 >> 6) << 5);
    const uint32_t *cnts = (const uint32_t *)blk;
    const uint64_t *words = (const uint64_t *)(blk + 16);
    int64_t e0 = cnts[c], g0 = 0;
    for (int d = c + 1; d < 4; ++d) g0 += cnts[d];
    int sw = (int)((k2 >> 5) & 1);
    if (sw) {
        uint64_t y = words[0];
        e0 += occ_exact_word(y, c);
        g0 += occ_gt_word(y, c);
    }
    uint64_t y = words[sw];
    int zero = 31 - (int)(k2 & 31);
    if (zero) {
        int sh = zero << 1;
        y = (y >> sh) << sh;
    }
    e = e0 + occ_exact_word(y, c) - (c == 0 ? zero : 0);
    g = g0 + occ_gt_word(y, c);
}

static void occ_cg_pair(const StrandFM &f, int64_t k, int64_t l, int c,
                        int64_t &ek, int64_t &gk, int64_t &el, int64_t &gl) {
    if (f.ilv2 && k >= 0 && l < f.seq_len && k <= l) {
        int64_t k2 = k - (k >= f.primary ? 1 : 0);
        int64_t l2 = l - (l >= f.primary ? 1 : 0);
        if ((k2 >> 6) == (l2 >> 6)) {
            const uint8_t *blk = f.ilv2 + ((k2 >> 6) << 5);
            const uint32_t *cnts = (const uint32_t *)blk;
            const uint64_t *words = (const uint64_t *)(blk + 16);
            int64_t e0 = cnts[c], g0 = 0;
            for (int d = c + 1; d < 4; ++d) g0 += cnts[d];
            int swk = (int)((k2 >> 5) & 1), swl = (int)((l2 >> 5) & 1);
            if (swk) {
                uint64_t y = words[0];
                e0 += occ_exact_word(y, c);
                g0 += occ_gt_word(y, c);
            }
            uint64_t yk = words[swk];
            int zk = 31 - (int)(k2 & 31);
            if (zk) { int sh = zk << 1; yk = (yk >> sh) << sh; }
            ek = e0 + occ_exact_word(yk, c) - (c == 0 ? zk : 0);
            gk = g0 + occ_gt_word(yk, c);
            if (swl > swk) {
                uint64_t y = words[0];
                e0 += occ_exact_word(y, c);
                g0 += occ_gt_word(y, c);
            }
            uint64_t yl = words[swl];
            int zl = 31 - (int)(l2 & 31);
            if (zl) { int sh = zl << 1; yl = (yl >> sh) << sh; }
            el = e0 + occ_exact_word(yl, c) - (c == 0 ? zl : 0);
            gl = g0 + occ_gt_word(yl, c);
            return;
        }
        occ_cg_one(f, k, c, ek, gk);
        occ_cg_one(f, l, c, el, gl);
        return;
    }
    Occ4 ok4, ol4;
    occ4_pair(f, k, l, ok4, ol4);
    ek = ok4.c[c]; el = ol4.c[c];
    gk = 0; gl = 0;
    for (int d = c + 1; d < 4; ++d) { gk += ok4.c[d]; gl += ol4.c[d]; }
}

// ---- AVX-512 batched single-class occ: 8 independent occ_cg_one queries
// sharing one output class c (the backward SMEM step extends every interval
// of `prev` with the SAME character, so the lookups vectorize cleanly:
// 4 gathers pull each rank's full 32-byte ilv2 block, VPOPCNTQ does the
// counting).  Bit-exact with occ_cg_one; tests/test_native_engine.py
// compares it against the scalar path over every rank of a small index.
#if defined(__AVX512F__) && defined(__AVX512BW__)
#define BT_HAVE_AVX512_OCC 1

// Per-qword popcount: VPOPCNTQ where the host has it, otherwise the classic
// vpshufb nibble-LUT + vpsadbw horizontal sum (AVX512BW) — identical result,
// ~2 extra uops per use. Lets Skylake-class hosts run the SIMD seeder too.
static inline __m512i bt_popcnt64(__m512i v) {
#if defined(__AVX512VPOPCNTDQ__)
    return _mm512_popcnt_epi64(v);
#else
    const __m512i lut = _mm512_broadcast_i32x4(
        _mm_setr_epi8(0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4));
    const __m512i low = _mm512_set1_epi8(0x0f);
    __m512i lo = _mm512_and_si512(v, low);
    __m512i hi = _mm512_and_si512(_mm512_srli_epi16(v, 4), low);
    __m512i cnt = _mm512_add_epi8(_mm512_shuffle_epi8(lut, lo),
                                  _mm512_shuffle_epi8(lut, hi));
    return _mm512_sad_epu8(cnt, _mm512_setzero_si512());
#endif
}

static inline __m512i occ_exact_vec(__m512i y, int c) {
    const __m512i M = _mm512_set1_epi64((long long)OCC_M);
    __m512i t = _mm512_xor_si512(y, _mm512_set1_epi64((long long)OCC_MAGIC[c]));
    __m512i u = _mm512_andnot_si512(
        _mm512_or_si512(_mm512_srli_epi64(t, 1), t), M);
    return bt_popcnt64(u);
}
static inline __m512i occ_gt_vec(__m512i y, int c) {
    const __m512i M = _mm512_set1_epi64((long long)OCC_M);
    __m512i r;
    switch (c) {
    case 0: r = _mm512_and_si512(_mm512_or_si512(y, _mm512_srli_epi64(y, 1)), M); break;
    case 1: r = _mm512_and_si512(_mm512_srli_epi64(y, 1), M); break;
    case 2: r = _mm512_and_si512(_mm512_and_si512(y, _mm512_srli_epi64(y, 1)), M); break;
    default: return _mm512_setzero_si512();
    }
    return bt_popcnt64(r);
}

// Load 8 ranks' full 32-byte ilv2 blocks into 4 column vectors
// (counts01, counts23, superword0, superword1): 8 plain ymm loads + an
// in-register 8x4 u64 transpose — measurably faster than 4 vpgatherqq on
// this core (gathers decode to one load uop per element plus overhead).
static inline void occ_load_blocks_x8(const uint8_t *base, __m512i voff,
                                      __m512i &c01, __m512i &c23,
                                      __m512i &w0, __m512i &w1) {
    alignas(64) int64_t off[8];
    _mm512_store_si512((void *)off, voff);
    __m256i y0 = _mm256_loadu_si256((const __m256i *)(base + off[0]));
    __m256i y1 = _mm256_loadu_si256((const __m256i *)(base + off[1]));
    __m256i y2 = _mm256_loadu_si256((const __m256i *)(base + off[2]));
    __m256i y3 = _mm256_loadu_si256((const __m256i *)(base + off[3]));
    __m256i y4 = _mm256_loadu_si256((const __m256i *)(base + off[4]));
    __m256i y5 = _mm256_loadu_si256((const __m256i *)(base + off[5]));
    __m256i y6 = _mm256_loadu_si256((const __m256i *)(base + off[6]));
    __m256i y7 = _mm256_loadu_si256((const __m256i *)(base + off[7]));
    __m512i z0 = _mm512_inserti64x4(_mm512_castsi256_si512(y0), y4, 1);
    __m512i z1 = _mm512_inserti64x4(_mm512_castsi256_si512(y1), y5, 1);
    __m512i z2 = _mm512_inserti64x4(_mm512_castsi256_si512(y2), y6, 1);
    __m512i z3 = _mm512_inserti64x4(_mm512_castsi256_si512(y3), y7, 1);
    const __m512i IA = _mm512_setr_epi64(0, 8, 2, 10, 4, 12, 6, 14);
    const __m512i IB = _mm512_setr_epi64(1, 9, 3, 11, 5, 13, 7, 15);
    __m512i m01A = _mm512_permutex2var_epi64(z0, IA, z1);
    __m512i m01B = _mm512_permutex2var_epi64(z0, IB, z1);
    __m512i m23A = _mm512_permutex2var_epi64(z2, IA, z3);
    __m512i m23B = _mm512_permutex2var_epi64(z2, IB, z3);
    const __m512i JA = _mm512_setr_epi64(0, 1, 8, 9, 4, 5, 12, 13);
    const __m512i JB = _mm512_setr_epi64(2, 3, 10, 11, 6, 7, 14, 15);
    c01 = _mm512_permutex2var_epi64(m01A, JA, m23A);
    w0 = _mm512_permutex2var_epi64(m01A, JB, m23A);
    c23 = _mm512_permutex2var_epi64(m01B, JA, m23B);
    w1 = _mm512_permutex2var_epi64(m01B, JB, m23B);
}

// pre: f.ilv2 != null, every ranks[i] in [0, seq_len]
static inline void occ_cg_one_x8(const StrandFM &f, const int64_t *ranks,
                                 int c, int64_t *e, int64_t *g) {
    __m512i vk = _mm512_loadu_si512((const void *)ranks);
    __mmask8 ge = _mm512_cmp_epi64_mask(
        vk, _mm512_set1_epi64(f.primary), _MM_CMPINT_NLT);  // k >= primary
    __m512i vk2 = _mm512_mask_sub_epi64(vk, ge, vk, _mm512_set1_epi64(1));
    __m512i voff = _mm512_slli_epi64(_mm512_srli_epi64(vk2, 6), 5);
    __m512i c01, c23, w0, w1;
    occ_load_blocks_x8(f.ilv2, voff, c01, c23, w0, w1);
    const __m512i m32 = _mm512_set1_epi64(0xffffffffLL);
    __m512i cnt0 = _mm512_and_si512(c01, m32);
    __m512i cnt1 = _mm512_srli_epi64(c01, 32);
    __m512i cnt2 = _mm512_and_si512(c23, m32);
    __m512i cnt3 = _mm512_srli_epi64(c23, 32);
    __m512i e0, g0;
    switch (c) {
    case 0: e0 = cnt0; g0 = _mm512_add_epi64(cnt1, _mm512_add_epi64(cnt2, cnt3)); break;
    case 1: e0 = cnt1; g0 = _mm512_add_epi64(cnt2, cnt3); break;
    case 2: e0 = cnt2; g0 = cnt3; break;
    default: e0 = cnt3; g0 = _mm512_setzero_si512(); break;
    }
    // second superword: add the first word's full counts
    __mmask8 msw = _mm512_test_epi64_mask(_mm512_srli_epi64(vk2, 5),
                                          _mm512_set1_epi64(1));
    e0 = _mm512_mask_add_epi64(e0, msw, e0, occ_exact_vec(w0, c));
    g0 = _mm512_mask_add_epi64(g0, msw, g0, occ_gt_vec(w0, c));
    __m512i y = _mm512_mask_blend_epi64(msw, w0, w1);
    __m512i zero = _mm512_sub_epi64(_mm512_set1_epi64(31),
                                    _mm512_and_si512(vk2, _mm512_set1_epi64(31)));
    __m512i sh = _mm512_slli_epi64(zero, 1);
    y = _mm512_sllv_epi64(_mm512_srlv_epi64(y, sh), sh);
    __m512i ev = _mm512_add_epi64(e0, occ_exact_vec(y, c));
    if (c == 0) ev = _mm512_sub_epi64(ev, zero);  // zeroed pairs decode as 'A'
    __m512i gv = _mm512_add_epi64(g0, occ_gt_vec(y, c));
    _mm512_storeu_si512((void *)e, ev);
    _mm512_storeu_si512((void *)g, gv);
}

// Variable-class variant: 8 occ_cg_one queries with a PER-LANE class
// (forward lockstep lanes sit at different read positions).  cs[i] in
// [0,3]; bit-exact with occ_cg_one(ranks[i], cs[i]).
static inline void occ_cg_one_x8v(const StrandFM &f, const int64_t *ranks,
                                  const int64_t *cs, int64_t *e, int64_t *g) {
    const __m512i M = _mm512_set1_epi64((long long)OCC_M);
    __m512i vc = _mm512_loadu_si512((const void *)cs);
    __m512i vmagic = _mm512_permutexvar_epi64(
        vc, _mm512_set_epi64(0, 0, 0, 0, (long long)OCC_MAGIC[3],
                             (long long)OCC_MAGIC[2], (long long)OCC_MAGIC[1],
                             (long long)OCC_MAGIC[0]));
    __mmask8 c_is0 = _mm512_cmpeq_epi64_mask(vc, _mm512_setzero_si512());
    __mmask8 c_lt1 = c_is0;
    __mmask8 c_lt2 = _mm512_cmplt_epi64_mask(vc, _mm512_set1_epi64(2));
    __mmask8 c_lt3 = _mm512_cmplt_epi64_mask(vc, _mm512_set1_epi64(3));
    __mmask8 c_is1 = _mm512_cmpeq_epi64_mask(vc, _mm512_set1_epi64(1));
    __mmask8 c_is2 = _mm512_cmpeq_epi64_mask(vc, _mm512_set1_epi64(2));
    auto exactv = [&](__m512i y) {
        __m512i t = _mm512_xor_si512(y, vmagic);
        return bt_popcnt64(_mm512_andnot_si512(
            _mm512_or_si512(_mm512_srli_epi64(t, 1), t), M));
    };
    auto gtv = [&](__m512i y) {
        __m512i v = _mm512_and_si512(_mm512_srli_epi64(y, 1), M);
        __m512i u = _mm512_and_si512(y, M);
        // c==0: u|v, c==1: v, c==2: u&v, c==3: 0
        __m512i r = _mm512_setzero_si512();
        r = _mm512_mask_mov_epi64(r, c_is0, _mm512_or_si512(u, v));
        r = _mm512_mask_mov_epi64(r, c_is1, v);
        r = _mm512_mask_mov_epi64(r, c_is2, _mm512_and_si512(u, v));
        return bt_popcnt64(r);
    };
    __m512i vk = _mm512_loadu_si512((const void *)ranks);
    __mmask8 ge = _mm512_cmp_epi64_mask(
        vk, _mm512_set1_epi64(f.primary), _MM_CMPINT_NLT);
    __m512i vk2 = _mm512_mask_sub_epi64(vk, ge, vk, _mm512_set1_epi64(1));
    __m512i voff = _mm512_slli_epi64(_mm512_srli_epi64(vk2, 6), 5);
    __m512i c01, c23, w0, w1;
    occ_load_blocks_x8(f.ilv2, voff, c01, c23, w0, w1);
    const __m512i m32 = _mm512_set1_epi64(0xffffffffLL);
    __m512i cnt0 = _mm512_and_si512(c01, m32);
    __m512i cnt1 = _mm512_srli_epi64(c01, 32);
    __m512i cnt2 = _mm512_and_si512(c23, m32);
    __m512i cnt3 = _mm512_srli_epi64(c23, 32);
    // e0 = cnt[c] per lane; g0 = sum of cnt[d > c]
    __m512i e0 = cnt0;
    e0 = _mm512_mask_mov_epi64(e0, c_is1, cnt1);
    e0 = _mm512_mask_mov_epi64(e0, c_is2, cnt2);
    e0 = _mm512_mask_mov_epi64(
        e0, _mm512_cmpeq_epi64_mask(vc, _mm512_set1_epi64(3)), cnt3);
    __m512i g0 = _mm512_maskz_mov_epi64(c_lt3, cnt3);
    g0 = _mm512_mask_add_epi64(g0, c_lt2, g0, cnt2);
    g0 = _mm512_mask_add_epi64(g0, c_lt1, g0, cnt1);
    __mmask8 msw = _mm512_test_epi64_mask(_mm512_srli_epi64(vk2, 5),
                                          _mm512_set1_epi64(1));
    e0 = _mm512_mask_add_epi64(e0, msw, e0, exactv(w0));
    g0 = _mm512_mask_add_epi64(g0, msw, g0, gtv(w0));
    __m512i y = _mm512_mask_blend_epi64(msw, w0, w1);
    __m512i zero = _mm512_sub_epi64(
        _mm512_set1_epi64(31), _mm512_and_si512(vk2, _mm512_set1_epi64(31)));
    __m512i sh = _mm512_slli_epi64(zero, 1);
    y = _mm512_sllv_epi64(_mm512_srlv_epi64(y, sh), sh);
    __m512i ev = _mm512_add_epi64(e0, exactv(y));
    ev = _mm512_mask_sub_epi64(ev, c_is0, ev, zero);  // zeroed pairs are 'A'
    __m512i gv = _mm512_add_epi64(g0, gtv(y));
    _mm512_storeu_si512((void *)e, ev);
    _mm512_storeu_si512((void *)g, gv);
}

// Batched backward bwt_extend over n intervals with one class c.  Outputs
// match fm_extend_one(f, in[j], c, out[j], true) exactly: x0-1 >= 0 and
// x0-1+s <= seq_len hold for every live interval, and occ_cg_one's counts
// at rank seq_len equal occ4's early-out totals, so every lane sits inside
// occ_cg_pair's ilv2 fast path semantics.
static void fm_extend_many_back(const StrandFM &f, const Intv *in, int n,
                                int c, Intv *out) {
    alignas(64) int64_t ks[8], ls[8], ek[8], gk[8], el[8], gl[8];
    for (int j = 0; j < n; j += 8) {
        int m = n - j < 8 ? n - j : 8;
        for (int t = 0; t < m; ++t) {
            ks[t] = in[j + t].x0 - 1;
            ls[t] = in[j + t].x0 - 1 + in[j + t].s;
        }
        for (int t = m; t < 8; ++t) { ks[t] = 0; ls[t] = 0; }  // pad: rank 0
        occ_cg_one_x8(f, ks, c, ek, gk);
        occ_cg_one_x8(f, ls, c, el, gl);
        for (int t = 0; t < m; ++t) {
            const Intv &p = in[j + t];
            Intv &o = out[j + t];
            int64_t crosses =
                (p.x0 <= f.primary && p.x0 + p.s - 1 >= f.primary) ? 1 : 0;
            o.s = el[t] - ek[t];
            o.x0 = f.L2[c] + 1 + ek[t];
            o.x1 = p.x1 + crosses + (gl[t] - gk[t]);
            o.end = p.end;
        }
    }
}
#endif  // AVX-512 occ

// bwt_extend for a single known output class c (all the SMEM passes need).
static inline void fm_extend_one(const StrandFM &f, const Intv &ik, int c,
                                 Intv &out, bool is_back) {
    int64_t xq = is_back ? ik.x0 : ik.x1;
    int64_t xo = is_back ? ik.x1 : ik.x0;
    int64_t ek, gk, el, gl;
    occ_cg_pair(f, xq - 1, xq - 1 + ik.s, c, ek, gk, el, gl);
    int64_t crosses = (xq <= f.primary && xq + ik.s - 1 >= f.primary) ? 1 : 0;
    int64_t nxq = f.L2[c] + 1 + ek;
    int64_t nxo = xo + crosses + (gl - gk);
    out.s = el - ek;
    if (is_back) { out.x0 = nxq; out.x1 = nxo; }
    else         { out.x0 = nxo; out.x1 = nxq; }
    out.end = ik.end;
}

// one inverse-Psi step (k != primary): the BWT char and its rank count come
// from the same ilv2 cache line; counts only the one needed class
// (reference walks rank+char separately via bwt_invPsi, lib/aln/bwt.c).
static inline int64_t invpsi_step(const StrandFM &f, int64_t k) {
    if (!f.ilv2) {
        int64_t x = k - (k > f.primary ? 1 : 0);
        if (f.ilv) {
            // The 64-byte ilv block holds the four occ counts AND the 128
            // bases, so the char AND its rank come from ONE cache line —
            // the wide-strand (no-ilv2) walk step was two dependent lines
            // (words for bwt_char + the block for occ4). Same inclusive
            // count as occ4's ilv branch, c-specialized via the magic LUT.
            // (invpsi_step is never called with k == primary, so occ4's
            // >=-adjustment and bwt_char's >-adjustment agree on x.)
            const uint64_t *blk = f.ilv + ((x >> 7) << 3);
            int sw = (int)((x >> 5) & 3);
            uint64_t yx = blk[4 + sw];
            int p = (int)(x & 31);
            int c = (int)((yx >> (62 - 2 * p)) & 3);
            const uint64_t M = 0x5555555555555555ULL;
            static const uint64_t magic[4] = {0ULL, M, M << 1, ~0ULL};
            int64_t cnt = (int64_t)blk[c];
            for (int j = 0; j < sw; ++j) {
                uint64_t t = blk[4 + j] ^ magic[c];
                cnt += __builtin_popcountll(~((t >> 1) | t) & M);
            }
            int zero = 31 - p;
            uint64_t y = yx;
            if (zero) {
                int sh = zero << 1;
                y = (y >> sh) << sh;
            }
            uint64_t t = y ^ magic[c];
            cnt += __builtin_popcountll(~((t >> 1) | t) & M);
            if (c == 0) cnt -= zero;
            return f.L2[c] + cnt;
        }
        int c = bwt_char(f, x);
        return f.L2[c] + occ4(f, k).c[c];
    }
    // k in [1, seq_len]; for k == seq_len this degenerates to the full
    // count through the last block, same as occ4's early-out.
    int64_t k2 = k - (k > f.primary ? 1 : 0);
    const uint8_t *blk = f.ilv2 + ((k2 >> 6) << 5);
    const uint32_t *cnts = (const uint32_t *)blk;
    const uint64_t *words = (const uint64_t *)(blk + 16);
    const uint64_t M = 0x5555555555555555ULL;
    static const uint64_t magic[4] = {0ULL, M, M << 1, ~0ULL};
    int sw = (int)((k2 >> 5) & 1);
    uint64_t y = words[sw];
    int p = (int)(k2 & 31);
    int c = (int)((y >> (62 - 2 * p)) & 3);
    int64_t cnt = cnts[c];
    if (sw) {
        uint64_t t = words[0] ^ magic[c];
        cnt += __builtin_popcountll(~((t >> 1) | t) & M);
    }
    int zero = 31 - p;
    if (zero) {
        int sh = zero << 1;
        y = (y >> sh) << sh;
    }
    uint64_t t = y ^ magic[c];
    cnt += __builtin_popcountll(~((t >> 1) | t) & M);
    if (c == 0) cnt -= zero;
    return f.L2[c] + cnt;
}

static inline int64_t fm_sa_sample(const StrandFM &f, int64_t k) {
    // sa[0] is -1 ('$' row): stored as the uint32 wrap in the narrow
    // layout (interpret as signed), literal int64 -1 in the wide layout
    return f.sa_wide
        ? ((const int64_t *)f.sa)[k >> f.sa_shift]
        : (int64_t)(int32_t)((const uint32_t *)f.sa)[k >> f.sa_shift];
}

static int64_t fm_sa(const StrandFM &f, int64_t k) {
    int64_t add = 0;
    const int64_t samp_mask = (1LL << f.sa_shift) - 1;
    while (k & samp_mask) {
        ++add;
        if (k == f.primary) k = 0;
        else k = invpsi_step(f, k);
    }
    return add + fm_sa_sample(f, k);
}

// Batched SA resolution: the invPsi walks of different occurrences are
// independent dependent-chains (avg 16 block reads each), so step W of them
// round-robin with a software prefetch issued one step ahead — the chain's
// cache-miss latency overlaps across lanes instead of serializing.
// The interleave is LAYOUT-AGNOSTIC: only the prefetch target depends on
// which occ layout invpsi_step will read. Wide (>= 2^32-char) strands can
// never have ilv2 (its counts are uint32), so gating the whole interleave
// on ilv2 — as this function originally did — silently serialized every
// human-scale SA walk: at 3.1 Gbp both intv 8 and intv 16 measured ~66 s
// of sa_walk per 100k reads (the OOO window overlaps 2-3 short walks but
// not long ones, equalizing the intervals) vs ~190 s of total align CPU.
static void fm_sa_batch(const StrandFM &f, const int64_t *ks, int n,
                        int64_t *out) {
    if (n < 4) {
        for (int i = 0; i < n; ++i) out[i] = fm_sa(f, ks[i]);
        return;
    }
    auto pf = [&](int64_t k) {
        int64_t k2 = k - (k > f.primary ? 1 : 0);
        if (f.ilv2) {
            __builtin_prefetch(f.ilv2 + ((k2 >> 6) << 5), 0, 1);
        } else if (f.ilv) {
            // invpsi_step's ilv-specialized step reads only this block
            __builtin_prefetch(f.ilv + ((k2 >> 7) << 3), 0, 1);
        } else {
            // flat fallback: bwt_char reads words[k2>>4], occ4 the
            // checkpoint row (its word scan mostly shares the words line)
            __builtin_prefetch(f.words + (k2 >> 4), 0, 1);
            __builtin_prefetch(f.occ + (k2 >> 7) * 4, 0, 1);
        }
    };
    constexpr int W = 16;
    const int64_t samp_mask = (1LL << f.sa_shift) - 1;
    int64_t k[W], add[W];
    int oi[W];
    int next = 0, live = 0;
    auto refill = [&](int i) {
        while (next < n) {
            int64_t kk = ks[next];
            if ((kk & samp_mask) == 0) { out[next++] = fm_sa_sample(f, kk); continue; }
            k[i] = kk; add[i] = 0; oi[i] = next++;
            pf(kk);
            ++live;
            return;
        }
        oi[i] = -1;
    };
    for (int i = 0; i < W; ++i) refill(i);
    while (live) {
        for (int i = 0; i < W; ++i) {
            if (oi[i] < 0) continue;
            int64_t kk = k[i];
            ++add[i];
            kk = (kk == f.primary) ? 0 : invpsi_step(f, kk);
            if ((kk & samp_mask) == 0) {
                out[oi[i]] = add[i] + fm_sa_sample(f, kk);
                --live;
                oi[i] = -1;
                refill(i);
            } else {
                k[i] = kk;
                pf(kk);
            }
        }
    }
}

// --------------------------------------------------------------- options

struct Opt {
    int32_t a, b, o_del, e_del, o_ins, e_ins, pen_clip5, pen_clip3, w, zdrop;
    int64_t max_mem_intv;
    int32_t min_seed_len, split_width;
    int64_t max_occ;
    int32_t max_chain_gap;
    double split_factor, mask_level, drop_ratio;
    int32_t min_chain_weight;
    int64_t max_chain_extend;
    int32_t flag, parent_policy, bsstrand;
    int8_t mats[2][25];     // [0]=gamat, [1]=ctmat; row = ref, col = read
};

// ----------------------------------------------------------------- SMEM

struct Seed5 { int32_t start, end; int64_t x0, x1, s; };

static void smem_backward(const StrandFM &fm, const uint8_t *q, int x,
                          int64_t min_intv, std::vector<Intv> &prev,
                          std::vector<Seed5> &mem);

static int smem1a(const StrandFM &fm, const StrandFM &fmc, const uint8_t *q,
                  int len, int x, int64_t min_intv, std::vector<Seed5> &mem) {
    mem.clear();
    if (q[x] > 3) return x + 1;
    if (min_intv < 1) min_intv = 1;
    prof_count(3);
    int c0 = q[x];
    Intv ik{fm.L2[c0] + 1, fmc.L2[3 - c0] + 1, fm.L2[c0 + 1] - fm.L2[c0],
            (int32_t)(x + 1)};
    // scratch reused across calls (the reference keeps these in smem_aux_t)
    static thread_local std::vector<Intv> curr, prev;
    curr.clear(); prev.clear();
    int i = x + 1;
    Intv ok[4];
    {
        ProfScope pfwd(7);  // forward-extension share of seeding
        for (; i < len; ++i) {
            if (q[i] < 4) {
                int c = 3 - q[i];
                prof_count(0);
                fm_extend_one(fmc, ik, c, ok[c], false);
                if (ok[c].s != ik.s) {
                    curr.push_back(ik);
                    if (ok[c].s < min_intv) break;
                }
                ik = ok[c];
                ik.end = i + 1;
            } else {
                curr.push_back(ik);
                break;
            }
        }
    }
    if (i == len) curr.push_back(ik);
    std::reverse(curr.begin(), curr.end());
    int ret = curr[0].end;
    prev.swap(curr);
    smem_backward(fm, q, x, min_intv, prev, mem);
    return ret;
}

// The backward half of smem1a: `prev` holds the forward pass's surviving
// intervals longest-first (i.e. reversed push order); appends the maximal
// exact matches to `mem`. Shared by smem1a and the chunk-lockstep seeder
// (which records forward calls and replays them here in call order).
static void smem_backward(const StrandFM &fm, const uint8_t *q, int x,
                          int64_t min_intv, std::vector<Intv> &prev,
                          std::vector<Seed5> &mem) {
    static thread_local std::vector<Intv> curr;
    static thread_local std::vector<std::pair<int32_t, Intv>> out;  // (start, entry)
    static thread_local std::vector<Intv> vext;
    Intv ok[4];
    out.clear();
    int i;
    for (i = x - 1; i >= -1; --i) {
        int c = (i < 0 || q[i] > 3) ? -1 : q[i];
        curr.clear();
        bool use_vec = false;
#ifdef BT_HAVE_AVX512_OCC
        // below ~3 intervals the batch setup loses to the scalar path
        // (sweep: BT_VEC_MIN, measured 4 > 3 > 6 > 2 at 5-50 Mbp)
        static const size_t vec_min = [] {
            const char *s = getenv("BT_VEC_MIN");
            return s ? (size_t)atol(s) : (size_t)4;
        }();
        if (c >= 0 && fm.ilv2 && prev.size() >= vec_min) {
            vext.resize(prev.size());
            fm_extend_many_back(fm, prev.data(), (int)prev.size(), c,
                                vext.data());
            use_vec = true;
            prof_count(5, (long long)prev.size());
        }
#endif
        if (!use_vec && c >= 0 && fm.ilv2 && prev.size() > 1) {
            // scalar path: the extensions of this step are independent
            // lookups at addresses known upfront — prefetch every
            // interval's occ blocks so their cache misses overlap (the
            // vector path's plain loads make this redundant there)
            for (size_t j = 0; j < prev.size(); ++j) {
                int64_t xq = prev[j].x0;
                int64_t ka = xq - 1 - (xq - 1 > fm.primary ? 1 : 0);
                int64_t kb = xq - 1 + prev[j].s;
                kb -= (kb > fm.primary ? 1 : 0);
                __builtin_prefetch(fm.ilv2 + ((ka >> 6) << 5), 0, 1);
                __builtin_prefetch(fm.ilv2 + ((kb >> 6) << 5), 0, 1);
            }
        }
        prof_count(2);
        prof_count(1, c >= 0 ? (long long)prev.size() : 0);
        for (size_t j = 0; j < prev.size(); ++j) {
            const Intv &p = prev[j];
            bool have_ok = false;
            if (c >= 0) {
                if (use_vec) ok[c] = vext[j];
                else fm_extend_one(fm, p, c, ok[c], true);
                have_ok = true;
            }
            if (c < 0 || ok[c].s < min_intv) {
                if (curr.empty()) {
                    if (out.empty() || i + 1 < out.back().first)
                        out.push_back({(int32_t)(i + 1), p});
                }
            } else if (curr.empty() || ok[c].s != curr.back().s) {
                Intv e = ok[c];
                e.end = p.end;
                curr.push_back(e);
            }
            (void)have_ok;
        }
        if (curr.empty()) break;
        prev.swap(curr);
    }
    for (auto it = out.rbegin(); it != out.rend(); ++it)
        mem.push_back({it->first, it->second.end, it->second.x0,
                       it->second.x1, it->second.s});
}

#ifdef BT_HAVE_AVX512_OCC
// Two smem_backward walks step-locked: the backward pass is a dependent
// chain (each step's ranks come from the previous step's intervals), so a
// single walk exposes one cache-miss latency per step.  Interleaving two
// independent calls' walks overlaps their misses; their per-step vector
// batches are concatenated (classes stay per-call-uniform, so the
// variable-class kernel takes lanes from both).  Bit-exact with running
// smem_backward(a) then smem_backward(b).
// Extended-interval fields for np (<=16) lanes of one backward step, all
// lanes sharing class c: reads the batch counts (ek/gk/el/gl slices) and
// prev's AoS fields via qword gathers, writes SoA s/x0/x1 (arrays of 16).
// Bit-exact with the scalar tail of fm_extend_many_back.
static inline void intv_fields_x8(const StrandFM &fm, const Intv *prev,
                                  int np, int c,
                                  const int64_t *bek, const int64_t *bgk,
                                  const int64_t *bel, const int64_t *bgl,
                                  int64_t *s_a, int64_t *x0_a, int64_t *x1_a) {
    const __m512i vprim = _mm512_set1_epi64(fm.primary);
    const __m512i vl2 = _mm512_set1_epi64(fm.L2[c] + 1);
    const __m512i idx = _mm512_setr_epi64(0, 4, 8, 12, 16, 20, 24, 28);
    for (int j = 0; j < np; j += 8) {
        int m = np - j < 8 ? np - j : 8;
        __mmask8 mk = (__mmask8)((1u << m) - 1);
        const long long *pb = (const long long *)(prev + j);
        const __m512i z = _mm512_setzero_si512();
        __m512i px0 = _mm512_mask_i64gather_epi64(z, mk, idx, pb + 0, 8);
        __m512i px1 = _mm512_mask_i64gather_epi64(z, mk, idx, pb + 1, 8);
        __m512i ps = _mm512_mask_i64gather_epi64(z, mk, idx, pb + 2, 8);
        // masked loads: base[k]+np can land within 8 of the end of the
        // 16-slot batch arrays, so an unmasked 8-lane load would read
        // past them (UB / ASan stack-overflow-read even though the
        // garbage lanes are never stored)
        __m512i vek = _mm512_maskz_loadu_epi64(mk, (const void *)(bek + j));
        __m512i vel = _mm512_maskz_loadu_epi64(mk, (const void *)(bel + j));
        __m512i vgk = _mm512_maskz_loadu_epi64(mk, (const void *)(bgk + j));
        __m512i vgl = _mm512_maskz_loadu_epi64(mk, (const void *)(bgl + j));
        __mmask8 cr = _mm512_cmple_epi64_mask(px0, vprim) &
                      _mm512_cmple_epi64_mask(
                          vprim, _mm512_sub_epi64(_mm512_add_epi64(px0, ps),
                                                  _mm512_set1_epi64(1)));
        __m512i x1v = _mm512_add_epi64(px1, _mm512_sub_epi64(vgl, vgk));
        x1v = _mm512_mask_add_epi64(x1v, cr, x1v, _mm512_set1_epi64(1));
        _mm512_storeu_si512((void *)(s_a + j), _mm512_sub_epi64(vel, vek));
        _mm512_storeu_si512((void *)(x0_a + j), _mm512_add_epi64(vl2, vek));
        _mm512_storeu_si512((void *)(x1_a + j), x1v);
    }
}

struct BackCall {
    const uint8_t *q;
    int x;
    int64_t min_intv;
    std::vector<Intv> *prev;          // reversed forward pushes (consumed)
    std::vector<Seed5> *mem;          // append target
    int32_t min_seed_len;             // append filter
};
static void smem_backward_pair(const StrandFM &fm, const BackCall *calls,
                               int ncalls) {
    struct M {
        std::vector<Intv> prev, curr;
        std::vector<std::pair<int32_t, Intv>> out;  // (start, entry)
        int i;
        bool done = false;
    };
    static thread_local M ms[2];
    static thread_local std::vector<Intv> vres[2];
    for (int k = 0; k < ncalls; ++k) {
        ms[k].prev.swap(*calls[k].prev);
        ms[k].curr.clear();
        ms[k].out.clear();
        ms[k].i = calls[k].x - 1;
        ms[k].done = false;
    }
    alignas(64) int64_t ks[16], lr[16], cs[16], ek[16], gk[16], el[16], gl[16];
    for (;;) {
        bool any = false;
        int cls[2] = {-1, -1}, base[2] = {-1, -1};
        int n = 0;
        {
        ProfScope ps(12);
        for (int k = 0; k < ncalls; ++k) {
            M &m = ms[k];
            if (m.done) continue;
            any = true;
            const uint8_t *q = calls[k].q;
            cls[k] = (m.i < 0 || q[m.i] > 3) ? -1 : q[m.i];
            if (cls[k] >= 0 && n >= 0 && n + (int)m.prev.size() <= 16) {
                base[k] = n;
                for (size_t j = 0; j < m.prev.size(); ++j, ++n) {
                    ks[n] = m.prev[j].x0 - 1;
                    lr[n] = m.prev[j].x0 - 1 + m.prev[j].s;
                    cs[n] = cls[k];
                }
            }
        }
        }
        if (!any) break;
        if (n > 0) {
            ProfScope po(13);
            for (int t = n; t < ((n + 7) & ~7); ++t) {
                ks[t] = 0; lr[t] = 0; cs[t] = 0;
            }
            for (int h = 0; h < n; h += 8) {
                occ_cg_one_x8v(fm, ks + h, cs + h, ek + h, gk + h);
                occ_cg_one_x8v(fm, lr + h, cs + h, el + h, gl + h);
            }
        }
        ProfScope pp(14);
        for (int k = 0; k < ncalls; ++k) {
            M &m = ms[k];
            if (m.done) continue;
            int c = cls[k];
            size_t np = m.prev.size();
            prof_count(2);
            prof_count(1, c >= 0 ? (long long)np : 0);
            m.curr.clear();
            if (c >= 0) {
                // extension fields as SoA: vectorized from the shared
                // batch slice, or copied from this machine's own vector
                // batch when the combined step overflowed 16 lanes
                alignas(64) int64_t sb[16], x0b[16], x1b[16];
                const int64_t *s_a = sb, *x0_a = x0b, *x1_a = x1b;
                if (base[k] >= 0) {   // shared slice: np <= 16 by batching
                    intv_fields_x8(fm, m.prev.data(), (int)np, c,
                                   ek + base[k], gk + base[k],
                                   el + base[k], gl + base[k],
                                   sb, x0b, x1b);
                } else {              // overflow: np may exceed 16
                    static thread_local std::vector<int64_t> sv, x0v, x1v;
                    sv.resize(np); x0v.resize(np); x1v.resize(np);
                    vres[k].resize(np);
                    fm_extend_many_back(fm, m.prev.data(), (int)np, c,
                                        vres[k].data());
                    for (size_t j = 0; j < np; ++j) {
                        sv[j] = vres[k][j].s;
                        x0v[j] = vres[k][j].x0;
                        x1v[j] = vres[k][j].x1;
                    }
                    s_a = sv.data(); x0_a = x0v.data(); x1_a = x1v.data();
                }
                prof_count(5, (long long)np);
                // prev is nested (longest match = smallest interval first)
                // with strictly ascending sizes, and backward extension
                // preserves containment, so extended sizes ascend along j:
                // dying lanes (s < min_intv) form a PREFIX and the
                // distinct-size dedup only ever compares with the last
                // kept size. One branch-light pass replaces the generic
                // curr-rebuild loop.
                // The pass depends on that ascending invariant: check it
                // under the profiler so a future seeder change that breaks
                // it dies loudly instead of silently diverging from the
                // oracle (mid-array dying lanes would be kept as live).
                if (g_prof_on)
                    for (size_t jj = 1; jj < np; ++jj)
                        if (s_a[jj] < s_a[jj - 1]) {
                            fprintf(stderr, "[bt] BUG: backward-extend "
                                    "sizes not ascending (j=%zu)\n", jj);
                            abort();
                        }
                size_t j = 0;
                while (j < np && s_a[j] < calls[k].min_intv) ++j;
                if (j > 0 && (m.out.empty() || m.i + 1 < m.out.back().first))
                    m.out.push_back({(int32_t)(m.i + 1), m.prev[0]});
                int64_t last_s = -1;
                for (; j < np; ++j) {
                    if (s_a[j] == last_s) continue;
                    last_s = s_a[j];
                    m.curr.push_back({x0_a[j], x1_a[j], s_a[j],
                                      m.prev[j].end});
                }
            } else if (np) {
                if (m.out.empty() || m.i + 1 < m.out.back().first)
                    m.out.push_back({(int32_t)(m.i + 1), m.prev[0]});
            }
            if (m.curr.empty() || m.i < 0) m.done = true;
            else {
                m.prev.swap(m.curr);
                --m.i;
            }
        }
    }
    // emit in call order (preserves per-job seed order when both calls
    // target the same read)
    for (int k = 0; k < ncalls; ++k) {
        for (auto it = ms[k].out.rbegin(); it != ms[k].out.rend(); ++it)
            if (it->second.end - it->first >= calls[k].min_seed_len)
                calls[k].mem->push_back({it->first, it->second.end,
                                         it->second.x0, it->second.x1,
                                         it->second.s});
    }
}
#endif

static int seed_strategy1(const StrandFM &fm, const StrandFM &fmc,
                          const uint8_t *q, int len, int x, int min_len,
                          int64_t max_intv, Seed5 &m) {
    m = Seed5{0, 0, 0, 0, 0};
    if (q[x] > 3) return x + 1;
    int c0 = q[x];
    Intv ik{fm.L2[c0] + 1, fmc.L2[3 - c0] + 1, fm.L2[c0 + 1] - fm.L2[c0], 0};
    Intv ok[4];
    for (int i = x + 1; i < len; ++i) {
        if (q[i] < 4) {
            int c = 3 - q[i];
            prof_count(4);
            fm_extend_one(fmc, ik, c, ok[c], false);
            if (ok[c].s < max_intv && i - x >= min_len) {
                m = Seed5{(int32_t)x, (int32_t)(i + 1), ok[c].x0, ok[c].x1, ok[c].s};
                return i + 1;
            }
            ik = ok[c];
        } else return i + 1;
    }
    return len;
}

static void collect_intv(const Opt &opt, const StrandFM &fm, const StrandFM &fmc,
                         const uint8_t *q, int len, std::vector<Seed5> &mem) {
    mem.clear();
    // MEM_F_SELF_OVLP requires >= 2 occurrences in the first pass so a
    // read's own locus does not seed (memchain.c:54, smem.py:107)
    int start_width = (opt.flag & 0x40) ? 2 : 1;
    int split_len = (int)(opt.min_seed_len * opt.split_factor + 0.499);
    std::vector<Seed5> tmp;
    int x = 0;
    while (x < len) {
        if (q[x] < 4) {
            x = smem1a(fm, fmc, q, len, x, start_width, tmp);
            for (auto &s : tmp)
                if (s.end - s.start >= opt.min_seed_len) mem.push_back(s);
        } else ++x;
    }
    size_t old_n = mem.size();
    for (size_t k = 0; k < old_n; ++k) {
        Seed5 p = mem[k];
        if (p.end - p.start < split_len || p.s > opt.split_width) continue;
        smem1a(fm, fmc, q, len, (p.start + p.end) >> 1, p.s + 1, tmp);
        for (auto &s : tmp)
            if (s.end - s.start >= opt.min_seed_len) mem.push_back(s);
    }
    if (opt.max_mem_intv > 0) {
        x = 0;
        Seed5 m;
        while (x < len) {
            if (q[x] < 4) {
                x = seed_strategy1(fm, fmc, q, len, x, opt.min_seed_len,
                                   opt.max_mem_intv, m);
                if (m.s > 0) mem.push_back(m);
            } else ++x;
        }
    }
    std::stable_sort(mem.begin(), mem.end(), [](const Seed5 &a, const Seed5 &b) {
        return ((uint64_t)(uint32_t)a.start << 32 | (uint32_t)a.end) <
               ((uint64_t)(uint32_t)b.start << 32 | (uint32_t)b.end);
    });
}

// ------------------------------------------- interleaved SMEM seeding
//
// collect_intv is a dependent pointer-chase over occ blocks: each
// fm_extend_one's loads feed the next step's addresses, so one read's walk
// runs at cache-miss latency (~56 ns/step L3-scale, ~290 ns DRAM-scale on
// this host; tools/bench_mlp.cpp). Different (read, parent) tasks are
// independent, so a thread runs K of them as coroutine lanes: each lane
// issues prefetches for its next occ block(s), suspends, and the scheduler
// round-robins the other lanes while the lines arrive — the measured MLP
// headroom is 4.2x (L3) to 6.8x (DRAM). The coroutine bodies below are
// mechanical transforms of smem1a/seed_strategy1/collect_intv with
// co_await at each dependent-fetch point; output must stay byte-identical
// (same push order), which the oracle e2e matrix verifies.

struct SeedLane {
    std::coroutine_handle<> cur{};
    bool done = true;
};

// coroutine frames are allocated per smem1a/seed_strategy1 call (hot path):
// recycle them in a per-thread freelist keyed by exact frame size (only a
// handful of distinct sizes exist — one per coroutine function)
struct FrameCache {
    struct Slot { size_t sz = 0; void *head = nullptr; };
    Slot slots[8];
    void *alloc(size_t sz) {
        for (auto &s : slots)
            if (s.sz == sz && s.head) {
                void *p = s.head;
                s.head = *(void **)p;
                return p;
            }
        return ::operator new(sz);
    }
    void free(void *p, size_t sz) {
        for (auto &s : slots) {
            if (s.sz == 0) s.sz = sz;
            if (s.sz == sz) {
                *(void **)p = s.head;
                s.head = p;
                return;
            }
        }
        ::operator delete(p);
    }
    ~FrameCache() {
        for (auto &s : slots)
            while (s.head) {
                void *p = s.head;
                s.head = *(void **)p;
                ::operator delete(p);
            }
    }
};
static thread_local FrameCache g_frame_cache;

struct CoTask {
    struct promise_type;
    using Handle = std::coroutine_handle<promise_type>;
    struct FinalAwaiter {
        bool await_ready() noexcept { return false; }
        std::coroutine_handle<> await_suspend(Handle h) noexcept;
        void await_resume() noexcept {}
    };
    struct Fetch {};  // co_await Fetch{}: suspend until the scheduler's next
                      // round (prefetches for this lane were just issued)
    struct promise_type {
        std::coroutine_handle<> cont{};  // parent frame (null for a root)
        SeedLane *lane = nullptr;
        CoTask get_return_object() {
            return CoTask{Handle::from_promise(*this)};
        }
        std::suspend_always initial_suspend() noexcept { return {}; }
        FinalAwaiter final_suspend() noexcept { return {}; }
        void return_void() {}
        void unhandled_exception() { std::terminate(); }
        static void *operator new(size_t sz) { return g_frame_cache.alloc(sz); }
        static void operator delete(void *p, size_t sz) {
            g_frame_cache.free(p, sz);
        }
        struct FetchAwaiter {
            promise_type *p;
            bool await_ready() noexcept { return false; }
            void await_suspend(std::coroutine_handle<> h) noexcept {
                p->lane->cur = h;  // scheduler resumes this exact frame
            }
            void await_resume() noexcept {}
        };
        FetchAwaiter await_transform(Fetch) noexcept { return {this}; }
        struct ChildAwaiter {
            Handle child;
            bool await_ready() noexcept { return false; }
            std::coroutine_handle<> await_suspend(
                std::coroutine_handle<> parent) noexcept {
                child.promise().cont = parent;
                return child;  // symmetric transfer into the child
            }
            void await_resume() noexcept { child.destroy(); }
        };
        ChildAwaiter await_transform(CoTask &&t) noexcept {
            t.h.promise().lane = lane;
            return {t.h};
        }
    };
    Handle h;
};

inline std::coroutine_handle<> CoTask::FinalAwaiter::await_suspend(
    CoTask::Handle h) noexcept {
    auto &p = h.promise();
    if (p.cont) return p.cont;  // back into the parent frame
    p.lane->done = true;        // root finished: tell the scheduler
    return std::noop_coroutine();
}

struct SeedScratch {
    std::vector<Intv> curr, prev;
    std::vector<std::pair<int32_t, Intv>> out;
    std::vector<Seed5> tmp;
};

// prefetch the occ block(s) fm_extend_one(f, ik, ., is_back) will read
static inline void prefetch_extend(const StrandFM &f, const Intv &ik,
                                   bool is_back) {
    if (!f.ilv2) return;
    int64_t xq = is_back ? ik.x0 : ik.x1;
    int64_t ka = xq - 1;
    ka -= (ka >= f.primary ? 1 : 0);
    int64_t kb = xq - 1 + ik.s;
    kb -= (kb >= f.primary ? 1 : 0);
    __builtin_prefetch(f.ilv2 + ((ka >> 6) << 5), 0, 1);
    __builtin_prefetch(f.ilv2 + ((kb >> 6) << 5), 0, 1);
}

// smem1a with a co_await at every dependent occ fetch; logic identical.
static CoTask smem1a_il(const StrandFM &fm, const StrandFM &fmc,
                        const uint8_t *q, int len, int x, int64_t min_intv,
                        std::vector<Seed5> &mem, SeedScratch &sc,
                        int *ret_out) {
    mem.clear();
    if (q[x] > 3) { *ret_out = x + 1; co_return; }
    if (min_intv < 1) min_intv = 1;
    int c0 = q[x];
    Intv ik{fm.L2[c0] + 1, fmc.L2[3 - c0] + 1, fm.L2[c0 + 1] - fm.L2[c0],
            (int32_t)(x + 1)};
    auto &curr = sc.curr;
    auto &prev = sc.prev;
    auto &out = sc.out;
    curr.clear();
    prev.clear();
    out.clear();
    int i = x + 1;
    Intv ok[4];
    for (; i < len; ++i) {
        if (q[i] < 4) {
            int c = 3 - q[i];
            prefetch_extend(fmc, ik, false);
            co_await CoTask::Fetch{};
            fm_extend_one(fmc, ik, c, ok[c], false);
            if (ok[c].s != ik.s) {
                curr.push_back(ik);
                if (ok[c].s < min_intv) break;
            }
            ik = ok[c];
            ik.end = i + 1;
        } else {
            curr.push_back(ik);
            break;
        }
    }
    if (i == len) curr.push_back(ik);
    std::reverse(curr.begin(), curr.end());
    *ret_out = curr[0].end;
    prev.swap(curr);

    for (i = x - 1; i >= -1; --i) {
        int c = (i < 0 || q[i] > 3) ? -1 : q[i];
        curr.clear();
        if (c >= 0) {
            for (size_t j = 0; j < prev.size(); ++j)
                prefetch_extend(fm, prev[j], true);
            co_await CoTask::Fetch{};
        }
        for (size_t j = 0; j < prev.size(); ++j) {
            const Intv &p = prev[j];
            if (c >= 0) fm_extend_one(fm, p, c, ok[c], true);
            if (c < 0 || ok[c].s < min_intv) {
                if (curr.empty()) {
                    if (out.empty() || i + 1 < out.back().first)
                        out.push_back({(int32_t)(i + 1), p});
                }
            } else if (curr.empty() || ok[c].s != curr.back().s) {
                Intv e = ok[c];
                e.end = p.end;
                curr.push_back(e);
            }
        }
        if (curr.empty()) break;
        prev.swap(curr);
    }
    for (auto it = out.rbegin(); it != out.rend(); ++it)
        mem.push_back({it->first, it->second.end, it->second.x0,
                       it->second.x1, it->second.s});
}

static CoTask seed_strategy1_il(const StrandFM &fm, const StrandFM &fmc,
                                const uint8_t *q, int len, int x, int min_len,
                                int64_t max_intv, Seed5 *m, int *ret_out) {
    *m = Seed5{0, 0, 0, 0, 0};
    if (q[x] > 3) { *ret_out = x + 1; co_return; }
    int c0 = q[x];
    Intv ik{fm.L2[c0] + 1, fmc.L2[3 - c0] + 1, fm.L2[c0 + 1] - fm.L2[c0], 0};
    Intv ok[4];
    for (int i = x + 1; i < len; ++i) {
        if (q[i] < 4) {
            int c = 3 - q[i];
            prefetch_extend(fmc, ik, false);
            co_await CoTask::Fetch{};
            fm_extend_one(fmc, ik, c, ok[c], false);
            if (ok[c].s < max_intv && i - x >= min_len) {
                *m = Seed5{(int32_t)x, (int32_t)(i + 1), ok[c].x0, ok[c].x1,
                           ok[c].s};
                *ret_out = i + 1;
                co_return;
            }
            ik = ok[c];
        } else {
            *ret_out = i + 1;
            co_return;
        }
    }
    *ret_out = len;
}

static CoTask collect_intv_il(const Opt &opt, const StrandFM &fm,
                              const StrandFM &fmc, const uint8_t *q, int len,
                              std::vector<Seed5> &mem, SeedScratch &sc) {
    mem.clear();
    int start_width = (opt.flag & 0x40) ? 2 : 1;
    int split_len = (int)(opt.min_seed_len * opt.split_factor + 0.499);
    std::vector<Seed5> &tmp = sc.tmp;
    int x = 0;
    while (x < len) {
        if (q[x] < 4) {
            int ret;
            co_await smem1a_il(fm, fmc, q, len, x, start_width, tmp, sc,
                               &ret);
            x = ret;
            for (auto &s : tmp)
                if (s.end - s.start >= opt.min_seed_len) mem.push_back(s);
        } else ++x;
    }
    size_t old_n = mem.size();
    for (size_t k = 0; k < old_n; ++k) {
        Seed5 p = mem[k];
        if (p.end - p.start < split_len || p.s > opt.split_width) continue;
        int ret;
        co_await smem1a_il(fm, fmc, q, len, (p.start + p.end) >> 1, p.s + 1,
                           tmp, sc, &ret);
        for (auto &s : tmp)
            if (s.end - s.start >= opt.min_seed_len) mem.push_back(s);
    }
    if (opt.max_mem_intv > 0) {
        x = 0;
        Seed5 m;
        while (x < len) {
            if (q[x] < 4) {
                int ret;
                co_await seed_strategy1_il(fm, fmc, q, len, x,
                                           opt.min_seed_len,
                                           opt.max_mem_intv, &m, &ret);
                x = ret;
                if (m.s > 0) mem.push_back(m);
            } else ++x;
        }
    }
    std::stable_sort(mem.begin(), mem.end(), [](const Seed5 &a, const Seed5 &b) {
        return ((uint64_t)(uint32_t)a.start << 32 | (uint32_t)a.end) <
               ((uint64_t)(uint32_t)b.start << 32 | (uint32_t)b.end);
    });
}

// one (read, parent) seeding job for the interleaved scheduler
struct SeedJob {
    const StrandFM *fm, *fmc;
    const uint8_t *q;  // converted read codes
    int len;
    std::vector<Seed5> *mem;
};

#ifdef BT_HAVE_AVX512_OCC
// ---------------- SIMD lockstep seeding over a chunk -----------------
//
// The expensive primitive of every SMEM pass is a single-class occ pair.
// The backward pass vectorizes within one read (all intervals share the
// step character; fm_extend_many_back).  The FORWARD chains are width-1
// and sequential within one (read,parent) job, but chains of DIFFERENT
// jobs are independent — so 8 of them run in lockstep: one variable-class
// vector occ (occ_cg_one_x8v) per step, per-lane scalar bookkeeping.
// Result order is untouched: pass-1 forward calls are recorded and their
// backward halves replayed per job in call order, pass-2 tasks in
// (job, seed) order, pass-3 discoveries in scan order — so each job's
// seed vector is byte-identical to collect_intv's (A/B-checked in
// tests/test_native_engine.py and the oracle E2E matrix).
static void lockstep_slice(const Opt &opt, const std::vector<SeedJob> &jobs,
                           const std::vector<int> &group) {
    const SeedJob &J0 = jobs[group[0]];
    const StrandFM &fm = *J0.fm, &fmc = *J0.fmc;
    const int64_t start_width = (opt.flag & 0x40) ? 2 : 1;
    const int split_len = (int)(opt.min_seed_len * opt.split_factor + 0.499);

    struct LsCall { int job; int x; int off, n; };  // curr slice in `flat`
    static thread_local std::vector<Intv> flat;
    static thread_local std::vector<LsCall> calls;
    static thread_local std::vector<Intv> prevbuf;
    static thread_local std::vector<Seed5> tmp;
    flat.clear();
    calls.clear();

    struct Lane {
        int job = -1;        // index into jobs; -1 = idle
        bool open = false;   // a forward chain is in flight
        int x = 0, i = 0;
        int64_t min_intv = 1;
        Intv ik;
        std::vector<Intv> curr;
    };
    constexpr int LS_LANES = 16;
    Lane ls[LS_LANES];
    size_t next_job = 0;

    // ---- phase A: pass-1 forward chains, 8 jobs in lockstep
    auto close_chain = [&](Lane &st) {
        st.curr.push_back(st.ik);
        calls.push_back({st.job, st.x, (int)flat.size(), (int)st.curr.size()});
        flat.insert(flat.end(), st.curr.begin(), st.curr.end());
        st.x = st.curr.back().end;  // smem1a's ret = last-pushed end
        st.open = false;
    };
    // advance lane until it needs a vector extend (returns true) or idles
    auto settleA = [&](Lane &st) -> bool {
        for (;;) {
            if (st.job < 0) {
                if (next_job >= group.size()) return false;
                st.job = group[next_job++];
                st.x = 0;
                st.open = false;
            }
            const SeedJob &J = jobs[st.job];
            if (!st.open) {
                while (st.x < J.len && J.q[st.x] > 3) ++st.x;
                if (st.x >= J.len) { st.job = -1; continue; }
                int c0 = J.q[st.x];
                st.ik = Intv{fm.L2[c0] + 1, fmc.L2[3 - c0] + 1,
                             fm.L2[c0 + 1] - fm.L2[c0], (int32_t)(st.x + 1)};
                st.i = st.x + 1;
                st.min_intv = start_width;
                st.curr.clear();
                st.open = true;
                prof_count(3);
            }
            if (st.i >= J.len || J.q[st.i] > 3) { close_chain(st); continue; }
            return true;
        }
    };
    alignas(64) int64_t ks[LS_LANES], lr[LS_LANES], cs[LS_LANES],
        ek[LS_LANES], gk[LS_LANES], el[LS_LANES], gl[LS_LANES];
    // shared by phases A/C/D: one lockstep vector step over the active
    // lanes; consume() applies the extension o to lane t.  LS_LANES (16)
    // is 2 vector widths: the chains are latency-bound dependent walks, so
    // extra lanes in flight buy memory-level parallelism.
    auto run_pool = [&](auto &&settle, auto &&consume) {
        int live = 0;
        for (int t = 0; t < LS_LANES; ++t) live += settle(ls[t]) ? 1 : 0;
        while (live) {
            int act[LS_LANES], m = 0;
            for (int t = 0; t < LS_LANES; ++t) {
                Lane &st = ls[t];
                if (st.job < 0 || !st.open) continue;
                const SeedJob &J = jobs[st.job];
                act[m] = t;
                ks[m] = st.ik.x1 - 1;
                lr[m] = st.ik.x1 - 1 + st.ik.s;
                cs[m] = 3 - J.q[st.i];
                ++m;
            }
            for (int t = m; t < LS_LANES; ++t) { ks[t] = 0; lr[t] = 0; cs[t] = 0; }
            for (int h = 0; h < m; h += 8) {
                occ_cg_one_x8v(fmc, ks + h, cs + h, ek + h, gk + h);
                occ_cg_one_x8v(fmc, lr + h, cs + h, el + h, gl + h);
            }
            live = 0;
            for (int j = 0; j < m; ++j) {
                Lane &st = ls[act[j]];
                int c = (int)cs[j];
                int64_t xq = st.ik.x1;
                int64_t crosses = (xq <= fmc.primary &&
                                   xq + st.ik.s - 1 >= fmc.primary) ? 1 : 0;
                Intv o;
                o.s = el[j] - ek[j];
                o.x0 = st.ik.x0 + crosses + (gl[j] - gk[j]);
                o.x1 = fmc.L2[c] + 1 + ek[j];
                o.end = st.ik.end;
                consume(st, o, c);
                live += settle(st) ? 1 : 0;
            }
            for (int t = 0; t < LS_LANES; ++t)  // idled lanes may refill now
                if (ls[t].job < 0) live += settle(ls[t]) ? 1 : 0;
        }
    };
    {
    ProfScope pA(8);
    run_pool(settleA, [&](Lane &st, const Intv &o, int) {
        prof_count(0);
        if (o.s != st.ik.s) {
            st.curr.push_back(st.ik);
            if (o.s < st.min_intv) {
                calls.push_back({st.job, st.x, (int)flat.size(),
                                 (int)st.curr.size()});
                flat.insert(flat.end(), st.curr.begin(), st.curr.end());
                st.x = st.curr.back().end;
                st.open = false;
                return;
            }
        }
        st.ik = o;
        st.ik.end = st.i + 1;
        ++st.i;
    });
    }

    // ---- phase B: backward halves replayed per job in call order,
    // two records step-locked so their dependent-chain misses overlap
    ProfScope *pB = new ProfScope(9);
    for (int g : group) jobs[g].mem->clear();
    static thread_local std::vector<Intv> pb[2];
    for (size_t r = 0; r < calls.size(); r += 2) {
        int nc = (int)std::min<size_t>(2, calls.size() - r);
        BackCall bc[2];
        for (int k = 0; k < nc; ++k) {
            const LsCall &rc = calls[r + k];
            pb[k].assign(flat.begin() + rc.off, flat.begin() + rc.off + rc.n);
            std::reverse(pb[k].begin(), pb[k].end());
            bc[k] = BackCall{jobs[rc.job].q, rc.x, start_width, &pb[k],
                             jobs[rc.job].mem, opt.min_seed_len};
        }
        smem_backward_pair(fm, bc, nc);
    }

    delete pB;
    // ---- phase C: pass-2 re-seeds (lane = independent task, no refill
    // sequencing: eligibility comes from the pass-1 snapshot)
    struct P2Task { int job; int x; int64_t min_intv; };
    static thread_local std::vector<P2Task> p2;
    p2.clear();
    for (int g : group) {
        std::vector<Seed5> &mem = *jobs[g].mem;
        size_t old_n = mem.size();
        for (size_t k = 0; k < old_n; ++k) {
            const Seed5 &p = mem[k];
            if (p.end - p.start < split_len || p.s > opt.split_width) continue;
            p2.push_back({g, (p.start + p.end) >> 1, p.s + 1});
        }
    }
    if (!p2.empty()) {
        ProfScope pC(10);
        flat.clear();
        calls.clear();
        static thread_local std::vector<int> rec_of_task;  // -1 = no seeds
        rec_of_task.assign(p2.size(), -1);
        size_t next_task = 0;
        static thread_local std::vector<int> lane_task(LS_LANES);
        auto settleC = [&](Lane &st) -> bool {
            for (;;) {
                if (!st.open) {
                    if (next_task >= p2.size()) { st.job = -1; return false; }
                    const P2Task &tk = p2[next_task];
                    lane_task[&st - ls] = (int)next_task;
                    ++next_task;
                    const SeedJob &J = jobs[tk.job];
                    st.job = tk.job;
                    st.x = tk.x;
                    st.min_intv = tk.min_intv < 1 ? 1 : tk.min_intv;
                    if (J.q[st.x] > 3) continue;  // smem1a early-out: no seeds
                    int c0 = J.q[st.x];
                    st.ik = Intv{fm.L2[c0] + 1, fmc.L2[3 - c0] + 1,
                                 fm.L2[c0 + 1] - fm.L2[c0],
                                 (int32_t)(st.x + 1)};
                    st.i = st.x + 1;
                    st.curr.clear();
                    st.open = true;
                    prof_count(3);
                }
                const SeedJob &J = jobs[st.job];
                if (st.i >= J.len || J.q[st.i] > 3) {
                    st.curr.push_back(st.ik);
                    rec_of_task[lane_task[&st - ls]] = (int)calls.size();
                    calls.push_back({st.job, st.x, (int)flat.size(),
                                     (int)st.curr.size()});
                    flat.insert(flat.end(), st.curr.begin(), st.curr.end());
                    st.open = false;
                    continue;
                }
                return true;
            }
        };
        for (int t = 0; t < LS_LANES; ++t) { ls[t].job = -1; ls[t].open = false; }
        run_pool(settleC, [&](Lane &st, const Intv &o, int) {
            prof_count(0);
            if (o.s != st.ik.s) {
                st.curr.push_back(st.ik);
                if (o.s < st.min_intv) {
                    rec_of_task[lane_task[&st - ls]] = (int)calls.size();
                    calls.push_back({st.job, st.x, (int)flat.size(),
                                     (int)st.curr.size()});
                    flat.insert(flat.end(), st.curr.begin(), st.curr.end());
                    st.open = false;
                    return;
                }
            }
            st.ik = o;
            st.ik.end = st.i + 1;
            ++st.i;
        });
        static thread_local std::vector<int> live_tasks;
        live_tasks.clear();
        for (size_t ti = 0; ti < p2.size(); ++ti)
            if (rec_of_task[ti] >= 0) live_tasks.push_back((int)ti);
        for (size_t r = 0; r < live_tasks.size(); r += 2) {
            int nc = (int)std::min<size_t>(2, live_tasks.size() - r);
            BackCall bc[2];
            for (int k = 0; k < nc; ++k) {
                int ti = live_tasks[r + k];
                const LsCall &rc = calls[rec_of_task[ti]];
                pb[k].assign(flat.begin() + rc.off,
                             flat.begin() + rc.off + rc.n);
                std::reverse(pb[k].begin(), pb[k].end());
                bc[k] = BackCall{jobs[rc.job].q, rc.x, p2[ti].min_intv,
                                 &pb[k], jobs[rc.job].mem, opt.min_seed_len};
            }
            smem_backward_pair(fm, bc, nc);
        }
    }

    // ---- phase D: strategy-1 reseeding (pure forward, no backward)
    if (opt.max_mem_intv > 0) {
        ProfScope pD(11);
        next_job = 0;
        for (int t = 0; t < LS_LANES; ++t) { ls[t].job = -1; ls[t].open = false; }
        auto settleD = [&](Lane &st) -> bool {
            for (;;) {
                if (st.job < 0) {
                    if (next_job >= group.size()) return false;
                    st.job = group[next_job++];
                    st.x = 0;
                    st.open = false;
                }
                const SeedJob &J = jobs[st.job];
                if (!st.open) {
                    // q[x]>3 makes seed_strategy1 return x+1 == a plain scan
                    while (st.x < J.len && J.q[st.x] > 3) ++st.x;
                    if (st.x >= J.len) { st.job = -1; continue; }
                    int c0 = J.q[st.x];
                    st.ik = Intv{fm.L2[c0] + 1, fmc.L2[3 - c0] + 1,
                                 fm.L2[c0 + 1] - fm.L2[c0], 0};
                    st.i = st.x + 1;
                    st.open = true;
                }
                if (st.i >= J.len) { st.x = J.len; st.open = false; continue; }
                if (J.q[st.i] > 3) { st.x = st.i + 1; st.open = false; continue; }
                return true;
            }
        };
        run_pool(settleD, [&](Lane &st, const Intv &o, int) {
            prof_count(4);
            if (o.s < opt.max_mem_intv && st.i - st.x >= opt.min_seed_len) {
                if (o.s > 0)
                    jobs[st.job].mem->push_back(
                        {(int32_t)st.x, (int32_t)(st.i + 1), o.x0, o.x1, o.s});
                st.x = st.i + 1;
                st.open = false;
            } else {
                st.ik = o;
                ++st.i;
            }
        });
    }

    for (int g : group)
        std::stable_sort(jobs[g].mem->begin(), jobs[g].mem->end(),
                         [](const Seed5 &a, const Seed5 &b) {
            return ((uint64_t)(uint32_t)a.start << 32 | (uint32_t)a.end) <
                   ((uint64_t)(uint32_t)b.start << 32 | (uint32_t)b.end);
        });
}

// Bounded slices: the single-thread path seeds the whole batch as one
// group; the forward-call records (`flat`) must not grow with it.
static void collect_intv_lockstep(const Opt &opt,
                                  const std::vector<SeedJob> &jobs,
                                  const std::vector<int> &group) {
    constexpr size_t SLICE = 256;
    if (group.size() <= SLICE) { lockstep_slice(opt, jobs, group); return; }
    for (size_t s0 = 0; s0 < group.size(); s0 += SLICE) {
        std::vector<int> sub(group.begin() + s0,
                             group.begin() + std::min(s0 + SLICE, group.size()));
        lockstep_slice(opt, jobs, sub);
    }
}
#endif  // BT_HAVE_AVX512_OCC

static void collect_intv_interleaved(const Opt &opt,
                                     const std::vector<SeedJob> &jobs) {
    constexpr int LANES = 16;
    if (jobs.empty()) return;
    // BISCUIT_TPU_SEED_IL=1/0 forces the coroutine interleave on/off.
    // Unset -> AUTO by index scale: at 5-50 Mbp the interleave is
    // byte-identical but ~5-20% slower (the forward chain hits cache and
    // the ~35 ns/suspend overhead wins), and at a 400 M-char strand the
    // AVX-512 lockstep seeder still leads by ~16% — but on a wide
    // (>= 2^31-char) strand the 15+ GB occ tables are purely DRAM-bound
    // and the interleave measured 3.8x FASTER than lockstep (3.1 Gbp,
    // 100k reads: 92.0 s -> 24.1 s at -@4). Auto enables it exactly
    // there (r4 measurement, docs/SCALING.md).
    static const char *il_env = getenv("BISCUIT_TPU_SEED_IL");
    const bool il_auto = !jobs.empty() &&
                         jobs[0].fm->seq_len > 0x7FFFFFFFLL;
    const bool il_on = il_env ? (il_env[0] == '1') : il_auto;
#ifdef BT_HAVE_AVX512_OCC
    // Default on AVX-512 hosts: the SIMD lockstep seeder (byte-identical
    // seeds, ~vectorized forward chains). BISCUIT_TPU_SEED_LS=0 disables;
    // BISCUIT_TPU_SEED_IL=1 (coroutines) takes precedence when set.
    static const bool ls_on = !(getenv("BISCUIT_TPU_SEED_LS") &&
                                getenv("BISCUIT_TPU_SEED_LS")[0] == '0');
    if (ls_on && !il_on && jobs.size() >= 2) {
        bool all_ilv2 = true;
        for (auto &j : jobs)
            if (!j.fm->ilv2 || !j.fmc->ilv2) { all_ilv2 = false; break; }
        if (all_ilv2) {
            std::vector<int> g0, g1;  // one pool per (fm,fmc) strand pair
            for (int i = 0; i < (int)jobs.size(); ++i)
                (jobs[i].fm == jobs[0].fm ? g0 : g1).push_back(i);
            if (!g0.empty()) collect_intv_lockstep(opt, jobs, g0);
            if (!g1.empty()) collect_intv_lockstep(opt, jobs, g1);
            return;
        }
    }
#endif
    if (jobs.size() < 2 || !jobs[0].fm->ilv2 || !il_on) {
        for (auto &j : jobs) collect_intv(opt, *j.fm, *j.fmc, j.q, j.len, *j.mem);
        return;
    }
    int nl = std::min<int>(LANES, (int)jobs.size());
    static thread_local SeedScratch scratch[LANES];
    SeedLane lanes[LANES];
    CoTask::Handle roots[LANES];
    size_t next = 0;
    int live = 0;
    auto start = [&](int li) {
        if (next >= jobs.size()) return;
        const SeedJob &j = jobs[next++];
        CoTask t = collect_intv_il(opt, *j.fm, *j.fmc, j.q, j.len, *j.mem,
                                   scratch[li]);
        t.h.promise().lane = &lanes[li];
        roots[li] = t.h;
        lanes[li].cur = t.h;
        lanes[li].done = false;
        ++live;
    };
    for (int i = 0; i < nl; ++i) start(i);
    while (live) {
        for (int i = 0; i < nl; ++i) {
            if (lanes[i].done) continue;
            lanes[i].cur.resume();
            if (lanes[i].done) {
                roots[i].destroy();
                --live;
                start(i);
            }
        }
    }
}

// ------------------------------------------------------------------ bns

struct Bns {
    const int64_t *ann_off;  // [n_seqs]
    const int64_t *ann_len;  // int64: one contig may exceed 2^31 (reference caps at int32, bntann1_t)
    const uint8_t *ann_alt;
    int32_t n_seqs;
    const uint8_t *pac;      // unpacked forward codes [l_pac]
    int64_t l_pac;
};

static int pos2rid(const Bns &b, int64_t pos_f) {
    if (pos_f >= b.l_pac) return -1;
    int left = 0, mid = 0, right = b.n_seqs;
    while (left < right) {
        mid = (left + right) >> 1;
        if (pos_f >= b.ann_off[mid]) {
            if (mid == b.n_seqs - 1) break;
            if (pos_f < b.ann_off[mid + 1]) break;
            left = mid + 1;
        } else right = mid;
    }
    return mid;
}

static int64_t depos(const Bns &b, int64_t pos, bool &is_rev) {
    is_rev = pos >= b.l_pac;
    return is_rev ? (b.l_pac << 1) - 1 - pos : pos;
}

static int intv2rid(const Bns &b, int64_t rb, int64_t re) {
    if (rb < b.l_pac && b.l_pac < re) return -2;
    bool rev;
    int rid_b = pos2rid(b, depos(b, rb, rev));
    int rid_e = rb < re ? pos2rid(b, depos(b, re - 1, rev)) : rid_b;
    return rid_b == rid_e ? rid_b : -1;
}

static void get_seq(const Bns &b, int64_t beg, int64_t end, std::vector<uint8_t> &out) {
    out.clear();
    if (end < beg) std::swap(beg, end);
    if (end > b.l_pac << 1) end = b.l_pac << 1;
    if (beg < 0) beg = 0;
    if (beg >= b.l_pac || end <= b.l_pac) {
        if (beg >= b.l_pac) {
            int64_t beg_f = (b.l_pac << 1) - end;
            int64_t end_f = (b.l_pac << 1) - beg;
            out.resize(end_f - beg_f);
            for (int64_t k = end_f - 1, l = 0; k >= beg_f; --k, ++l)
                out[l] = 3 - b.pac[k];
        } else {
            out.assign(b.pac + beg, b.pac + end);
        }
    }
}

// clamp to the contig of `mid` and fetch; returns rid
static int fetch_seq(const Bns &b, int64_t &beg, int64_t mid, int64_t &end,
                     std::vector<uint8_t> &out) {
    if (end < beg) std::swap(beg, end);
    bool is_rev;
    int rid = pos2rid(b, depos(b, mid, is_rev));
    int64_t far_beg = b.ann_off[rid];
    int64_t far_end = far_beg + b.ann_len[rid];
    if (is_rev) {
        int64_t t = far_beg;
        far_beg = (b.l_pac << 1) - far_end;
        far_end = (b.l_pac << 1) - t;
    }
    if (beg < far_beg) beg = far_beg;
    if (end > far_end) end = far_end;
    get_seq(b, beg, end, out);
    return rid;
}

// -------------------------------------------------------------- SW extend

struct ExtRes { int score, qle, tle, gtle, gscore, max_off; };

#ifdef BT_HAVE_AVX512_OCC
// Vectorized row kernel for sw_extend: 16 int32 cells per step.  The
// horizontal F-chain (f = max(f - e_ins, t)) is a max-plus prefix scan —
// u[k] = t[k] + k*e_ins, f[j] = prefixmax(u)[j-1] - (j-1)*e_ins — done in
// 4 lane-shift/max steps per chunk with a scalar carry between chunks
// (the same ramp trick as ops/pallas_sw.py on TPU).  Bit-exact with the
// scalar row loop; A/B-checked per call in tests and by oracle E2E.
static inline __m512i prefix_max_incl_epi32(__m512i v) {
    const __m512i ninf = _mm512_set1_epi32(INT32_MIN / 2);
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 15));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 14));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 12));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 8));
    return v;
}

// One DP row over columns [beg, end): reads h_row (shifted: h_row[j] =
// H(i-1, j-1)) and e_row, writes H[j] and the updated e_row, returns the
// row max m and its LAST attaining index mj (scalar tie rule).  qp = the
// target-char row of the query profile; iota*e_ins ramps precomputed.
static inline void sw_row_vec(const int32_t *h_row, int32_t *e_row,
                              const int32_t *qp, int32_t *H, int beg, int end,
                              int oe_del, int e_del, int oe_ins, int e_ins,
                              int &m_out, int &mj_out) {
    const __m512i vz = _mm512_setzero_si512();
    const __m512i voedel = _mm512_set1_epi32(oe_del);
    const __m512i vedel = _mm512_set1_epi32(e_del);
    const __m512i voeins = _mm512_set1_epi32(oe_ins);
    const __m512i iota = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                           11, 12, 13, 14, 15);
    int32_t carry = (beg - 1) * e_ins;  // f[beg] = 0 by construction
    __m512i vrowmax = vz;
    for (int j = beg; j < end; j += 16) {
        int nrem = end - j;
        __mmask16 mk = nrem >= 16 ? (__mmask16)0xFFFF
                                  : (__mmask16)((1u << nrem) - 1);
        __m512i hd = _mm512_maskz_loadu_epi32(mk, h_row + j);
        __m512i E = _mm512_maskz_loadu_epi32(mk, e_row + j);
        __m512i pr = _mm512_maskz_loadu_epi32(mk, qp + j);
        __mmask16 nz = _mm512_mask_cmpneq_epi32_mask(mk, hd, vz);
        __m512i M = _mm512_maskz_add_epi32(nz, hd, pr);
        // E update (independent of f)
        __m512i tdel = _mm512_max_epi32(_mm512_sub_epi32(M, voedel), vz);
        __m512i Eo = _mm512_max_epi32(_mm512_sub_epi32(E, vedel), tdel);
        _mm512_mask_storeu_epi32(e_row + j, mk, Eo);
        // F via exclusive prefix-max of u = t_ins + j*e_ins
        __m512i jv = _mm512_add_epi32(_mm512_set1_epi32(j), iota);
        __m512i tins = _mm512_max_epi32(_mm512_sub_epi32(M, voeins), vz);
        __m512i u = _mm512_mask_add_epi32(
            _mm512_set1_epi32(INT32_MIN / 2), mk, tins,
            _mm512_mullo_epi32(jv, _mm512_set1_epi32(e_ins)));
        __m512i incl = prefix_max_incl_epi32(u);
        // the incoming carry is the max-plus state over ALL prior columns:
        // it must join every lane's exclusive scan, not just lane 0, and
        // survive into the next chunk (an F source >16 columns back can
        // dominate when gaps are cheap, e.g. -x ont2d O=E=1)
        __m512i vcar = _mm512_set1_epi32(carry);
        __m512i excl = _mm512_max_epi32(_mm512_alignr_epi32(incl, vcar, 15),
                                        vcar);
        carry = std::max(carry,
                         (int32_t)_mm512_mask_reduce_max_epi32(mk, incl));
        __m512i f = _mm512_sub_epi32(
            excl, _mm512_mullo_epi32(_mm512_sub_epi32(jv,
                                                      _mm512_set1_epi32(1)),
                                     _mm512_set1_epi32(e_ins)));
        __m512i h = _mm512_max_epi32(_mm512_max_epi32(M, E), f);
        _mm512_mask_storeu_epi32(H + j, mk, h);
        vrowmax = _mm512_mask_max_epi32(vrowmax, mk, vrowmax, h);
    }
    int m = _mm512_reduce_max_epi32(vrowmax);
    // the scalar tie rule keeps the LAST index attaining the running max
    int mj = end - 1;
    if (m > 0) {
        __m512i vm = _mm512_set1_epi32(m);
        for (int j = ((end - 1) & ~15);; j -= 16) {
            int lo = j < beg ? beg : j;
            __mmask16 mk = (__mmask16)(((1u << (end - j > 16 ? 16 : end - j))
                                        - 1) & ~((1u << (lo - j)) - 1));
            __m512i h = _mm512_maskz_loadu_epi32(mk, H + j);
            __mmask16 eq = _mm512_mask_cmpeq_epi32_mask(mk, h, vm);
            if (eq) { mj = j + 31 - __builtin_clz((unsigned)eq); break; }
            if (j <= beg) break;
        }
    }
    m_out = m;
    mj_out = mj;
}
#endif  // BT_HAVE_AVX512_OCC

// exact ops/sw.py::sw_extend semantics
static ExtRes sw_extend(const uint8_t *query, int qlen, const uint8_t *target,
                        int tlen, const int8_t *mat /*5x5*/, int o_del,
                        int e_del, int o_ins, int e_ins, int w, int end_bonus,
                        int zdrop, int h0, int vec_mode = -1) {
    int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    std::vector<int> h_row(qlen + 1, 0), e_row(qlen + 1, 0);
    h_row[0] = h0;
    if (qlen >= 1) {
        h_row[1] = h0 > oe_ins ? h0 - oe_ins : 0;
        for (int j = 2; j <= qlen && h_row[j - 1] > e_ins; ++j)
            h_row[j] = h_row[j - 1] - e_ins;
    }
    int mmax = 0;
    for (int i = 0; i < 25; ++i) mmax = std::max(mmax, (int)mat[i]);
    int max_ins = (int)((double)(qlen * mmax + end_bonus - o_ins) / e_ins + 1.0);
    max_ins = std::max(max_ins, 1);
    w = std::min(w, max_ins);
    int max_del = (int)((double)(qlen * mmax + end_bonus - o_del) / e_del + 1.0);
    max_del = std::max(max_del, 1);
    w = std::min(w, max_del);

    int max_sc = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
    int beg = 0, end = qlen;
    std::vector<int> H(qlen);
#ifdef BT_HAVE_AVX512_OCC
    // vector rows pay a 5xqlen profile build; below ~2 chunks the scalar
    // row wins (BT_SW_VEC=0 forces scalar everywhere for A/B)
    static const bool swvec_on = !(getenv("BT_SW_VEC") &&
                                   getenv("BT_SW_VEC")[0] == '0');
    const bool use_vec = vec_mode >= 0 ? vec_mode == 1
                                       : (swvec_on && qlen >= 24);
    static thread_local std::vector<int32_t> qp;
    if (use_vec) {
        qp.resize(5 * (size_t)qlen);
        for (int c = 0; c < 5; ++c)
            for (int j = 0; j < qlen; ++j)
                qp[(size_t)c * qlen + j] = mat[5 * c + query[j]];
    }
#endif
    for (int i = 0; i < tlen; ++i) {
        if (beg < i - w) beg = i - w;
        if (end > i + w + 1) end = i + w + 1;
        if (end > qlen) end = qlen;
        int h1_first = beg == 0 ? std::max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
        if (beg >= end) {
            h_row[end] = h1_first;
            e_row[end] = 0;
            if (end == qlen && gscore <= h1_first) {
                max_ie = i;
                gscore = std::max(gscore, h1_first);
            }
            break;
        }
        int m, mj;
#ifdef BT_HAVE_AVX512_OCC
        if (use_vec) {
            sw_row_vec((const int32_t *)h_row.data(), (int32_t *)e_row.data(),
                       qp.data() + (size_t)qlen * target[i],
                       (int32_t *)H.data(), beg, end, oe_del, e_del, oe_ins,
                       e_ins, m, mj);
        } else
#endif
        {
            const int8_t *prof = mat + 5 * target[i];
            int f = 0;
            m = 0; mj = -1;
            for (int j = beg; j < end; ++j) {
                int Hdiag = h_row[j];
                int E = e_row[j];
                int M = Hdiag ? Hdiag + prof[query[j]] : 0;
                int h = std::max(std::max(M, E), f);
                H[j] = h;
                if (m > h) { /* keep mj */ } else { mj = j; m = h; }
                int t = std::max(M - oe_del, 0);
                e_row[j] = std::max(E - e_del, t);
                t = std::max(M - oe_ins, 0);
                f = std::max(f - e_ins, t);
            }
        }
        int h1_last = H[end - 1];
        // shifted store
        for (int j = end; j > beg; --j) h_row[j] = H[j - 1];
        h_row[beg] = h1_first;
        e_row[end] = 0;
        if (end == qlen) {
            if (gscore <= h1_last) { max_ie = i; gscore = h1_last; }
        }
        if (m == 0) break;
        if (m > max_sc) {
            max_sc = m; max_i = i; max_j = mj;
            max_off = std::max(max_off, std::abs(mj - i));
        } else if (zdrop > 0) {
            if (i - max_i > mj - max_j) {
                if (max_sc - m - ((i - max_i) - (mj - max_j)) * e_del > zdrop) break;
            } else {
                if (max_sc - m - ((mj - max_j) - (i - max_i)) * e_ins > zdrop) break;
            }
        }
        // band shrink (scan shifted arrays; backward scan includes index end)
        int j = beg;
        while (j < end && h_row[j] == 0 && e_row[j] == 0) ++j;
        int new_beg = j;
        j = end;
        while (j >= new_beg && h_row[j] == 0 && e_row[j] == 0) --j;
        int new_end = std::min(j + 2, qlen);
        beg = new_beg;
        end = new_end;
    }
    return ExtRes{max_sc, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off};
}

// --------------------------------------------------------------- chaining

struct SeedHit { int64_t rbeg; int32_t qbeg, len, score; };

struct Chain {
    int64_t pos;
    std::vector<SeedHit> seeds, seeds_extra;
    int32_t rid;
    uint8_t is_alt;
    int32_t w = 0, kept = 0, first = -1;
    double frac_rep = 0.0;
};

static int chain_weight(const Chain &c) {
    int64_t end = 0;
    int64_t w = 0;
    for (auto &s : c.seeds) {
        if (s.qbeg >= end) w += s.len;
        else if (s.qbeg + s.len > end) w += s.qbeg + s.len - end;
        end = std::max(end, (int64_t)s.qbeg + s.len);
    }
    int64_t tmp = w;
    w = 0; end = 0;
    for (auto &s : c.seeds) {
        if (s.rbeg >= end) w += s.len;
        else if (s.rbeg + s.len > end) w += s.rbeg + s.len - end;
        end = std::max(end, s.rbeg + s.len);
    }
    w = std::min(w, tmp);
    return (int)std::min<int64_t>(w, (1 << 30) - 1);
}

static bool merge_seed_to_chain(const Opt &opt, int64_t l_pac, Chain &c,
                                const SeedHit &s, int rid) {
    const SeedHit &last = c.seeds.back();
    if (rid != c.rid) return false;
    if (s.qbeg >= c.seeds[0].qbeg && s.qbeg + s.len <= last.qbeg + last.len &&
        s.rbeg >= c.seeds[0].rbeg && s.rbeg + s.len <= last.rbeg + last.len) {
        c.seeds_extra.push_back(s);
        return true;
    }
    if ((last.rbeg < l_pac || c.seeds[0].rbeg < l_pac) && s.rbeg >= l_pac)
        return false;
    int64_t qdist = s.qbeg - last.qbeg;
    int64_t rdist = s.rbeg - last.rbeg;
    if (rdist >= 0 && qdist - rdist <= opt.w && rdist - qdist <= opt.w &&
        qdist - last.len < opt.max_chain_gap && rdist - last.len < opt.max_chain_gap) {
        c.seeds.push_back(s);
        return true;
    }
    return false;
}

// chain clustering from a precomputed sorted seed list
static void chain_from_seeds(const Opt &opt, const StrandFM &fm, const Bns &bns,
                             int len, int parent,
                             const std::vector<Seed5> &mem,
                             std::vector<Chain> &chains, double &frac_rep_out,
                             // optional device-prefetched SA positions: seed j
                             // occurrence k < sa_off[j+1]-sa_off[j] is
                             // sa_pos[sa_off[j]+k]; the tail walks fm_sa
                             const int64_t *sa_pos = nullptr,
                             const int64_t *sa_off = nullptr) {
    chains.clear();
    int64_t l_pac = bns.l_pac;
    // l_rep
    int64_t l_rep = 0, b = 0, e = 0;
    for (auto &iv : mem) {
        if (iv.s <= opt.max_occ) continue;
        if (iv.start > e) { l_rep += e - b; b = iv.start; e = iv.end; }
        else e = std::max<int64_t>(e, iv.end);
    }
    l_rep += e - b;
    frac_rep_out = (double)l_rep / len;

    std::vector<int64_t> keys;  // chain pos, sorted
    std::vector<Chain> tree;
    // Cross-seed SA pre-resolution: the per-seed tile below only batches
    // WITHIN one occurrence list, so near-unique seeds (s = 1..3 — the
    // common case on a large genome) degrade to serial invPsi walks of
    // ~sa_intv/2 dependent DRAM misses each. Resolve the first
    // min(s, PRECAP) occurrences of EVERY seed in one fm_sa_batch call:
    // the walks of different seeds overlap their misses (measured 36% of
    // human-scale align time in this slot before this pass).
    constexpr int64_t PRECAP = 8;
    std::vector<int64_t> pre_ks, pre_out;
    std::vector<int32_t> pre_at(mem.size() + 1, 0);
    if (!sa_off) {
        ProfScope psa(6);
        for (size_t si = 0; si < mem.size(); ++si) {
            const Seed5 &iv = mem[si];
            int64_t n_i = std::min<int64_t>(iv.s, PRECAP);
            for (int64_t j = 0; j < n_i; ++j)
                pre_ks.push_back(iv.x0 + j);
            pre_at[si + 1] = (int32_t)pre_ks.size();
        }
        pre_out.resize(pre_ks.size());
        fm_sa_batch(fm, pre_ks.data(), (int)pre_ks.size(), pre_out.data());
    }
    for (size_t si = 0; si < mem.size(); ++si) {
        const Seed5 &iv = mem[si];
        int32_t slen = iv.end - iv.start;
        int64_t pre_base = sa_off ? sa_off[si] : pre_at[si];
        int64_t pre_n = sa_off ? sa_off[si + 1] - sa_off[si]
                               : pre_at[si + 1] - pre_at[si];
        const int64_t *pre_pos = sa_off ? sa_pos : pre_out.data();
        int64_t k = 0, count = 0;
        // SA positions resolved in tiles (fm_sa_batch): occurrences are
        // consumed strictly in order, so over-resolve past the loop's
        // data-dependent exit wastes at most SA_TILE-1 (cheap) walks
        constexpr int64_t SA_TILE = 64;
        int64_t tile_base = 0, tile_n = 0;
        int64_t tbuf[SA_TILE], tks[SA_TILE];
        while (k < iv.s && count < opt.max_occ &&
               ((count > 5 && k < opt.max_occ) || count <= 5)) {
            int64_t rbeg;
            if (k < pre_n) rbeg = pre_pos[pre_base + k];
            else {
                if (k >= tile_base + tile_n) {
                    ProfScope psa(6);
                    tile_base = k;
                    tile_n = std::min<int64_t>(SA_TILE, iv.s - k);
                    for (int64_t j = 0; j < tile_n; ++j)
                        tks[j] = iv.x0 + k + j;
                    fm_sa_batch(fm, tks, (int)tile_n, tbuf);
                }
                rbeg = tbuf[k - tile_base];
            }
            ++k;
            SeedHit s{rbeg, iv.start, slen, slen};
            int rid = intv2rid(bns, rbeg, rbeg + slen);
            if (rid < 0) continue;
            if ((opt.bsstrand & 1)) {
                int bss = ((rbeg > l_pac) == (parent != 0)) ? 1 : 0;
                if (bss != (opt.bsstrand >> 1)) continue;
            }
            bool to_add = false;
            if (!tree.empty()) {
                // lower = chain with largest pos <= rbeg
                auto it = std::upper_bound(keys.begin(), keys.end(), rbeg);
                if (it == keys.begin()) to_add = true;
                else {
                    size_t j = (it - keys.begin()) - 1;
                    if (!merge_seed_to_chain(opt, l_pac, tree[j], s, rid))
                        to_add = true;
                }
            } else to_add = true;
            if (to_add) {
                ++count;
                Chain c;
                c.pos = rbeg;
                c.seeds.push_back(s);
                c.rid = rid;
                c.is_alt = bns.ann_alt[rid];
                auto it = std::upper_bound(keys.begin(), keys.end(), rbeg);
                size_t j = it - keys.begin();
                keys.insert(it, rbeg);
                tree.insert(tree.begin() + j, std::move(c));
            }
        }
    }
    for (auto &c : tree) c.frac_rep = frac_rep_out;
    chains.swap(tree);
}

static void chain_flt(const Opt &opt, std::vector<Chain> &chns) {
    if (chns.empty()) return;
    std::vector<Chain> kept_chains;
    for (auto &c : chns) {
        c.first = -1;
        c.kept = 0;
        c.w = chain_weight(c);
        if (c.w >= opt.min_chain_weight) kept_chains.push_back(std::move(c));
    }
    chns.swap(kept_chains);
    if (chns.empty()) return;
    // exact ks_introsort(mem_flt) tie order (memchain.c:402,425)
    ks_introsort_emul(chns,
                      [](const Chain &a, const Chain &b) { return a.w > b.w; });
    auto chn_beg = [](const Chain &c) { return c.seeds[0].qbeg; };
    auto chn_end = [](const Chain &c) {
        const SeedHit &s = c.seeds.back();
        return s.qbeg + s.len;
    };
    std::vector<int> to_keep{0};
    chns[0].kept = 3;
    for (size_t i = 1; i < chns.size(); ++i) {
        bool large_overlap = false, broke = false;
        for (size_t kidx = 0; kidx < to_keep.size(); ++kidx) {
            Chain &ci = chns[i];
            Chain &ck = chns[to_keep[kidx]];
            int b_max = std::max(chn_beg(ck), chn_beg(ci));
            int e_min = std::min(chn_end(ck), chn_end(ci));
            if (e_min > b_max && (!ck.is_alt || ci.is_alt)) {
                int li = chn_end(ci) - chn_beg(ci);
                int lj = chn_end(ck) - chn_beg(ck);
                int min_l = std::min(li, lj);
                if (e_min - b_max >= min_l * opt.mask_level &&
                    min_l < opt.max_chain_gap) {
                    large_overlap = true;
                    if (ck.first < 0) ck.first = (int)i;
                    if (ci.w < ck.w * opt.drop_ratio &&
                        ck.w - ci.w >= opt.min_seed_len << 1) {
                        broke = true;
                        break;
                    }
                }
            }
        }
        if (!broke) {
            to_keep.push_back((int)i);
            chns[i].kept = large_overlap ? 2 : 3;
        }
    }
    for (int idx : to_keep) {
        Chain &c = chns[idx];
        if (c.first >= 0) chns[c.first].kept = 1;
    }
    int64_t k = 0;
    size_t i = 0;
    for (; i < chns.size(); ++i) {
        if (chns[i].kept == 0 || chns[i].kept == 3) continue;
        if (++k >= opt.max_chain_extend) break;
    }
    for (size_t j = i; j < chns.size(); ++j)
        if (chns[j].kept < 3) chns[j].kept = 0;
    std::vector<Chain> outc;
    for (auto &c : chns)
        if (c.kept != 0) outc.push_back(std::move(c));
    chns.swap(outc);
}

// --------------------------------------------------------------- regions

struct Region {
    int64_t rb, re;
    int32_t qb, qe, rid, score, truesc, w, seedcov, seedlen0;
    float frac_rep;
    uint8_t bss, parent;
};

static int cal_max_gap(const Opt &opt, int qlen) {
    int l_del = (int)((double)(qlen * opt.a - opt.o_del) / opt.e_del + 1.0);
    int l_ins = (int)((double)(qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0);
    int l = std::max(std::max(l_del, l_ins), 1);
    return std::min(l, opt.w << 1);
}

static void chain2region1(const Opt &opt, const Bns &bns,
                          const std::vector<uint8_t> &rseq, int64_t rmax0,
                          int64_t rmax1, int rid, int l_query,
                          const uint8_t *query, const std::vector<SeedHit> &seeds,
                          std::vector<Region> &regs, int parent, size_t reg0,
                          double frac_rep) {
    const int8_t *mat = opt.mats[parent ? 1 : 0];
    size_t n = seeds.size();
    std::vector<uint64_t> srt(n);
    for (size_t i = 0; i < n; ++i)
        srt[i] = ((uint64_t)(uint32_t)seeds[i].score << 32) | (uint32_t)i;
    std::sort(srt.begin(), srt.end());
    std::vector<bool> alive(n, true);

    for (int64_t k = (int64_t)n - 1; k >= 0; --k) {
        const SeedHit &s = seeds[(uint32_t)srt[k]];
        // asymmetric seed filter
        {
            bool bad = false;
            const uint8_t *r = rseq.data() + (s.rbeg - rmax0);
            for (int i = 0; i < s.len; ++i) {
                uint8_t rb = r[i], qb = query[s.qbeg + i];
                if ((rb == 3 && qb == 1) || (rb == 0 && qb == 2)) { bad = true; break; }
            }
            if (bad) continue;
        }
        // containment test vs existing regions
        size_t u = reg0;
        bool contained = false;
        for (; u < regs.size(); ++u) {
            const Region &reg = regs[u];
            if (s.rbeg < reg.rb || s.rbeg + s.len > reg.re ||
                s.qbeg < reg.qb || s.qbeg + s.len > reg.qe) continue;
            if (s.len - reg.seedlen0 > 0.1 * l_query) continue;
            int qd = s.qbeg - reg.qb;
            int64_t rd = s.rbeg - reg.rb;
            int mg = cal_max_gap(opt, std::min<int64_t>(qd, rd));
            int w = std::min(mg, reg.w);
            if (qd - rd < w && rd - qd < w) { contained = true; break; }
            qd = reg.qe - (s.qbeg + s.len);
            rd = reg.re - (s.rbeg + s.len);
            mg = cal_max_gap(opt, std::min<int64_t>(qd, rd));
            w = std::min(mg, reg.w);
            if (qd - rd < w && rd - qd < w) { contained = true; break; }
        }
        if (contained) {
            bool overlapping = false;
            for (size_t i2 = k + 1; i2 < n; ++i2) {
                if (!alive[(uint32_t)srt[i2]]) continue;
                const SeedHit &t = seeds[(uint32_t)srt[i2]];
                if (t.len < s.len * 0.95) continue;
                if (s.qbeg <= t.qbeg && s.qbeg + s.len - t.qbeg >= s.len >> 2 &&
                    t.qbeg - s.qbeg != t.rbeg - s.rbeg) { overlapping = true; break; }
                if (t.qbeg <= s.qbeg && t.qbeg + t.len - s.qbeg >= s.len >> 2 &&
                    s.qbeg - t.qbeg != s.rbeg - t.rbeg) { overlapping = true; break; }
            }
            if (!overlapping) {
                alive[(uint32_t)srt[k]] = false;
                continue;
            }
        }
        // extension
        Region reg{};
        reg.w = opt.w;
        reg.score = reg.truesc = -1;
        reg.rid = rid;
        int aw0 = opt.w, aw1 = opt.w;
        // left
        if (s.qbeg == 0) {
            reg.score = reg.truesc = s.len * opt.a;
            reg.qb = 0;
            reg.rb = s.rbeg;
        } else {
            std::vector<uint8_t> qs(s.qbeg), rs(s.rbeg - rmax0);
            for (int i = 0; i < s.qbeg; ++i) qs[i] = query[s.qbeg - 1 - i];
            int64_t tmp = s.rbeg - rmax0;
            for (int64_t i = 0; i < tmp; ++i) rs[i] = rseq[tmp - 1 - i];
            ExtRes r{};
            for (int t = 0; t < 2; ++t) {
                int prev = reg.score;
                aw0 = opt.w << t;
                r = sw_extend(qs.data(), qs.size(), rs.data(), rs.size(), mat,
                              opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, aw0,
                              opt.pen_clip5, opt.zdrop, s.len * opt.a);
                reg.score = r.score;
                if (reg.score == prev || r.max_off < (aw0 >> 1) + (aw0 >> 2)) break;
            }
            if (r.gscore <= 0 || r.gscore <= reg.score - opt.pen_clip5) {
                reg.qb = s.qbeg - r.qle;
                reg.rb = s.rbeg - r.tle;
                reg.truesc = reg.score;
            } else {
                reg.qb = 0;
                reg.rb = s.rbeg - r.gtle;
                reg.truesc = r.gscore;
            }
        }
        // right
        if (s.qbeg + s.len == l_query) {
            reg.qe = l_query;
            reg.re = s.rbeg + s.len;
        } else {
            int sc0 = reg.score;
            int qe = s.qbeg + s.len;
            int64_t re_ = s.rbeg + s.len - rmax0;
            ExtRes r{};
            for (int t = 0; t < 2; ++t) {
                int prev = reg.score;
                aw1 = opt.w << t;
                r = sw_extend(query + qe, l_query - qe, rseq.data() + re_,
                              (int)(rmax1 - rmax0 - re_), mat, opt.o_del,
                              opt.e_del, opt.o_ins, opt.e_ins, aw1,
                              opt.pen_clip3, opt.zdrop, sc0);
                reg.score = r.score;
                if (reg.score == prev || r.max_off < (aw1 >> 1) + (aw1 >> 2)) break;
            }
            if (r.gscore <= 0 || r.gscore <= reg.score - opt.pen_clip3) {
                reg.qe = qe + r.qle;
                reg.re = rmax0 + re_ + r.tle;
                reg.truesc += reg.score - sc0;
            } else {
                reg.qe = l_query;
                reg.re = rmax0 + re_ + r.gtle;
                reg.truesc += r.gscore - sc0;
            }
        }
        reg.bss = ((reg.rb > bns.l_pac) == (parent != 0)) ? 1 : 0;
        reg.parent = (uint8_t)parent;
        uint8_t bss_e = ((reg.re > bns.l_pac) == (parent != 0)) ? 1 : 0;
        if (bss_e != reg.bss) continue;  // crosses the strand boundary
        reg.seedcov = 0;
        for (auto &t : seeds) {
            if (t.qbeg >= reg.qb && t.qbeg + t.len <= reg.qe &&
                t.rbeg >= reg.rb && t.rbeg + t.len <= reg.re)
                reg.seedcov += t.len;
        }
        reg.w = std::max(aw0, aw1);
        reg.seedlen0 = s.len;
        reg.frac_rep = (float)frac_rep;
        regs.push_back(reg);
    }
}

static void chain2region(const Opt &opt, const Bns &bns, int l_query,
                         const uint8_t *query, int parent,
                         std::vector<Chain> &chns, std::vector<Region> &regs) {
    size_t reg0 = regs.size();
    for (auto &c : chns) {
        if (c.seeds.empty()) continue;
        int64_t rmax0 = bns.l_pac << 1, rmax1 = 0;
        for (auto &s : c.seeds) {
            int64_t b = s.rbeg - (s.qbeg + cal_max_gap(opt, s.qbeg));
            int64_t e = s.rbeg + s.len +
                ((l_query - s.qbeg - s.len) +
                 cal_max_gap(opt, l_query - s.qbeg - s.len));
            rmax0 = std::min(rmax0, b);
            rmax1 = std::max(rmax1, e);
        }
        rmax0 = std::max<int64_t>(rmax0, 0);
        rmax1 = std::min<int64_t>(rmax1, bns.l_pac << 1);
        if (rmax0 < bns.l_pac && bns.l_pac < rmax1) {
            if (c.seeds[0].rbeg < bns.l_pac) rmax1 = bns.l_pac;
            else rmax0 = bns.l_pac;
        }
        std::vector<uint8_t> rseq;
        int rid = fetch_seq(bns, rmax0, c.seeds[0].rbeg, rmax1, rseq);
        size_t n0 = regs.size();
        chain2region1(opt, bns, rseq, rmax0, rmax1, rid, l_query, query,
                      c.seeds, regs, parent, reg0, c.frac_rep);
        if (regs.size() == n0 && !c.seeds_extra.empty())
            chain2region1(opt, bns, rseq, rmax0, rmax1, rid, l_query, query,
                          c.seeds_extra, regs, parent, reg0, c.frac_rep);
    }
}

// --------------------------------------------------------------- worker1

struct Ctx {
    StrandFM fm[2];  // 0 = daughter, 1 = parent
    Bns bns;
    Opt opt;
};

// Device-computed seed injection for a batch (see bt_align_*_batch): when a
// lane (read, parent) has `has[read*2+parent]` set, the TPU already ran
// mem_collect_intv (ops/seed_parallel.seed_collect_device) and prefetched SA
// positions for the leading occurrences of each seed; the C++ path then
// skips collect_intv and most fm_sa walks. Lanes without the flag self-seed
// (identical output either way — injection is purely an offload).
struct SeedInj {
    const uint8_t *has;       // [n_reads*2] lane key = read_idx*2 + parent
    const int64_t *lane_off;  // [n_reads*2 + 1] row ranges per lane
    const int32_t *rows_se;   // [M*2] start, end
    const int64_t *rows_xs;   // [M*3] x0, x1, s
    const int64_t *sa_off;    // [M+1] absolute offsets into sa_pos
    const int64_t *sa_pos;    // prefetched SA positions
};

// align one read against one strand: convert, seed, chain, filter, extend
static void align1_core(const Ctx &cx, const uint8_t *seq, int len, int parent,
                        std::vector<Region> &regs, bool &needs_fallback,
                        const SeedInj *inj = nullptr, int read_idx = -1,
                        std::vector<Seed5> *premem = nullptr) {
    if (len < cx.opt.min_seed_len) return;  // mem_chain early-out
    // mem_flt_chained_seeds gate: active only for long reads / explicit
    // min_chain_weight — fall back to the Python engine in that case
    double min_l = cx.opt.min_chain_weight
        ? 1.1 * cx.opt.min_chain_weight : 5.5 * std::log((double)len);
    if (!(min_l > 0.05 * len)) { needs_fallback = true; return; }
    const StrandFM &fm = cx.fm[parent];
    const StrandFM &fmc = cx.fm[1 - parent];
    std::vector<Seed5> mem;
    const int64_t *sa_pos = nullptr;
    const int64_t *sa_off = nullptr;
    int lane = read_idx >= 0 ? read_idx * 2 + parent : -1;
    if (inj && lane >= 0 && inj->has[lane]) {
        int64_t r0 = inj->lane_off[lane], r1 = inj->lane_off[lane + 1];
        mem.resize(r1 - r0);
        for (int64_t r = r0; r < r1; ++r) {
            Seed5 &s = mem[r - r0];
            s.start = inj->rows_se[r * 2];
            s.end = inj->rows_se[r * 2 + 1];
            s.x0 = inj->rows_xs[r * 3];
            s.x1 = inj->rows_xs[r * 3 + 1];
            s.s = inj->rows_xs[r * 3 + 2];
        }
        sa_pos = inj->sa_pos;
        sa_off = inj->sa_off + r0;
    } else if (premem) {
        // chunk-interleaved seeding already ran (collect_intv_interleaved)
        mem.swap(*premem);
    } else {
        std::vector<uint8_t> conv(seq, seq + len);
        if (parent) {
            for (auto &c : conv) if (c == 1) c = 3;
        } else {
            for (auto &c : conv) if (c == 2) c = 0;
        }
        ProfScope p(0);
        collect_intv(cx.opt, fm, fmc, conv.data(), len, mem);
    }
    std::vector<Chain> chns;
    double frac_rep = 0.0;
    {
        ProfScope p(1);
        chain_from_seeds(cx.opt, fm, cx.bns, len, parent, mem, chns, frac_rep,
                         sa_pos, sa_off);
    }
    {
        ProfScope p(2);
        chain_flt(cx.opt, chns);
    }
    {
        ProfScope p(3);
        chain2region(cx.opt, cx.bns, len, seq, parent, chns, regs);
    }
}

// Interleaved seeding over a work-stealing chunk: pre-runs collect_intv for
// every (read, parent) lane the chunk's align1_core calls would self-seed
// (same gates: min_seed_len, the min_l fallback gate, device injection),
// K lanes in lockstep so the dependent occ fetches of different reads
// overlap. align1_core then consumes the results via `premem`.
struct ChunkSeeds {
    int lo = 0;
    std::vector<std::vector<Seed5>> mems;      // [(i-lo)*2 + parent]
    std::vector<uint8_t> have;
    std::vector<std::vector<uint8_t>> convs;   // alive while jobs run
    std::vector<Seed5> *get(int i, int p) {
        int idx = (i - lo) * 2 + p;
        return have[idx] ? &mems[idx] : nullptr;
    }
};

static void seed_chunk(const Ctx &cx, const uint8_t *reads,
                       const int64_t *offs, const int32_t *lens,
                       int lo, int hi, bool pe, int parent_policy,
                       const SeedInj *inj, const uint8_t *skip,
                       ChunkSeeds &out) {
    out.lo = lo;
    int n = (hi - lo) * 2;
    out.mems.assign(n, {});
    out.have.assign(n, 0);
    out.convs.clear();
    out.convs.reserve(n);  // conv.data() pointers must stay stable
    std::vector<SeedJob> jobs;
    jobs.reserve(n);
    auto add = [&](int i, int p) {
        int len = lens[i];
        if (len < cx.opt.min_seed_len) return;
        double min_l = cx.opt.min_chain_weight
            ? 1.1 * cx.opt.min_chain_weight : 5.5 * std::log((double)len);
        if (!(min_l > 0.05 * len)) return;  // align1_core falls back
        if (inj && inj->has[i * 2 + p]) return;
        const uint8_t *seq = reads + offs[i];
        out.convs.emplace_back(seq, seq + len);
        auto &conv = out.convs.back();
        if (p) {
            for (auto &c : conv) if (c == 1) c = 3;
        } else {
            for (auto &c : conv) if (c == 2) c = 0;
        }
        int idx = (i - lo) * 2 + p;
        out.have[idx] = 1;
        jobs.push_back({&cx.fm[p], &cx.fm[1 - p], conv.data(), len,
                        &out.mems[idx]});
    };
    for (int i = lo; i < hi; ++i) {
        if (skip && skip[i]) continue;
        if (!pe) {
            if (!(parent_policy & 1) || (parent_policy >> 1)) add(i, 0);
            if (!(parent_policy & 1) || !(parent_policy >> 1)) add(i, 1);
        } else {
            int first = (i % 2) == 0 ? 1 : 0;
            add(i, first);
            if (!parent_policy) add(i, 1 - first);
        }
    }
    ProfScope pscope(0);
    collect_intv_interleaved(cx.opt, jobs);
}

// =====================================================================
// worker2 (SE): merge/dedup, primary marking, SAM emission.
//
// Transliteration of biscuit_tpu/align/region.py (sort_deduplicate,
// merge_regions, mark_primary — porting mem_alnreg.c:37-380) and
// align/sam.py (gen_cigar/setSAM/mapq/select_format/format_sam/reg2sam_se —
// porting bwa.c:290-428 and mem_alnreg_format.c). The Python modules stay
// the ground truth; E2E SAM output must remain byte-identical.
// =====================================================================

static const int64_t GMINF = -0x40000000;
static const int I32_MAX = 2147483647;

struct Opt2 {
    int T;
    double XA_drop_ratio, mask_level_redun, mapQ_coef_len, mapQ_coef_fac;
    int max_XA_hits, max_XA_hits_alt, pen_unpaired;
};

struct Reg2 {
    int64_t rb = 0, re = 0;
    int qb = 0, qe = 0, rid = -1;
    int score = 0, truesc = 0, sub = 0, alt_sc = 0, csub = 0, sub_n = 0;
    int w = 0, seedcov = 0, secondary = -1, secondary_all = -1;
    int seedlen0 = 0, n_comp = 0, is_alt = 0;
    double frac_rep = 0.0;
    uint64_t hash = 0;
    int bss = 0, parent = 0;
    // SAM meta
    int64_t pos = 0;
    int flag = 0, NM = 0, n_cigar = 0, is_rev = 0, mapq = 0, ZC = 0, ZR = 0,
        bss_u = 0;
    std::vector<std::pair<int, int>> cigar;
    std::string md;
    // Python regions are objects with stable identity; vector entries are
    // not. `serial` tracks identity across sort_deduplicate reorders/removals
    // (needed by matesw, which holds references across mutations).
    uint32_t serial = 0;
};

struct ReadSE {
    const uint8_t *seq; int l_seq;      // clipped nt4 codes
    const uint8_t *seq0; int l_seq0;    // original nt4 codes
    const char *qual; int l_qual;       // 0 => "*"
    const char *name; int name_len;     // name (with _comment merged)
    int clip5, clip3;
};

static uint64_t hash_64(uint64_t key) {  // region.py:23 (Wang hash)
    key = key + ~(key << 32);
    key ^= key >> 22;
    key = key + ~(key << 13);
    key ^= key >> 8;
    key = key + (key << 3);
    key ^= key >> 15;
    key = key + ~(key << 27);
    key ^= key >> 31;
    return key;
}

// ops/sw.py:143 sw_global (ksw_global2 semantics). Returns score; fills
// *cig when want_cigar.
static int sw_global(const uint8_t *query, int qlen, const uint8_t *target,
                     int tlen, const int8_t *mat, int o_del, int e_del,
                     int o_ins, int e_ins, int w, bool want_cigar,
                     std::vector<std::pair<int, int>> *cig) {
    if (cig) cig->clear();
    if (qlen == 0 || tlen == 0) return 0;
    int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    int n_col = std::min(qlen, 2 * w + 1);
    std::vector<uint8_t> z;
    if (want_cigar) z.assign((size_t)tlen * n_col, 0);
    std::vector<int64_t> h(qlen + 1, GMINF), e(qlen + 1, GMINF);
    h[0] = 0;
    for (int j = 1; j <= qlen && j <= w; ++j) h[j] = -(o_ins + e_ins * j);
    for (int i = 0; i < tlen; ++i) {
        int beg = i > w ? i - w : 0;
        int end = std::min(i + w + 1, qlen);
        int64_t h1_first = beg == 0 ? -(int64_t)(o_del + e_del * (i + 1)) : GMINF;
        const int8_t *qp = mat + (int)target[i] * 5;
        int64_t diag = h[beg];
        h[beg] = h1_first;
        int64_t F = GMINF;
        uint8_t *zrow = want_cigar ? z.data() + (size_t)i * n_col : nullptr;
        for (int j = beg; j < end; ++j) {
            int64_t M = diag + qp[query[j]];
            int64_t E = e[j];
            int64_t ME = M >= E ? M : E;
            int64_t H = F > ME ? F : ME;
            if (want_cigar) {
                uint8_t d = M >= E ? 0 : 1;
                if (H > ME) d = 2;                       // F strictly greater
                d |= (uint8_t)((E - e_del) > (M - oe_del)) << 2;
                d |= (uint8_t)((F - e_ins) > (M - oe_ins)) << 5;  // 2<<4
                zrow[j - beg] = d;
            }
            diag = h[j + 1];
            h[j + 1] = H;
            e[j] = std::max(E - e_del, M - oe_del);
            F = std::max(F - e_ins, M - oe_ins);
        }
        e[end] = GMINF;
    }
    int score = (int)h[qlen];
    if (!want_cigar) return score;
    // backtrack (ops/sw.py:203-218)
    auto push = [&](int op, int ln) {
        if (!cig->empty() && cig->back().first == op) cig->back().second += ln;
        else cig->push_back({op, ln});
    };
    int i = tlen - 1;
    int k = std::min(i + w + 1, qlen) - 1;
    int which = 0;
    while (i >= 0 && k >= 0) {
        int beg = i > w ? i - w : 0;
        which = (z[(size_t)i * n_col + (k - beg)] >> (which << 1)) & 3;
        if (which == 0) { push(0, 1); --i; --k; }
        else if (which == 1) { push(2, 1); --i; }
        else { push(1, 1); --k; }
    }
    if (i >= 0) push(2, i + 1);
    if (k >= 0) push(1, k + 1);
    std::reverse(cig->begin(), cig->end());
    return score;
}

struct CigRes {
    int score = 0;
    std::vector<std::pair<int, int>> cigar;
    bool emitted = false;   // NM/MD/ZC/ZR computed
    int NM = -1, ZC = 0, ZR = 0, bss_u = 0;
    std::string md;
};

// sam.py:49 gen_cigar (bis_bwa_gen_cigar2)
static void gen_cigar(const Opt &opt, const Bns &bns, const uint8_t *query0,
                      int l_query, int64_t rb, int64_t re, int parent, int w_,
                      bool want_cigar, CigRes &res) {
    res = CigRes();
    const int8_t *mat = opt.mats[parent];
    if (l_query <= 0 || rb >= re || (rb < bns.l_pac && re > bns.l_pac)) return;
    std::vector<uint8_t> rseq;
    get_seq(bns, rb, re, rseq);
    int64_t rlen = (int64_t)rseq.size();
    if (re - rb != rlen) return;
    std::vector<uint8_t> q(query0, query0 + l_query);
    if (rb >= bns.l_pac) {  // reverse both to left-align indels
        std::reverse(q.begin(), q.end());
        std::reverse(rseq.begin(), rseq.end());
    }
    bool n_cigar_flag;
    if ((int64_t)l_query == re - rb && w_ == 0) {
        if (want_cigar) res.cigar.push_back({0, l_query});
        int64_t sc = 0;
        for (int j = 0; j < l_query; ++j) sc += mat[(int)rseq[j] * 5 + q[j]];
        res.score = (int)sc;
        n_cigar_flag = want_cigar;
    } else {
        int max_ins = (int)(((double)(((l_query + 1) >> 1) * mat[0]) - opt.o_ins) / opt.e_ins + 1.0);
        int max_del = (int)(((double)(((l_query + 1) >> 1) * mat[0]) - opt.o_del) / opt.e_del + 1.0);
        int max_gap = std::max(std::max(max_ins, max_del), 1);
        int w = (int)((max_gap + std::llabs(rlen - l_query) + 1) >> 1);
        w = std::min(w, w_);
        int min_w = (int)std::llabs(rlen - l_query) + 3;
        w = std::max(w, min_w);
        res.score = sw_global(q.data(), l_query, rseq.data(), (int)rlen, mat,
                              opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w,
                              want_cigar, want_cigar ? &res.cigar : nullptr);
        n_cigar_flag = want_cigar;
    }
    if (n_cigar_flag) {
        const char *int2base = rb < bns.l_pac ? "ACGTN" : "TGCAN";
        std::string md;
        int x = 0, y = 0, u = 0, n_mm = 0, n_gap = 0;
        int n_conv_ct = 0, n_ret_c = 0, n_conv_ga = 0, n_ret_g = 0;
        int n_cigar = (int)res.cigar.size();
        for (int kk = 0; kk < n_cigar; ++kk) {
            int op = res.cigar[kk].first, ln = res.cigar[kk].second;
            if (op == 0) {
                int prev = 0, op_conv = 0, op_mm = 0;
                for (int j = 0; j < ln; ++j) {
                    uint8_t qc = q[x + j], rc = rseq[y + j];
                    bool eq = qc == rc;
                    if (eq && qc == 1) ++n_ret_c;
                    if (eq && qc == 2) ++n_ret_g;
                    bool conv = parent ? (!eq && qc == 3 && rc == 1)
                                       : (!eq && qc == 0 && rc == 2);
                    if (conv) ++op_conv;
                    if (!eq) {
                        md += std::to_string(u + (j - prev));
                        md += int2base[rc];
                        prev = j + 1;
                        u = 0;
                        ++op_mm;
                    }
                }
                if (parent) n_conv_ct += op_conv; else n_conv_ga += op_conv;
                n_mm += op_mm - op_conv;
                u += ln - prev;
                x += ln; y += ln;
            } else if (op == 2) {
                if (kk > 0 && kk < n_cigar - 1) {
                    md += std::to_string(u);
                    md += '^';
                    for (int t = 0; t < ln; ++t) md += int2base[rseq[y + t]];
                    u = 0;
                    n_gap += ln;
                }
                y += ln;
            } else if (op == 1) {
                x += ln;
                n_gap += ln;
            }
        }
        md += std::to_string(u);
        res.md = std::move(md);
        res.NM = n_mm + n_gap;
        res.ZC = parent ? n_conv_ct : n_conv_ga;
        res.ZR = parent ? n_ret_c : n_ret_g;
        res.bss_u = (n_conv_ct == 0 && n_conv_ga == 0) ? 1 : 0;
        res.emitted = true;
    }
}

// sam.py:35 infer_bw (bwamem.h:192-198)
static int infer_bw(int l1, int l2, int score, int a, int q, int r) {
    if (l1 == l2 && l1 * a - score < ((q + r - a) << 1)) return 0;
    int w = (int)((double)(std::min(l1, l2) * a - score - q) / r + 2.0);
    return std::max(w, std::abs(l1 - l2));
}

// sam.py:134 alnreg_setSAM. Returns false when the pos2rid assertion fails
// (caller falls back to the Python engine).
static bool setSAM(const Opt &opt, const Bns &bns, const ReadSE &s, Reg2 &reg) {
    if (reg.n_cigar > 0) return true;
    int w1 = infer_bw(reg.qe - reg.qb, (int)(reg.re - reg.rb), reg.truesc,
                      opt.a, opt.o_del, opt.e_del);
    int w2 = infer_bw(reg.qe - reg.qb, (int)(reg.re - reg.rb), reg.truesc,
                      opt.a, opt.o_ins, opt.e_ins);
    int w = std::max(w1, w2);
    if (w > opt.w) w = std::min(w, reg.w);
    int last_sc = -(1 << 30);
    CigRes res;
    for (int it = 0; it < 3; ++it) {
        w = std::min(w, opt.w << 2);
        gen_cigar(opt, bns, s.seq + reg.qb, reg.qe - reg.qb, reg.rb, reg.re,
                  reg.parent, w, true, res);
        if (res.score == last_sc) break;
        if (w == opt.w << 2) break;
        if (res.score >= reg.truesc - opt.a) break;
        last_sc = res.score;
        w <<= 1;
    }
    reg.NM = res.NM; reg.ZC = res.ZC; reg.ZR = res.ZR;
    reg.bss_u = res.bss_u; reg.md = res.md;
    std::vector<std::pair<int, int>> cigar = res.cigar;
    bool is_rev;
    int64_t rpos = depos(bns, reg.rb < bns.l_pac ? reg.rb : reg.re - 1, is_rev);
    reg.is_rev = is_rev ? 1 : 0;
    reg.flag |= is_rev ? 0x10 : 0;
    if (!cigar.empty()) {  // squeeze leading/trailing deletions
        if (cigar.front().first == 2) {
            rpos += cigar.front().second;
            cigar.erase(cigar.begin());
        } else if (cigar.back().first == 2) {
            cigar.pop_back();
        }
    }
    if (reg.qb != 0 || reg.qe != s.l_seq || s.clip5 || s.clip3) {
        int clip5, clip3;
        if (reg.is_rev) { clip5 = s.l_seq - reg.qe + s.clip3; clip3 = reg.qb + s.clip5; }
        else { clip5 = reg.qb + s.clip5; clip3 = s.l_seq - reg.qe + s.clip3; }
        if (clip5) cigar.insert(cigar.begin(), {3, clip5});
        if (clip3) cigar.push_back({3, clip3});
    }
    reg.n_cigar = (int)cigar.size();
    reg.cigar = std::move(cigar);
    if (pos2rid(bns, rpos) != reg.rid) return false;
    reg.pos = rpos - bns.ann_off[reg.rid];
    return true;
}

// sam.py:191 mapq_se (mem_approx_mapq_se)
static int mapq_se(const Opt &opt, const Opt2 &o2, const Reg2 &a) {
    int sub = a.sub ? a.sub : opt.min_seed_len * opt.a;
    sub = std::max(a.csub, sub);
    if (sub >= a.score) return 0;
    int l = std::max(a.qe - a.qb, (int)(a.re - a.rb));
    double identity = 1.0 - (double)(l * opt.a - a.score) / (opt.a + opt.b) / l;
    int mapq;
    if (a.score == 0) {
        mapq = 0;
    } else if (o2.mapQ_coef_len > 0) {
        double tmp = l < o2.mapQ_coef_len ? 1.0 : o2.mapQ_coef_fac / std::log((double)l);
        tmp *= identity * identity;
        mapq = (int)(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499);
    } else {
        mapq = (int)(30.0 * (1.0 - (double)sub / a.score) * std::log((double)a.seedcov) + 0.499);
        if (identity < 0.95) mapq = (int)(mapq * identity * identity + 0.499);
    }
    if (a.sub_n > 0) mapq -= (int)(4.343 * std::log((double)(a.sub_n + 1)) + 0.499);
    mapq = std::min(mapq, 60);
    mapq = std::max(mapq, 0);
    mapq = (int)(mapq * (1.0 - a.frac_rep) + 0.499);
    return mapq;
}

// region.py:312 _test_reg_concatenation (mem_alnreg.c:63-108)
static bool test_reg_concat(const Opt &opt, const Bns &bns,
                            const uint8_t *query, const Reg2 &a, const Reg2 &b,
                            int &score_out, int &w_out) {
    if (!query) return false;  // region.py:316 (idx/query None => no patching)
    if (a.rb < bns.l_pac && b.rb >= bns.l_pac) return false;
    if (a.qb >= b.qb || a.qe >= b.qe || a.re >= b.re) return false;
    int w = (int)std::llabs((a.re - b.rb) - (int64_t)(a.qe - b.qb));
    double r = std::fabs((double)(a.re - b.rb) / (b.re - a.rb)
                         - (double)(a.qe - b.qb) / (b.qe - a.qb));
    if (a.re < b.rb || a.qe < b.qb) {
        if (w > opt.w << 1 || r >= 0.05) return false;
    } else if (w > opt.w << 2 || r >= 0.05 * 2) {
        return false;
    }
    w += a.w + b.w;
    w = std::min(w, opt.w << 2);
    CigRes res;
    gen_cigar(opt, bns, query + a.qb, b.qe - a.qb, a.rb, b.re, a.parent, w,
              false, res);
    int score = res.score;
    int q_s = (int)((double)(b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb)) * (b.score + a.score) + 0.499);
    int r_s = (int)((double)(b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb)) * (b.score + a.score) + 0.499);
    if ((double)score / std::max(q_s, r_s) < 0.90) return false;
    score_out = score;
    w_out = w;
    return score > 0;
}

// region.py:342 sort_deduplicate (mem_alnreg.c:112-195). `graveyard`, when
// given, receives the filtered-out entries (their final field values) so
// matesw's held references stay observable, as in Python.
static void sort_deduplicate(const Opt &opt, const Opt2 &o2, const Bns &bns,
                             const uint8_t *query, std::vector<Reg2> &regs,
                             std::vector<Reg2> *graveyard = nullptr) {
    if (regs.size() <= 1) return;
    // exact ks_introsort(mem_ars2) tie order (mem_alnreg.c:43,118)
    ks_introsort_emul(regs,
                      [](const Reg2 &x, const Reg2 &y) { return x.re < y.re; });
    for (auto &p : regs) p.n_comp = 1;
    for (size_t i = 1; i < regs.size(); ++i) {
        Reg2 &p = regs[i];
        int j = (int)i - 1;
        while (j >= 0 && p.rid == regs[j].rid
               && p.rb < regs[j].re + opt.max_chain_gap) {
            Reg2 &q = regs[j];
            --j;
            if (q.qe == q.qb) continue;
            int64_t orr = q.re - p.rb;
            int oq = q.qb < p.qb ? (q.qe - p.qb) : (p.qe - q.qb);
            int64_t mr = std::min(q.re - q.rb, p.re - p.rb);
            int mq = std::min(q.qe - q.qb, p.qe - p.qb);
            if (orr > o2.mask_level_redun * mr && oq > o2.mask_level_redun * mq) {
                if (p.score < q.score) { p.qe = p.qb; break; }
                else q.qe = q.qb;
            } else if (q.rb < p.rb) {
                int score, w;
                if (test_reg_concat(opt, bns, query, q, p, score, w)) {
                    p.n_comp += q.n_comp + 1;
                    p.seedcov = std::max(p.seedcov, q.seedcov);
                    p.sub = std::max(p.sub, q.sub);
                    p.csub = std::max(p.csub, q.csub);
                    p.truesc = p.score = score;
                    p.qb = q.qb;
                    p.rb = q.rb;
                    p.w = w;
                    q.qb = q.qe;
                }
            }
        }
    }
    {
        std::vector<Reg2> keep;
        keep.reserve(regs.size());
        for (auto &p : regs) {
            if (p.qe > p.qb) keep.push_back(std::move(p));
            else if (graveyard) graveyard->push_back(std::move(p));
        }
        regs.swap(keep);
    }
    // exact ks_introsort(mem_ars) tie order (mem_alnreg.c:48,180)
    ks_introsort_emul(regs,
                      [](const Reg2 &x, const Reg2 &y) {
                          if (x.score != y.score) return x.score > y.score;
                          if (x.rb != y.rb) return x.rb < y.rb;
                          return x.qb < y.qb;
                      });
    for (size_t i = 1; i < regs.size(); ++i)
        if (regs[i].score == regs[i - 1].score && regs[i].rb == regs[i - 1].rb
            && regs[i].qb == regs[i - 1].qb)
            regs[i].qe = regs[i].qb;
    {
        std::vector<Reg2> keep;
        keep.reserve(regs.size());
        for (size_t i = 0; i < regs.size(); ++i) {
            if (i == 0 || regs[i].qe > regs[i].qb)
                keep.push_back(std::move(regs[i]));
            else if (graveyard)
                graveyard->push_back(std::move(regs[i]));
        }
        regs.swap(keep);
    }
}

// region.py:389 merge_regions (mem_alnreg.c:208-227)
static void merge_regions2(const Opt &opt, const Opt2 &o2, const Bns &bns,
                           const uint8_t *query, int l_seq,
                           std::vector<Reg2> &regs) {
    sort_deduplicate(opt, o2, bns, query, regs);
    if (opt.flag & 0x40)  // MEM_F_SELF_OVLP
        if (!regs.empty() && regs[0].truesc == l_seq * opt.a)
            regs.erase(regs.begin());
    for (auto &p : regs)
        if (p.rid >= 0 && bns.ann_alt[p.rid]) p.is_alt = 1;
}

// region.py:405 _mark_primary_core (mem_alnreg.c:252-288)
static void mark_primary_core(const Opt &opt, int n_mark,
                              std::vector<Reg2> &regs) {
    int tmp = std::max(std::max(opt.a + opt.b, opt.o_del + opt.e_del),
                       opt.o_ins + opt.e_ins);
    std::vector<int> z{0};
    for (int i = 1; i < n_mark; ++i) {
        Reg2 &a = regs[i];
        size_t k = 0;
        for (; k < z.size(); ++k) {
            Reg2 &b = regs[z[k]];
            int b_max = std::max(a.qb, b.qb);
            int e_min = std::min(a.qe, b.qe);
            if (e_min > b_max) {
                int min_l = std::min(a.qe - a.qb, b.qe - b.qb);
                if (e_min - b_max >= min_l * opt.mask_level) {
                    if (b.sub == 0) b.sub = a.score;
                    if (b.score - a.score <= tmp && (b.is_alt || !a.is_alt))
                        ++b.sub_n;
                    break;
                }
            }
        }
        if (k == z.size()) z.push_back(i);
        else a.secondary = z[k];
    }
}

// region.py:431 mark_primary (mem_mark_primary_se)
static void mark_primary(const Opt &opt, std::vector<Reg2> &regs,
                         int64_t rid_id, int &n_pri) {
    n_pri = 0;
    if (regs.empty()) return;
    for (size_t i = 0; i < regs.size(); ++i) {
        Reg2 &p = regs[i];
        p.sub = p.alt_sc = 0;
        p.secondary = -1;
        p.secondary_all = -1;
        p.hash = hash_64((uint64_t)(rid_id + (int64_t)i));
        if (!p.is_alt) ++n_pri;
    }
    std::stable_sort(regs.begin(), regs.end(),
                     [](const Reg2 &x, const Reg2 &y) {
                         if (x.score != y.score) return x.score > y.score;
                         if (x.is_alt != y.is_alt) return x.is_alt < y.is_alt;
                         return x.hash < y.hash;
                     });
    mark_primary_core(opt, (int)regs.size(), regs);
    for (size_t i = 0; i < regs.size(); ++i) {
        Reg2 &p = regs[i];
        p.secondary_all = (int)i;
        if (!p.is_alt && p.secondary >= 0 && regs[p.secondary].is_alt)
            p.alt_sc = regs[p.secondary].score;
    }
    if (0 < n_pri && n_pri < (int)regs.size()) {
        std::vector<int> z(regs.size());
        std::stable_sort(regs.begin(), regs.end(),
                         [](const Reg2 &x, const Reg2 &y) {
                             if (x.is_alt != y.is_alt) return x.is_alt < y.is_alt;
                             if (x.score != y.score) return x.score > y.score;
                             return x.hash < y.hash;
                         });
        for (size_t i = 0; i < regs.size(); ++i) z[regs[i].secondary_all] = (int)i;
        for (auto &p : regs) {
            if (p.secondary >= 0) {
                p.secondary_all = z[p.secondary];
                if (p.is_alt) p.secondary = I32_MAX;
            } else {
                p.secondary_all = -1;
            }
        }
        if (n_pri > 0) {
            for (int i = 0; i < n_pri; ++i) {
                regs[i].sub = 0;
                regs[i].secondary = -1;
            }
            mark_primary_core(opt, n_pri, regs);
        }
    } else {
        for (auto &p : regs) p.secondary_all = p.secondary;
    }
}

// sam.py:419 select_format (mem_alnreg_select_format)
static bool select_format(const Opt &opt, const Opt2 &o2, const Bns &bns,
                          const ReadSE &s, std::vector<Reg2> &regs,
                          std::vector<int> &to_output) {
    to_output.clear();
    int l = 0;
    for (size_t k = 0; k < regs.size(); ++k) {
        Reg2 &p = regs[k];
        if (p.rb < 0 || p.re < 0) continue;
        if (p.score < o2.T) continue;
        if (p.secondary >= 0 && (p.is_alt || !(opt.flag & 0x8))) continue;  // MEM_F_ALL
        if (p.secondary >= 0 && p.secondary < I32_MAX
            && p.score < regs[p.secondary].score * opt.drop_ratio) continue;
        if (l && p.secondary < 0)
            p.flag |= (opt.flag & 0x10) ? 0x10000 : 0x800;  // MEM_F_NO_MULTI
        if (p.secondary >= 0) p.flag |= 0x100;
        p.mapq = p.secondary < 0 ? mapq_se(opt, o2, p) : 0;
        if (!(opt.flag & 0x1000) && l && !p.is_alt)  // MEM_F_KEEP_SUPP_MAPQ
            p.mapq = std::min(p.mapq, regs[0].mapq);
        if (!setSAM(opt, bns, s, p)) return false;
        to_output.push_back((int)k);
        ++l;
    }
    return true;
}

static void cigar_str(const std::vector<std::pair<int, int>> &cigar,
                      int is_primary, const Opt &opt, int is_alt,
                      std::string &out) {
    static const char OPS[] = "MIDSH";
    for (auto &oc : cigar) {
        int c = oc.first;
        if (!(opt.flag & 0x200) && !is_alt && (c == 3 || c == 4))  // MEM_F_SOFTCLIP
            c = is_primary ? 3 : 4;
        out += std::to_string(oc.second);
        out += OPS[c];
    }
}

// sam.py:216 get_pri_idx
static int get_pri_idx(double xa_drop_ratio, const std::vector<Reg2> &regs, int i) {
    int k = regs[i].secondary_all;
    if (k >= 0 && regs[i].score >= regs[k].score * xa_drop_ratio) return k;
    return -1;
}

// sam.py:233 _tag_XAXB. p0_idx = index of p0 in regs0 (-1 = not a member).
static bool tag_XAXB(const Opt &opt, const Opt2 &o2, const Bns &bns,
                     const std::vector<std::string> &ann_names, const ReadSE &s,
                     int p0_idx, std::vector<Reg2> *regs0, std::string &out) {
    if (!regs0 || (opt.flag & 0x8)) return true;  // MEM_F_ALL
    int cnt_pri = 0, cnt_alt = 0;
    for (int i = 0; i < (int)regs0->size(); ++i) {
        int r = get_pri_idx(o2.XA_drop_ratio, *regs0, i);
        if (r >= 0 && r == p0_idx) {
            if ((*regs0)[i].is_alt) ++cnt_alt; else ++cnt_pri;
        }
    }
    if (cnt_pri <= o2.max_XA_hits && cnt_alt <= o2.max_XA_hits_alt) {
        std::string parts;
        static const char XOPS[] = "MIDSHN";
        for (int i = 0; i < (int)regs0->size(); ++i) {
            Reg2 &q = (*regs0)[i];
            int r = get_pri_idx(o2.XA_drop_ratio, *regs0, i);
            if (r < 0 || r != p0_idx) continue;
            if (q.n_cigar == 0) {
                if (!setSAM(opt, bns, s, q)) return false;
                if (q.n_cigar == 0) continue;
            }
            if (!parts.empty()) parts += ';';
            parts += ann_names[q.rid];
            parts += ',';
            parts += "+-"[q.is_rev];
            parts += std::to_string(q.pos + 1);
            parts += ',';
            for (auto &oc : q.cigar) {
                parts += std::to_string(oc.second);
                parts += XOPS[oc.first];
            }
            parts += ',';
            parts += std::to_string(q.NM);
        }
        if (!parts.empty()) { out += "\tXA:Z:"; out += parts; }
    }
    if (cnt_pri > 0 || cnt_alt > 0) {
        out += "\tXB:Z:";
        out += std::to_string(cnt_pri);
        out += ',';
        out += std::to_string(cnt_alt);
    }
    return true;
}

// sam.py:265 _tag_SA
static void tag_SA(const Opt &opt, const std::vector<std::string> &ann_names,
                   int p0_idx, int p0_flag, const std::vector<Reg2> *regs0,
                   std::string &out) {
    if (!regs0 || (p0_flag & 0x100)) return;
    std::string parts;
    static const char OPS[] = "MIDSH";
    for (int i = 0; i < (int)regs0->size(); ++i) {
        const Reg2 &q = (*regs0)[i];
        if (i == p0_idx || q.n_cigar == 0 || (q.flag & 0x100)) continue;
        parts += ann_names[q.rid];
        parts += ',';
        parts += std::to_string(q.pos + 1);
        parts += ',';
        parts += "+-"[q.is_rev];
        parts += ',';
        for (auto &oc : q.cigar) {
            parts += std::to_string(oc.second);
            parts += OPS[oc.first];
        }
        parts += ',';
        parts += std::to_string(q.mapq);
        parts += ',';
        parts += std::to_string(q.NM);
        parts += ';';
    }
    if (!parts.empty()) { out += "\tSA:Z:"; out += parts; }
}

// sam.py:286 format_sam, SE specialization (m0 = None, pes = None)
static bool format_sam_se(const Opt &opt, const Opt2 &o2, const Bns &bns,
                          const std::vector<std::string> &ann_names,
                          const ReadSE &s, const Reg2 &p0, int p0_idx,
                          std::vector<Reg2> *regs0, int is_primary,
                          const std::string &rg, std::string &out) {
    Reg2 p = p0;  // copy; mutations stay local (copy.copy in Python)
    out.append(s.name, s.name_len);
    out += '\t';
    out += std::to_string((p.flag & 0xFFFF) | ((p.flag & 0x10000) ? 0x100 : 0));
    out += '\t';
    if (p.rid >= 0) {
        out += ann_names[p.rid];
        out += '\t';
        out += std::to_string(p.pos + 1);
        out += '\t';
        out += std::to_string(p.mapq);
        out += '\t';
        if (p.n_cigar) cigar_str(p.cigar, is_primary, opt, p.is_alt, out);
        else out += '*';
    } else {
        out += "*\t0\t0\t*";
    }
    out += "\t*\t0\t0\t";  // no mate
    if (p.flag & 0x100) {
        out += "*\t*";
    } else {
        static const char FWD[] = "ACGTN", COMP[] = "TGCAN";
        int qb = 0, qe = s.l_seq0;
        bool hard = p.n_cigar && !is_primary && !(opt.flag & 0x200) && !p.is_alt;
        if (p.is_rev) {
            if (hard) {
                if (p.cigar.front().first == 3 || p.cigar.front().first == 4)
                    qe -= p.cigar.front().second;
                if (p.cigar.back().first == 3 || p.cigar.back().first == 4)
                    qb += p.cigar.back().second;
            }
            for (int j = qe - 1; j >= qb; --j)
                out += COMP[s.seq0[j] < 4 ? s.seq0[j] : 4];
            out += '\t';
            if (s.l_qual) for (int j = qe - 1; j >= qb; --j) out += s.qual[j];
            else out += '*';
        } else {
            if (hard) {
                if (p.cigar.front().first == 3 || p.cigar.front().first == 4)
                    qb += p.cigar.front().second;
                if (p.cigar.back().first == 3 || p.cigar.back().first == 4)
                    qe -= p.cigar.back().second;
            }
            for (int j = qb; j < qe; ++j)
                out += FWD[s.seq0[j] < 4 ? s.seq0[j] : 4];
            out += '\t';
            if (s.l_qual) out.append(s.qual + qb, qe - qb);
            else out += '*';
        }
    }
    if (p.n_cigar) {
        out += "\tNM:i:";
        out += std::to_string(p.NM);
        out += "\tMD:Z:";
        out += p.md;
        out += "\tZC:i:";
        out += std::to_string(p.ZC);
        out += "\tZR:i:";
        out += std::to_string(p.ZR);
    }
    if (p.score >= 0) { out += "\tAS:i:"; out += std::to_string(p.score); }
    if (p.sub >= 0) { out += "\tXS:i:"; out += std::to_string(std::max(p.sub, p.csub)); }
    if (!rg.empty()) { out += "\tRG:Z:"; out += rg; }
    tag_SA(opt, ann_names, p0_idx, p0.flag, regs0, out);
    if (is_primary && p.alt_sc > 0) {
        char buf[32];
        snprintf(buf, sizeof buf, "\tPA:f:%.3f", (double)p.score / p.alt_sc);
        out += buf;
    }
    out += "\tXL:i:";
    out += std::to_string(s.l_seq);
    if (!tag_XAXB(opt, o2, bns, ann_names, s, p0_idx, regs0, out)) return false;
    out += "\tMC:Z:*\tMQ:i:0\tYD:A:";
    out += p.bss_u ? 'u' : "fr"[p.bss];
    out += '\n';
    return true;
}

// sam.py:568 reg2sam_se (mem_reg2sam_se)
static bool reg2sam_se(const Opt &opt, const Opt2 &o2, const Bns &bns,
                       const std::vector<std::string> &ann_names,
                       const ReadSE &s, std::vector<Reg2> &regs,
                       const std::string &rg, std::string &out) {
    std::vector<int> to_output;
    if (!select_format(opt, o2, bns, s, regs, to_output)) return false;
    if (!to_output.empty()) {
        for (size_t i = 0; i < to_output.size(); ++i) {
            int k = to_output[i];
            Reg2 snapshot = regs[k];  // regs0 entries may be setSAM'd later
            if (!format_sam_se(opt, o2, bns, ann_names, s, snapshot, k, &regs,
                               i == 0 ? 1 : 0, rg, out))
                return false;
        }
        return true;
    }
    Reg2 u;
    u.rid = -1;
    u.flag = 0x4;
    u.sub = 0;
    return format_sam_se(opt, o2, bns, ann_names, s, u, -1, &regs, 1, rg, out);
}

// pipeline.py:93 worker2_se
static bool worker2_se(const Opt &opt, const Opt2 &o2, const Bns &bns,
                       const std::vector<std::string> &ann_names,
                       const ReadSE &s, std::vector<Reg2> &regs,
                       int64_t rid_id, const std::string &rg, std::string &out) {
    int n_pri;
    mark_primary(opt, regs, rid_id, n_pri);
    for (auto &r : regs) r.flag = 0;
    return reg2sam_se(opt, o2, bns, ann_names, s, regs, rg, out);
}

// =====================================================================
// PE: insert-size stats, mate rescue (striped-SW emulation), pairing,
// and paired SAM emission. Ports align/pair.py (pestat/mem_pair),
// region.py:475-559 (isize helpers + matesw), ops/sw.py:228-318
// (sw_align/_local_core striped u8/i16 emulation), and
// sam.py:286-565 (full format_sam, reg2sam_pe{,_nopairing}).
// =====================================================================

struct Opt3 {  // PE-only knobs (config.py)
    int64_t max_ins;
    int max_matesw;
};

struct PeStatS {
    int64_t low = 0, high = 0;
    int set_ = 0, failed = 0;
    double avg = 0.0, std = 0.0;
};

// region.py:475 infer_isize
static bool infer_isize(int64_t pos1, int64_t pos2, int isrev1, int isrev2,
                        int len1, int len2, int64_t &out) {
    if (isrev1 && !isrev2) { out = pos1 - pos2 + len1; return true; }
    if (isrev2 && !isrev1) { out = pos2 - pos1 + len2; return true; }
    return false;
}

// region.py:483 alnreg_isize
static bool alnreg_isize(const Bns &bns, const Reg2 &r1, const Reg2 &r2,
                         int64_t &out) {
    if (r1.rid != r2.rid) return false;
    bool isrev1 = r1.rb > bns.l_pac;
    bool isrev2 = r2.rb > bns.l_pac;
    int64_t pos1 = isrev1 ? (bns.l_pac << 1) - 1 - r1.rb : r1.rb;
    int64_t pos2 = isrev2 ? (bns.l_pac << 1) - 1 - r2.rb : r2.rb;
    return infer_isize(pos1, pos2, isrev1, isrev2, r1.qe - r1.qb,
                       r2.qe - r2.qb, out);
}

// region.py:493 is_proper_pair
static bool is_proper_pair(const Bns &bns, const Reg2 &r1, const Reg2 &r2,
                           const PeStatS &pes) {
    int64_t isize;
    if (!alnreg_isize(bns, r1, r2, isize)) return false;
    return pes.low <= isize && isize <= pes.high;
}

// pair.py:31 _cal_sub
static int cal_sub(const Opt &opt, const std::vector<Reg2> &regs) {
    const Reg2 &best = regs[0];
    for (size_t j = 1; j < regs.size(); ++j) {
        const Reg2 &p = regs[j];
        int b_max = std::max(p.qb, best.qb);
        int e_min = std::min(p.qe, best.qe);
        if (e_min > b_max) {
            int min_l = std::min(p.qe - p.qb, best.qe - best.qb);
            if (e_min - b_max >= min_l * opt.mask_level) return p.score;
        }
    }
    return opt.min_seed_len * opt.a;
}

// pair.py:44 pestat (mem_pestat). Prints the reference's [M::mem_pestat]
// progress lines to stderr like the Python engine does.
static void pestat(const Opt &opt, const Opt3 &o3, const Bns &bns,
                   const std::vector<std::vector<Reg2>> &all_regs,
                   PeStatS &pes, bool verbose) {
    std::vector<int64_t> isize;
    size_t n = all_regs.size();
    for (size_t i = 0; i < n >> 1; ++i) {
        const std::vector<Reg2> &r0 = all_regs[i << 1];
        const std::vector<Reg2> &r1 = all_regs[(i << 1) | 1];
        if (r0.empty() || r1.empty()) continue;
        const Reg2 &best0 = r0[0], &best1 = r1[0];
        if (cal_sub(opt, r0) > 0.8 * best0.score) continue;
        if (cal_sub(opt, r1) > 0.8 * best1.score) continue;
        if (best0.rid != best1.rid) continue;
        if (best0.bss != best1.bss) continue;
        int64_t is_;
        if (alnreg_isize(bns, best0, best1, is_)
            && -o3.max_ins <= is_ && is_ <= o3.max_ins)
            isize.push_back(is_);
    }
    pes = PeStatS();
    if (verbose)
        fprintf(stderr, "[M::mem_pestat] # candidate unique pairs: %zu\n",
                isize.size());
    if ((int)isize.size() < 10) {
        if (verbose)
            fprintf(stderr, "[M:mem_pestat] There are not enough pairs for insert size inference\n");
        pes.failed = 1;
        return;
    }
    std::sort(isize.begin(), isize.end());
    int64_t p25 = isize[(size_t)(0.25 * isize.size() + 0.499)];
    int64_t p50 = isize[(size_t)(0.50 * isize.size() + 0.499)];
    int64_t p75 = isize[(size_t)(0.75 * isize.size() + 0.499)];
    pes.low = (int64_t)(p25 - 2.0 * (p75 - p25) + 0.499);
    pes.high = (int64_t)(p75 + 2.0 * (p75 - p25) + 0.499);
    if (verbose) {
        fprintf(stderr, "[M::mem_pestat] (25, 50, 75) percentile: (%lld, %lld, %lld)\n",
                (long long)p25, (long long)p50, (long long)p75);
        fprintf(stderr, "[M::mem_pestat] low and high boundaries for computing mean and std.dev: (%lld, %lld)\n",
                (long long)pes.low, (long long)pes.high);
    }
    int64_t cnt = 0;
    double sum = 0.0;
    for (int64_t v : isize)
        if (pes.low <= v && v <= pes.high) { sum += (double)v; ++cnt; }
    pes.avg = sum / cnt;
    double var = 0.0;
    for (int64_t v : isize)
        if (pes.low <= v && v <= pes.high)
            var += ((double)v - pes.avg) * ((double)v - pes.avg);
    pes.std = std::sqrt(var / cnt);
    if (verbose)
        fprintf(stderr, "[M::mem_pestat] mean and std.dev: (%.2f, %.2f)\n",
                pes.avg, pes.std);
    pes.low = (int64_t)(p25 - 3.0 * (p75 - p25) + 0.499);
    pes.high = (int64_t)(p75 + 3.0 * (p75 - p25) + 0.499);
    if ((double)pes.low > pes.avg - 4.0 * pes.std)
        pes.low = (int64_t)(pes.avg - 4.0 * pes.std + 0.499);
    if ((double)pes.high < pes.avg + 4.0 * pes.std)
        pes.high = (int64_t)(pes.avg + 4.0 * pes.std + 0.499);
    if (verbose)
        fprintf(stderr, "[M::mem_pestat] low and high boundaries for proper pairs: (%lld, %lld)\n",
                (long long)pes.low, (long long)pes.high);
}

// ops/sw.py:228 _local_core — scalar equivalent of the striped ksw_i16/u8
// kernels including the lane-padding echo and 255 saturation quirks.
struct KswRes { int score = 0, te = -1, qe = -1, score2 = -1, te2 = -1,
                    tb = -1, qb = -1; };

static void local_core(const uint8_t *query, int qlen0, const uint8_t *target,
                       int tlen, const int8_t *mat, int o_del, int e_del,
                       int o_ins, int e_ins, int minsc, int endsc, bool u8,
                       KswRes &r) {
    r = KswRes();
    if (qlen0 == 0 || tlen == 0) return;
    int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    int lanes = u8 ? 16 : 8;
    int8_t mat_min = 127, mat_max = -128;
    for (int i = 0; i < 25; ++i) {
        mat_min = std::min(mat_min, mat[i]);
        mat_max = std::max(mat_max, mat[i]);
    }
    int shift = u8 ? ((256 - (int)mat_min) & 0xFF) : 0;
    int qlen = (qlen0 + lanes - 1) / lanes * lanes;  // zero-scoring pad lanes
    std::vector<int64_t> H(qlen, 0), E(qlen, 0), Hmax(qlen, 0);
    int64_t gmax = 0;
    int te = -1;
    std::vector<std::pair<int64_t, int>> b;  // (imax, i) runs
    for (int i = 0; i < tlen; ++i) {
        const int8_t *S = mat + (int)target[i] * 5;
        int64_t diag = 0;  // H[-1] treated as 0
        int64_t F = 0;
        int64_t imax = 0;
        for (int j = 0; j < qlen; ++j) {
            int sc = j < qlen0 ? S[query[j]] : 0;
            int64_t M = diag + sc;
            if (M < 0) M = 0;
            int64_t H1 = std::max(M, E[j]);
            int64_t h = std::max(H1, F);
            diag = H[j];
            H[j] = h;
            if (h > imax) imax = h;
            E[j] = std::max(E[j] - e_del, std::max(h - oe_del, (int64_t)0));
            F = std::max(F - e_ins, std::max(h - oe_ins, (int64_t)0));
        }
        if (imax >= minsc) {
            if (b.empty() || b.back().second + 1 != i) b.push_back({imax, i});
            else if (b.back().first < imax) b.back() = {imax, i};
        }
        if (imax > gmax) {
            gmax = imax;
            te = i;
            Hmax = H;
            if ((u8 && gmax + shift >= 255) || gmax >= endsc) break;
        }
    }
    r.score = (u8 && gmax + shift >= 255) ? 255 : (int)gmax;
    r.te = te;
    if (u8 && r.score == 255) return;  // reference skips qe/score2 (ksw.c:211)
    int64_t mx = -1;
    for (int j = 0; j < qlen; ++j) mx = std::max(mx, Hmax[j]);
    if (mx >= 0)
        for (int j = 0; j < qlen; ++j)
            if (Hmax[j] == mx) { r.qe = j; break; }
    if (!b.empty()) {
        int iw = (r.score + mat_max - 1) / mat_max;
        int low = te - iw, high = te + iw;
        for (auto &se : b)
            if ((se.second < low || se.second > high) && se.first > r.score2) {
                r.score2 = (int)se.first;
                r.te2 = se.second;
            }
    }
}

// CAUTION (ops/sw.py:247-269): the E/F recurrences here derive from h AFTER
// the f-max, not from H1 — the Python kernel proves the closed forms agree
// because oe >= e; the scalar loop above uses h directly, matching the
// reference's lazy-F fixed point. Verified against ref_bindings in
// tests/test_sw.py and E2E.

// ops/sw.py:300 sw_align (ksw_align2)
static void sw_align(const uint8_t *query, int qlen, const uint8_t *target,
                     int tlen, const int8_t *mat, int o_del, int e_del,
                     int o_ins, int e_ins, int xsubo, bool xbyte, KswRes &r) {
    int minsc = xsubo, endsc = 0x10000;
    local_core(query, qlen, target, tlen, mat, o_del, e_del, o_ins, e_ins,
               minsc, endsc, xbyte, r);
    if (r.score < minsc) return;
    std::vector<uint8_t> rq(query, query + r.qe + 1);
    std::vector<uint8_t> rt(target, target + r.te + 1);
    std::reverse(rq.begin(), rq.end());
    std::reverse(rt.begin(), rt.end());
    KswRes rr;
    local_core(rq.data(), (int)rq.size(), rt.data(), (int)rt.size(), mat,
               o_del, e_del, o_ins, e_ins, 0x10000, r.score, xbyte, rr);
    if (r.score == rr.score) {
        r.tb = r.te - rr.te;
        r.qb = r.qe - rr.qe;
    }
}

// region.py:498 _matesw_core (mem_alnreg_matesw_core)
static void matesw_core(const Opt &opt, const Opt2 &o2, const Bns &bns,
                        const PeStatS &pes, const Reg2 &reg, int l_ms,
                        const uint8_t *ms, std::vector<Reg2> &mregs,
                        std::vector<Reg2> *graveyard, uint32_t &next_serial) {
    int64_t l_pac = bns.l_pac;
    for (const Reg2 &mr : mregs) {
        int64_t isize;
        if (alnreg_isize(bns, reg, mr, isize)
            && pes.low <= isize && isize <= pes.high)
            return;
    }
    std::vector<uint8_t> rev(l_ms);
    for (int j = 0; j < l_ms; ++j) {
        uint8_t c = ms[l_ms - 1 - j];
        rev[j] = c < 4 ? 3 - c : 4;
    }
    int64_t rb = std::max((int64_t)0, reg.rb + pes.low - l_ms);
    int64_t re = std::min(l_pac << 1, reg.rb + pes.high);
    if (rb >= re) return;
    std::vector<uint8_t> ref;
    int rid = fetch_seq(bns, rb, (rb + re) >> 1, re, ref);
    if (reg.rid != rid || re - rb < opt.min_seed_len) return;
    int parent = reg.bss ^ (reg.rb < l_pac ? 1 : 0);
    KswRes aln;
    // xbyte: the reference uses the u8 striped kernel when l_ms*a < 250
    sw_align(rev.data(), l_ms, ref.data(), (int)ref.size(),
             parent ? opt.mats[0] : opt.mats[1],  // gamat if parent else ctmat
             opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
             opt.min_seed_len * opt.a, l_ms * opt.a < 250, aln);
    if (aln.score >= opt.min_seed_len && aln.qb >= 0) {
        Reg2 b;
        b.rid = reg.rid;
        b.is_alt = reg.is_alt;
        b.qb = l_ms - (aln.qe + 1);
        b.qe = l_ms - aln.qb;
        b.rb = (l_pac << 1) - (rb + aln.te + 1);
        b.re = (l_pac << 1) - (rb + aln.tb);
        b.score = aln.score;
        b.csub = aln.score2;
        b.secondary = -1;
        b.seedcov = (int)(std::min(b.re - b.rb, (int64_t)(b.qe - b.qb)) >> 1);
        b.bss = reg.bss;
        b.parent = 1 - parent;
        b.serial = next_serial++;
        size_t i = 0;
        while (i < mregs.size() && mregs[i].score >= b.score) ++i;
        mregs.insert(mregs.begin() + i, b);
        // sort_deduplicate with idx=None/query=None: concat test disabled
        sort_deduplicate(opt, o2, bns, nullptr, mregs, graveyard);
    }
}

// region.py:546 matesw (mem_alnreg_matesw). Python's `good` lists hold live
// object references collected before any rescue mutates the region lists;
// we track them by serial and consult graveyards for removed entries.
static void matesw(const Opt &opt, const Opt2 &o2, const Opt3 &o3,
                   const Bns &bns, const PeStatS &pes,
                   const ReadSE &s0, const ReadSE &s1,
                   std::vector<Reg2> &regs0, std::vector<Reg2> &regs1,
                   uint32_t &next_serial) {
    std::vector<uint32_t> good[2];
    std::vector<Reg2> *rp[2] = {&regs0, &regs1};
    const ReadSE *sp[2] = {&s0, &s1};
    std::vector<Reg2> grave[2];
    for (int i = 0; i < 2; ++i)
        for (const Reg2 &r : *rp[i])
            if (!rp[i]->empty() && r.score >= (*rp[i])[0].score - o2.pen_unpaired)
                good[i].push_back(r.serial);
    auto lookup = [&](int list, uint32_t serial) -> const Reg2 * {
        for (const Reg2 &r : *rp[list]) if (r.serial == serial) return &r;
        for (const Reg2 &r : grave[list]) if (r.serial == serial) return &r;
        return nullptr;
    };
    for (int i = 0; i < 2; ++i)
        for (size_t j = 0; j < good[i].size(); ++j) {
            if ((int)j >= o3.max_matesw) break;
            const Reg2 *r = lookup(i, good[i][j]);
            if (!r) continue;  // unreachable: removed entries live in grave
            Reg2 snapshot = *r;  // matesw_core may reorder/remove from rp[i]?
            // (it only mutates rp[1-i]; snapshot also guards vector realloc)
            matesw_core(opt, o2, bns, pes, snapshot, sp[1 - i]->l_seq,
                        sp[1 - i]->seq, *rp[1 - i], &grave[1 - i],
                        next_serial);
        }
}

// pair.py:105 region_depos
static int64_t region_depos(const Bns &bns, const Reg2 &reg) {
    bool is_rev;
    int64_t rpos = depos(bns, reg.rb < bns.l_pac ? reg.rb : reg.re - 1, is_rev);
    return rpos - bns.ann_off[reg.rid];
}

// pair.py:110 mem_pair. Returns score (0 => no pairing); z = chosen indices.
static int mem_pair(const Opt &opt, const Bns &bns, const PeStatS &pes,
                    std::vector<Reg2> *regs_pair[2], const int n_pri[2],
                    int64_t pair_id, int &sub_out, int &n_sub_out, int z[2]) {
    struct V { uint64_t x, y; int z; };
    std::vector<V> v;
    for (int r = 0; r < 2; ++r) {
        std::vector<Reg2> &regs = *regs_pair[r];
        for (int i = 0; i < n_pri[r]; ++i) {
            const Reg2 &p = regs[i];
            uint64_t x = ((uint64_t)(p.bss & 1) << 63)
                | ((uint64_t)(uint32_t)p.rid << 32)
                | (uint64_t)(uint32_t)(region_depos(bns, p) & 0xFFFFFFFF);
            uint64_t y = ((uint64_t)(uint32_t)p.score << 32)
                | ((uint64_t)i << 2)
                | ((p.rb >= bns.l_pac ? 1ULL : 0ULL) << 1) | (uint64_t)r;
            v.push_back({x, y, p.qe - p.qb});
        }
    }
    std::stable_sort(v.begin(), v.end(), [](const V &a, const V &b) {
        if (a.x != b.x) return a.x < b.x;
        return a.y < b.y;
    });
    struct PP { uint64_t x, y; };
    std::vector<PP> pp;
    int64_t maxlh = std::max(pes.low, pes.high);
    for (int i = 0; i < (int)v.size(); ++i) {
        for (int k = i - 1; k >= 0; --k) {
            if (v[i].x >> 32 != v[k].x >> 32) break;
            if (v[i].x >> 63 != v[k].x >> 63) break;
            if ((int64_t)((v[i].x & 0xFFFFFFFF) - (v[k].x & 0xFFFFFFFF)) > maxlh) break;
            if ((v[i].y & 1) == (v[k].y & 1)) break;
            int64_t is_;
            if (infer_isize((int64_t)(v[k].x & 0xFFFFFFFF),
                            (int64_t)(v[i].x & 0xFFFFFFFF),
                            (int)((v[k].y >> 1) & 1), (int)((v[i].y >> 1) & 1),
                            v[k].z, v[i].z, is_)
                && pes.low <= is_ && is_ <= pes.high) {
                double zscore = ((double)is_ - pes.avg) / pes.std;
                // 1/sqrt(2) computed like Python's `1 / math.sqrt(2)` so the
                // double matches bit-for-bit (may differ 1 ulp from M_SQRT1_2)
                double inv_sqrt2 = 1.0 / std::sqrt(2.0);
                double raw = (double)(v[i].y >> 32) + (double)(v[k].y >> 32)
                    + 0.721 * std::log(2.0 * std::erfc(std::fabs(zscore) * inv_sqrt2)) * opt.a
                    + 0.499;
                int64_t score_ = std::max((int64_t)0, (int64_t)raw);
                uint64_t y = ((uint64_t)k << 32) | (uint64_t)i;
                uint64_t x = ((uint64_t)score_ << 32)
                    | (hash_64(y ^ ((uint64_t)pair_id << 8)) & 0xFFFFFFFF);
                pp.push_back({x, y});
            }
        }
    }
    z[0] = z[1] = -1;
    if (pp.empty()) { sub_out = 0; n_sub_out = 0; return 0; }
    std::stable_sort(pp.begin(), pp.end(), [](const PP &a, const PP &b) {
        if (a.x != b.x) return a.x < b.x;
        return a.y < b.y;
    });
    uint64_t yi = pp.back().y >> 32;       // k
    uint64_t yk = pp.back().y & 0xFFFFFFFF;  // i
    int ii = (int)yk, kk = (int)yi;
    z[v[ii].y & 1] = (int)((v[ii].y & 0xFFFFFFFF) >> 2);
    z[v[kk].y & 1] = (int)((v[kk].y & 0xFFFFFFFF) >> 2);
    int score = (int)(pp.back().x >> 32);
    int sub = pp.size() > 1 ? (int)(pp[pp.size() - 2].x >> 32) : 0;
    int tmp = std::max(std::max(opt.a + opt.b, opt.o_del + opt.e_del),
                       opt.o_ins + opt.e_ins);
    int n_sub = 0;
    for (int j = (int)pp.size() - 2; j >= 0; --j)
        if (sub - (int)(pp[j].x >> 32) <= tmp) ++n_sub;
    sub_out = sub;
    n_sub_out = n_sub;
    return score;
}

// sam.py:43 get_rlen
static int64_t get_rlen(const std::vector<std::pair<int, int>> &cigar) {
    int64_t n = 0;
    for (auto &oc : cigar)
        if (oc.first == 0 || oc.first == 2) n += oc.second;
    return n;
}

// sam.py:447 raw_mapq
static int raw_mapq(int diff, int a) {
    return (int)(6.02 * diff / a + 0.499);
}

// sam.py:286 format_sam — full version with mate handling. p0_orig is the
// live region in regs0 (identity for SA/XA); m0 may be null (SE / unmapped
// mate synthesized by the caller).
static bool format_sam(const Opt &opt, const Opt2 &o2, const Bns &bns,
                       const std::vector<std::string> &ann_names,
                       const ReadSE &s, const Reg2 &p0, int p0_idx,
                       const Reg2 *m0, std::vector<Reg2> *regs0,
                       int is_primary, const PeStatS *pes,
                       const std::string &rg, std::string &out) {
    Reg2 p = p0;
    Reg2 mcopy;
    Reg2 *m = nullptr;
    if (m0) { mcopy = *m0; m = &mcopy; }
    p.flag |= m0 ? 0x1 : 0;
    p.flag |= (m0 && m->rid < 0) ? 0x8 : 0;
    if (m0 && m0->bss_u == 0) p.bss_u = 0;
    if (p.rid >= 0 && m0 && m->rid >= 0 && pes
        && is_proper_pair(bns, p, *m, *pes)) {
        p.flag |= 2;
        m->flag |= 2;
    }
    if (p.rid < 0 && m0 && m->rid >= 0) {
        p.rid = m->rid;
        p.pos = m->pos;
        p.is_rev = m->is_rev;
        p.n_cigar = 0;
        p.cigar.clear();
    }
    if (m0 && m->rid < 0 && p.rid >= 0) {
        m->rid = p.rid;
        m->pos = p.pos;
        m->is_rev = p.is_rev;
        m->n_cigar = 0;
        m->cigar.clear();
    }
    p.flag |= (m0 && m->is_rev) ? 0x20 : 0;

    out.append(s.name, s.name_len);
    out += '\t';
    out += std::to_string((p.flag & 0xFFFF) | ((p.flag & 0x10000) ? 0x100 : 0));
    out += '\t';
    if (p.rid >= 0) {
        out += ann_names[p.rid];
        out += '\t';
        out += std::to_string(p.pos + 1);
        out += '\t';
        out += std::to_string(p.mapq);
        out += '\t';
        if (p.n_cigar) cigar_str(p.cigar, is_primary, opt, p.is_alt, out);
        else out += '*';
    } else {
        out += "*\t0\t0\t*";
    }
    out += '\t';
    if (m0 && m->rid >= 0) {
        if (p.rid == m->rid) out += '=';
        else out += ann_names[m->rid];
        out += '\t';
        out += std::to_string(m->pos + 1);
        out += '\t';
        if (p.rid == m->rid) {
            int64_t pp0 = -1, pp1 = -1;
            if (p.is_rev)
                pp1 = p.pos + (p.n_cigar ? get_rlen(p.cigar) : 0) - 1;
            else pp0 = p.pos;
            if (m->is_rev)
                pp1 = m->pos + (m->n_cigar ? get_rlen(m->cigar) : 0) - 1;
            else pp0 = m->pos;
            if (p.n_cigar > 0 && m->n_cigar > 0 && pp0 >= 0 && pp1 >= 0)
                out += std::to_string(pp1 - pp0 + 1);
            else out += '0';
        } else {
            out += '0';
        }
    } else {
        out += "*\t0\t0";
    }
    out += '\t';
    if (p.flag & 0x100) {
        out += "*\t*";
    } else {
        static const char FWD[] = "ACGTN", COMP[] = "TGCAN";
        int qb = 0, qe = s.l_seq0;
        bool hard = p.n_cigar && !is_primary && !(opt.flag & 0x200) && !p.is_alt;
        if (p.is_rev) {
            if (hard) {
                if (p.cigar.front().first == 3 || p.cigar.front().first == 4)
                    qe -= p.cigar.front().second;
                if (p.cigar.back().first == 3 || p.cigar.back().first == 4)
                    qb += p.cigar.back().second;
            }
            for (int j = qe - 1; j >= qb; --j)
                out += COMP[s.seq0[j] < 4 ? s.seq0[j] : 4];
            out += '\t';
            if (s.l_qual) for (int j = qe - 1; j >= qb; --j) out += s.qual[j];
            else out += '*';
        } else {
            if (hard) {
                if (p.cigar.front().first == 3 || p.cigar.front().first == 4)
                    qb += p.cigar.front().second;
                if (p.cigar.back().first == 3 || p.cigar.back().first == 4)
                    qe -= p.cigar.back().second;
            }
            for (int j = qb; j < qe; ++j)
                out += FWD[s.seq0[j] < 4 ? s.seq0[j] : 4];
            out += '\t';
            if (s.l_qual) out.append(s.qual + qb, qe - qb);
            else out += '*';
        }
    }
    if (p.n_cigar) {
        out += "\tNM:i:";
        out += std::to_string(p.NM);
        out += "\tMD:Z:";
        out += p.md;
        out += "\tZC:i:";
        out += std::to_string(p.ZC);
        out += "\tZR:i:";
        out += std::to_string(p.ZR);
    }
    if (p.score >= 0) { out += "\tAS:i:"; out += std::to_string(p.score); }
    if (p.sub >= 0) { out += "\tXS:i:"; out += std::to_string(std::max(p.sub, p.csub)); }
    if (!rg.empty()) { out += "\tRG:Z:"; out += rg; }
    tag_SA(opt, ann_names, p0_idx, p0.flag, regs0, out);
    if (is_primary && p.alt_sc > 0) {
        char buf[32];
        snprintf(buf, sizeof buf, "\tPA:f:%.3f", (double)p.score / p.alt_sc);
        out += buf;
    }
    out += "\tXL:i:";
    out += std::to_string(s.l_seq);
    if (!tag_XAXB(opt, o2, bns, ann_names, s, p0_idx, regs0, out)) return false;
    out += "\tMC:Z:";
    if (m && m->n_cigar) cigar_str(m->cigar, is_primary, opt, m->is_alt, out);
    else out += '*';
    out += "\tMQ:i:";
    out += std::to_string(m ? m->mapq : 0);
    out += "\tYD:A:";
    out += p.bss_u ? 'u' : "fr"[p.bss];
    out += '\n';
    return true;
}

// sam.py:451 reg2sam_pe_nopairing
static bool reg2sam_pe_nopairing(const Opt &opt, const Opt2 &o2, const Bns &bns,
                                 const std::vector<std::string> &ann_names,
                                 const ReadSE *seqs[2],
                                 std::vector<Reg2> *regs_pair[2],
                                 const PeStatS *pes, const std::string &rg,
                                 std::string out[2]) {
    Reg2 synth[2];
    const Reg2 *best[2] = {nullptr, nullptr};
    int best_idx[2] = {-1, -1};
    std::vector<int> to_outputs[2];
    for (int i = 0; i < 2; ++i) {
        if (!select_format(opt, o2, bns, *seqs[i], *regs_pair[i], to_outputs[i]))
            return false;
        if (!to_outputs[i].empty()) {
            best_idx[i] = to_outputs[i][0];
            best[i] = &(*regs_pair[i])[best_idx[i]];
        } else {
            synth[i].rid = -1;
            synth[i].flag = (0x40 << i) | 0x1 | 0x4;
            synth[i].sub = 0;
            best[i] = &synth[i];
        }
    }
    for (int i = 0; i < 2; ++i) {
        std::vector<Reg2> &regs = *regs_pair[i];
        if (!to_outputs[i].empty()) {
            for (size_t j = 0; j < to_outputs[i].size(); ++j) {
                int k = to_outputs[i][j];
                Reg2 snapshot = regs[k];
                // best[1-i] may alias an entry that later setSAMs mutate;
                // Python passes the live object — mirror via current value
                if (!format_sam(opt, o2, bns, ann_names, *seqs[i], snapshot, k,
                                best[1 - i], &regs, j == 0 ? 1 : 0, pes, rg,
                                out[i]))
                    return false;
            }
        } else {
            if (!format_sam(opt, o2, bns, ann_names, *seqs[i], *best[i], -1,
                            best[1 - i], nullptr, 1, pes, rg, out[i]))
                return false;
        }
    }
    return true;
}

// sam.py:484 reg2sam_pe (mem_reg2sam_pe)
static bool reg2sam_pe(const Opt &opt, const Opt2 &o2, const Bns &bns,
                       const std::vector<std::string> &ann_names,
                       int64_t pair_id, const ReadSE *seqs[2],
                       std::vector<Reg2> *regs_pair[2], const int n_pri[2],
                       const PeStatS &pes, const std::string &rg,
                       std::string out[2]) {
    for (int i = 0; i < 2; ++i)
        for (Reg2 &r : *regs_pair[i]) r.flag |= (0x40 << i) | 1;
    if (opt.flag & 0x4)  // MEM_F_NOPAIRING
        return reg2sam_pe_nopairing(opt, o2, bns, ann_names, seqs, regs_pair,
                                    &pes, rg, out);
    if (n_pri[0] == 0 || n_pri[1] == 0)
        return reg2sam_pe_nopairing(opt, o2, bns, ann_names, seqs, regs_pair,
                                    &pes, rg, out);
    for (int i = 0; i < 2; ++i) {
        int j = 1;
        while (j < n_pri[i]) {
            const Reg2 &q = (*regs_pair[i])[j];
            if (q.secondary < 0 && q.score >= o2.T) break;
            ++j;
        }
        if (j < n_pri[i])  // multi-hit => no pairing
            return reg2sam_pe_nopairing(opt, o2, bns, ann_names, seqs,
                                        regs_pair, &pes, rg, out);
    }
    int sub_pscore, n_subpairings, z[2];
    int pscore = mem_pair(opt, bns, pes, regs_pair, n_pri, pair_id,
                          sub_pscore, n_subpairings, z);
    if (pscore <= 0)
        return reg2sam_pe_nopairing(opt, o2, bns, ann_names, seqs, regs_pair,
                                    &pes, rg, out);
    int score_unpaired = (*regs_pair[0])[0].score + (*regs_pair[1])[0].score
        - o2.pen_unpaired;
    if (pscore > score_unpaired) {
        sub_pscore = std::max(sub_pscore, score_unpaired);
        int q_pe = raw_mapq(pscore - sub_pscore, opt.a);
        if (n_subpairings > 0)
            q_pe -= (int)(4.343 * std::log((double)(n_subpairings + 1)) + 0.499);
        q_pe = std::max(0, std::min(60, q_pe));
        q_pe = (int)(q_pe * (1.0 - 0.5 * ((*regs_pair[0])[0].frac_rep
                                          + (*regs_pair[1])[0].frac_rep))
                     + 0.499);
        int q_se[2];
        Reg2 *c[2] = {&(*regs_pair[0])[z[0]], &(*regs_pair[1])[z[1]]};
        for (int i = 0; i < 2; ++i) {
            if (c[i]->secondary >= 0) {
                c[i]->sub = (*regs_pair[i])[c[i]->secondary].score;
                c[i]->secondary = -2;
            }
            q_se[i] = mapq_se(opt, o2, *c[i]);
        }
        q_se[0] = std::max(q_se[0], std::min(q_pe, q_se[0] + 40));
        q_se[1] = std::max(q_se[1], std::min(q_pe, q_se[1] + 40));
        c[0]->mapq = std::min(q_se[0], raw_mapq(c[0]->score - c[0]->csub, opt.a));
        c[1]->mapq = std::min(q_se[1], raw_mapq(c[1]->score - c[1]->csub, opt.a));
    } else {
        z[0] = z[1] = 0;
        (*regs_pair[0])[0].mapq = mapq_se(opt, o2, (*regs_pair[0])[0]);
        (*regs_pair[1])[0].mapq = mapq_se(opt, o2, (*regs_pair[1])[0]);
    }
    // secondary/primary switch
    for (int i = 0; i < 2; ++i) {
        std::vector<Reg2> &regs = *regs_pair[i];
        int k = regs[z[i]].secondary_all;
        if (0 <= k && k < n_pri[i]) {
            for (int j = 0; j < (int)regs.size(); ++j)
                if (regs[j].secondary_all == k || j == k)
                    regs[j].secondary_all = z[i];
            regs[z[i]].secondary_all = -1;
        }
    }
    for (int i = 0; i < 2; ++i)
        if (!setSAM(opt, bns, *seqs[i], (*regs_pair[i])[z[i]])) return false;
    for (int i = 0; i < 2; ++i) {
        std::vector<Reg2> &regs = *regs_pair[i];
        Reg2 snapshot = regs[z[i]];
        const Reg2 *mreg = &(*regs_pair[1 - i])[z[1 - i]];
        if (!format_sam(opt, o2, bns, ann_names, *seqs[i], snapshot, z[i],
                        mreg, &regs, 1, &pes, rg, out[i]))
            return false;
        if (n_pri[i] < (int)regs.size()) {
            Reg2 &p = regs[n_pri[i]];
            if (p.score >= o2.T && p.secondary < 0) {
                p.flag |= 0x800;
                if (!setSAM(opt, bns, *seqs[i], p)) return false;
                Reg2 snap2 = p;
                if (!format_sam(opt, o2, bns, ann_names, *seqs[i], snap2,
                                n_pri[i], nullptr, &regs, 0, &pes, rg, out[i]))
                    return false;
            }
        }
    }
    return true;
}

// pipeline.py:101 worker2_pe
static bool worker2_pe(const Opt &opt, const Opt2 &o2, const Opt3 &o3,
                       const Bns &bns,
                       const std::vector<std::string> &ann_names,
                       const ReadSE *seqs[2], std::vector<Reg2> *regs_pair[2],
                       const PeStatS &pes, int64_t n_processed, int64_t i,
                       uint32_t &next_serial, const std::string &rg,
                       std::string out[2]) {
    if (!(opt.flag & 0x20))  // MEM_F_NO_RESCUE
        matesw(opt, o2, o3, bns, pes, *seqs[0], *seqs[1], *regs_pair[0],
               *regs_pair[1], next_serial);
    int n_pri[2];
    mark_primary(opt, *regs_pair[0], (i << 1) | 0, n_pri[0]);
    mark_primary(opt, *regs_pair[1], (i << 1) | 1, n_pri[1]);
    for (int r = 0; r < 2; ++r)
        for (Reg2 &p : *regs_pair[r]) p.flag = 0;
    return reg2sam_pe(opt, o2, bns, ann_names, (n_processed >> 1) + i, seqs,
                      regs_pair, n_pri, pes, rg, out);
}

extern "C" {

struct StrandFMC {
    const uint32_t *words;
    const int64_t *occ;
    const int64_t *L2;
    const void *sa;
    int64_t primary, seq_len, n_words;
    const uint64_t *ilv;   // optional interleaved blocks (bt_build_ilv)
    int32_t sa_wide;       // 1 => sa is int64[] (genome strand >= 2^31)
    int32_t sa_shift;      // log2 of the SA sampling interval (5 = ref 32)
    const uint8_t *ilv2;   // optional dense 64-base blocks (bt_build_ilv2)
};

// Dense interleave: 32-byte block per 64 BWT bases (uint32 counts + 2
// uint64 superwords). Only valid for strands < 2^32 (uint32 counts).
// Caller frees with bt_buf_free.
void *bt_build_ilv2(const StrandFMC *s) {
    if (s->seq_len >= (1LL << 32)) return nullptr;
    int64_t nb = (s->seq_len + 63) >> 6;
    uint8_t *buf = (uint8_t *)huge_alloc((size_t)nb * 32);
    if (!buf) return nullptr;
    int64_t n_words = s->n_words;
    const uint64_t M = 0x5555555555555555ULL;
    for (int64_t b = 0; b < nb; ++b) {
        uint8_t *blk = buf + (b << 5);
        uint32_t *cnts = (uint32_t *)blk;
        uint64_t *words = (uint64_t *)(blk + 16);
        // checkpoint at the enclosing 128-block + first-half superword counts
        int64_t b128 = b >> 1;
        int64_t c[4];
        for (int i = 0; i < 4; ++i) c[i] = s->occ[b128 * 4 + i];
        if (b & 1) {  // second half: add the first 2 superwords (64 bases)
            for (int t = 0; t < 2; ++t) {
                int64_t w0 = (b128 << 3) + 2 * t, w1 = w0 + 1;
                uint64_t hi = w0 < n_words ? s->words[w0] : 0;
                uint64_t lo = w1 < n_words ? s->words[w1] : 0;
                uint64_t y = (hi << 32) | lo, inv = ~y;
                c[0] += __builtin_popcountll(((inv >> 1) & inv) & M);
                c[1] += __builtin_popcountll(((inv >> 1) & y) & M);
                c[2] += __builtin_popcountll(((y >> 1) & inv) & M);
                c[3] += __builtin_popcountll(((y >> 1) & y) & M);
            }
        }
        for (int i = 0; i < 4; ++i) cnts[i] = (uint32_t)c[i];
        int toff = (b & 1) ? 2 : 0;
        for (int t = 0; t < 2; ++t) {
            int64_t w0 = (b128 << 3) + 2 * (toff + t), w1 = w0 + 1;
            uint64_t hi = w0 < n_words ? s->words[w0] : 0;
            uint64_t lo = w1 < n_words ? s->words[w1] : 0;
            words[t] = (hi << 32) | lo;
        }
    }
    return buf;
}

// Test hooks: the AVX-512 batched single-class occ kernel vs the scalar
// path (tests/test_native_engine.py compares them over every rank).
// bt_occ_cg_x8 returns 0 when the vector kernel is unavailable (non-AVX512
// build or missing ilv2) so callers can skip.
// Test-only sw_extend entry: vec_mode 0 forces the scalar row, 1 forces the
// AVX-512 row, -1 uses the production heuristic. Returns 1 when the vector
// row kernel exists in this build (so A/B tests can skip on non-AVX512).
int bt_sw_extend(const uint8_t *query, int qlen, const uint8_t *target,
                 int tlen, const int8_t *mat, int o_del, int e_del, int o_ins,
                 int e_ins, int w, int end_bonus, int zdrop, int h0,
                 int vec_mode, int32_t *out6) {
    ExtRes r = sw_extend(query, qlen, target, tlen, mat, o_del, e_del, o_ins,
                         e_ins, w, end_bonus, zdrop, h0, vec_mode);
    out6[0] = r.score; out6[1] = r.qle; out6[2] = r.tle;
    out6[3] = r.gtle; out6[4] = r.gscore; out6[5] = r.max_off;
#ifdef BT_HAVE_AVX512_OCC
    return 1;
#else
    return 0;
#endif
}

int bt_occ_cg_x8(const StrandFMC *s, const int64_t *ranks, int c,
                 int64_t *e, int64_t *g) {
#ifdef BT_HAVE_AVX512_OCC
    if (!s->ilv2) return 0;
    StrandFM f{s->words, s->occ, s->L2, s->sa, s->primary, s->seq_len,
               s->n_words, s->sa_wide, s->sa_shift ? s->sa_shift : 5,
               s->ilv, s->ilv2};
    occ_cg_one_x8(f, ranks, c, e, g);
    return 1;
#else
    (void)s; (void)ranks; (void)c; (void)e; (void)g;
    return 0;
#endif
}
int bt_occ_cg_x8v(const StrandFMC *s, const int64_t *ranks,
                  const int64_t *cs, int64_t *e, int64_t *g) {
#ifdef BT_HAVE_AVX512_OCC
    if (!s->ilv2) return 0;
    StrandFM f{s->words, s->occ, s->L2, s->sa, s->primary, s->seq_len,
               s->n_words, s->sa_wide, s->sa_shift ? s->sa_shift : 5,
               s->ilv, s->ilv2};
    occ_cg_one_x8v(f, ranks, cs, e, g);
    return 1;
#else
    (void)s; (void)ranks; (void)cs; (void)e; (void)g;
    return 0;
#endif
}
int bt_occ_cg_scalar(const StrandFMC *s, int64_t k, int c,
                     int64_t *e, int64_t *g) {
    if (!s->ilv2) return 0;
    StrandFM f{s->words, s->occ, s->L2, s->sa, s->primary, s->seq_len,
               s->n_words, s->sa_wide, s->sa_shift ? s->sa_shift : 5,
               s->ilv, s->ilv2};
    occ_cg_one(f, k, c, *e, *g);
    return 1;
}

// Microbenchmark: ns per backward extend, scalar pair path (mode 0) vs the
// AVX-512 batch (mode 1), over synthetic intervals drawn width-n_batch like
// the real backward step. Returns ns/extend ×1000, or -1 if unavailable.
int64_t bt_occ_bench(const StrandFMC *s, int64_t n_iters, int32_t n_batch,
                     int32_t mode) {
    if (!s->ilv2 || n_batch < 1 || n_batch > 64) return -1;
#ifndef BT_HAVE_AVX512_OCC
    if (mode == 1) return -1;
#endif
    StrandFM f{s->words, s->occ, s->L2, s->sa, s->primary, s->seq_len,
               s->n_words, s->sa_wide, s->sa_shift ? s->sa_shift : 5,
               s->ilv, s->ilv2};
    // xorshift intervals: x0 in [1, seq_len-64], s in [1, 48]
    uint64_t rng = 0x9E3779B97F4A7C15ULL;
    auto next = [&]() { rng ^= rng << 13; rng ^= rng >> 7; rng ^= rng << 17; return rng; };
    std::vector<Intv> in(n_batch), outv(n_batch);
    int64_t acc = 0;
    auto t0 = std::chrono::steady_clock::now();
    for (int64_t it = 0; it < n_iters; ++it) {
        int c = (int)(next() & 3);
        for (int j = 0; j < n_batch; ++j) {
            in[j].x0 = 1 + (int64_t)(next() % (uint64_t)(f.seq_len - 64));
            in[j].x1 = in[j].x0;
            in[j].s = 1 + (int64_t)(next() % 48);
            in[j].end = 0;
        }
        if (mode == 1) {
#ifdef BT_HAVE_AVX512_OCC
            fm_extend_many_back(f, in.data(), n_batch, c, outv.data());
#endif
        } else {
            for (int j = 0; j < n_batch; ++j)
                fm_extend_one(f, in[j], c, outv[j], true);
        }
        acc += outv[0].s + outv[n_batch - 1].x0;
    }
    auto dt = std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now() - t0).count();
    if (acc == 42) fprintf(stderr, "x");  // keep the work alive
    return dt * 1000 / (n_iters * n_batch);
}

// Build the interleaved occ+BWT block array (see StrandFM::ilv): one
// 64-byte block per 128 BWT bases. Caller frees with bt_buf_free.
void *bt_build_ilv(const StrandFMC *s) {
    int64_t nb = (s->seq_len + 127) >> 7;
    uint64_t *ilv = (uint64_t *)huge_alloc((size_t)nb * 64);
    if (!ilv) return nullptr;
    int64_t n_words = s->n_words;
    for (int64_t b = 0; b < nb; ++b) {
        uint64_t *blk = ilv + (b << 3);
        for (int c = 0; c < 4; ++c) blk[c] = (uint64_t)s->occ[b * 4 + c];
        for (int t = 0; t < 4; ++t) {
            int64_t w0 = (b << 3) + 2 * t, w1 = w0 + 1;
            uint64_t hi = w0 < n_words ? s->words[w0] : 0;
            uint64_t lo = w1 < n_words ? s->words[w1] : 0;
            blk[4 + t] = (hi << 32) | lo;
        }
    }
    return ilv;
}

struct BnsC {
    const int64_t *ann_off;
    const int64_t *ann_len;  // int64: one contig may exceed 2^31 (reference caps at int32, bntann1_t)
    const uint8_t *ann_alt;
    int32_t n_seqs;
    const uint8_t *pac;
    int64_t l_pac;
};

struct OptC {
    int32_t a, b, o_del, e_del, o_ins, e_ins, pen_clip5, pen_clip3, w, zdrop;
    int64_t max_mem_intv;
    int32_t min_seed_len, split_width;
    int64_t max_occ;
    int32_t max_chain_gap;
    double split_factor, mask_level, drop_ratio;
    int32_t min_chain_weight;
    int64_t max_chain_extend;
    int32_t flag, parent_policy, bsstrand, is_pe;
    int8_t gamat[25], ctmat[25];
};

struct RegionC {
    int64_t rb, re;
    int32_t qb, qe, rid, score, truesc, w, seedcov, seedlen0;
    float frac_rep;
    uint8_t bss, parent, pad0, pad1;
};

// worker1 over a batch. reads: concatenated nt4 codes; offs[i]..offs[i]+lens[i].
// out: per-read regions at out + i*cap; out_n[i] = count (or -1 => fall back
// to the Python engine for that read).
int bt_worker1_batch(const StrandFMC *dau, const StrandFMC *par, const BnsC *bns,
                     const OptC *optc, const uint8_t *reads, const int64_t *offs,
                     const int32_t *lens, int n_reads, RegionC *out, int cap,
                     int32_t *out_n, int n_threads) {
    Ctx cx;
    for (int i = 0; i < 2; ++i) {
        const StrandFMC *s = i ? par : dau;
        cx.fm[i] = StrandFM{s->words, s->occ, s->L2, s->sa, s->primary,
                            s->seq_len, s->n_words, s->sa_wide,
                            s->sa_shift ? s->sa_shift : 5, s->ilv, s->ilv2};
    }
    cx.bns = Bns{bns->ann_off, bns->ann_len, bns->ann_alt, bns->n_seqs,
                 bns->pac, bns->l_pac};
    Opt &o = cx.opt;
    o.a = optc->a; o.b = optc->b;
    o.o_del = optc->o_del; o.e_del = optc->e_del;
    o.o_ins = optc->o_ins; o.e_ins = optc->e_ins;
    o.pen_clip5 = optc->pen_clip5; o.pen_clip3 = optc->pen_clip3;
    o.w = optc->w; o.zdrop = optc->zdrop;
    o.max_mem_intv = optc->max_mem_intv;
    o.min_seed_len = optc->min_seed_len;
    o.split_width = optc->split_width;
    o.max_occ = optc->max_occ;
    o.max_chain_gap = optc->max_chain_gap;
    o.split_factor = optc->split_factor;
    o.mask_level = optc->mask_level;
    o.drop_ratio = optc->drop_ratio;
    o.min_chain_weight = optc->min_chain_weight;
    o.max_chain_extend = optc->max_chain_extend;
    o.flag = optc->flag;
    o.parent_policy = optc->parent_policy;
    o.bsstrand = optc->bsstrand;
    std::memcpy(o.mats[0], optc->gamat, 25);
    std::memcpy(o.mats[1], optc->ctmat, 25);
    bool pe = optc->is_pe != 0;

    auto run = [&](int lo, int hi) {
        std::vector<Region> regs;
        ChunkSeeds cs;
        seed_chunk(cx, reads, offs, lens, lo, hi, pe, o.parent_policy,
                   nullptr, nullptr, cs);
        for (int i = lo; i < hi; ++i) {
            regs.clear();
            bool fallback = false;
            const uint8_t *seq = reads + offs[i];
            int len = lens[i];
            if (!pe) {
                int pp = o.parent_policy;
                if (!(pp & 1) || (pp >> 1))
                    align1_core(cx, seq, len, 0, regs, fallback,
                                nullptr, -1, cs.get(i, 0));
                if (!(pp & 1) || !(pp >> 1))
                    align1_core(cx, seq, len, 1, regs, fallback,
                                nullptr, -1, cs.get(i, 1));
            } else {
                bool r1 = (i % 2) == 0;
                int first = r1 ? 1 : 0;
                align1_core(cx, seq, len, first, regs, fallback,
                            nullptr, -1, cs.get(i, first));
                if (!o.parent_policy)
                    align1_core(cx, seq, len, 1 - first, regs, fallback,
                                nullptr, -1, cs.get(i, 1 - first));
            }
            if (fallback || (int)regs.size() > cap) {
                out_n[i] = -1;
                continue;
            }
            out_n[i] = (int32_t)regs.size();
            for (size_t j = 0; j < regs.size(); ++j) {
                const Region &r = regs[j];
                RegionC &rc = out[(int64_t)i * cap + j];
                rc.rb = r.rb; rc.re = r.re;
                rc.qb = r.qb; rc.qe = r.qe;
                rc.rid = r.rid; rc.score = r.score; rc.truesc = r.truesc;
                rc.w = r.w; rc.seedcov = r.seedcov; rc.seedlen0 = r.seedlen0;
                rc.frac_rep = r.frac_rep;
                rc.bss = r.bss; rc.parent = r.parent;
                rc.pad0 = rc.pad1 = 0;
            }
        }
    };
    if (n_threads <= 1) {
        run(0, n_reads);
    } else {
        // dynamic work-stealing: seed-rich reads take far longer than
        // clean ones, so static chunks leave threads idle
        std::atomic<int> next(0);
        auto steal = [&]() {
            for (;;) {
                int lo = next.fetch_add(16);
                if (lo >= n_reads) break;
                run(lo, std::min(n_reads, lo + 16));
            }
        };
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; ++t) ts.emplace_back(steal);
        for (auto &t : ts) t.join();
    }
    return 0;
}

struct Opt2C {
    int32_t T;
    double XA_drop_ratio, mask_level_redun, mapQ_coef_len, mapQ_coef_fac;
    int32_t max_XA_hits, max_XA_hits_alt, pen_unpaired, pad;
};

// Fused worker1 + worker2 for SE reads: align, merge, mark-primary, and emit
// final SAM lines per read. status[i] = 0 ok, -1 => rerun that read on the
// Python engine (worker1 fallback gate, setSAM assert, or region overflow).
// *out_buf receives one malloc'd buffer with the per-read SAM text
// concatenated in order; out_lens[i] gives each read's byte length. The
// caller must release it with bt_buf_free.
int bt_align_se_batch(const StrandFMC *dau, const StrandFMC *par,
                      const BnsC *bnsc, const OptC *optc, const Opt2C *o2c,
                      const uint8_t *reads, const int64_t *offs, const int32_t *lens,
                      const uint8_t *reads0, const int64_t *offs0, const int32_t *lens0,
                      const char *quals, const int64_t *qoffs, const int32_t *qlens,
                      const char *names, const int64_t *noffs, const int32_t *nlens,
                      const int32_t *clip5, const int32_t *clip3,
                      const uint8_t *py_only,
                      const char *ann_names_cat, const int64_t *ann_name_offs,
                      const char *rg, int32_t rg_len,
                      int64_t n_processed, int32_t n_reads, int32_t n_threads,
                      const SeedInj *inj,
                      void **out_buf, int64_t *out_lens, int32_t *status) {
    Ctx cx;
    for (int i = 0; i < 2; ++i) {
        const StrandFMC *s = i ? par : dau;
        cx.fm[i] = StrandFM{s->words, s->occ, s->L2, s->sa, s->primary,
                            s->seq_len, s->n_words, s->sa_wide,
                            s->sa_shift ? s->sa_shift : 5, s->ilv, s->ilv2};
    }
    cx.bns = Bns{bnsc->ann_off, bnsc->ann_len, bnsc->ann_alt, bnsc->n_seqs,
                 bnsc->pac, bnsc->l_pac};
    Opt &o = cx.opt;
    o.a = optc->a; o.b = optc->b;
    o.o_del = optc->o_del; o.e_del = optc->e_del;
    o.o_ins = optc->o_ins; o.e_ins = optc->e_ins;
    o.pen_clip5 = optc->pen_clip5; o.pen_clip3 = optc->pen_clip3;
    o.w = optc->w; o.zdrop = optc->zdrop;
    o.max_mem_intv = optc->max_mem_intv;
    o.min_seed_len = optc->min_seed_len;
    o.split_width = optc->split_width;
    o.max_occ = optc->max_occ;
    o.max_chain_gap = optc->max_chain_gap;
    o.split_factor = optc->split_factor;
    o.mask_level = optc->mask_level;
    o.drop_ratio = optc->drop_ratio;
    o.min_chain_weight = optc->min_chain_weight;
    o.max_chain_extend = optc->max_chain_extend;
    o.flag = optc->flag;
    o.parent_policy = optc->parent_policy;
    o.bsstrand = optc->bsstrand;
    std::memcpy(o.mats[0], optc->gamat, 25);
    std::memcpy(o.mats[1], optc->ctmat, 25);
    Opt2 o2;
    o2.T = o2c->T;
    o2.XA_drop_ratio = o2c->XA_drop_ratio;
    o2.mask_level_redun = o2c->mask_level_redun;
    o2.mapQ_coef_len = o2c->mapQ_coef_len;
    o2.mapQ_coef_fac = o2c->mapQ_coef_fac;
    o2.max_XA_hits = o2c->max_XA_hits;
    o2.max_XA_hits_alt = o2c->max_XA_hits_alt;
    o2.pen_unpaired = o2c->pen_unpaired;
    std::vector<std::string> ann_names(cx.bns.n_seqs);
    for (int i = 0; i < cx.bns.n_seqs; ++i)
        ann_names[i].assign(ann_names_cat + ann_name_offs[i],
                            ann_names_cat + ann_name_offs[i + 1]);
    std::string rgs(rg, rg + rg_len);

    std::vector<std::string> sams(n_reads);
    auto run = [&](int lo, int hi) {
        std::vector<Region> regs1;
        ChunkSeeds cs;
        seed_chunk(cx, reads, offs, lens, lo, hi, false, o.parent_policy,
                   inj, py_only, cs);
        for (int i = lo; i < hi; ++i) {
            if (py_only[i]) { status[i] = -1; continue; }
            regs1.clear();
            bool fallback = false;
            const uint8_t *seq = reads + offs[i];
            int len = lens[i];
            int pp = o.parent_policy;
            if (!(pp & 1) || (pp >> 1))
                align1_core(cx, seq, len, 0, regs1, fallback, inj, i,
                            cs.get(i, 0));
            if (!(pp & 1) || !(pp >> 1))
                align1_core(cx, seq, len, 1, regs1, fallback, inj, i,
                            cs.get(i, 1));
            if (fallback) { status[i] = -1; continue; }
            std::vector<Reg2> regs(regs1.size());
            for (size_t j = 0; j < regs1.size(); ++j) {
                const Region &r = regs1[j];
                Reg2 &g = regs[j];
                g.rb = r.rb; g.re = r.re; g.qb = r.qb; g.qe = r.qe;
                g.rid = r.rid; g.score = r.score; g.truesc = r.truesc;
                g.w = r.w; g.seedcov = r.seedcov; g.seedlen0 = r.seedlen0;
                g.frac_rep = (double)r.frac_rep;
                g.bss = r.bss; g.parent = r.parent;
            }
            ReadSE s;
            s.seq = seq; s.l_seq = len;
            s.seq0 = reads0 + offs0[i]; s.l_seq0 = lens0[i];
            s.qual = quals + qoffs[i]; s.l_qual = qlens[i];
            s.name = names + noffs[i]; s.name_len = nlens[i];
            s.clip5 = clip5[i]; s.clip3 = clip3[i];
            {
                ProfScope p(4);
                merge_regions2(o, o2, cx.bns, seq, len, regs);
            }
            ProfScope p(5);
            if (!worker2_se(o, o2, cx.bns, ann_names, s, regs,
                            n_processed + i, rgs, sams[i])) {
                status[i] = -1;
                continue;
            }
            status[i] = 0;
        }
    };
    {
        const char *e = getenv("BT_PROF");
        int v = e ? atoi(e) : 0;   // empty/junk values stay off
        g_prof_on = v >= 1;
        g_prof_fine = v >= 2;
    }
    if (n_threads <= 1) {
        run(0, n_reads);
    } else {
        std::atomic<int> next(0);
        auto steal = [&]() {
            for (;;) {
                int lo = next.fetch_add(16);
                if (lo >= n_reads) break;
                run(lo, std::min((int)n_reads, lo + 16));
            }
        };
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; ++t) ts.emplace_back(steal);
        for (auto &t : ts) t.join();
    }
    prof_report("se_batch");
    int64_t total = 0;
    for (int i = 0; i < n_reads; ++i) {
        out_lens[i] = status[i] == 0 ? (int64_t)sams[i].size() : 0;
        total += out_lens[i];
    }
    char *buf = (char *)std::malloc(total > 0 ? total : 1);
    if (!buf) return -1;
    int64_t off = 0;
    for (int i = 0; i < n_reads; ++i) {
        if (out_lens[i]) {
            std::memcpy(buf + off, sams[i].data(), out_lens[i]);
            off += out_lens[i];
        }
    }
    *out_buf = buf;
    return 0;
}

void bt_buf_free(void *p) {
    {
        std::lock_guard<std::mutex> lk(g_huge_mu);
        auto it = g_huge_allocs.find(p);
        if (it != g_huge_allocs.end()) {
            munmap(p, it->second);
            g_huge_allocs.erase(it);
            return;
        }
    }
    std::free(p);
}

// Copy an arbitrary (e.g. file-mmapped) array into THP-backed memory so
// its random accesses ride 2 MB TLB entries; free with bt_buf_free.
void *bt_hugify(const void *src, int64_t size) {
    void *p = huge_alloc((size_t)size);
    if (p) std::memcpy(p, src, (size_t)size);
    return p;
}

struct PeStatC {
    int64_t low, high;
    int32_t set_, failed;
    double avg, std_;
};

struct Opt3C {
    int64_t max_ins;
    int32_t max_matesw, verbose;
};

// Fused worker1 + worker2 for PE batches (reads interleaved R1,R2,...).
// pes_io: in/out insert-size stats; *pes_given != 0 uses them as-is,
// otherwise they are estimated over the whole batch (mem_pestat) and
// written back. status[i]: 0 ok, -1 => Python fallback — when ANY read's
// worker1 needs the Python engine the whole batch is flagged (-1
// everywhere) because pestat must see every pair's regions.
int bt_align_pe_batch(const StrandFMC *dau, const StrandFMC *par,
                      const BnsC *bnsc, const OptC *optc, const Opt2C *o2c,
                      const Opt3C *o3c,
                      const uint8_t *reads, const int64_t *offs, const int32_t *lens,
                      const uint8_t *reads0, const int64_t *offs0, const int32_t *lens0,
                      const char *quals, const int64_t *qoffs, const int32_t *qlens,
                      const char *names, const int64_t *noffs, const int32_t *nlens,
                      const int32_t *clip5, const int32_t *clip3,
                      const uint8_t *py_only,
                      const char *ann_names_cat, const int64_t *ann_name_offs,
                      const char *rg, int32_t rg_len,
                      int64_t n_processed, int32_t n_reads, int32_t n_threads,
                      PeStatC *pes_io, int32_t pes_given,
                      const SeedInj *inj,
                      void **out_buf, int64_t *out_lens, int32_t *status) {
    Ctx cx;
    for (int i = 0; i < 2; ++i) {
        const StrandFMC *s = i ? par : dau;
        cx.fm[i] = StrandFM{s->words, s->occ, s->L2, s->sa, s->primary,
                            s->seq_len, s->n_words, s->sa_wide,
                            s->sa_shift ? s->sa_shift : 5, s->ilv, s->ilv2};
    }
    cx.bns = Bns{bnsc->ann_off, bnsc->ann_len, bnsc->ann_alt, bnsc->n_seqs,
                 bnsc->pac, bnsc->l_pac};
    Opt &o = cx.opt;
    o.a = optc->a; o.b = optc->b;
    o.o_del = optc->o_del; o.e_del = optc->e_del;
    o.o_ins = optc->o_ins; o.e_ins = optc->e_ins;
    o.pen_clip5 = optc->pen_clip5; o.pen_clip3 = optc->pen_clip3;
    o.w = optc->w; o.zdrop = optc->zdrop;
    o.max_mem_intv = optc->max_mem_intv;
    o.min_seed_len = optc->min_seed_len;
    o.split_width = optc->split_width;
    o.max_occ = optc->max_occ;
    o.max_chain_gap = optc->max_chain_gap;
    o.split_factor = optc->split_factor;
    o.mask_level = optc->mask_level;
    o.drop_ratio = optc->drop_ratio;
    o.min_chain_weight = optc->min_chain_weight;
    o.max_chain_extend = optc->max_chain_extend;
    o.flag = optc->flag;
    o.parent_policy = optc->parent_policy;
    o.bsstrand = optc->bsstrand;
    std::memcpy(o.mats[0], optc->gamat, 25);
    std::memcpy(o.mats[1], optc->ctmat, 25);
    Opt2 o2;
    o2.T = o2c->T;
    o2.XA_drop_ratio = o2c->XA_drop_ratio;
    o2.mask_level_redun = o2c->mask_level_redun;
    o2.mapQ_coef_len = o2c->mapQ_coef_len;
    o2.mapQ_coef_fac = o2c->mapQ_coef_fac;
    o2.max_XA_hits = o2c->max_XA_hits;
    o2.max_XA_hits_alt = o2c->max_XA_hits_alt;
    o2.pen_unpaired = o2c->pen_unpaired;
    Opt3 o3;
    o3.max_ins = o3c->max_ins;
    o3.max_matesw = o3c->max_matesw;
    std::vector<std::string> ann_names(cx.bns.n_seqs);
    for (int i = 0; i < cx.bns.n_seqs; ++i)
        ann_names[i].assign(ann_names_cat + ann_name_offs[i],
                            ann_names_cat + ann_name_offs[i + 1]);
    std::string rgs(rg, rg + rg_len);

    // phase A: worker1 + merge for every read
    std::vector<std::vector<Reg2>> all_regs(n_reads);
    std::vector<uint8_t> fb(n_reads, 0);
    auto runA = [&](int lo, int hi) {
        std::vector<Region> regs1;
        ChunkSeeds cs;
        seed_chunk(cx, reads, offs, lens, lo, hi, true, o.parent_policy,
                   inj, py_only, cs);
        for (int i = lo; i < hi; ++i) {
            if (py_only[i]) { fb[i] = 1; continue; }
            regs1.clear();
            bool fallback = false;
            const uint8_t *seq = reads + offs[i];
            int len = lens[i];
            bool r1 = (i % 2) == 0;
            int first = r1 ? 1 : 0;
            align1_core(cx, seq, len, first, regs1, fallback, inj, i,
                        cs.get(i, first));
            if (!o.parent_policy)
                align1_core(cx, seq, len, 1 - first, regs1, fallback, inj, i,
                            cs.get(i, 1 - first));
            if (fallback) { fb[i] = 1; continue; }
            std::vector<Reg2> &regs = all_regs[i];
            regs.resize(regs1.size());
            for (size_t j = 0; j < regs1.size(); ++j) {
                const Region &r = regs1[j];
                Reg2 &g = regs[j];
                g.rb = r.rb; g.re = r.re; g.qb = r.qb; g.qe = r.qe;
                g.rid = r.rid; g.score = r.score; g.truesc = r.truesc;
                g.w = r.w; g.seedcov = r.seedcov; g.seedlen0 = r.seedlen0;
                g.frac_rep = (double)r.frac_rep;
                g.bss = r.bss; g.parent = r.parent;
            }
            merge_regions2(o, o2, cx.bns, seq, len, regs);
            for (size_t j = 0; j < regs.size(); ++j)
                regs[j].serial = (uint32_t)j;
        }
    };
    auto fanout = [&](auto fn, int n_items) {
        if (n_threads <= 1) { fn(0, n_items); return; }
        std::atomic<int> next(0);
        auto steal = [&]() {
            for (;;) {
                int lo = next.fetch_add(16);
                if (lo >= n_items) break;
                fn(lo, std::min(n_items, lo + 16));
            }
        };
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; ++t) ts.emplace_back(steal);
        for (auto &t : ts) t.join();
    };
    fanout(runA, n_reads);
    for (int i = 0; i < n_reads; ++i) {
        if (fb[i]) {  // whole-batch fallback: pestat needs every pair
            for (int j = 0; j < n_reads; ++j) { status[j] = -1; out_lens[j] = 0; }
            *out_buf = std::malloc(1);
            return 0;
        }
    }

    // phase B: insert-size stats over the whole batch
    PeStatS pes;
    if (pes_given) {
        pes.low = pes_io->low; pes.high = pes_io->high;
        pes.set_ = pes_io->set_; pes.failed = pes_io->failed;
        pes.avg = pes_io->avg; pes.std = pes_io->std_;
    } else {
        pestat(o, o3, cx.bns, all_regs, pes, o3c->verbose != 0);
        pes_io->low = pes.low; pes_io->high = pes.high;
        pes_io->set_ = pes.set_; pes_io->failed = pes.failed;
        pes_io->avg = pes.avg; pes_io->std_ = pes.std;
    }

    // phase C: pairing + SAM per pair
    int n_pairs = n_reads >> 1;
    std::vector<std::string> sams(n_reads);
    auto runC = [&](int lo, int hi) {
        for (int pi = lo; pi < hi; ++pi) {
            int i0 = pi << 1, i1 = i0 | 1;
            ReadSE s[2];
            for (int r = 0; r < 2; ++r) {
                int i = r ? i1 : i0;
                s[r].seq = reads + offs[i]; s[r].l_seq = lens[i];
                s[r].seq0 = reads0 + offs0[i]; s[r].l_seq0 = lens0[i];
                s[r].qual = quals + qoffs[i]; s[r].l_qual = qlens[i];
                s[r].name = names + noffs[i]; s[r].name_len = nlens[i];
                s[r].clip5 = clip5[i]; s[r].clip3 = clip3[i];
            }
            const ReadSE *sp[2] = {&s[0], &s[1]};
            std::vector<Reg2> *rp[2] = {&all_regs[i0], &all_regs[i1]};
            uint32_t next_serial = 1u << 20;
            std::string out2[2];
            if (worker2_pe(o, o2, o3, cx.bns, ann_names, sp, rp, pes,
                           n_processed, pi, next_serial, rgs, out2)) {
                sams[i0] = std::move(out2[0]);
                sams[i1] = std::move(out2[1]);
                status[i0] = status[i1] = 0;
            } else {
                status[i0] = status[i1] = -1;
            }
        }
    };
    fanout(runC, n_pairs);

    int64_t total = 0;
    for (int i = 0; i < n_reads; ++i) {
        out_lens[i] = status[i] == 0 ? (int64_t)sams[i].size() : 0;
        total += out_lens[i];
    }
    char *buf = (char *)std::malloc(total > 0 ? total : 1);
    if (!buf) return -1;
    int64_t off2 = 0;
    for (int i = 0; i < n_reads; ++i) {
        if (out_lens[i]) {
            std::memcpy(buf + off2, sams[i].data(), out_lens[i]);
            off2 += out_lens[i];
        }
    }
    *out_buf = buf;
    return 0;
}

}  // extern "C"

}  // namespace bt
