// Semi-external blockwise BWT construction for human-scale strands.
//
// The reference builds big genomes with incremental BWT-SW
// (lib/aln/bwt_gen.c:1-1626, selected at bwtindex.c:258 for
// >50 Mbp) so a workstation can index arbitrarily large texts in bounded
// memory. This file is biscuit_tpu's equivalent, written from scratch around
// a different (merge-based) scheme: the full suffix array is NEVER
// materialized, so peak memory is O(text + block) instead of the 8n bytes an
// int64 SA-IS needs (~50 GB for the 6.2 G-char doubled human strand).
//
// Scheme (in the spirit of Ferragina-Gagie-Manzini's bwte and pSAscan's
// gt-bitvector block sorting, re-derived from first principles here):
// process T right-to-left in blocks of m chars. Maintain the BWT of the
// suffix T[e..n) built so far. For a new block [b, e):
//
//   1. gamma bits: gamma[t] = (T[b+t..) > T[e..)). Computed by one Z-array
//      scan of U = T[e..e+m) # T[b..e): a mismatch inside the block decides
//      by chars; a scan that exhausts the block (z == m-t) reduces to
//      comparing two suffixes anchored at e, which the PREVIOUS round's
//      block ranks already ordered (G bits) — so no scan ever leaves the
//      block and periodic texts stay O(m) per round.
//   2. Block suffix sort: suffixes S_i = T[b+i..) extend past e, but any
//      comparison between two of them either hits a char mismatch inside
//      the block or reduces (at the shorter one's boundary) to a gamma bit.
//      Both are captured by plain SA-IS over the 12-letter string
//      X[j] = 3*T[b+j] + s, with s = 2*gamma[j+1] for j < m-1 and s = 1
//      (a "between" value: T[e..) compared with itself) at j = m-1. The
//      suffix order of X equals the true order of the S_i — proved by the
//      invariant that after matching k chars, cmp(S_i,S_j) equals
//      cmp(S_{i+k}, S_{j+k}), whose straddle-of-T[e..) status is exactly
//      the gamma pair.
//   3. Insertion ranks: R[i] = #old-matrix rows < S_i via a right-to-left
//      LF walk (one occ query per char, same full-matrix/$-removed rank
//      convention as ops/fm.py and bwt_from_sa in sais.cpp).
//   4. One linear merge pass emits the new BWT; the new block's suffix at
//      b becomes the new primary. occ checkpoints ride in 64-byte
//      interleaved blocks (4x uint64 counts + 8x uint32 code words = 128
//      codes) so every rank query during the walks is one cache line.
//
// After the last round, SA samples are derived by the standard LF walk over
// the final BWT (the bwt_cal_sa trick, lib/aln/bwt.c:240-256)
// at the caller's sampling interval — positions exact, full SA never built.
//
// Validated byte-identical (words, occ checkpoints, primary, SA samples)
// against the in-memory SA-IS path over randomized and adversarially
// periodic texts in tests/test_bwt_merge.py.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/mman.h>
#include <thread>
#include <vector>

extern "C" int sais_u8_i32(const uint8_t *T, int32_t *SA, int32_t n, int32_t K);

namespace {
// BT_BWTM_PROF=1: per-phase wall seconds to stderr
struct Prof {
    // slots race-free across the pipeline threads: the worker only touches
    // slots 2/3, the main thread 0/1/4, and each thread keeps its own mark.
    bool on;
    double t[5] = {0, 0, 0, 0, 0}; // gamma/Z, sais, R-walk, merge, sa-walk
    static thread_local std::chrono::steady_clock::time_point mark;
    Prof() { const char *e = getenv("BT_BWTM_PROF"); on = e && *e == '1'; }
    void start() { if (on) mark = std::chrono::steady_clock::now(); }
    void stop(int k) {
        if (!on) return;
        auto now = std::chrono::steady_clock::now();
        t[k] += std::chrono::duration<double>(now - mark).count();
        mark = now;
    }
    void report() {
        if (on)
            fprintf(stderr, "[bwt_merge] gamma=%.1fs sais=%.1fs rwalk=%.1fs "
                    "merge=%.1fs sawalk=%.1fs\n", t[0], t[1], t[2], t[3], t[4]);
    }
};
thread_local std::chrono::steady_clock::time_point Prof::mark;
} // namespace

namespace {

// ---- interleaved BWT store: 64-byte blocks of [cnt[4] | 8 words] ---------

// 2 MB-aligned allocation marked MADV_HUGEPAGE: the R-walk and SA-walk are
// dependent random-access chains over a multi-GB store at human scale, so
// TLB reach matters as much as cache lines.
struct HugeBuf {
    uint64_t *p = nullptr;
    size_t cap = 0; // in uint64s
    ~HugeBuf() { if (p) free(p); }
    void ensure(size_t n_u64) {
        if (n_u64 <= cap) return;
        if (p) free(p);
        size_t bytes = (n_u64 * 8 + (2u << 20) - 1) & ~(size_t)((2u << 20) - 1);
        if (posix_memalign((void **)&p, 2u << 20, bytes) != 0) { p = nullptr; }
        if (!p) { p = (uint64_t *)malloc(n_u64 * 8); cap = n_u64; return; }
#ifdef MADV_HUGEPAGE
        madvise(p, bytes, MADV_HUGEPAGE);
#endif
        cap = n_u64;
    }
    void swap(HugeBuf &o) { std::swap(p, o.p); std::swap(cap, o.cap); }
};

struct IlvStore {
    // block layout: uint64 cnt[4] = counts of codes 0..3 in codes [0, 128*blk),
    // then uint32 w[8] holding 128 codes, code i at bit (15-(i&15))*2 of
    // w[(i>>4)&7] (the pack_words layout, index/fmindex.py:209-224).
    HugeBuf buf; // 8 x uint64 per block
    int64_t n = 0;             // codes stored

    void reset(int64_t cap_codes) {
        int64_t nb = (cap_codes + 127) / 128 + 1;
        buf.ensure(nb * 8);
        n = 0;
    }
    inline const uint64_t *blk(int64_t b) const { return buf.p + b * 8; }
    inline uint64_t *blk(int64_t b) { return buf.p + b * 8; }

    inline uint8_t code_at(int64_t i) const {
        const uint32_t *w = (const uint32_t *)(blk(i >> 7) + 4);
        uint32_t word = w[(i >> 4) & 7];
        return (word >> (((~i) & 15) << 1)) & 3;
    }
    // # of code c among stored codes [0, j)
    inline int64_t occ1(uint8_t c, int64_t j) const {
        int64_t b = j >> 7, r = j & 127;
        const uint64_t *h = blk(b);
        int64_t cnt = (int64_t)h[c];
        const uint32_t *w = (const uint32_t *)(h + 4);
        // per-word 2-bit equality count; mask the tail of the last word
        uint32_t pat = 0x55555555u * (uint32_t)c; // c replicated in pairs
        int full = (int)(r >> 4);
        for (int k = 0; k < full; ++k) {
            uint32_t x = w[k] ^ pat;
            uint32_t y = (x | (x >> 1)) & 0x55555555u;
            cnt += 16 - __builtin_popcount(y);
        }
        int rem = (int)(r & 15);
        if (rem) {
            uint32_t x = w[full] ^ pat;
            uint32_t y = (x | (x >> 1)) & 0x55555555u;
            // keep only the top `rem` code slots (codes pack MSB-first)
            uint32_t keep = ~((1u << ((16 - rem) << 1)) - 1u);
            y |= ~keep & 0x55555555u; // pretend tail mismatches
            cnt += 16 - __builtin_popcount(y);
        }
        return cnt;
    }
};

// sequential writer into an IlvStore: tracks running counts, flushes
// headers at block starts and packs codes MSB-first into words
struct IlvWriter {
    IlvStore *s;
    int64_t cnt[4] = {0, 0, 0, 0};
    int64_t i = 0;       // codes written
    uint32_t word = 0;

    explicit IlvWriter(IlvStore *st) : s(st) {
        uint64_t *h = s->blk(0);
        h[0] = h[1] = h[2] = h[3] = 0;
    }
    inline void put(uint8_t c) {
        word = (word << 2) | c;
        ++cnt[c];
        ++i;
        if ((i & 15) == 0) {
            uint32_t *w = (uint32_t *)(s->blk((i - 1) >> 7) + 4);
            w[((i - 1) >> 4) & 7] = word;
            word = 0;
            if ((i & 127) == 0) {
                uint64_t *h = s->blk(i >> 7);
                for (int k = 0; k < 4; ++k) h[k] = (uint64_t)cnt[k];
            }
        }
    }
    void finish() {
        if (i & 15) {
            // left-align the partial word (codes are MSB-first)
            uint32_t w32 = word << (((16 - (i & 15)) & 15) << 1);
            uint32_t *w = (uint32_t *)(s->blk(i >> 7) + 4);
            w[(i >> 4) & 7] = w32;
        }
        s->n = i;
    }
};

// sequential decoder over an IlvStore (the merge's old-BWT scan): one word
// load per 16 codes instead of per-code div/shift indexing
struct IlvReader {
    const IlvStore *s;
    int64_t i = 0;
    uint32_t word = 0;
    explicit IlvReader(const IlvStore *st) : s(st) {}
    inline uint8_t next() {
        if ((i & 15) == 0) {
            const uint32_t *w = (const uint32_t *)(s->blk(i >> 7) + 4);
            word = w[(i >> 4) & 7];
        }
        uint8_t c = (word >> 30) & 3;
        word <<= 2;
        ++i;
        return c;
    }
};

// Z-array of s[0..n): z[k] = lcp(s[k..], s), z[0] = n
void z_array(const uint8_t *s, int64_t n, int32_t *z) {
    if (n == 0) return;
    z[0] = (int32_t)n;
    int64_t l = 0, r = 0;
    for (int64_t k = 1; k < n; ++k) {
        int64_t zk = 0;
        if (k < r) zk = std::min((int64_t)z[k - l], r - k);
        while (k + zk < n && s[zk] == s[k + zk]) ++zk;
        z[k] = (int32_t)zk;
        if (k + zk > r) { l = k; r = k + zk; }
    }
}

struct BitVec {
    std::vector<uint64_t> w;
    void resize(int64_t n) { w.assign((n + 63) / 64, 0); }
    inline void set(int64_t i, bool v) {
        if (v) w[i >> 6] |= 1ull << (i & 63);
        else w[i >> 6] &= ~(1ull << (i & 63));
    }
    inline bool get(int64_t i) const { return (w[i >> 6] >> (i & 63)) & 1; }
};

} // namespace

extern "C" {

// Build the BWT of T[0..n) (codes 0..3) blockwise in bounded memory.
//   words_out:  (n+15)/16 uint32, pack_words layout
//   occ_cp_out: ((n+127)/128 + 1) * 4 uint64, occ_checkpoints layout
//   sa_out:     (n + sa_intv) / sa_intv int64 samples; sa_out[0] = -1
// Returns primary (>=1) on success, -1 on error.
int64_t bwt_merge_build(const uint8_t *T, int64_t n, int64_t block_size,
                        uint32_t *words_out, uint64_t *occ_cp_out,
                        int64_t sa_intv, int64_t *sa_out) {
    if (n <= 0 || block_size < 2 || block_size > (int64_t)1 << 30) return -1;
    int64_t m = std::min(block_size, n);

    IlvStore cur, nxt;
    cur.reset(n);
    nxt.reset(n);

    std::vector<int32_t> SA(m);
    std::vector<uint8_t> X(m);
    std::vector<uint8_t> U(2 * m + 1);
    std::vector<int32_t> Z(2 * m + 1);
    std::vector<int32_t> xr(m);
    std::vector<int64_t> R(m);
    std::vector<int64_t> ins(m);  // R in xr order (contiguous for the merge)
    BitVec gamma, G;
    gamma.resize(m + 1);
    G.resize(m + 1);

    Prof prof;
    int64_t primary = -1;      // full-matrix rank convention (>=1)
    int64_t cnt_lt[5] = {0, 0, 0, 0, 0}; // # stored text chars < c

    // ---- base round: rightmost block [n-m, n), plain SA-IS ----
    {
        int64_t b = n - m;
        prof.start();
        if (sais_u8_i32(T + b, SA.data(), (int32_t)m, 4) != 0) return -1;
        prof.stop(1);
        for (int64_t r = 0; r < m; ++r) xr[SA[r]] = (int32_t)r;
        IlvWriter w(&cur);
        w.put(T[n - 1]);       // rank-0 row: '$'-suffix, bwt char = last text char
        for (int64_t r = 0; r < m; ++r) {
            if (SA[r] == 0) primary = r + 1;
            else w.put(T[b + SA[r] - 1]);
        }
        w.finish();
        for (int c = 0; c < 4; ++c) cnt_lt[c + 1] = cnt_lt[c] + w.cnt[c];
        // G[d] = (T[b+d..) > T[b..)) for the next round's boundary at e=b
        for (int64_t d = 1; d < m; ++d) G.set(d, xr[d] > xr[0]);
        G.set(m, false);       // T[n..) (empty) > T[b..) is false
        if (m == n) { /* single-block text */ }
    }

    // ---- merge rounds, right to left ----
    //
    // Two-stage software pipeline: the block suffix sort of round k+1
    // (gamma + SA-IS, main thread) only depends on round k's RANKS (G bits),
    // not on its merge, so it overlaps the rwalk+merge of round k (worker
    // thread). SA buffers ping-pong; G is snapshotted before the overlap.
    std::vector<int32_t> SAb(m);     // sort target for the overlapped round
    int32_t *SA_cur = SA.data(), *SA_nxt = SAb.data();

    // sort block [b-?, e) given G bits for the boundary at e; returns mc
    auto sort_block = [&](int64_t e2, int32_t *SAout) -> int64_t {
        int64_t mc = std::min(m, e2);
        int64_t b2 = e2 - mc;
        // gamma[t] = (T[b2+t..) > T[e2..)) via Z over U = T[e2..e2+mc) # block
        std::memcpy(U.data(), T + e2, mc);
        U[mc] = 0xFF;
        std::memcpy(U.data() + mc + 1, T + b2, mc);
        z_array(U.data(), 2 * mc + 1, Z.data());
        for (int64_t t = 0; t < mc; ++t) {
            int64_t z = Z[mc + 1 + t];
            if (z < mc - t) gamma.set(t, T[b2 + t + z] > T[e2 + z]);
            else gamma.set(t, !G.get(mc - t)); // cmp(T[e2..), T[e2+mc-t..))
        }
        // 12-letter derived block string, SA-IS
        for (int64_t j = 0; j + 1 < mc; ++j)
            X[j] = (uint8_t)(3 * T[b2 + j] + 2 * (gamma.get(j + 1) ? 1 : 0));
        X[mc - 1] = (uint8_t)(3 * T[b2 + mc - 1] + 1);
        if (sais_u8_i32(X.data(), SAout, (int32_t)mc, 12) != 0) return -1;
        // G bits for the NEXT boundary (at b2), from this block's ranks
        for (int64_t r = 0; r < mc; ++r) xr[SAout[r]] = (int32_t)r;
        for (int64_t d = 1; d < mc; ++d) G.set(d, xr[d] > xr[0]);
        G.set(mc, !gamma.get(0)); // cmp(T[e2..), T[b2..)) flipped
        return mc;
    };

    int64_t e = n - m;
    int64_t mc = 0;
    int rc_async = 0;
    if (e > 0) {
        prof.start();
        mc = sort_block(e, SA_cur);
        prof.stop(1);
        if (mc < 0) return -1;
    }
    while (e > 0) {
        int64_t b = e - mc;

        // worker: insertion-rank LF walk + linear merge of block [b, e)
        auto walk_and_merge = [&, b, e, mc]() {
            prof.start();
            int64_t rk = primary; // rank of T[e..)
            const int32_t *SAw = SA_cur;
            for (int64_t i = mc - 1; i >= 0; --i) {
                uint8_t c = T[b + i];
                int64_t idx = rk - (rk > primary ? 1 : 0);
                rk = 1 + cnt_lt[c] + cur.occ1(c, idx);
                R[i] = rk;
            }
            prof.stop(2);
            IlvWriter w(&nxt);
            IlvReader rd(&cur);
            for (int64_t r = 0; r < mc; ++r) {
                ins[r] = R[SAw[r]];
                if (r && ins[r] < ins[r - 1]) { rc_async = -2; return; }
            }
            int64_t new_primary = -1;
            int64_t ni = 0;                   // next new suffix (xr order)
            int64_t out_rank = 0;             // merged full-matrix rank
            // old full-matrix ranks are [0, cur.n] (cur.n stored chars plus
            // the '$'-slot); insertion rank cur.n + 1 = "after every old row"
            for (int64_t rr = 0; rr <= cur.n + 1; ++rr) {
                while (ni < mc && ins[ni] == rr) {
                    int64_t pos = SAw[ni];
                    if (pos == 0) new_primary = out_rank;
                    else w.put(T[b + pos - 1]);
                    ++out_rank;
                    ++ni;
                }
                if (rr > cur.n) break;
                if (rr == primary) w.put(T[e - 1]); // old '$'-slot: real char now
                else w.put(rd.next());              // sequential old-BWT scan
                ++out_rank;
            }
            if (ni != mc || new_primary < 0) { rc_async = -3; return; }
            w.finish();
            for (int c = 0; c < 4; ++c) cnt_lt[c + 1] = cnt_lt[c] + w.cnt[c];
            primary = new_primary;
            prof.stop(3);
        };

        int64_t mc_next = 0;
        if (b > 0) {
            std::thread worker(walk_and_merge);
            prof.start();
            mc_next = sort_block(b, SA_nxt); // overlaps the worker
            prof.stop(1);
            worker.join();
        } else {
            walk_and_merge();
        }
        if (rc_async != 0) return rc_async;
        if (mc_next < 0) return -1;
        cur.buf.swap(nxt.buf);
        cur.n = nxt.n; // nxt.n was set by finish(); swap buffers kept sizes
        std::swap(SA_cur, SA_nxt);
        mc = mc_next;
        e = b;
    }

    // ---- free the block working set before the export + SA walk: at a
    // 6.2 G-char strand these vectors are ~4.4 GB that would otherwise
    // overlap the output arrays' residency (32 GB budget at human scale)
    {
        std::vector<int32_t>().swap(SA);
        std::vector<int32_t>().swap(SAb);
        std::vector<uint8_t>().swap(X);
        std::vector<uint8_t>().swap(U);
        std::vector<int32_t>().swap(Z);
        std::vector<int32_t>().swap(xr);
        std::vector<int64_t>().swap(R);
        std::vector<int64_t>().swap(ins);
        HugeBuf empty;
        nxt.buf.swap(empty);  // drop the ping-pong twin (cur stays live)
    }

    // ---- export words + occ checkpoints ----
    {
        int64_t nw = (n + 15) / 16;
        for (int64_t k = 0; k < nw; ++k) {
            const uint32_t *w = (const uint32_t *)(cur.blk(k >> 3) + 4);
            words_out[k] = w[k & 7];
        }
        int64_t nb = (n + 127) / 128;
        for (int64_t bk = 0; bk < nb; ++bk) {
            const uint64_t *h = cur.blk(bk);
            for (int c = 0; c < 4; ++c) occ_cp_out[bk * 4 + c] = h[c];
        }
        for (int c = 0; c < 4; ++c) // totals row
            occ_cp_out[nb * 4 + c] = (uint64_t)(cnt_lt[c + 1] - cnt_lt[c]);
    }

    // ---- SA samples: LF walk from rank 0 (pos n) down to pos 0 ----
    prof.start();
    if (sa_intv > 0 && sa_out) {
        int64_t r = 0, pos = n;
        for (;;) {
            if ((r & (sa_intv - 1)) == 0)
                sa_out[r / sa_intv] = (r == 0) ? -1 : pos;
            if (pos == 0) break;
            // LF: this row's bwt char prepends its suffix
            uint8_t c = cur.code_at(r - (r > primary ? 1 : 0));
            int64_t idx = r - (r > primary ? 1 : 0);
            r = 1 + cnt_lt[c] + cur.occ1(c, idx);
            --pos;
        }
    }
    prof.stop(4);
    prof.report();
    return primary;
}

} // extern "C"
