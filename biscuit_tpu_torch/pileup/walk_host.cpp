// The `device` pileup engine's window walk over raw BAM records
// (pileup/walk.py): the records decoded straight into the datum arrays that
// _pileup_window_fast hands _device_counts (pileup/engine.py), and the VCF
// text formatted from the counts it returns.
//
// native/pileup_native.cpp is a pinned copy of its source, and
// native/__init__.py compiles every .cpp in that directory into the copied
// library, so this file lives outside it. It includes the copy for its
// record parser (parse_raw, cig_at, seq_at) and its site formatting
// (plp_format with pileup_genotype, top_mutant and redistribute), and
// defines:
// - bt_walk_stage: one window's records through bt_pileup_window_raw's
//   record loop (read filters, strand and retention, mate-overlap rule),
//   line for line but for the lines marked `// stage`, which write each
//   kept aligned base as a datum where the copy counts it: the int32 site
//   offset rp - beg, the int32 sample, the uint8 stat base << 4 | meth and
//   the pass byte (base quality and the 5' / 3' end distances), at
//   data[0, 4 cap), [4 cap, 8 cap), [8 cap, 9 cap) and [9 cap, 10 cap).
//   The room it needs is a bound taken from the records' reference spans
//   first: it writes nothing and returns minus the bound when cap is short.
// - bt_walk_emit: the window's VCF text from _device_counts' int64 counts
//   cm [P][nbam][3], cb [P][nbam][7] and dp [P][nbam], read in place:
//   every site with depth through plp_format, as bt_pileup_window_raw
//   emits, which adds the context sums of _meth_average.tsv. Buffers from
//   it are freed with bt_walk_free.

#include "../native/pileup_native.cpp"

namespace btw {

using namespace btp;

// The bases of a record's M/=/X ops inside [beg, end): no datum of the
// record lies elsewhere. 0 for a record parse_raw would refuse.
static int64_t record_bound(const uint8_t *data, int64_t off, int64_t len,
                            int64_t beg, int64_t end) {
    if (off + 4 > len) return 0;
    int32_t bs;
    std::memcpy(&bs, data + off, 4);
    if (bs < 32 || off + 4 + bs > len) return 0;
    const uint8_t *p = data + off + 4;
    int32_t pos;
    uint16_t n_cigar;
    std::memcpy(&pos, p + 4, 4);
    std::memcpy(&n_cigar, p + 12, 2);
    int64_t cig_off = 32 + (int64_t)p[8];
    if (cig_off + 4 * (int64_t)n_cigar > bs) return 0;
    const uint32_t *cig = (const uint32_t *)(p + cig_off);
    int64_t rpos = (int64_t)pos + 1, n = 0;
    for (int k = 0; k < n_cigar; ++k) {
        uint32_t v = cig_at(cig, k);
        int op = v & 0xF;
        int64_t ln = v >> 4;
        if (op == 0 || op == 7 || op == 8) {
            n += std::max<int64_t>(0, std::min(rpos + ln, end)
                                          - std::max(rpos, beg));
            rpos += ln;
        } else if (op == 2 || op == 3) {
            rpos += ln;
        }
    }
    return n;
}

}  // namespace btw

extern "C" {

// One [beg, end) 1-based window's data over raw records (datas, data_lens,
// rec_offs, n_recs per sample, as bt_pileup_window_raw takes them) into
// data, which holds 10 * cap bytes. Returns the number of data n; minus the
// bound of the window's data, writing nothing, when it exceeds cap; or
// INT64_MIN if the records held more data than their bound.
int64_t bt_walk_stage(const btp::Conf *cf, const char *chrom, int64_t seqlen,
                      int64_t beg, int64_t end, int32_t nbam,
                      const uint8_t *const *datas, const int64_t *data_lens,
                      const int64_t *const *rec_offs, const int64_t *n_recs,
                      uint8_t *data, int64_t cap) {
    using namespace btp;
    int64_t bound = 0;
    for (int sid = 0; sid < nbam; ++sid)
        for (int64_t ri = 0; ri < n_recs[sid]; ++ri)
            bound += btw::record_bound(datas[sid], rec_offs[sid][ri],
                                       data_lens[sid], beg, end);
    if (bound > cap) return -bound;
    if (bound == 0) return 0;
    int32_t *pos = (int32_t *)data, *sids = (int32_t *)(data + 4 * cap);
    uint8_t *stats = data + 8 * cap, *pass = data + 9 * cap;
    int64_t n = 0;

    RawRec b;
    for (int sid = 0; sid < nbam; ++sid) {
        for (int64_t ri = 0; ri < n_recs[sid]; ++ri) {
            if (parse_raw(datas[sid], rec_offs[sid][ri], data_lens[sid], b) < 0)
                continue;
            if (b.mapq < cf->min_mapq) continue;
            if (b.l_qseq < cf->min_read_len) continue;
            if (b.flag > 0) {
                if (cf->filter_secondary && (b.flag & FLAG_SECONDARY)) continue;
                if (cf->filter_duplicate && (b.flag & FLAG_DUP)) continue;
                if (cf->filter_ppair && (b.flag & FLAG_PAIRED)
                    && !(b.flag & FLAG_PROPER)) continue;
                if (cf->filter_qcfail && (b.flag & FLAG_QCFAIL)) continue;
            }
            if (b.nm != INT32_MIN && b.nm > cf->max_nm) continue;
            if (b.as_ != INT32_MIN && b.as_ < cf->min_score) continue;

            bool has_qual = !(b.l_qseq > 0 && b.qual[0] == 0xFF);
            int bss = b.bs_known;
            int64_t read_len_ref = 0;
            {   // bsstrand inference + retention count (bisc_utils.c)
                int nC2T = 0, nG2A = 0, cnt_c = 0, cnt_g = 0;
                int64_t rpos = b.pos + 1;
                int qpos = 0;
                for (int k = 0; k < b.n_cigar; ++k) {
                    uint32_t v = cig_at(b.cigar, k);
                    int op = v & 0xF, ln = v >> 4;
                    if (op == 0 || op == 7 || op == 8) {
                        for (int j = 0; j < ln; ++j) {
                            int64_t rp = rpos + j;
                            int qp = qpos + j;
                            char rbc = (rp >= 1 && rp <= seqlen)
                                ? chrom[rp - 1] : 'N';
                            char qb = qp < b.l_qseq ? seq_at(b, qp) : 'N';
                            bool qok = !has_qual
                                || (qp < b.l_qseq
                                    && b.qual[qp] >= cf->min_base_qual);
                            if (qp < b.l_qseq && qok) {
                                if (rbc == 'C' && qb == 'T') ++nC2T;
                                if (rbc == 'G' && qb == 'A') ++nG2A;
                            }
                            if (rbc == 'C' && qb == 'C') ++cnt_c;
                            if (rbc == 'G' && qb == 'G') ++cnt_g;
                        }
                        rpos += ln;
                        qpos += ln;
                        read_len_ref += ln;
                    } else if (op == 1 || op == 4 || op == 5) {
                        qpos += ln;
                    } else if (op == 2 || op == 3) {
                        rpos += ln;
                        read_len_ref += ln;
                    }
                }
                if (bss < 0) bss = nC2T >= nG2A ? 0 : 1;
                int cnt_ret = bss ? cnt_c : cnt_g;
                if (cnt_ret > cf->max_retention) continue;
            }

            int32_t mate_len = b.mate_len_mc >= 0 ? b.mate_len_mc
                                                  : (int32_t)read_len_ref;
            int64_t rpos0 = b.pos + 1;
            int64_t rmpos = b.mpos + 1;
            int64_t rend = rpos0 + read_len_ref - 1;
            int64_t rmend = rmpos + mate_len - 1;
            bool dc = cf->filter_doublecnt && (b.flag & FLAG_READ2);
            int64_t ov_lo = std::max(rpos0, rmpos);
            int64_t ov_hi = std::min(rend, rmend);

            int64_t rpos = b.pos + 1;
            int qpos = 0;
            for (int k = 0; k < b.n_cigar; ++k) {
                uint32_t v = cig_at(b.cigar, k);
                int op = v & 0xF, ln = v >> 4;
                if (op == 0 || op == 7 || op == 8) {
                    for (int j = 0; j < ln; ++j) {
                        int64_t rp = rpos + j;
                        if (rp < beg || rp >= end) continue;
                        if (dc && rp >= ov_lo && rp <= ov_hi) continue;
                        int qp = qpos + j;
                        char rbc = (rp >= 1 && rp <= seqlen)
                            ? chrom[rp - 1] : 'N';
                        char qb = qp < b.l_qseq ? seq_at(b, qp) : 'N';
                        int meth, base;
                        if (bss) {
                            meth = rbc == 'G'
                                ? (qb == 'A' ? METH_CONV
                                             : (qb == 'G' ? METH_RET : METH_NA))
                                : METH_NA;
                            base = qb == 'A' ? BASE_R : char2int8(qb);
                        } else {
                            meth = rbc == 'C'
                                ? (qb == 'T' ? METH_CONV
                                             : (qb == 'C' ? METH_RET : METH_NA))
                                : METH_NA;
                            base = qb == 'T' ? BASE_Y : char2int8(qb);
                        }
                        if (n == bound) return INT64_MIN;  // stage
                        int q = has_qual  // stage
                            ? (qp < b.l_qseq ? b.qual[qp] : -33) : 0;  // stage
                        pos[n] = (int32_t)(rp - beg);  // stage
                        sids[n] = sid;  // stage
                        stats[n] = (uint8_t)(base << 4 | meth);  // stage
                        pass[n] = q >= cf->min_base_qual  // stage
                            && qp + 1 > cf->min_dist_end_5p  // stage
                            && b.l_qseq >= qp + 1 + cf->min_dist_end_3p;  // stage
                        ++n;  // stage
                    }
                    rpos += ln;
                    qpos += ln;
                } else if (op == 1 || op == 4 || op == 5) {
                    qpos += ln;
                } else if (op == 2 || op == 3) {
                    rpos += ln;
                }
            }
        }
    }
    return n;
}

// The [beg, end) window's VCF text from _device_counts' counts (int64
// cm [end - beg][nbam][NMETH], cb [..][NBASE], dp [..]). Returns 0 (-1 when
// out of memory); *out_buf is malloc'd text of *out_len bytes, freed with
// bt_walk_free. betasum / cntctx are [nbam][6] accumulators (added into).
int bt_walk_emit(const btp::Conf *cf, const char *chrom_name,
                 const char *chrom, int64_t seqlen, int64_t beg, int64_t end,
                 int32_t nbam, const int64_t *cm, const int64_t *cb,
                 const int64_t *dp, void **out_buf, int64_t *out_len,
                 double *betasum, int64_t *cntctx) {
    using namespace btp;
    std::string out;
    out.reserve(1 << 16);
    for (int64_t p = 0; p < end - beg; ++p) {
        const int64_t *d = dp + (size_t)p * nbam;
        int64_t depth = 0;
        for (int s = 0; s < nbam; ++s) depth += d[s];
        if (!depth) continue;
        plp_format(chrom_name, chrom, seqlen, beg + p, *cf, nbam,
                   cm + (size_t)p * nbam * NMETH, cb + (size_t)p * nbam * NBASE,
                   d, betasum, cntctx, out);
    }
    char *buf = (char *)std::malloc(out.size() > 0 ? out.size() : 1);
    if (!buf) return -1;
    std::memcpy(buf, out.data(), out.size());
    *out_buf = buf;
    *out_len = (int64_t)out.size();
    return 0;
}

void bt_walk_free(void *p) { std::free(p); }

}  // extern "C"
