// Native pileup window engine: per-window cytosine+SNP calling to VCF text.
//
// C++ transliteration of biscuit_tpu/pileup/{engine,common,stats}.py (which
// port the reference's src/pileup.c and src/bisc_utils.c) — the Python
// modules remain the ground truth and tests byte-compare both paths.
// Verbose (DIAGNOSE) mode stays in Python.
//
// One call = one [beg, end) window for one or more samples; the Python CLI
// keeps its fork pool over windows.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace btp {

// ---- status codes (pileup/common.py) ----
enum { METH_RET = 0, METH_CONV = 1, METH_NA = 2 };
enum { BASE_A, BASE_C, BASE_G, BASE_T, BASE_N, BASE_Y, BASE_R };
static const int NMETH = 3, NBASE = 7;
static const char *BASECODE = "ACGTNYR";
enum { CTXT_HCG, CTXT_HCHG, CTXT_HCHH, CTXT_GCG, CTXT_GCHG, CTXT_GCHH,
       CTXT_NA };
static const int NCONTXTS = 6;
static const char *CYT_CTX[7] = {"CG", "CHG", "CHH", "CG", "CHG", "CHH", "CN"};
static const char *CYT_CTX_NOME[7] = {"HCG", "HCHG", "HCHH", "GCG", "GCH",
                                      "GCH", "CN"};

static int char2int8(char c) {
    switch (c) {
        case 'A': return BASE_A;
        case 'C': return BASE_C;
        case 'G': return BASE_G;
        case 'T': return BASE_T;
        case 'Y': return BASE_Y;
        case 'R': return BASE_R;
        default: return BASE_N;
    }
}

static char comp(char c) {
    switch (c) {
        case 'A': return 'T'; case 'C': return 'G'; case 'G': return 'C';
        case 'T': return 'A'; case 'Y': return 'R'; case 'R': return 'Y';
        case 'a': return 't'; case 'c': return 'g'; case 'g': return 'c';
        case 't': return 'a'; case 'y': return 'r'; case 'r': return 'y';
        default: return c == 'N' || c == 'n' ? c : c;
    }
}

// ---- stats.py (re-derived genotype math; defined behavior) ----
enum { HOMOREF = 0, HET = 1, HOMOVAR = 2 };

static double genotype_lnlik(int genotype, int cref, int altsupp, double error,
                             double contam) {
    double p_alt;
    if (genotype == HOMOREF) p_alt = error + contam;
    else if (genotype == HET) p_alt = 0.5;
    else p_alt = 1.0 - error - contam;
    p_alt = std::min(std::max(p_alt, 1e-12), 1 - 1e-12);
    return cref * std::log(1.0 - p_alt) + altsupp * std::log(p_alt);
}

static double ln_sum3(double a, double b, double c) {
    double m = std::max(std::max(a, b), c);
    return m + std::log(std::exp(a - m) + std::exp(b - m) + std::exp(c - m));
}

static double pval2qual(double p) {
    if (p <= 0.0) return 255.0;
    double q = -10.0 * std::log10(p);
    return std::max(q, 0.0);
}

static double somatic_posterior(int cref_t, int altcnt_t, int cref_n,
                                int altcnt_n, double error, double mu,
                                double mu_somatic, double contam) {
    double ln_som = genotype_lnlik(HET, cref_t, altcnt_t, error, contam)
        + genotype_lnlik(HOMOREF, cref_n, altcnt_n, error, contam)
        + std::log(std::max(mu_somatic, 1e-300));
    double ln_germ = genotype_lnlik(HET, cref_t, altcnt_t, error, contam)
        + genotype_lnlik(HET, cref_n, altcnt_n, error, contam)
        + std::log(std::max(mu, 1e-300));
    double ln_wild = genotype_lnlik(HOMOREF, cref_t, altcnt_t, error, contam)
        + genotype_lnlik(HOMOREF, cref_n, altcnt_n, error, contam)
        + std::log(std::max(1.0 - mu - mu_somatic, 1e-300));
    double total = ln_sum3(ln_som, ln_germ, ln_wild);
    double p_not = 1.0 - std::exp(ln_som - total);
    return std::max(p_not, 0.0);
}

// ---- config mirror (PileupConf + MethFilter) ----
struct Conf {
    int32_t is_nome;
    int32_t ambi_redist, somatic;
    double error, mu, mu_somatic, contam, prior1, prior2;
    int32_t min_base_qual, min_read_len, min_dist_end_5p, min_dist_end_3p;
    int32_t min_mapq, min_score, max_nm, max_retention;
    int32_t filter_ppair, filter_secondary, filter_duplicate, filter_qcfail,
        filter_doublecnt;
};

// per-read input row (tags pre-extracted by Python)
struct ReadC {
    int64_t pos;        // 0-based leftmost
    int64_t mpos;       // 0-based mate pos
    int32_t flag, mapq, l_qseq;
    int32_t nm;         // INT32_MIN => absent
    int32_t as_;        // INT32_MIN => absent
    int32_t bs_known;   // -1 infer, 0/1 known (YD>ZS>XG priority, Python-side)
    int32_t mate_len;   // reference length of mate (MC tag or own rlen)
    int32_t sid;
    int64_t seq_off; int32_t seq_len;
    int64_t qual_off; int32_t qual_len;  // 0 => '*'
    int64_t cig_off; int32_t n_cigar;
};

static const int FLAG_PAIRED = 0x1, FLAG_PROPER = 0x2, FLAG_REVERSE = 0x10,
    FLAG_READ2 = 0x80, FLAG_SECONDARY = 0x100, FLAG_QCFAIL = 0x200,
    FLAG_DUP = 0x400;

// bisc_utils.c:33-72 fivenuc_context (pileup/common.py:111)
static int fivenuc_context(const char *chrom, int64_t seqlen, int64_t rpos,
                           char rb, char five_out[6]) {
    char five[5] = {'N', 'N', 'N', 'N', 'N'};
    auto sub = [&](int64_t pos, int n, char *dst) {
        for (int i = 0; i < n; ++i) dst[i] = chrom[pos - 1 + i];
    };
    if (rpos == 1) sub(1, 3, five + 2);
    else if (rpos == 2) sub(1, 4, five + 1);
    else if (rpos == seqlen) sub(rpos - 2, 3, five);
    else if (rpos == seqlen - 1) sub(rpos - 2, 4, five);
    else sub(rpos - 2, 5, five);
    if (rb == 'G') {  // revcomp in place
        char tmp[5];
        for (int i = 0; i < 5; ++i) tmp[i] = comp(five[4 - i]);
        std::memcpy(five, tmp, 5);
    }
    std::memcpy(five_out, five, 5);
    five_out[5] = 0;
    bool hasN = false;
    for (int i = 0; i < 5; ++i) if (five[i] == 'N') hasN = true;
    if (hasN) return CTXT_NA;
    if (rb != 'C' && rb != 'G') return CTXT_NA;
    if (five[3] == 'G') return five[1] == 'G' ? CTXT_GCG : CTXT_HCG;
    if (five[4] == 'G') return five[1] == 'G' ? CTXT_GCHG : CTXT_HCHG;
    return five[1] == 'G' ? CTXT_GCHH : CTXT_HCHH;
}

// pileup.c:312-333 _top_mutant (pileup/engine.py:96)
static int top_mutant(const int64_t *cb, int rb_code) {
    long long supp[NBASE];
    for (int i = 0; i < NBASE; ++i)
        supp[i] = i != BASE_N ? ((cb[i] << 4) | i) : 0;
    std::stable_sort(supp, supp + NBASE,
                     [](long long a, long long b) { return (a >> 4) > (b >> 4); });
    for (int k = 0; k < NBASE; ++k) {
        int base = (int)(supp[k] & 0xF);
        if (base == BASE_R && (rb_code == BASE_A || rb_code == BASE_G)) continue;
        if (base == BASE_Y && (rb_code == BASE_C || rb_code == BASE_T)) continue;
        if (base != BASE_N && base != rb_code && (supp[k] >> 4) > 0) return base;
    }
    return -1;
}

// pileup.c:339-370 _redistribute_cnts (engine.py:113)
static void redistribute(int64_t *cb /* [nbam][NBASE] */, int nbam,
                         int rb_code) {
    int64_t all_[NBASE] = {0};
    for (int s = 0; s < nbam; ++s)
        for (int i = 0; i < NBASE; ++i) all_[i] += cb[s * NBASE + i];
    for (int s = 0; s < nbam; ++s) {
        int64_t *row = cb + s * NBASE;
        if ((rb_code == BASE_T || all_[BASE_T]) && all_[BASE_C] == 0
            && rb_code != BASE_C) { row[BASE_T] += row[BASE_Y]; row[BASE_Y] = 0; }
        if ((rb_code == BASE_C || all_[BASE_C]) && all_[BASE_T] == 0
            && rb_code != BASE_T) { row[BASE_C] += row[BASE_Y]; row[BASE_Y] = 0; }
        if ((rb_code == BASE_A || all_[BASE_A]) && all_[BASE_G] == 0
            && rb_code != BASE_G) { row[BASE_A] += row[BASE_R]; row[BASE_R] = 0; }
        if ((rb_code == BASE_G || all_[BASE_G]) && all_[BASE_A] == 0
            && rb_code != BASE_A) { row[BASE_G] += row[BASE_R]; row[BASE_R] = 0; }
    }
}

// pileup.c:389-413 pileup_genotype (engine.py:70)
static void pileup_genotype(int cref, int altsupp, const Conf &cf,
                            char gt_out[4], double &gl0, double &gl1,
                            double &gl2, double &gq) {
    std::strcpy(gt_out, "./.");
    gl0 = gl1 = gl2 = -1.0;
    gq = -1.0;
    double prior0 = 1.0 - cf.prior1 - cf.prior2;
    if (cref >= 0 || altsupp >= 0) {
        gl0 = std::log(prior0) + genotype_lnlik(HOMOREF, cref, altsupp, cf.error, cf.contam);
        gl1 = std::log(cf.prior1) + genotype_lnlik(HET, cref, altsupp, cf.error, cf.contam);
        gl2 = std::log(cf.prior2) + genotype_lnlik(HOMOVAR, cref, altsupp, cf.error, cf.contam);
        double lsum = ln_sum3(gl0, gl1, gl2);
        if (gl0 > gl1) {
            if (gl0 > gl2) { gq = pval2qual(1 - std::exp(gl0 - lsum)); std::strcpy(gt_out, "0/0"); }
            else { gq = pval2qual(1 - std::exp(gl2 - lsum)); std::strcpy(gt_out, "1/1"); }
        } else if (gl1 > gl2) {
            gq = pval2qual(1 - std::exp(gl1 - lsum)); std::strcpy(gt_out, "0/1");
        } else {
            gq = pval2qual(1 - std::exp(gl2 - lsum)); std::strcpy(gt_out, "1/1");
        }
    }
}

struct ApIter {  // aligned-pairs walk over M/=/X ops (common.py:139)
    const uint8_t *ops; const int32_t *lens; int n;
};

// engine.py plp_format (pileup.c:415-640) with precomputed counts
static void plp_format(const char *chrom_name, const char *chrom,
                       int64_t seqlen, int64_t rpos, const Conf &cf, int nbam,
                       const int64_t *cm,   // [nbam][NMETH] filtered
                       const int64_t *cb,   // [nbam][NBASE] filtered
                       const int64_t *dp,   // [nbam]
                       double *betasum, int64_t *cntctx,  // [nbam][NCONTXTS]
                       std::string &out) {
    char rb = (rpos >= 1 && rpos <= seqlen) ? chrom[rpos - 1] : 'N';
    if (rb == 'N') return;
    int rb_code = char2int8(rb);

    std::vector<int64_t> cbr(cb, cb + nbam * NBASE);
    if (cf.ambi_redist) redistribute(cbr.data(), nbam, rb_code);

    int64_t cb_all[NBASE] = {0};
    int64_t cm_all[NMETH] = {0};
    for (int s = 0; s < nbam; ++s) {
        for (int i = 0; i < NMETH; ++i) cm_all[i] += cm[s * NMETH + i];
        for (int i = 0; i < NBASE; ++i) cb_all[i] += cbr[s * NBASE + i];
    }
    int cm1 = top_mutant(cb_all, rb_code);
    if (cm1 < 0 && cm_all[METH_RET] == 0 && cm_all[METH_CONV] == 0)
        return;  // non-verbose emission test

    std::vector<std::string> gt(nbam, "./.");
    std::vector<double> gl0(nbam, -1.0), gl1(nbam, -1.0), gl2(nbam, -1.0),
        gq(nbam, 0.0);
    std::vector<int> methcallable(nbam, 0);
    int any_methcallable = 0;
    double lowest_gq = 0.0;
    for (int s = 0; s < nbam; ++s) {
        const int64_t *cb1 = cbr.data() + s * NBASE;
        const int64_t *cm_1 = cm + s * NMETH;
        if (cm_1[METH_RET] + cm_1[METH_CONV] > 0) {
            if (rb == 'C') {
                if (cb1[BASE_T] == 0) methcallable[s] = 1;
                else if (cb1[BASE_C] > 0
                         && (double)cb1[BASE_T] / cb1[BASE_C] < 0.05)
                    methcallable[s] = 1;
            }
            if (rb == 'G') {
                if (cb1[BASE_A] == 0) methcallable[s] = 1;
                else if (cb1[BASE_G] > 0
                         && (double)cb1[BASE_A] / cb1[BASE_G] < 0.05)
                    methcallable[s] = 1;
            }
        }
        int64_t nref = cb1[rb_code];
        int64_t nalt = cm1 >= 0 ? cb1[cm1] : 0;
        if (nref + nalt > 0) {
            char g[4];
            pileup_genotype((int)nref, (int)nalt, cf, g, gl0[s], gl1[s],
                            gl2[s], gq[s]);
            gt[s] = g;
        }
        if (gq[s] < lowest_gq || s == 0) lowest_gq = gq[s];
        if (methcallable[s]) any_methcallable = 1;
    }

    double squal = 0.0;
    int ss = 5;
    if (cf.somatic && cm1 >= 0) {
        int cm1_t = top_mutant(cbr.data(), rb_code);  // tumor sample row
        if (cm1_t >= 0) {
            int64_t altcnt_t = cbr[0 * NBASE + cm1_t];
            int64_t altcnt_n = cbr[1 * NBASE + cm1_t];
            int64_t cref_t = cbr[0 * NBASE + rb_code];
            int64_t cref_n = cbr[1 * NBASE + rb_code];
            squal = pval2qual(somatic_posterior(
                (int)cref_t, (int)altcnt_t, (int)cref_n, (int)altcnt_n,
                cf.error, cf.mu, cf.mu_somatic, cf.contam));
            if (squal > 1) ss = 2;
            else if (gt[1].size() > 2 && gt[1][2] == '1') ss = 1;
            else ss = 0;
        }
    }

    char buf[64];
    out += chrom_name;
    out += '\t';
    out += std::to_string(rpos);
    out += "\t.\t";
    out += rb;
    out += '\t';
    if (cm1 >= 0)
        out += (cm1 == BASE_Y || cm1 == BASE_R) ? 'N' : BASECODE[cm1];
    else out += '.';
    out += '\t';
    out += std::to_string((long long)lowest_gq);
    out += lowest_gq > 5 ? "\tPASS\t" : "\tLowQual\t";

    int ctt = CTXT_NA;
    out += "NS=";
    out += std::to_string(nbam);
    char fivenuc[6] = {0};
    if (rb == 'C' || rb == 'G') {
        ctt = fivenuc_context(chrom, seqlen, rpos, rb, fivenuc);
        out += ";CX=";
        out += cf.is_nome ? CYT_CTX_NOME[ctt] : CYT_CTX[ctt];
        out += ";N5=";
        out += fivenuc;
    }
    if (cf.somatic && cm1 >= 0) {
        out += ";SS=";
        out += std::to_string(ss);
        out += ";SC=";
        out += std::to_string((long long)squal);
    }
    if (cm1 >= 0 && (cm1 == BASE_Y || cm1 == BASE_R)) {
        out += ";AB=";
        out += BASECODE[cm1];
    }

    out += "\tGT:GL1:GQ:DP:SP";
    if (cm1 >= 0) out += ":AC:AF1";
    if (any_methcallable) out += ":CV:BT";

    for (int s = 0; s < nbam; ++s) {
        const int64_t *cb1 = cb + s * NBASE;        // unredistributed
        const int64_t *cb1r = cbr.data() + s * NBASE;
        const int64_t *cm_1 = cm + s * NMETH;
        int64_t dps = dp[s];
        if (gq[s] > 0 && dps) {
            snprintf(buf, sizeof buf, "\t%s:%1.0f,%1.0f,%1.0f:%1.0f",
                     gt[s].c_str(), std::max(-1000.0, gl0[s]),
                     std::max(-1000.0, gl1[s]), std::max(-1000.0, gl2[s]),
                     gq[s]);
            out += buf;
        } else {
            out += "\t./.:.,.,.:0";
        }
        out += ':';
        out += std::to_string(dps ? dps : 0);
        out += ':';
        bool added = false;
        if (cb1[rb_code]) {
            out += rb;
            out += std::to_string(cb1[rb_code]);
            added = true;
        }
        for (int i = 0; i < NBASE; ++i) {
            if (i == BASE_N || i == rb_code || cb1[i] <= 0) continue;
            out += BASECODE[i];
            out += std::to_string(cb1[i]);
            added = true;
        }
        if (!added) out += '.';
        if (cm1 >= 0) {
            int64_t nref = cb1r[rb_code], nalt = cb1r[cm1];
            out += ':';
            out += std::to_string(nref + nalt);
            out += ':';
            if (nref + nalt) {
                snprintf(buf, sizeof buf, "%1.2f",
                         (double)nalt / (nref + nalt));
                out += buf;
            } else {
                out += '.';
            }
        }
        if (any_methcallable) {
            if (methcallable[s]) {
                double beta = (double)cm_1[METH_RET]
                    / (cm_1[METH_RET] + cm_1[METH_CONV]);
                if (ctt != CTXT_NA) {
                    betasum[s * NCONTXTS + ctt] += beta;
                    cntctx[s * NCONTXTS + ctt] += 1;
                }
                snprintf(buf, sizeof buf, ":%lld:%1.3f",
                         (long long)(cm_1[METH_RET] + cm_1[METH_CONV]), beta);
                out += buf;
            } else {
                out += ":0:.";
            }
        }
    }
    out += '\n';
}

}  // namespace btp

extern "C" {

// Process one [beg, end) 1-based window. Returns 0; *out_buf is malloc'd VCF
// text of out_len bytes (caller frees with bt_buf_free from align_host.cpp).
// betasum/cntctx are [nbam][6] accumulators (added into).
int bt_pileup_window(const btp::Conf *cf, const char *chrom_name,
                     const char *chrom /* uppercased */, int64_t seqlen,
                     int64_t beg, int64_t end, int32_t nbam,
                     const btp::ReadC *reads, int32_t n_reads,
                     const char *seq_blob, const char *qual_blob,
                     const uint8_t *cig_ops, const int32_t *cig_lens,
                     void **out_buf, int64_t *out_len,
                     double *betasum, int64_t *cntctx) {
    using namespace btp;
    int64_t P = end - beg;
    std::vector<int64_t> cm((size_t)P * nbam * NMETH, 0);
    std::vector<int64_t> cb((size_t)P * nbam * NBASE, 0);
    std::vector<int64_t> dp((size_t)P * nbam, 0);
    std::vector<uint8_t> covered((size_t)P, 0);

    for (int r = 0; r < n_reads; ++r) {
        const ReadC &b = reads[r];
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

        const char *seq = seq_blob + b.seq_off;
        const char *qual = b.qual_len ? qual_blob + b.qual_off : nullptr;
        const uint8_t *ops = cig_ops + b.cig_off;
        const int32_t *lens = cig_lens + b.cig_off;

        // bsstrand: tag chain resolved Python-side; infer here if needed
        // (bisc_utils.c:163-206), then cnt_retention (:76-122)
        int bss = b.bs_known;
        int64_t read_len_ref = 0;  // reference span of this read's cigar
        {
            int nC2T = 0, nG2A = 0, cnt_c = 0, cnt_g = 0;
            int64_t rpos = b.pos + 1;
            int qpos = 0;
            for (int k = 0; k < b.n_cigar; ++k) {
                int op = ops[k], ln = lens[k];
                if (op == 0 || op == 7 || op == 8) {
                    for (int j = 0; j < ln; ++j) {
                        int64_t rp = rpos + j;
                        int qp = qpos + j;
                        char rbc = (rp >= 1 && rp <= seqlen) ? chrom[rp - 1] : 'N';
                        char qb = qp < b.seq_len ? seq[qp] : 'N';
                        // '*' qual => all pass; out-of-range qpos fails
                        bool qok = !qual
                            || (qp < b.qual_len
                                && qual[qp] - 33 >= cf->min_base_qual);
                        if (qp < b.seq_len && qok) {
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
                } else if (op == 2) {
                    rpos += ln;
                    read_len_ref += ln;
                }
            }
            if (bss < 0) bss = nC2T >= nG2A ? 0 : 1;
            int cnt_ret = bss ? cnt_c : cnt_g;
            if (cnt_ret > cf->max_retention) continue;
        }

        int64_t rpos0 = b.pos + 1;
        int64_t rmpos = b.mpos + 1;
        int64_t rend = rpos0 + read_len_ref - 1;
        int64_t rmend = rmpos + b.mate_len - 1;
        bool dc = cf->filter_doublecnt && (b.flag & FLAG_READ2);
        int64_t ov_lo = std::max(rpos0, rmpos), ov_hi = std::min(rend, rmend);

        int64_t rpos = b.pos + 1;
        int qpos = 0;
        for (int k = 0; k < b.n_cigar; ++k) {
            int op = ops[k], ln = lens[k];
            if (op == 0 || op == 7 || op == 8) {
                for (int j = 0; j < ln; ++j) {
                    int64_t rp = rpos + j;
                    if (rp < beg || rp >= end) continue;
                    if (dc && rp >= ov_lo && rp <= ov_hi) continue;
                    int qp = qpos + j;
                    char rbc = (rp >= 1 && rp <= seqlen) ? chrom[rp - 1] : 'N';
                    char qb = qp < b.seq_len ? seq[qp] : 'N';
                    int meth, base;
                    if (bss) {  // BSC
                        meth = rbc == 'G'
                            ? (qb == 'A' ? METH_CONV
                                         : (qb == 'G' ? METH_RET : METH_NA))
                            : METH_NA;
                        base = qb == 'A' ? BASE_R : char2int8(qb);
                    } else {  // BSW
                        meth = rbc == 'C'
                            ? (qb == 'T' ? METH_CONV
                                         : (qb == 'C' ? METH_RET : METH_NA))
                            : METH_NA;
                        base = qb == 'T' ? BASE_Y : char2int8(qb);
                    }
                    int64_t p = rp - beg;
                    covered[p] = 1;
                    dp[p * nbam + b.sid] += 1;
                    int q = qual ? (qp < b.qual_len ? qual[qp] - 33 : -33) : 0;
                    // datum-level filters (plp_getcnts)
                    if (q < cf->min_base_qual) continue;
                    if (qp + 1 <= cf->min_dist_end_5p
                        || b.l_qseq < qp + 1 + cf->min_dist_end_3p) continue;
                    cm[(p * nbam + b.sid) * NMETH + meth] += 1;
                    cb[(p * nbam + b.sid) * NBASE + base] += 1;
                }
                rpos += ln;
                qpos += ln;
            } else if (op == 1 || op == 4 || op == 5) {
                qpos += ln;
            } else if (op == 2) {
                rpos += ln;
            }
        }
    }

    std::string out;
    out.reserve(1 << 16);
    for (int64_t p = 0; p < P; ++p) {
        if (!covered[p]) continue;
        plp_format(chrom_name, chrom, seqlen, beg + p, *cf, nbam,
                   cm.data() + (size_t)p * nbam * NMETH,
                   cb.data() + (size_t)p * nbam * NBASE,
                   dp.data() + (size_t)p * nbam, betasum, cntctx, out);
    }
    char *buf = (char *)std::malloc(out.size() > 0 ? out.size() : 1);
    if (!buf) return -1;
    std::memcpy(buf, out.data(), out.size());
    *out_buf = buf;
    *out_len = (int64_t)out.size();
    return 0;
}

}  // extern "C"

// =====================================================================
// Raw-BAM path: parse uncompressed BAM records (SAMv1 §4.2) directly so
// no per-read Python marshaling is needed. bt_bam_scan indexes the blob
// once; bt_pileup_window_raw runs a window from record offsets.
// =====================================================================

namespace btp {

static const char NT16[] = "=ACMGRSVTWYHKDBN";

struct RawRec {  // views into the BAM record body
    int64_t pos, mpos;
    int32_t tid, flag, mapq, l_qseq;
    const uint32_t *cigar; int n_cigar;
    const uint8_t *seq4;          // 4-bit packed
    const uint8_t *qual;          // raw phred; qual[0]==0xFF => absent
    const uint8_t *tags; int64_t tags_len;
    int32_t nm, as_, bs_known, mate_len_mc;  // mate_len_mc -1 => no MC
    const uint8_t *mm;            // MM/Mm Z-tag value (NUL-terminated), or null
    const uint8_t *ml; int32_t ml_n;  // ML/Ml B,C array view, or null
};

static inline char seq_at(const RawRec &r, int qp) {
    return NT16[(r.seq4[qp >> 1] >> ((~qp & 1) << 2)) & 0xF];
}

// cigar points into the raw BAM body, which has no alignment guarantee:
// read ops via memcpy (compiles to one mov on x86; a direct deref is UB)
static inline uint32_t cig_at(const uint32_t *cig, int k) {
    uint32_t v;
    std::memcpy(&v, (const uint8_t *)cig + 4 * (size_t)k, 4);
    return v;
}

// parse one record at data+off; returns offset past it (or -1 on overrun)
static int64_t parse_raw(const uint8_t *data, int64_t off, int64_t len,
                         RawRec &r) {
    if (off + 4 > len) return -1;
    int32_t bs;
    std::memcpy(&bs, data + off, 4);
    if (bs < 32 || off + 4 + bs > len) return -1;
    const uint8_t *p = data + off + 4;
    int32_t refID, pos, l_seq, next_refID, next_pos;
    std::memcpy(&refID, p, 4);
    std::memcpy(&pos, p + 4, 4);
    uint8_t l_read_name = p[8];
    r.mapq = p[9];
    uint16_t n_cigar, flag;
    std::memcpy(&n_cigar, p + 12, 2);
    std::memcpy(&flag, p + 14, 2);
    std::memcpy(&l_seq, p + 16, 4);
    std::memcpy(&next_refID, p + 20, 4);
    std::memcpy(&next_pos, p + 24, 4);
    r.tid = refID;
    r.pos = pos;
    r.mpos = next_pos;
    r.flag = flag;
    r.l_qseq = l_seq;
    const uint8_t *q = p + 32 + l_read_name;
    r.cigar = (const uint32_t *)q;
    r.n_cigar = n_cigar;
    q += 4 * n_cigar;
    r.seq4 = q;
    q += (l_seq + 1) / 2;
    r.qual = q;
    q += l_seq;
    r.tags = q;
    r.tags_len = (data + off + 4 + bs) - q;
    // tag scan: NM/AS (i-family), YD (A), ZS, XG, MC, MM/Mm + ML/Ml
    r.nm = INT32_MIN;
    r.as_ = INT32_MIN;
    r.bs_known = -1;
    r.mate_len_mc = -1;
    r.mm = nullptr;
    r.ml = nullptr;
    r.ml_n = 0;
    const uint8_t *mm_u = nullptr, *mm_l = nullptr;
    const uint8_t *ml_u = nullptr, *ml_l = nullptr;
    int32_t mln_u = 0, mln_l = 0;
    int bs_src = 3;  // priority: 0 = YD, 1 = ZS, 2 = XG, 3 = none
    const uint8_t *t = r.tags;
    const uint8_t *tend = r.tags + r.tags_len;
    while (t + 3 <= tend) {
        char t0 = t[0], t1 = t[1], typ = t[2];
        const uint8_t *v = t + 3;
        int64_t vlen = 0;
        int64_t ival = 0;
        bool is_int = true;
        switch (typ) {
            case 'A': vlen = 1; ival = (int8_t)v[0]; is_int = false; break;
            case 'c': vlen = 1; ival = (int8_t)v[0]; break;
            case 'C': vlen = 1; ival = v[0]; break;
            case 's': { int16_t x; std::memcpy(&x, v, 2); ival = x; vlen = 2; break; }
            case 'S': { uint16_t x; std::memcpy(&x, v, 2); ival = x; vlen = 2; break; }
            case 'i': { int32_t x; std::memcpy(&x, v, 4); ival = x; vlen = 4; break; }
            case 'I': { uint32_t x; std::memcpy(&x, v, 4); ival = (int64_t)x; vlen = 4; break; }
            case 'f': vlen = 4; is_int = false; break;
            case 'Z': case 'H': {
                const uint8_t *z = v;
                while (z < tend && *z) ++z;
                vlen = (z - v) + 1;
                is_int = false;
                break;
            }
            case 'B': {
                if (v + 5 > tend) { t = tend; continue; }
                char sub = (char)v[0];
                int32_t n;
                std::memcpy(&n, v + 1, 4);
                int esz = (sub == 'c' || sub == 'C') ? 1
                    : (sub == 's' || sub == 'S') ? 2 : 4;
                vlen = 5 + (int64_t)n * esz;
                is_int = false;
                break;
            }
            default: t = tend; continue;  // unknown: stop scanning
        }
        if (t0 == 'N' && t1 == 'M' && is_int) r.nm = (int32_t)ival;
        else if (t0 == 'A' && t1 == 'S' && is_int) r.as_ = (int32_t)ival;
        else if (t0 == 'Y' && t1 == 'D' && typ == 'A' && bs_src > 0) {
            if ((char)v[0] == 'f') { r.bs_known = 0; bs_src = 0; }
            else if ((char)v[0] == 'r') { r.bs_known = 1; bs_src = 0; }
        } else if (t0 == 'Z' && t1 == 'S' && bs_src > 1
                   && (typ == 'Z' || typ == 'A')) {
            if ((char)v[0] == '+') { r.bs_known = 0; bs_src = 1; }
            else if ((char)v[0] == '-') { r.bs_known = 1; bs_src = 1; }
        } else if (t0 == 'X' && t1 == 'G' && typ == 'Z' && bs_src > 2
                   && vlen >= 3) {
            if (v[0] == 'C' && v[1] == 'T') { r.bs_known = 0; bs_src = 2; }
            else if (v[0] == 'G' && v[1] == 'A') { r.bs_known = 1; bs_src = 2; }
        } else if (t0 == 'M' && (t1 == 'M' || t1 == 'm') && typ == 'Z') {
            if (t1 == 'M') mm_u = v; else mm_l = v;
        } else if ((t0 == 'M' && t1 == 'L') || (t0 == 'M' && t1 == 'l')) {
            if (typ == 'B' && v + 5 <= tend
                && ((char)v[0] == 'C' || (char)v[0] == 'c')) {
                int32_t n;
                std::memcpy(&n, v + 1, 4);
                // clamp to the bytes actually present: a truncated/corrupt
                // record's declared count must not drive modbam_fill past
                // the record body
                n = (int32_t)std::max<int64_t>(
                    0, std::min<int64_t>(n, tend - (v + 5)));
                if (t1 == 'L') { ml_u = v + 5; mln_u = n; }
                else { ml_l = v + 5; mln_l = n; }
            }
        } else if (t0 == 'M' && t1 == 'C' && typ == 'Z') {
            // reference length from the mate cigar (MDN=X consume ref)
            int64_t n = 0, cur = 0;
            for (const uint8_t *z = v; z < tend && *z; ++z) {
                if (*z >= '0' && *z <= '9') cur = cur * 10 + (*z - '0');
                else {
                    char op = (char)*z;
                    if (op == 'M' || op == 'D' || op == 'N' || op == '='
                        || op == 'X') n += cur;
                    cur = 0;
                }
            }
            r.mate_len_mc = (int32_t)n;
        }
        t = v + vlen;
    }
    r.mm = mm_u ? mm_u : mm_l;             // MM preferred over Mm
    r.ml = ml_u ? ml_u : ml_l;
    r.ml_n = ml_u ? mln_u : mln_l;
    return off + 4 + bs;
}

static inline char comp_char(char c) {    // pileup/common.py:_COMP
    switch (c) {
        case 'A': return 'T'; case 'C': return 'G';
        case 'G': return 'C'; case 'T': return 'A';
        case 'a': return 't'; case 'c': return 'g';
        case 'g': return 'c'; case 't': return 'a';
        default: return c;
    }
}

// modBAM MM/ML -> per-stored-qpos qual (subcmds/epiread.py:modbam_quals,
// porting epiread.c:586-617's bam_parse_basemod2 consumption). mq[qpos]
// holds the ML byte, -1 when ML is absent, INT16_MIN when the position has
// no call. Returns 0, or -4 (not an 'm' modification) / -5 (canonical base
// not C/G) matching the Python SystemExit cases.
static int modbam_fill(const RawRec &b, std::vector<int16_t> &mq,
                       int &strand, char &canonical) {
    mq.assign(b.l_qseq, INT16_MIN);
    strand = 0;
    canonical = 'C';
    if (!b.mm || !b.mm[0]) return 0;
    const char *p = (const char *)b.mm;
    canonical = p[0];
    if (!p[1]) return -4;
    strand = p[1] == '+' ? 0 : 1;
    bool has_m = false;
    while (*p && *p != ',' && *p != ';') { if (*p == 'm') has_m = true; ++p; }
    if (!has_m) return -4;
    if (canonical != 'C' && canonical != 'G') return -5;
    bool rev = (b.flag & FLAG_REVERSE) != 0;
    int L = b.l_qseq;
    std::vector<int32_t> positions;  // of `canonical` in ORIGINAL orientation
    positions.reserve(L);
    for (int i = 0; i < L; ++i) {
        char c = rev ? comp_char(seq_at(b, L - 1 - i)) : seq_at(b, i);
        if (c == canonical) positions.push_back(i);
    }
    int64_t idx = -1;
    int k = 0;
    while (*p == ',') {            // first ';'-spec only, like the Python
        ++p;
        int64_t d = 0;
        while (*p >= '0' && *p <= '9') d = d * 10 + (*p++ - '0');
        idx += d + 1;
        if (idx >= (int64_t)positions.size()) break;
        int opos = positions[idx];
        int spos = rev ? L - 1 - opos : opos;
        mq[spos] = (b.ml && k < b.ml_n) ? (int16_t)b.ml[k] : (int16_t)-1;
        ++k;
    }
    return 0;
}

// bisc_utils.h:227-251 via subcmds/epiread.py:is_modbam_cpg
static inline int modbam_is_cpg(int flag, int strand, char canonical,
                                char qb, char rb, int64_t pos,
                                const char *chrom, int64_t seqlen,
                                int64_t rs_beg, int64_t rs_end) {
    auto gb = [&](int64_t p) -> char {
        return (p >= 1 && p <= seqlen) ? chrom[p - 1] : 'N';
    };
    bool rv = (flag & FLAG_REVERSE) != 0;
    if (canonical == 'C' && strand == 0) {
        if (qb == 'G' && rv) {
            if (rb == 'G' && pos - 1 >= rs_beg && gb(pos - 1) == 'C') return 1;
        } else if (qb == 'C' && !rv) {
            if (rb == 'C' && pos + 1 <= rs_end && gb(pos + 1) == 'G') return 1;
        }
    } else if (canonical == 'G' && strand == 1) {
        if (qb == 'C' && rv) {
            if (rb == 'C' && pos + 1 <= rs_end && gb(pos + 1) == 'G') return 1;
        } else if (qb == 'G' && !rv) {
            if (rb == 'G' && pos - 1 >= rs_beg && gb(pos - 1) == 'C') return 1;
        }
    }
    return 0;
}

}  // namespace btp

extern "C" {

// Pass 1 (n_out == 0): returns the record count. Pass 2: fills offs/tids/
// poss/rends (ref-end = pos + ref span from the cigar) for each record.
int64_t bt_bam_scan(const uint8_t *data, int64_t len, int64_t body_off,
                    int64_t *offs, int32_t *tids, int64_t *poss,
                    int64_t *rends, int64_t n_out) {
    using namespace btp;
    int64_t off = body_off, n = 0;
    RawRec r;
    while (off < len) {
        int64_t nxt = parse_raw(data, off, len, r);
        if (nxt < 0) break;
        if (n_out) {
            if (n >= n_out) break;
            int64_t span = 0;
            for (int k = 0; k < r.n_cigar; ++k) {
                uint32_t v = cig_at(r.cigar, k);
                uint32_t op = v & 0xF;
                if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                    span += v >> 4;
            }
            offs[n] = off;
            tids[n] = r.tid;
            poss[n] = r.pos;
            rends[n] = r.pos + span;
        }
        ++n;
        off = nxt;
    }
    return n;
}

// ------------------------------------------------------------------
// epiread (epiBED mode) over raw BAM records. Transliteration of
// subcmds/epiread.py:process_window/_format_epibed (porting
// epiread.c:195-281,540-1046); old/pairwise/modBAM modes stay Python.
// snp_locs (sorted, 1-based) / snp_meth are the window's episnp table.
// rs_beg/rs_end are the fetched reference-window bounds (refcache
// semantics: context bases outside them read as absent).
// mode: 0 = epiBED (default), 1 = old -O format, 2 = pairwise -P format
// (reference format_epiread_old epiread.c:285-421 / epiread_pairwise).
// have_snps: a SNP table was supplied (the old format prints ".\t." for a
// read with no SNPs only when a table exists; "\t\t" otherwise).
int bt_epiread_window_raw(const btp::Conf *cf, int32_t is_nome,
                          int32_t filter_empty, int32_t max_read_length,
                          int32_t mode, int32_t print_all_locations,
                          int32_t have_snps,
                          int32_t use_modbam, double modbam_prob,
                          const char *chrom_name, const char *chrom,
                          int64_t seqlen, int64_t rs_beg, int64_t rs_end,
                          int64_t beg, int64_t end,
                          int64_t print_w_beg, int64_t print_w_end,
                          const uint8_t *data, int64_t data_len,
                          const int64_t *rec_offs, int64_t n_recs,
                          const int64_t *snp_locs, const uint8_t *snp_meth,
                          int64_t n_snps,
                          void **out_buf, int64_t *out_len) {
    using namespace btp;
    auto getb = [&](int64_t p) -> char {  // 1-based, fetched-window bounded
        return (p >= 1 && p <= seqlen) ? chrom[p - 1] : 'N';
    };
    auto snp_at = [&](int64_t p) -> int {  // 0 none, 1 snp, 2 snp+methcallable
        int64_t lo = 0, hi = n_snps;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (snp_locs[mid] < p) lo = mid + 1;
            else hi = mid;
        }
        if (lo < n_snps && snp_locs[lo] == p) return snp_meth[lo] ? 2 : 1;
        return 0;
    };
    std::string out;
    out.reserve(1 << 16);
    std::string s_cg, s_gc, s_vr, rle;
    // old/pairwise per-read site lists (positions 1-based as collected by
    // the Python walk; the char lists can run LONGER than the position
    // lists — the reference's qj>0 gate on the bss HCG position is a
    // faithful quirk and the joined char string prints in full)
    std::vector<int64_t> hcg_p, gch_p, cg_p, snp_p;
    std::string hcg_c, gch_c, cg_c, snp_c;
    std::vector<int16_t> modq;  // modBAM per-qpos ML qual (INT16_MIN = none)
    RawRec b;
    for (int64_t ri = 0; ri < n_recs; ++ri) {
        if (parse_raw(data, rec_offs[ri], data_len, b) < 0) continue;
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
        {
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
                        char rbc = getb(rp);
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
            // modBAM reads ignore bisulfite strand and retention entirely
            // (subcmds/epiread.py:221-224)
            if (use_modbam) bss = 0;
            else if (cnt_ret > cf->max_retention) continue;
        }
        if (b.l_qseq >= max_read_length) return -2;  // too-long read

        int mstrand = 0;
        char mcanon = 'C';
        if (use_modbam) {
            int rc = modbam_fill(b, modq, mstrand, mcanon);
            if (rc != 0) return rc;
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

        int L2 = 2 * max_read_length;
        s_cg.assign(L2, 0);
        s_gc.assign(L2, 0);
        s_vr.assign(L2, 0);
        hcg_p.clear(); gch_p.clear(); cg_p.clear(); snp_p.clear();
        hcg_c.clear(); gch_c.clear(); cg_c.clear(); snp_c.clear();
        // _skipped_base_old (epiread.c:475-512): a filtered base that sits
        // on an epi context still records a '-' at its site
        auto collect_skipped = [&](int64_t rp, int qj) {
            if (bss && getb(rp) == 'G' && rp - 1 >= rs_beg) {
                char rb0 = getb(rp - 1);
                if (is_nome) {
                    if (rp + 1 <= rs_end) {
                        char rb1 = getb(rp + 1);
                        if (rb0 == 'C' && rb1 != 'C' && qj > 0) {
                            hcg_p.push_back(rp - 1); hcg_c += '-';
                        } else if (rb0 != 'C' && rb1 == 'C') {
                            gch_p.push_back(rp); gch_c += '-';
                        }
                    }
                } else if (rb0 == 'C') {
                    cg_p.push_back(rp - 1); cg_c += '-';
                }
            }
            if (!bss && getb(rp) == 'C' && rp + 1 <= rs_end) {
                char rb1 = getb(rp + 1);
                if (is_nome) {
                    if (rp - 1 >= rs_beg) {
                        char rb0 = getb(rp - 1);
                        if (rb0 != 'G' && rb1 == 'G') {
                            hcg_p.push_back(rp); hcg_c += '-';
                        } else if (rb0 == 'G' && rb1 != 'G') {
                            gch_p.push_back(rp); gch_c += '-';
                        }
                    }
                } else if (rb1 == 'G') {
                    cg_p.push_back(rp); cg_c += '-';
                }
            }
        };
        int n_del = 0, n_ins = 0, softclip_start = 0;
        int64_t rpos = rpos0;
        int qpos = 0;
        for (int k = 0; k < b.n_cigar; ++k) {
            uint32_t v = cig_at(b.cigar, k);
            int op = v & 0xF, ln = v >> 4;
            if (op == 0 || op == 7 || op == 8) {
                for (int j = 0; j < ln; ++j) {
                    int qj = qpos + j;
                    int qjd = qj + n_del;
                    int64_t rp = rpos + j;
                    char rb = getb(rp);
                    char qb = qj < b.l_qseq ? seq_at(b, qj) : 'N';
                    bool rle_set = false;
                    int q = has_qual ? (qj < b.l_qseq ? b.qual[qj] : -33) : 0;
                    if (q < cf->min_base_qual
                        || qj + 1 <= cf->min_dist_end_5p
                        || b.l_qseq < qj + 1 + cf->min_dist_end_3p
                        || (dc && rp >= ov_lo && rp <= ov_hi)) {
                        if (mode) collect_skipped(rp, qj);
                        s_cg[qjd] = s_vr[qjd] = s_gc[qjd] = 'F';
                        continue;
                    }
                    if (use_modbam) {
                        // MM/ML call path (subcmds/epiread.py:282-294,
                        // porting epiread.c:755-774); GC/HCG untouched
                        int16_t qv = qj < (int)modq.size() ? modq[qj]
                                                           : INT16_MIN;
                        if (qv != INT16_MIN) {
                            int cpg = modbam_is_cpg(b.flag, mstrand, mcanon,
                                                    qb, rb, rp, chrom, seqlen,
                                                    rs_beg, rs_end);
                            double prob = qv >= 0 ? (qv + 0.5) / 256.0 : -1.0;
                            if (mode) cg_p.push_back(rp);
                            if (cpg && qv >= 0 && prob > modbam_prob) {
                                s_cg[qjd] = 'M'; rle_set = true;
                                if (mode) cg_c += 'C';
                            } else if (cpg && qv >= 0
                                       && prob < 1.0 - modbam_prob) {
                                s_cg[qjd] = 'U'; rle_set = true;
                                if (mode) cg_c += 'T';
                            } else if (mode) cg_c += 'N';
                        }
                    } else {
                    if (bss && rb == 'G' && rp - 1 >= rs_beg) {
                        char rb0 = getb(rp - 1);
                        if (is_nome) {
                            if (rp + 1 <= rs_end) {
                                char rb1 = getb(rp + 1);
                                if (rb0 == 'C' && rb1 != 'C') {
                                    if (mode && qj > 0) hcg_p.push_back(rp - 1);
                                    if (qb == 'A') { s_cg[qjd] = 'U'; s_gc[qjd] = 'x'; rle_set = true; if (mode) hcg_c += 'T'; }
                                    else if (qb == 'G') { s_cg[qjd] = 'M'; s_gc[qjd] = 'x'; rle_set = true; if (mode) hcg_c += 'C'; }
                                    else if (mode) hcg_c += 'N';
                                } else if (rb0 != 'C' && rb1 == 'C') {
                                    if (mode) gch_p.push_back(rp);
                                    if (qb == 'A') { s_cg[qjd] = 'x'; s_gc[qjd] = 'S'; rle_set = true; if (mode) gch_c += 'T'; }
                                    else if (qb == 'G') { s_cg[qjd] = 'x'; s_gc[qjd] = 'O'; rle_set = true; if (mode) gch_c += 'C'; }
                                    else if (mode) gch_c += 'N';
                                }
                            }
                        } else {
                            s_gc[qjd] = 'x';
                            if (rb0 == 'C') {
                                if (mode) cg_p.push_back(rp - 1);
                                if (qb == 'A') { s_cg[qjd] = 'U'; rle_set = true; if (mode) cg_c += 'T'; }
                                else if (qb == 'G') { s_cg[qjd] = 'M'; rle_set = true; if (mode) cg_c += 'C'; }
                                else if (mode) cg_c += 'N';
                            }
                        }
                    }
                    if (!bss && rb == 'C' && rp + 1 <= rs_end) {
                        char rb1 = getb(rp + 1);
                        if (is_nome) {
                            if (rp - 1 >= rs_beg) {
                                char rb0 = getb(rp - 1);
                                if (rb0 != 'G' && rb1 == 'G') {
                                    if (mode) hcg_p.push_back(rp);
                                    if (qb == 'T') { s_cg[qjd] = 'U'; s_gc[qjd] = 'x'; rle_set = true; if (mode) hcg_c += 'T'; }
                                    else if (qb == 'C') { s_cg[qjd] = 'M'; s_gc[qjd] = 'x'; rle_set = true; if (mode) hcg_c += 'C'; }
                                    else if (mode) hcg_c += 'N';
                                } else if (rb0 == 'G' && rb1 != 'G') {
                                    if (mode) gch_p.push_back(rp);
                                    if (qb == 'T') { s_cg[qjd] = 'x'; s_gc[qjd] = 'S'; rle_set = true; if (mode) gch_c += 'T'; }
                                    else if (qb == 'C') { s_cg[qjd] = 'x'; s_gc[qjd] = 'O'; rle_set = true; if (mode) gch_c += 'C'; }
                                    else if (mode) gch_c += 'N';
                                }
                            }
                        } else {
                            s_gc[qjd] = 'x';
                            if (rb1 == 'G') {
                                if (mode) cg_p.push_back(rp);
                                if (qb == 'T') { s_cg[qjd] = 'U'; rle_set = true; if (mode) cg_c += 'T'; }
                                else if (qb == 'C') { s_cg[qjd] = 'M'; rle_set = true; if (mode) cg_c += 'C'; }
                                else if (mode) cg_c += 'N';
                            }
                        }
                    }
                    }  // !use_modbam
                    int sp = n_snps ? snp_at(rp) : 0;
                    if (sp) {
                        if (mode) { snp_p.push_back(rp); snp_c += qb; }
                        if (!rle_set || (rle_set && sp != 2)) {
                            s_cg[qjd] = 'x';
                            s_gc[qjd] = 'x';
                        }
                        if (bss && qb == 'A') s_vr[qjd] = 'R';
                        else if (!bss && qb == 'T') s_vr[qjd] = 'Y';
                        else s_vr[qjd] = qb;
                        rle_set = true;
                    } else {
                        s_vr[qjd] = 'x';
                        if (!rle_set) { s_cg[qjd] = 'x'; s_gc[qjd] = 'x'; }
                    }
                    if (!rle_set && !s_cg[qjd]) { s_cg[qjd] = 'x'; s_gc[qjd] = 'x'; }
                }
                rpos += ln;
                qpos += ln;
            } else if (op == 1) {
                for (int j = 0; j < ln; ++j) {
                    int qj = qpos + j;
                    int qjd = qj + n_del;
                    char qb = qj < b.l_qseq ? seq_at(b, qj) : 'N';
                    s_vr[qjd] = (char)std::tolower(qb);
                    s_cg[qjd] = 'i';
                    s_gc[qjd] = 'i';
                }
                n_ins += ln;
                qpos += ln;
            } else if (op == 2) {
                for (int j = 0; j < ln; ++j) {
                    int qjd = qpos + j + n_del;
                    s_cg[qjd] = 'd';
                    s_gc[qjd] = 'd';
                    s_vr[qjd] = 'D';
                }
                n_del += ln;
                rpos += ln;
            } else if (op == 4) {
                for (int j = 0; j < ln; ++j) {
                    int qj = qpos + j;
                    int qjd = qj + n_del;
                    if (qj <= softclip_start) ++softclip_start;
                    s_cg[qjd] = 'P';
                    s_gc[qjd] = 'P';
                    s_vr[qjd] = 'P';
                }
                qpos += ln;
            } else {
                return -3;  // H/N/other: Python path handles the error
            }
        }

        int slen = b.l_qseq + n_del;
        int64_t start = b.pos + 1 - softclip_start;
        int64_t end_ = start + b.l_qseq + n_del - n_ins - 1;
        // qname from the record body (needed by every output mode)
        const uint8_t *pq = data + rec_offs[ri] + 4;
        uint8_t l_read_name = pq[8];
        const char *qname = (const char *)pq + 32;
        size_t qname_len = l_read_name > 0 ? l_read_name - 1 : 0;

        if (mode == 2) {        // pairwise -P (epiread.c pairwise output)
            for (size_t k = 0; k < snp_p.size(); ++k) {
                int64_t sp = snp_p[k];
                if (!(print_w_beg <= sp && sp < print_w_end)) continue;
                auto pair_rows = [&](const std::vector<int64_t> &P,
                                     const std::string &C) {
                    for (size_t jj = 0; jj < P.size(); ++jj) {
                        out += chrom_name; out += '\t';
                        out += std::to_string(sp); out += '\t';
                        out += std::to_string(P[jj]); out += '\t';
                        out += snp_c[k]; out += '\t';
                        out += C[jj]; out += '\n';
                    }
                };
                if (is_nome) { pair_rows(hcg_p, hcg_c); pair_rows(gch_p, gch_c); }
                else pair_rows(cg_p, cg_c);
            }
            continue;
        }
        if (mode == 1) {        // old -O format (format_epiread_old)
            int64_t first_epi = 0;
            if (is_nome) {
                if (!hcg_p.empty() && !gch_p.empty())
                    first_epi = std::min(hcg_p[0], gch_p[0]);
                else if (!hcg_p.empty()) first_epi = hcg_p[0];
                else if (!gch_p.empty()) first_epi = gch_p[0];
            } else {
                first_epi = cg_p.empty() ? 0 : cg_p[0];
            }
            if (!(first_epi > 0 && print_w_beg <= first_epi
                  && first_epi < print_w_end))
                continue;
            out += chrom_name; out += '\t';
            out.append(qname, qname_len);
            out += '\t';
            out += (b.flag & FLAG_READ2) ? '2' : '1';
            out += '\t';
            out += bss ? '-' : '+';
            auto group = [&](const std::vector<int64_t> &P,
                             const std::string &C) {
                if (!P.empty()) {
                    out += '\t';
                    out += std::to_string(P[0] - 1);
                    if (print_all_locations)
                        for (size_t i2 = 1; i2 < P.size(); ++i2) {
                            out += ',';
                            out += std::to_string(P[i2] - 1);
                        }
                    out += '\t';
                    out += C;
                } else {
                    out += "\t.\t.";
                }
            };
            if (is_nome) { group(hcg_p, hcg_c); group(gch_p, gch_c); }
            else group(cg_p, cg_c);
            if (!snp_p.empty()) {
                out += '\t';
                out += std::to_string(snp_p[0] - 1);
                if (print_all_locations)
                    for (size_t i2 = 1; i2 < snp_p.size(); ++i2) {
                        out += ',';
                        out += std::to_string(snp_p[i2] - 1);
                    }
                out += '\t';
                out += snp_c;
            } else if (have_snps) {
                out += "\t.\t.";
            } else {
                out += "\t\t";
            }
            out += '\n';
            continue;
        }

        int64_t w_start = b.pos + 1;
        if (!(w_start > 0 && print_w_beg <= w_start && w_start < print_w_end))
            continue;
        auto all_in = [&](const std::string &s) {
            for (int i = 0; i < slen; ++i) {
                char c = s[i];
                if (c != 'F' && c != 'x' && c != 'P') return false;
            }
            return true;
        };
        bool write_cg = true, write_gc = true, write_vr = true;
        if (filter_empty) {
            write_cg = !all_in(s_cg);
            write_vr = !all_in(s_vr);
            write_gc = is_nome ? !all_in(s_gc) : false;
        }
        if (!(write_cg || write_gc || write_vr)) continue;
        if (start <= 0) continue;  // Python warns; rare degenerate case
        auto rle_enc = [&](const std::string &s) {
            rle.clear();
            int i = 0;
            while (i < slen) {
                rle += s[i];
                int run = 1;
                while (i + 1 < slen && s[i] == s[i + 1]) { ++run; ++i; }
                if (run > 1) rle += std::to_string(run);
                ++i;
            }
        };
        out += chrom_name;
        out += '\t';
        out += std::to_string(start - 1);
        out += '\t';
        out += std::to_string(end_);
        out += '\t';
        out.append(qname, qname_len);
        out += '\t';
        out += (b.flag & FLAG_READ2) ? '2' : '1';
        out += '\t';
        out += bss ? '-' : '+';
        out += '\t';
        rle_enc(s_cg);
        out += rle;
        if (is_nome) {
            out += '\t';
            rle_enc(s_gc);
            out += rle;
        } else {
            out += "\t.";
        }
        out += '\t';
        rle_enc(s_vr);
        out += rle;
        out += '\n';
    }
    char *buf = (char *)std::malloc(out.size() > 0 ? out.size() : 1);
    if (!buf) return -1;
    std::memcpy(buf, out.data(), out.size());
    *out_buf = buf;
    *out_len = (int64_t)out.size();
    return 0;
}

// One window over raw BAM records. datas/rec_offs/n_recs are per-sample.
int bt_pileup_window_raw(const btp::Conf *cf, const char *chrom_name,
                         const char *chrom, int64_t seqlen,
                         int64_t beg, int64_t end, int32_t nbam,
                         const uint8_t *const *datas, const int64_t *data_lens,
                         const int64_t *const *rec_offs,
                         const int64_t *n_recs,
                         void **out_buf, int64_t *out_len,
                         double *betasum, int64_t *cntctx) {
    using namespace btp;
    int64_t P = end - beg;
    std::vector<int64_t> cm((size_t)P * nbam * NMETH, 0);
    std::vector<int64_t> cb((size_t)P * nbam * NBASE, 0);
    std::vector<int64_t> dp((size_t)P * nbam, 0);
    std::vector<uint8_t> covered((size_t)P, 0);

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
                        int64_t p = rp - beg;
                        covered[p] = 1;
                        dp[p * nbam + sid] += 1;
                        int q = has_qual
                            ? (qp < b.l_qseq ? b.qual[qp] : -33) : 0;
                        if (q < cf->min_base_qual) continue;
                        if (qp + 1 <= cf->min_dist_end_5p
                            || b.l_qseq < qp + 1 + cf->min_dist_end_3p)
                            continue;
                        cm[(p * nbam + sid) * NMETH + meth] += 1;
                        cb[(p * nbam + sid) * NBASE + base] += 1;
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

    std::string out;
    out.reserve(1 << 16);
    for (int64_t p = 0; p < P; ++p) {
        if (!covered[p]) continue;
        plp_format(chrom_name, chrom, seqlen, beg + p, *cf, nbam,
                   cm.data() + (size_t)p * nbam * NMETH,
                   cb.data() + (size_t)p * nbam * NBASE,
                   dp.data() + (size_t)p * nbam, betasum, cntctx, out);
    }
    char *buf = (char *)std::malloc(out.size() > 0 ? out.size() : 1);
    if (!buf) return -1;
    std::memcpy(buf, out.data(), out.size());
    *out_buf = buf;
    *out_len = (int64_t)out.size();
    return 0;
}

}  // extern "C"
