// Native stream filters for the GB-scale text subcommands:
//   * vcf2bed context tracks (reference src/vcf2bed.c:82-188)
//   * mergecg strand-symmetric CpG merge (reference src/mergecg.c:90-137)
//
// Python keeps the IO (bgzf/gzip decode, stdout) and hands decompressed
// chunks of COMPLETE lines here; this file does the per-line parse,
// filter and formatting. Output semantics are byte-identical to the
// subcmds/{vcf2bed,mergecg}.py implementations (which are byte-diffed
// against the compiled reference in tests/test_downstream_oracle.py):
// notably Python's round() is round-half-even, so all rounds go through
// nearbyint() under the default FE_TONEAREST mode.
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <cctype>
#include <string>
#include <vector>

namespace {

struct OutBuf {
    char *p = nullptr;
    size_t len = 0, cap = 0;
    void reserve(size_t need) {
        if (len + need <= cap) return;
        cap = cap ? cap * 2 : 1 << 16;
        while (cap < len + need) cap *= 2;
        p = (char *)realloc(p, cap);
    }
    void put(const char *s, size_t n) {
        reserve(n);
        memcpy(p + len, s, n);
        len += n;
    }
    void putc(char c) { reserve(1); p[len++] = c; }
    void fmt(const char *f, ...) {
        va_list ap;
        va_start(ap, f);
        char tmp[256];
        int n = vsnprintf(tmp, sizeof tmp, f, ap);
        va_end(ap);
        put(tmp, (size_t)n);
    }
};

// split a line into tab-separated field views (no copies)
struct Fields {
    const char *b[64];
    int l[64];
    int n = 0;
    void parse(const char *s, const char *end) {
        n = 0;
        const char *f = s;
        for (const char *q = s; q <= end; ++q) {
            if (q == end || *q == '\t') {
                if (n < 64) {
                    b[n] = f;
                    l[n] = (int)(q - f);
                    ++n;
                }
                f = q + 1;
            }
        }
    }
};

bool field_eq(const Fields &f, int i, const char *s) {
    size_t n = strlen(s);
    return i < f.n && (size_t)f.l[i] == n && memcmp(f.b[i], s, n) == 0;
}

long field_int(const Fields &f, int i, bool *ok = nullptr) {
    char tmp[32];
    int n = f.l[i] < 31 ? f.l[i] : 31;
    memcpy(tmp, f.b[i], n);
    tmp[n] = 0;
    char *e;
    long v = strtol(tmp, &e, 10);
    if (ok) *ok = (e != tmp && *e == 0);
    return v;
}

// python float(str) equivalent; returns false if not a number
bool parse_num(const char *s, int n, double *out) {
    char tmp[64];
    if (n <= 0 || n > 63) return false;
    memcpy(tmp, s, n);
    tmp[n] = 0;
    char *e;
    *out = strtod(tmp, &e);
    while (*e == ' ') ++e;
    return e != tmp && *e == 0;
}

// find "KEY=" entry in a ;-separated INFO field; value view or nullptr
const char *info_get(const char *info, int ilen, const char *key, int *vlen) {
    size_t kl = strlen(key);
    const char *s = info, *end = info + ilen;
    while (s < end) {
        const char *e = (const char *)memchr(s, ';', end - s);
        if (!e) e = end;
        if ((size_t)(e - s) > kl && memcmp(s, key, kl) == 0 && s[kl] == '=') {
            *vlen = (int)(e - s - kl - 1);
            return s + kl + 1;
        }
        if ((size_t)(e - s) == kl && memcmp(s, key, kl) == 0) {
            *vlen = 0;  // bare flag entry: Python info_get returns ""
            return s + kl;
        }
        s = e + 1;
    }
    return nullptr;
}

// index of `key` in a :-separated FORMAT field, -1 if absent
int fmt_index(const char *fmt, int flen, const char *key) {
    size_t kl = strlen(key);
    const char *s = fmt, *end = fmt + flen;
    int idx = 0;
    while (s < end) {
        const char *e = (const char *)memchr(s, ':', end - s);
        if (!e) e = end;
        if ((size_t)(e - s) == kl && memcmp(s, key, kl) == 0) return idx;
        s = e + 1;
        ++idx;
    }
    return -1;
}

// k-th :-separated subfield of a sample column; "." when missing
void sub_field(const char *s, int len, int k, const char **vb, int *vl) {
    const char *end = s + len;
    int idx = 0;
    const char *f = s;
    for (const char *q = s; q <= end; ++q) {
        if (q == end || *q == ':') {
            if (idx == k) {
                *vb = f;
                *vl = (int)(q - f);
                return;
            }
            f = q + 1;
            ++idx;
        }
    }
    *vb = ".";
    *vl = 1;
}

inline long long pyround(double x) { return (long long)nearbyint(x); }

}  // namespace

extern "C" {

void bt_stream_free(char *p) { free(p); }

// ---------------------------------------------------------------------------
// vcf2bed context filter. target: "CG", "CH", "C", "HCG", "GCH".
// sidx[nsel]: selected sample indices (0-based among sample columns).
// Returns a malloc'd output buffer (caller frees with bt_stream_free).
// ---------------------------------------------------------------------------
char *bt_vcf2bed_ctxt(const char *buf, int64_t blen, int mincov,
                      int showctxt, int showmu, const char *target,
                      const int32_t *sidx, int nsel, int64_t *out_len) {
    OutBuf out;
    bool t_c = strcmp(target, "C") == 0;
    bool t_ch = strcmp(target, "CH") == 0;
    char needle[16];
    snprintf(needle, sizeof needle, "CX=%s", target);
    bool use_needle = !t_c && !t_ch;
    std::vector<double> betas(nsel);
    std::vector<long> covs(nsel);
    Fields f;

    const char *s = buf, *end = buf + blen;
    while (s < end) {
        const char *nl = (const char *)memchr(s, '\n', end - s);
        const char *le = nl ? nl : end;
        const char *line = s;
        s = nl ? nl + 1 : end;
        int llen = (int)(le - line);
        if (llen == 0 || line[0] == '#') continue;  // header lines
        // substring pre-filter (vcf2bed.py:37-41)
        if (!memmem(line, llen, "CX=", 3)) continue;
        if (use_needle && !memmem(line, llen, needle, strlen(needle)))
            continue;
        f.parse(line, le);
        if (f.n < 9) continue;
        int cxl;
        const char *cx = info_get(f.b[7], f.l[7], "CX", &cxl);
        if (!cx) continue;
        char ref0 = f.l[3] > 0 ? f.b[3][0] : 'N';
        if (t_c) {
            if (ref0 != 'C' && ref0 != 'G') continue;
        } else if (t_ch) {
            if (!(cxl == 3 && (memcmp(cx, "CHH", 3) == 0 ||
                               memcmp(cx, "CHG", 3) == 0)))
                continue;
        } else {
            if ((size_t)cxl != strlen(target) || memcmp(cx, target, cxl))
                continue;
        }
        // BT / CV per selected sample (vcf2bed.py:_record_beta_cov)
        int bt_i = fmt_index(f.b[8], f.l[8], "BT");
        int cv_i = fmt_index(f.b[8], f.l[8], "CV");
        bool anycov = false;
        for (int i = 0; i < nsel; ++i) {
            betas[i] = -1.0;
            covs[i] = 0;
            int col = 9 + sidx[i];
            if (col >= f.n) continue;
            const char *vb;
            int vl;
            double d;
            if (bt_i >= 0) {
                sub_field(f.b[col], f.l[col], bt_i, &vb, &vl);
                if (parse_num(vb, vl, &d)) betas[i] = d;
            }
            if (cv_i >= 0) {
                sub_field(f.b[col], f.l[col], cv_i, &vb, &vl);
                if (parse_num(vb, vl, &d)) covs[i] = (long)d;
            }
            if (covs[i] >= mincov) anycov = true;
        }
        if (!anycov) continue;
        int n5l = 0;
        const char *n5 = info_get(f.b[7], f.l[7], "N5", &n5l);
        if (!n5 || n5l != 5) {
            n5 = "NNNNN";
            n5l = 5;
        }
        bool ok;
        long pos = field_int(f, 1, &ok);
        out.put(f.b[0], f.l[0]);
        out.fmt("\t%ld\t%ld", pos - 1, pos);
        if (showctxt) {
            out.putc('\t');
            out.put(f.b[3], f.l[3] > 0 ? 1 : 0);  // ref[0] printed as str ref
            out.putc('\t');
            out.put(cx, cxl);
            out.putc('\t');
            out.put(n5 + 2, 2);
            out.putc('\t');
            out.put(n5, 5);
        }
        for (int i = 0; i < nsel; ++i) {
            double b = betas[i];
            long c = covs[i];
            if (showmu) {
                long long m = b >= 0 ? pyround(c * b) : 0;
                if (b < 0)
                    out.put("\t.", 2);
                else
                    out.fmt("\t%lld", pyround(b * 100));
                out.fmt("\t%lld\t%lld", m, (long long)c - m);
            } else {
                if (b < 0)
                    out.put("\t.", 2);
                else
                    out.fmt("\t%1.3f", b);
                out.fmt("\t%ld", c);
            }
        }
        out.putc('\n');
    }
    *out_len = (int64_t)out.len;
    return out.p ? out.p : (char *)malloc(1);
}

// ---------------------------------------------------------------------------
// mergecg: stateful handle so chunks stream through while the pending
// record and the current chromosome's sequence persist across calls.
// ---------------------------------------------------------------------------
struct MergeCgState {
    int min_depth = 0, nome = 0, show_mu = 0;
    // current reference chromosome
    std::string chrom;
    const char *seq = nullptr;  // borrowed from Python (kept alive there)
    int64_t seqlen = 0;
    // pending record p
    bool has_p = false;
    std::string p_chrom;
    long p_beg = 0, p_end = 0;
    char p_ref = 'N', p_before = 'N', p_after = 'N';
    std::vector<double> c_betas, g_betas;
    std::vector<long> c_depts, g_depts;
    OutBuf out;
    std::string need_chrom;  // set when a line references a new chromosome
    int error = 0;
    char errmsg[256] = {0};
};

static char mc_base(const MergeCgState *st, long pos) {
    // RefCache.getbase_upcase: 1-based, N outside [1, seqlen]
    if (pos < 1 || pos > st->seqlen) return 'N';
    return (char)toupper((unsigned char)st->seq[pos - 1]);
}

static void mc_emit(MergeCgState *st) {
    if (!st->has_p) return;
    // _format_output (mergecg.py:49-81)
    size_t n = st->c_depts.size();
    long max_depth = 0;
    for (size_t i = 0; i < n; ++i) {
        long d = st->c_depts[i] + st->g_depts[i];
        if (d > max_depth) max_depth = d;
    }
    st->has_p = false;
    if (max_depth == 0 || max_depth < st->min_depth) return;
    long beg = st->p_beg, end = st->p_end;
    if (st->p_ref == 'C' && st->p_after == 'G')
        end += 1;
    else if (st->p_ref == 'G' && st->p_before == 'C')
        beg -= 1;
    OutBuf &o = st->out;
    o.put(st->p_chrom.data(), st->p_chrom.size());
    o.fmt("\t%ld\t%ld", beg, end);
    for (size_t i = 0; i < n; ++i) {
        long cov = st->c_depts[i] + st->g_depts[i];
        if (cov == 0) {
            o.put(st->show_mu ? "\t.\t0\t0" : "\t.\t0", st->show_mu ? 6 : 4);
        } else {
            long long c_ret = pyround(st->c_betas[i] * st->c_depts[i]);
            long long g_ret = pyround(st->g_betas[i] * st->g_depts[i]);
            long long m = c_ret + g_ret;
            if (st->show_mu)
                o.fmt("\t%lld\t%lld\t%lld",
                      pyround((double)m / cov * 100.0), m, cov - m);
            else
                o.fmt("\t%1.3f\t%ld", (double)m / cov, cov);
        }
        if (st->c_depts[i] == 0)
            o.put("\tC:.:0", 6);
        else
            o.fmt("\tC:%1.3f:%ld", st->c_betas[i], st->c_depts[i]);
        if (st->g_depts[i] == 0)
            o.put(",G:.:0", 6);
        else
            o.fmt(",G:%1.3f:%ld", st->g_betas[i], st->g_depts[i]);
    }
    o.putc('\n');
}

MergeCgState *bt_mergecg_new(int min_depth, int nome, int show_mu) {
    MergeCgState *st = new MergeCgState();
    st->min_depth = min_depth;
    st->nome = nome;
    st->show_mu = show_mu;
    return st;
}

void bt_mergecg_set_ref(MergeCgState *st, const char *chrom,
                        const char *seq, int64_t seqlen) {
    st->chrom = chrom;
    st->seq = seq;
    st->seqlen = seqlen;
    st->need_chrom.clear();
}

// Feed a chunk of complete lines. Returns the number of bytes consumed;
// stops early (returning < blen) when a line names a chromosome other than
// the current one — Python then reads need_chrom, fetches that sequence,
// calls set_ref, and re-feeds the remainder.
int64_t bt_mergecg_feed(MergeCgState *st, const char *buf, int64_t blen) {
    Fields f;
    const char *s = buf, *end = buf + blen;
    while (s < end) {
        const char *nl = (const char *)memchr(s, '\n', end - s);
        const char *le = nl ? nl : end;
        const char *line = s;
        int llen = (int)(le - line);
        // blank-line skip (mergecg.py:110-111)
        bool blank = true;
        for (int i = 0; i < llen; ++i)
            if (!isspace((unsigned char)line[i])) {
                blank = false;
                break;
            }
        if (blank) {
            s = nl ? nl + 1 : end;
            continue;
        }
        f.parse(line, le);
        if (f.n < 5) {
            snprintf(st->errmsg, sizeof st->errmsg, "No sample data identified.");
            st->error = 1;
            return (int64_t)(s - buf);
        }
        if ((size_t)f.l[0] != st->chrom.size() ||
            memcmp(f.b[0], st->chrom.data(), f.l[0]) != 0) {
            st->need_chrom.assign(f.b[0], f.l[0]);
            return (int64_t)(s - buf);  // caller switches the reference
        }
        s = nl ? nl + 1 : end;

        int start = (f.l[3] == 1 && (f.b[3][0] == 'C' || f.b[3][0] == 'G'))
                        ? 7 : 3;
        int nsamp = (f.n - start) / 2;
        if (nsamp <= 0) {
            snprintf(st->errmsg, sizeof st->errmsg, "No sample data identified.");
            st->error = 1;
            return (int64_t)(s - buf);
        }
        long beg = field_int(f, 1), bend = field_int(f, 2);
        std::vector<double> cb(nsamp), gb(nsamp, 0.0);
        std::vector<long> cd(nsamp), gd(nsamp, 0);
        for (int i = 0; i < nsamp; ++i) {
            double d = 0.0;
            const char *vb = f.b[start + 2 * i];
            int vl = f.l[start + 2 * i];
            cb[i] = (vl == 1 && vb[0] == '.') ? 0.0
                    : (parse_num(vb, vl, &d) ? d : 0.0);
            cd[i] = field_int(f, start + 1 + 2 * i);
        }
        char ref = mc_base(st, bend);
        char before = (bend - 1 < 0) ? 'N' : mc_base(st, bend - 1);
        char after = (bend == st->seqlen) ? 'N' : mc_base(st, bend + 1);
        if (ref == 'G') {
            gb.swap(cb);
            gd.swap(cd);
        }
        bool merged = false;
        if (st->has_p && st->p_chrom == st->chrom &&
            beg == st->p_beg + 1 && bend == st->p_end + 1 &&
            ref == 'G' && st->p_ref == 'C' &&
            (!st->nome || (st->p_before != 'G' && after != 'C'))) {
            if ((int)st->c_depts.size() != nsamp) {
                snprintf(st->errmsg, sizeof st->errmsg,
                         "Missing sample at %s:%ld-%ld.", st->chrom.c_str(),
                         beg, bend);
                st->error = 1;
                return (int64_t)(s - buf);
            }
            st->g_betas = gb;
            st->g_depts = gd;
            merged = true;
        }
        mc_emit(st);  // no-op if nothing pending (or just emitted by merge)
        if (!merged) {
            st->has_p = true;
            st->p_chrom = st->chrom;
            st->p_beg = beg;
            st->p_end = bend;
            st->p_ref = ref;
            st->c_betas = cb;
            st->c_depts = cd;
            st->g_betas = gb;
            st->g_depts = gd;
        }
        st->p_before = before;
        st->p_after = after;
    }
    return blen;
}

const char *bt_mergecg_need_chrom(MergeCgState *st) {
    return st->need_chrom.c_str();
}

int bt_mergecg_error(MergeCgState *st) { return st->error; }
const char *bt_mergecg_errmsg(MergeCgState *st) { return st->errmsg; }

// drain accumulated output; caller frees with bt_stream_free
char *bt_mergecg_take_output(MergeCgState *st, int64_t *out_len) {
    *out_len = (int64_t)st->out.len;
    char *p = st->out.p ? st->out.p : (char *)malloc(1);
    st->out.p = nullptr;
    st->out.len = st->out.cap = 0;
    return p;
}

void bt_mergecg_finish(MergeCgState *st) { mc_emit(st); }

void bt_mergecg_free(MergeCgState *st) {
    free(st->out.p);
    delete st;
}

}  // extern "C"
