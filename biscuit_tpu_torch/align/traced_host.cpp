// The port's own batch entries of the native align engine, with their
// phases timed: the hybrid engine's C++ stage (align/traced_native.py).
//
// native/align_host.cpp is a pinned copy of its source (it cannot carry
// timing of its own), and native/__init__.py compiles every .cpp in that
// directory into the copied library, so this file lives outside it. It
// includes the copy for its functions and defines:
// - bt_port_align_se_batch and bt_port_align_pe_batch: the copy's
//   bt_align_se_batch and bt_align_pe_batch, argument for argument and
//   line for line (tests/test_torch_traced.py holds them to it), calling
//   the copy's seed_chunk, align1_core, merge_regions2, pestat, worker2_se
//   and worker2_pe, but for the lines marked "// trace" and without the
//   copy's BT_PROF switch and its report on stderr. Each records its
//   phases' wall time (SE: regions+sam; PE: regions, pestat, pair; both:
//   concat, the SAM text joined into one buffer) and, for each parallel
//   phase, its threads' busy time (each worker's time inside its
//   work-stealing loop). PE adds a merge_regions slot to its regions phase.
// - bt_trace_set(on): drives the copy's ProfScope slots (CPU nanoseconds
//   summed over threads) while on. Never from the environment.
// - bt_trace_take(out): copies the phases, busy times, thread count and
//   slots recorded since the last take into out[TR_N] and clears them.
//
// Off, the only cost these entries add is a few clock reads a call and two
// a worker thread. Buffers from these entries are freed with this
// library's bt_buf_free.

#include "../native/align_host.cpp"

namespace bt {

// out[] of bt_trace_take: phases' wall ns at [TR_SE, TR_CONCAT], their busy
// thread-ns at TR_BUSY + phase, the thread count of the last parallel
// phase, the copy's ProfScope slots 0-6 (seed, chain(+sa), chain_flt,
// extend, merge_regions, worker2(sam), sa_walk) from TR_SLOTS
enum { TR_SE = 0, TR_REGIONS = 1, TR_PESTAT = 2, TR_PAIR = 3, TR_CONCAT = 4,
       TR_BUSY = 8, TR_THREADS = 15, TR_SLOTS = 16, TR_N_SLOTS = 7,
       TR_N = 23 };
static std::atomic<int64_t> g_tr[TR_SLOTS];

static inline int64_t tr_now() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}

// a serial phase that began at t0 ends now; returns now
static int64_t tr_serial(int ph, int64_t t0) {
    int64_t t = tr_now();
    g_tr[ph] += t - t0;
    return t;
}

// a parallel phase that began at t0 ends now: its wall, and its workers'
// busy time (on one thread, the caller's, its wall); returns now
static int64_t tr_parallel(int ph, int64_t t0, std::atomic<int64_t> &busy,
                           int32_t n_threads) {
    int64_t t = tr_serial(ph, t0);
    int64_t b = busy.exchange(0);
    g_tr[TR_BUSY + ph] += n_threads <= 1 ? t - t0 : b;
    g_tr[TR_THREADS] = n_threads <= 1 ? 1 : n_threads;
    return t;
}

extern "C" {

int bt_port_align_se_batch(const StrandFMC *dau, const StrandFMC *par,
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
    std::atomic<int64_t> busy(0);  // trace
    int64_t tp = tr_now();  // trace
    if (n_threads <= 1) {
        run(0, n_reads);
    } else {
        std::atomic<int> next(0);
        auto steal = [&]() {
            int64_t t0 = tr_now();  // trace
            for (;;) {
                int lo = next.fetch_add(16);
                if (lo >= n_reads) break;
                run(lo, std::min((int)n_reads, lo + 16));
            }
            busy += tr_now() - t0;  // trace
        };
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; ++t) ts.emplace_back(steal);
        for (auto &t : ts) t.join();
    }
    tp = tr_parallel(TR_SE, tp, busy, n_threads);  // trace
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
    tr_serial(TR_CONCAT, tp);  // trace
    *out_buf = buf;
    return 0;
}

int bt_port_align_pe_batch(const StrandFMC *dau, const StrandFMC *par,
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
            ProfScope pm(4);  // trace
            merge_regions2(o, o2, cx.bns, seq, len, regs);
            for (size_t j = 0; j < regs.size(); ++j)
                regs[j].serial = (uint32_t)j;
        }
    };
    std::atomic<int64_t> busy(0);  // trace
    auto fanout = [&](auto fn, int n_items) {
        if (n_threads <= 1) { fn(0, n_items); return; }
        std::atomic<int> next(0);
        auto steal = [&]() {
            int64_t t0 = tr_now();  // trace
            for (;;) {
                int lo = next.fetch_add(16);
                if (lo >= n_items) break;
                fn(lo, std::min(n_items, lo + 16));
            }
            busy += tr_now() - t0;  // trace
        };
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; ++t) ts.emplace_back(steal);
        for (auto &t : ts) t.join();
    };
    int64_t tp = tr_now();  // trace
    fanout(runA, n_reads);
    tp = tr_parallel(TR_REGIONS, tp, busy, n_threads);  // trace
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

    tp = tr_serial(TR_PESTAT, tp);  // trace
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
    tp = tr_parallel(TR_PAIR, tp, busy, n_threads);  // trace

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
    tr_serial(TR_CONCAT, tp);  // trace
    *out_buf = buf;
    return 0;
}

void bt_trace_set(int32_t on) {
    g_prof_on = on != 0;
    g_prof_fine = false;
}

int32_t bt_trace_take(int64_t *out) {
    for (int i = 0; i < TR_SLOTS; ++i) out[i] = g_tr[i].exchange(0);
    for (int i = 0; i < 16; ++i) {
        long long v = g_prof_ns[i].exchange(0);
        if (i < TR_N_SLOTS) out[TR_SLOTS + i] = v;
    }
    return TR_N;
}

}  // extern "C"

}  // namespace bt
