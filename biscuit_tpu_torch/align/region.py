"""Alignment regions: seed extension, merge/dedup, primary marking, mate
rescue. Ports mem_chain2region* (lib/aln/memchain.c:576-904)
and mem_alnreg.c (merge :37-227, primary :231-380, matesw :386-513).

Copy of biscuit_tpu/align/region.py. Only its imports differ: FMNumpy comes
from biscuit_tpu_torch.ops.fm and every other module from this package,
so the port imports nothing of the JAX package. tests/test_torch_engine.py holds the
copy to its source.
"""
import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils.ksort import introsort
from ..config import MemOpt
from ..ops import sw
from ..align import bns as bnsmod
from . import trace
from .chain import Chain, Seed, getbss

MAX_BAND_TRY = 2
PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90
INT_MAX = 2**31 - 1

U64 = (1 << 64) - 1


def hash_64(key: int) -> int:
    """utils.h:107-117 (Wang hash), uint64 semantics."""
    key &= U64
    key = (key + (~(key << 32) & U64)) & U64
    key ^= key >> 22
    key = (key + (~(key << 13) & U64)) & U64
    key ^= key >> 8
    key = (key + (key << 3)) & U64
    key ^= key >> 15
    key = (key + (~(key << 27) & U64)) & U64
    key ^= key >> 31
    return key


@dataclass
class AlnReg:
    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = 0
    truesc: int = 0
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    # the reference memsets new regions to 0 (memchain.c:829): secondary is 0
    # until mem_mark_primary_se assigns the real -1/default labels — visible
    # in -v 4 region dumps
    secondary: int = 0
    secondary_all: int = 0
    seedlen0: int = 0
    n_comp: int = 0
    is_alt: int = 0
    frac_rep: float = 0.0
    hash: int = 0
    bss: int = 0
    parent: int = 0
    read_in_pair: int = 0
    # SAM meta
    pos: int = 0
    flag: int = 0
    NM: int = 0
    n_cigar: int = 0
    is_rev: int = 0
    mapq: int = 0
    ZC: int = 0
    ZR: int = 0
    bss_u: int = 0
    cigar: Optional[List] = None
    md: str = ""


class AlnRegs(list):
    """mem_alnreg_v with its n_pri side-count."""
    n_pri: int = 0


def cal_max_gap(opt: MemOpt, qlen: int) -> int:
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(max(l_del, l_ins), 1)
    return min(l, opt.w << 1)


def chain_reference_span(opt: MemOpt, l_query: int, l_pac: int, c: Chain):
    rmax0, rmax1 = l_pac << 1, 0
    for s in c.seeds:
        b = s.rbeg - (s.qbeg + cal_max_gap(opt, s.qbeg))
        e = s.rbeg + s.len + ((l_query - s.qbeg - s.len)
                              + cal_max_gap(opt, l_query - s.qbeg - s.len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:
        if c.seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    return rmax0, rmax1


def _asymmetric_flt_seed(rseq: np.ndarray, query: np.ndarray, s: Seed, rbeg: int) -> bool:
    """memchain.c:138-149: reject seeds with ref T over read C or ref A over
    read G."""
    r = rseq[s.rbeg - rbeg:s.rbeg - rbeg + s.len]
    q = query[s.qbeg:s.qbeg + s.len]
    return bool(np.any(((r == 3) & (q == 1)) | ((r == 0) & (q == 2))))


def _left_extend(opt: MemOpt, s: Seed, query: np.ndarray, rseq: np.ndarray,
                 rmax0: int, parent: int, reg: AlnReg):
    """memchain.c:613-672. Generator: yields (qs, rs, aw, end_bonus, h0)
    extension-try requests, receives (score, qle, tle, gtle, gscore, max_off).
    Returns the actual bandwidth aw."""
    if s.qbeg == 0:
        reg.score = reg.truesc = s.len * opt.a
        reg.qb = 0
        reg.rb = s.rbeg
        return opt.w
    qs = query[:s.qbeg][::-1]
    tmp = s.rbeg - rmax0
    rs = rseq[:tmp][::-1]
    aw = opt.w
    qle = tle = gtle = gscore = 0
    for i in range(MAX_BAND_TRY):
        prev = reg.score
        aw = opt.w << i
        if trace.verbose >= 4:
            trace.out("*** [left_extend_seed_set_align_beg] Left ref:   ")
            trace.print_bases_one_per_line(rs)
            trace.out("*** [left_extend_seed_set_align_beg] Left query: ")
            trace.print_bases_one_per_line(qs)
        reg.score, qle, tle, gtle, gscore, max_off = \
            yield (qs, rs, aw, opt.pen_clip5, s.len * opt.a)
        if trace.verbose >= 4:
            trace.out("*** [left_extend_seed_set_align_beg] Left extension: "
                      "prev_score=%d; score=%d; bandwidth=%d; max_off_diagonal_dist=%d\n"
                      % (prev, reg.score, aw, max_off))
        if reg.score == prev or max_off < (aw >> 1) + (aw >> 2):
            break
    if gscore <= 0 or gscore <= reg.score - opt.pen_clip5:
        reg.qb = s.qbeg - qle
        reg.rb = s.rbeg - tle
        reg.truesc = reg.score
    else:
        reg.qb = 0
        reg.rb = s.rbeg - gtle
        reg.truesc = gscore
    return aw


def _right_extend(opt: MemOpt, s: Seed, query: np.ndarray, l_query: int,
                  rseq: np.ndarray, rmax0: int, rmax1: int, parent: int,
                  reg: AlnReg):
    """memchain.c:677-730. Generator like _left_extend."""
    if s.qbeg + s.len == l_query:
        reg.qe = l_query
        reg.re = s.rbeg + s.len
        return opt.w
    sc0 = reg.score
    qe = s.qbeg + s.len
    re_ = s.rbeg + s.len - rmax0
    assert re_ >= 0
    aw = opt.w
    qle = tle = gtle = gscore = 0
    for i in range(MAX_BAND_TRY):
        prev = reg.score
        aw = opt.w << i
        if trace.verbose >= 4:
            trace.out("*** [right_extend_seed_set_align_end] Right ref:   ")
            trace.print_bases_one_per_line(rseq[re_:rmax1 - rmax0])
            trace.out("*** [right_extend_seed_set_align_end] Right query: ")
            trace.print_bases_one_per_line(query[qe:])
        reg.score, qle, tle, gtle, gscore, max_off = \
            yield (query[qe:], rseq[re_:rmax1 - rmax0], aw, opt.pen_clip3, sc0)
        if trace.verbose >= 4:
            trace.out("*** [right_extend_seed_set_align_end] Right extension: "
                      "prev_score=%d; score=%d; bandwidth=%d; max_off_diagonal_dist=%d\n"
                      % (prev, reg.score, aw, max_off))
        if reg.score == prev or max_off < (aw >> 1) + (aw >> 2):
            break
    if gscore <= 0 or gscore <= reg.score - opt.pen_clip3:
        reg.qe = qe + qle
        reg.re = rmax0 + re_ + tle
        reg.truesc += reg.score - sc0
    else:
        reg.qe = l_query
        reg.re = rmax0 + re_ + gtle
        reg.truesc += gscore - sc0
    return aw


def chain2region1(opt: MemOpt, idx, rseq: np.ndarray, rmax, rid: int,
                  l_query: int, query: np.ndarray, seeds: List[Seed],
                  regs: AlnRegs, parent: int, reg0: int, frac_rep: float) -> None:
    """memchain.c:742-871."""
    srt = sorted(range(len(seeds)), key=lambda i: (seeds[i].score, i))
    srt_alive = {i: True for i in srt}
    order = [srt[k] for k in range(len(srt))]

    for k in range(len(order) - 1, -1, -1):
        sidx = order[k]
        s = seeds[sidx]
        if _asymmetric_flt_seed(rseq, query, s, rmax[0]):
            continue
        # test whether extension has been made before
        u = reg0
        contained = False
        while u < len(regs):
            reg = regs[u]
            if (s.rbeg < reg.rb or s.rbeg + s.len > reg.re or
                    s.qbeg < reg.qb or s.qbeg + s.len > reg.qe):
                u += 1
                continue
            if s.len - reg.seedlen0 > 0.1 * l_query:
                u += 1
                continue
            qd = s.qbeg - reg.qb
            rd = s.rbeg - reg.rb
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, reg.w)
            if qd - rd < w and rd - qd < w:
                contained = True
                break
            qd = reg.qe - (s.qbeg + s.len)
            rd = reg.re - (s.rbeg + s.len)
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, reg.w)
            if qd - rd < w and rd - qd < w:
                contained = True
                break
            u += 1
        if contained:
            if trace.verbose >= 4:
                trace.out(
                    "** [mem_chain2region1] Seed(%d) [%d;%d,%d] is almost contained"
                    " in an existing alignment [%d,%d) <=> [%d,%d)\n"
                    % (k, s.len, s.qbeg, s.rbeg, regs[u].qb, regs[u].qe,
                       regs[u].rb, regs[u].re))
            # check overlapping seeds in the same chain (memchain.c:803-814)
            i2 = k + 1
            overlapping = False
            while i2 < len(order):
                if not srt_alive.get(order[i2], True):
                    i2 += 1
                    continue
                t = seeds[order[i2]]
                if t.len < s.len * 0.95:
                    i2 += 1
                    continue
                if (s.qbeg <= t.qbeg and s.qbeg + s.len - t.qbeg >= s.len >> 2 and
                        t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                    overlapping = True
                    break
                if (t.qbeg <= s.qbeg and t.qbeg + t.len - s.qbeg >= s.len >> 2 and
                        s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                    overlapping = True
                    break
                i2 += 1
            if not overlapping:
                srt_alive[sidx] = False
                continue
            if trace.verbose >= 4:
                trace.out("** [mem_chain2region1] Seed(%d) might lead to a different"
                          " alignment even though it is contained. Extension will"
                          " be performed.\n" % k)

        reg = AlnReg()
        reg.w = opt.w
        reg.score = reg.truesc = -1
        reg.rid = rid
        if trace.verbose >= 4:
            trace.out("** ---> [mem_chain2region1] Extending from seed(%d)"
                      " [%d;%d,%d] @ %s <---\n"
                      % (k, s.len, s.qbeg, s.rbeg, idx.anns[rid].name))
        aw0 = yield from _left_extend(opt, s, query, rseq, rmax[0], parent, reg)
        aw1 = yield from _right_extend(opt, s, query, l_query, rseq, rmax[0],
                                       rmax[1], parent, reg)
        reg.bss = getbss(parent, idx, reg.rb)
        reg.parent = parent
        if getbss(parent, idx, reg.re) != reg.bss:
            continue  # cross strand boundary, rare
        regs.append(reg)
        if trace.verbose >= 4:
            trace.out("*** [mem_chain2region1] Added alignment region:"
                      " [%d,%d) <=> [%d,%d); score=%d; {left,right}_bandwidth={%d,%d}\n"
                      % (reg.qb, reg.qe, reg.rb, reg.re, reg.score, aw0, aw1))
        reg.seedcov = 0
        for t in seeds:
            if (t.qbeg >= reg.qb and t.qbeg + t.len <= reg.qe and
                    t.rbeg >= reg.rb and t.rbeg + t.len <= reg.re):
                reg.seedcov += t.len
        reg.w = max(aw0, aw1)
        reg.seedlen0 = s.len
        reg.frac_rep = frac_rep


def chain2region_gen(opt: MemOpt, idx, l_seq: int, query: np.ndarray,
                     parent: int, chns: List[Chain], regs: AlnRegs):
    """memchain.c:873-904 as an extension-request generator (see
    _left_extend); drive with `drive_gen` (host) or batch-schedule the yields
    across lanes (device engine)."""
    reg0 = len(regs)
    for c in chns:
        if not c.seeds:
            continue
        if trace.verbose >= 4:
            trace.out("[mem_chain2region] ---> Convert following chain to region <---\n")
            trace.print_chain1(idx, c)
        rmax0, rmax1 = chain_reference_span(opt, l_seq, idx.l_pac, c)
        rseq, rid, rmax0, rmax1 = bnsmod.fetch_seq(idx, rmax0, c.seeds[0].rbeg, rmax1)
        n0 = len(regs)
        yield from chain2region1(opt, idx, rseq, (rmax0, rmax1), rid, l_seq,
                                 query, c.seeds, regs, parent, reg0, c.frac_rep)
        if len(regs) == n0 and c.seeds_extra:
            yield from chain2region1(opt, idx, rseq, (rmax0, rmax1), rid,
                                     l_seq, query, c.seeds_extra, regs,
                                     parent, reg0, c.frac_rep)


def drive_gen(gen, opt: MemOpt, parent: int) -> None:
    """Run an extension-request generator on the host SW kernel."""
    mat = opt.ctmat if parent else opt.gamat
    try:
        req = next(gen)
        while True:
            qs, rs, aw, pen, h0 = req
            res = sw.sw_extend(qs, rs, mat, opt.o_del, opt.e_del, opt.o_ins,
                               opt.e_ins, aw, pen, opt.zdrop, h0)
            req = gen.send(res)
    except StopIteration:
        pass


def chain2region(opt: MemOpt, idx, l_seq: int, query: np.ndarray, parent: int,
                 chns: List[Chain], regs: AlnRegs) -> None:
    """Host path: generator + scalar SW driver."""
    drive_gen(chain2region_gen(opt, idx, l_seq, query, parent, chns, regs),
              opt, parent)


# ---------------------------------------------------------------------------
# merge / dedup (mem_alnreg.c:37-227)
# ---------------------------------------------------------------------------

def _test_reg_concatenation(opt: MemOpt, idx, query: np.ndarray,
                            a: AlnReg, b: AlnReg):
    """mem_alnreg.c:63-108. Returns (score, w) or (0, None)."""
    from .sam import gen_cigar  # late import to avoid cycle
    if idx is None or query is None:
        return 0, None
    assert a.rid == b.rid and a.rb <= b.rb
    if a.rb < idx.l_pac and b.rb >= idx.l_pac:
        return 0, None
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return 0, None
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if trace.verbose >= 4:
        trace.out("* potential hit merge between [%d,%d)<=>[%d,%d) and"
                  " [%d,%d)<=>[%d,%d), @ %s; w=%d, r=%.4g\n"
                  % (a.qb, a.qe, a.rb, a.re, b.qb, b.qe, b.rb, b.re,
                     idx.anns[a.rid].name, w, r))
    if a.re < b.rb or a.qe < b.qb:
        if w > opt.w << 1 or r >= PATCH_MAX_R_BW:
            return 0, None
    elif w > opt.w << 2 or r >= PATCH_MAX_R_BW * 2:
        return 0, None
    w += a.w + b.w
    w = min(w, opt.w << 2)
    if trace.verbose >= 4:
        trace.out("* test potential hit merge with global alignment; w=%d\n" % w)
    res = gen_cigar(opt, idx, query[a.qb:b.qe], a.rb, b.re, a.parent, w,
                    want_cigar=False)
    score = res.score
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb)) * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb)) * (b.score + a.score) + 0.499)
    if trace.verbose >= 4:
        trace.out("[mem_test_reg_concatenation] score=%d;(%d,%d)\n"
                  % (score, q_s, r_s))
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return 0, None
    return score, w


def sort_deduplicate(opt: MemOpt, idx, query, regs: AlnRegs) -> None:
    """mem_alnreg.c:112-195."""
    if len(regs) <= 1:
        return
    # ks_introsort(mem_ars2) order, ties included (mem_alnreg.c:43,118):
    # merge bookkeeping below reads adjacent pairs, so tie order matters
    introsort(regs, lambda a, b: a.re < b.re)
    for p in regs:
        p.n_comp = 1
    for i in range(1, len(regs)):
        p = regs[i]
        j = i - 1
        while j >= 0 and p.rid == regs[j].rid and p.rb < regs[j].re + opt.max_chain_gap:
            q = regs[j]
            j -= 1
            if q.qe == q.qb:
                continue
            orr = q.re - p.rb
            oq = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            mr = min(q.re - q.rb, p.re - p.rb)
            mq = min(q.qe - q.qb, p.qe - p.qb)
            if orr > opt.mask_level_redun * mr and oq > opt.mask_level_redun * mq:
                if p.score < q.score:
                    p.qe = p.qb
                    break
                else:
                    q.qe = q.qb
            elif q.rb < p.rb:
                score, w = _test_reg_concatenation(opt, idx, query, q, p)
                if score > 0:
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.truesc = p.score = score
                    p.qb = q.qb
                    p.rb = q.rb
                    p.w = w
                    q.qb = q.qe
    regs[:] = [p for p in regs if p.qe > p.qb]
    # ks_introsort(mem_ars) order (mem_alnreg.c:48,180)
    introsort(regs, lambda a, b: a.score > b.score or (
        a.score == b.score and (a.rb < b.rb or (
            a.rb == b.rb and a.qb < b.qb))))
    for i in range(1, len(regs)):
        if (regs[i].score == regs[i - 1].score and regs[i].rb == regs[i - 1].rb
                and regs[i].qb == regs[i - 1].qb):
            regs[i].qe = regs[i].qb
    regs[:] = [p for i, p in enumerate(regs) if i == 0 or p.qe > p.qb]


def merge_regions(opt: MemOpt, idx, query, l_seq: int, regs: AlnRegs) -> None:
    """mem_alnreg.c:208-227."""
    sort_deduplicate(opt, idx, query, regs)
    from ..config import MEM_F_SELF_OVLP
    if opt.flag & MEM_F_SELF_OVLP:
        if regs and regs[0].truesc == l_seq * opt.a:
            del regs[0]
    if trace.verbose >= 4:
        trace.out("[mem_merge_regions] %d regions remain after merging"
                  " duplicated regions\n" % len(regs))
        trace.print_regions(idx, regs)
    for p in regs:
        if p.rid >= 0 and idx.anns[p.rid].is_alt:
            p.is_alt = 1


# ---------------------------------------------------------------------------
# primary marking (mem_alnreg.c:252-380)
# ---------------------------------------------------------------------------

def _mark_primary_core(opt: MemOpt, n_mark: int, regs: AlnRegs) -> List[int]:
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z = [0]
    for i in range(1, n_mark):
        a = regs[i]
        k = 0
        while k < len(z):
            b = regs[z[k]]
            b_max = max(a.qb, b.qb)
            e_min = min(a.qe, b.qe)
            if e_min > b_max:
                min_l = min(a.qe - a.qb, b.qe - b.qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if b.sub == 0:
                        b.sub = a.score
                    if b.score - a.score <= tmp and (b.is_alt or not a.is_alt):
                        b.sub_n += 1
                    break
            k += 1
        if k == len(z):
            z.append(i)
        else:
            a.secondary = z[k]
    return z


def mark_primary(opt: MemOpt, regs: AlnRegs, rid_id: int) -> None:
    """mem_mark_primary_se (mem_alnreg.c:290-380)."""
    regs.n_pri = 0
    if not regs:
        return
    if trace.verbose >= 4:
        trace.out("[mem_mark_primary_se] Before marking\n")
        trace.print_regions(None, regs)
    for i, p in enumerate(regs):
        p.sub = p.alt_sc = 0
        p.secondary = -1
        p.secondary_all = -1
        p.hash = hash_64((rid_id + i) & U64)
        if not p.is_alt:
            regs.n_pri += 1
    regs.sort(key=lambda p: (-p.score, p.is_alt, p.hash))
    _mark_primary_core(opt, len(regs), regs)
    if trace.verbose >= 4:
        trace.out("[mem_mark_primary_se] 1st round marking\n")
        trace.print_regions(None, regs)
    for i, p in enumerate(regs):
        p.secondary_all = i
        if not p.is_alt and p.secondary >= 0 and regs[p.secondary].is_alt:
            p.alt_sc = regs[p.secondary].score
    if 0 < regs.n_pri < len(regs):
        z = [0] * len(regs)
        regs.sort(key=lambda p: (p.is_alt, -p.score, p.hash))
        for i, p in enumerate(regs):
            z[p.secondary_all] = i
        for p in regs:
            if p.secondary >= 0:
                p.secondary_all = z[p.secondary]
                if p.is_alt:
                    p.secondary = INT_MAX
            else:
                p.secondary_all = -1
        if regs.n_pri > 0:
            for i in range(regs.n_pri):
                regs[i].sub = 0
                regs[i].secondary = -1
            _mark_primary_core(opt, regs.n_pri, regs)
    else:
        for p in regs:
            p.secondary_all = p.secondary
    if trace.verbose >= 4:
        trace.out("[mem_mark_primary_se] 2nd round marking\n")
        trace.print_regions(None, regs)


# ---------------------------------------------------------------------------
# insert size helpers + mate rescue (mem_alnreg.h / mem_alnreg.c:386-513)
# ---------------------------------------------------------------------------

def infer_isize(pos1, pos2, isrev1, isrev2, len1, len2):
    if isrev1 and not isrev2:
        return pos1 - pos2 + len1
    if isrev2 and not isrev1:
        return pos2 - pos1 + len2
    return None


def alnreg_isize(idx, r1: AlnReg, r2: AlnReg):
    if r1.rid != r2.rid:
        return None
    isrev1 = r1.rb > idx.l_pac
    isrev2 = r2.rb > idx.l_pac
    pos1 = ((idx.l_pac << 1) - 1 - r1.rb) if isrev1 else r1.rb
    pos2 = ((idx.l_pac << 1) - 1 - r2.rb) if isrev2 else r2.rb
    return infer_isize(pos1, pos2, isrev1, isrev2, r1.qe - r1.qb, r2.qe - r2.qb)


def is_proper_pair(idx, r1: AlnReg, r2: AlnReg, pes) -> bool:
    isize = alnreg_isize(idx, r1, r2)
    return isize is not None and pes.low <= isize <= pes.high


def _matesw_prepare(opt: MemOpt, idx, pes, reg: AlnReg, l_ms: int,
                    ms: np.ndarray):
    """The order-independent half of mem_alnreg_matesw_core
    (mem_alnreg.c:395-434): window derivation, reference fetch and the
    early returns that depend only on (reg, pes, idx) — NOT on the evolving
    mate region list. Returns None when the call can never mutate mregs,
    else (rev, ref, parent, rb, re_) — everything the SW kernel needs, so
    a device batch can precompute every candidate's alignment upfront."""
    l_pac = idx.l_pac
    rev = np.where(ms < 4, 3 - ms, 4)[::-1].astype(np.uint8)
    rb = max(0, reg.rb + pes.low - l_ms)
    re_ = min(l_pac << 1, reg.rb + pes.high)
    if rb >= re_:
        return None
    ref, rid, rb, re_ = bnsmod.fetch_seq(idx, rb, (rb + re_) >> 1, re_)
    if reg.rid != rid or re_ - rb < opt.min_seed_len:
        return None
    parent = reg.bss ^ (1 if reg.rb < l_pac else 0)
    return rev, ref, parent, rb, re_


def _matesw_skip(idx, pes, reg: AlnReg, mregs: AlnRegs) -> bool:
    """The order-DEPENDENT early return (mem_alnreg.c:399-404): a mate
    region already pairing properly with reg exists — evaluated against
    the CURRENT mregs at replay time."""
    for mr in mregs:
        isize = alnreg_isize(idx, reg, mr)
        if isize is not None and pes.low <= isize <= pes.high:
            return True
    return False


def _matesw_core(opt: MemOpt, idx, pes, reg: AlnReg, l_ms: int, ms: np.ndarray,
                 mregs: AlnRegs) -> None:
    """mem_alnreg_matesw_core (mem_alnreg.c:395-493)."""
    if _matesw_skip(idx, pes, reg, mregs):
        return
    prep = _matesw_prepare(opt, idx, pes, reg, l_ms, ms)
    if prep is None:
        return
    rev, ref, parent, rb, re_ = prep
    # reference picks the u8 striped kernel for short reads (bwamem.c-style
    # xtra |= KSW_XBYTE when l_ms * a < 250, mem_alnreg.c:433) — 16-lane
    # padding + 255 saturation semantics
    aln = sw.sw_align(rev, ref, opt.gamat if parent else opt.ctmat,
                      opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                      xstart=True, xsubo=opt.min_seed_len * opt.a,
                      xbyte=l_ms * opt.a < 250)
    _matesw_apply(opt, idx, pes, reg, l_ms, aln, prep, mregs)


def _matesw_apply(opt: MemOpt, idx, pes, reg: AlnReg, l_ms: int, aln,
                  prep, mregs: AlnRegs) -> None:
    """Post-SW half of mem_alnreg_matesw_core (mem_alnreg.c:436-493)."""
    l_pac = idx.l_pac
    rev, ref, parent, rb, re_ = prep
    if trace.verbose >= 4:
        trace.out("[mem_alnreg_matesw_core] Try adding matesw-ed region %d-%d."
                  " score:%d\n" % (rb, re_, aln.score))
        trace.out("original: %d - %d (pes: [%d-%d])\n"
                  % (reg.rb, reg.re, pes.low, pes.high))
        trace.print_region1(idx, reg)
        trace.out("\n")
    if aln.score >= opt.min_seed_len and aln.qb >= 0:
        b = AlnReg()
        b.rid = reg.rid
        b.is_alt = reg.is_alt
        b.qb = l_ms - (aln.qe + 1)
        b.qe = l_ms - aln.qb
        b.rb = (l_pac << 1) - (rb + aln.te + 1)
        b.re = (l_pac << 1) - (rb + aln.tb)
        b.score = aln.score
        b.csub = aln.score2
        b.secondary = -1
        b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
        b.bss = reg.bss
        b.parent = 1 - parent
        if trace.verbose >= 4:
            trace.out("\n[mem_alnreg_matesw_core] Add matesw-ed region:\n")
            trace.print_region1(idx, b)
            trace.out("\n")
            trace.out("[mem_alnreg_matesw_core] for original alignment:\n")
            trace.print_region1(idx, reg)
            trace.out("\n\n")
        # insert b keeping mregs sorted by score desc
        i = 0
        while i < len(mregs):
            if mregs[i].score < b.score:
                break
            i += 1
        mregs.insert(i, b)
        sort_deduplicate(opt, None, None, mregs)


def matesw(opt: MemOpt, idx, pes, seqs, regs_pair) -> None:
    """mem_alnreg_matesw (mem_alnreg.c:496-513)."""
    good = [[], []]
    for i in range(2):
        regs = regs_pair[i]
        for r in regs:
            if regs and r.score >= regs[0].score - opt.pen_unpaired:
                good[i].append(r)
    for i in range(2):
        for j, r in enumerate(good[i]):
            if j >= opt.max_matesw:
                break
            _matesw_core(opt, idx, pes, r, seqs[1 - i].l_seq, seqs[1 - i].seq,
                         regs_pair[1 - i])


def matesw_candidates(opt: MemOpt, idx, pes, seqs, regs_pair):
    """Enumerate a pair's mate-rescue calls in exact matesw() order, with
    the order-independent prep resolved. Returns
    [(reg, l_ms, prep, mate_idx), ...] — prep is None for calls that can
    never mutate anything (kept so the replay order stays byte-exact)."""
    good = [[], []]
    for i in range(2):
        regs = regs_pair[i]
        for r in regs:
            if regs and r.score >= regs[0].score - opt.pen_unpaired:
                good[i].append(r)
    cands = []
    for i in range(2):
        for j, r in enumerate(good[i]):
            if j >= opt.max_matesw:
                break
            prep = _matesw_prepare(opt, idx, pes, r, seqs[1 - i].l_seq,
                                   seqs[1 - i].seq)
            cands.append((r, seqs[1 - i].l_seq, prep, 1 - i))
    return cands


def matesw_batch(opt: MemOpt, idx, pes, pairs, sw_batch_fn) -> None:
    """Batched mem_alnreg_matesw over many pairs: every candidate's
    ksw_align2 runs in ONE device batch (sw_batch_fn — e.g.
    ops/sw_local.sw_align_batch), then the sequential per-pair semantics
    (the proper-pair early return checks the EVOLVING mate list; insertions
    re-sort it) replay on host with the precomputed alignments. The SW
    inputs depend only on (reg, pes, mate seq), so precomputing them is
    exact; per-pair call order is preserved, so output is bit-identical to
    calling matesw() per pair.

    pairs: [(seqs2, regs_pair), ...]; sw_batch_fn(reqs, xsubo) takes
    [(query, target, parent, xbyte), ...] and returns KswResults."""
    all_cands = []   # (pair_idx, reg, l_ms, prep, mate_idx, slot, snapshot)
    reqs = []
    for pi, (seqs, regs_pair) in enumerate(pairs):
        for reg, l_ms, prep, mi in matesw_candidates(opt, idx, pes, seqs,
                                                     regs_pair):
            slot = -1
            if prep is not None:
                rev, ref, parent, _rb, _re = prep
                slot = len(reqs)
                reqs.append((rev, ref, int(parent), l_ms * opt.a < 250))
            # prep depends on (reg.rb, reg.rid, reg.bss): an EARLIER rescue
            # of the same pair can patch those via sort_deduplicate, so the
            # replay re-derives prep when the snapshot went stale (rare;
            # host-SW fallback keeps bit-identity)
            all_cands.append((pi, reg, l_ms, prep, mi, slot,
                              (reg.rb, reg.rid, reg.bss)))
    if not reqs:
        # no SW work, but order-dependent skips/empty preps still replay
        # as no-ops — nothing can mutate, so just return
        return
    alns = sw_batch_fn(reqs, opt.min_seed_len * opt.a)
    for pi, reg, l_ms, prep, mi, slot, snap in all_cands:
        regs_pair = pairs[pi][1]
        seqs = pairs[pi][0]
        if (reg.rb, reg.rid, reg.bss) != snap:
            # stale: replay this call entirely on host (exact)
            _matesw_core(opt, idx, pes, reg, l_ms, seqs[mi].seq,
                         regs_pair[mi])
            continue
        if prep is None:
            continue
        if _matesw_skip(idx, pes, reg, regs_pair[mi]):
            continue
        _matesw_apply(opt, idx, pes, reg, l_ms, alns[slot], prep,
                      regs_pair[mi])
