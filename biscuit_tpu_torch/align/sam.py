"""SAM generation: CIGAR/MD/NM/ZC/ZR, per-region SAM fields, record
formatting, SE/PE emission.

Ports bis_bwa_gen_cigar2 (lib/aln/bwa.c:290-428),
mem_alnreg_setSAM / formatSAM / select_format / reg2sam_{se,pe}
(mem_alnreg_format.c), and mem_approx_mapq_se (bwamem.c:134-157).

Copy of biscuit_tpu/align/sam.py. Its imports differ: FMNumpy comes
from biscuit_tpu_torch.ops.fm and every other module from this package,
so the port imports nothing of the JAX package. And one argument is the
port's own: `global_fn`, which reg2sam_se / reg2sam_pe /
reg2sam_pe_nopairing take and hand, through select_format, format_sam and
_tag_XAXB, to every alnreg_setSAM call, and which alnreg_setSAM calls with
the region it formats (the device engine's cached global alignments).
tests/test_torch_engine.py holds the copy to its source, that argument
left out.
"""
import math
from functools import partial
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import (MemOpt, MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NO_MULTI,
                      MEM_F_NOPAIRING, MEM_F_REF_HDR, MEM_F_SOFTCLIP)
from ..ops import sw
from ..align import bns as bnsmod
from . import trace
from .region import (AlnReg, AlnRegs, INT_MAX, alnreg_isize, hash_64,
                     is_proper_pair)

CIGAR_OPS = "MIDSH"


@dataclass
class CigarResult:
    score: int = 0
    cigar: Optional[List[Tuple[int, int]]] = None
    NM: int = -1
    ZC: int = 0
    ZR: int = 0
    bss_u: int = 0
    md: str = ""


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """bwamem.h:192-198."""
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def get_rlen(cigar) -> int:
    if not cigar:
        return 0
    return sum(ln for op, ln in cigar if op in (0, 2))


def gen_cigar(opt: MemOpt, idx, query: np.ndarray, rb: int, re_: int,
              parent: int, w_: int, want_cigar: bool = True,
              global_fn=None) -> CigarResult:
    """bis_bwa_gen_cigar2 (bwa.c:290-428).

    global_fn(query, rseq, w) -> (score, cigar), if given, replaces the
    scalar sw.sw_global call — the device engine injects a batched
    (Pallas DP + on-device traceback) implementation through it, and a
    recording stub that raises to collect the whole batch first."""
    res = CigarResult()
    l_query = len(query)
    l_pac = idx.l_pac
    mat = opt.ctmat if parent else opt.gamat
    if l_query <= 0 or rb >= re_ or (rb < l_pac and re_ > l_pac):
        return res
    rseq = bnsmod.get_seq(idx, rb, re_)
    rlen = len(rseq)
    if re_ - rb != rlen:
        return res
    if rb >= l_pac:  # reverse both to left-align indels
        query = query[::-1]
        rseq = rseq[::-1]
    if l_query == re_ - rb and w_ == 0:
        res.cigar = [(0, l_query)] if want_cigar else None
        res.score = int(np.sum(mat[rseq.astype(np.int64), query.astype(np.int64)]))
        n_cigar_flag = want_cigar
    else:
        max_ins = int((((l_query + 1) >> 1) * int(mat[0, 0]) - opt.o_ins) / opt.e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * int(mat[0, 0]) - opt.o_del) / opt.e_del + 1.0)
        max_gap = max(max(max_ins, max_del), 1)
        w = (max_gap + abs(rlen - l_query) + 1) >> 1
        w = min(w, w_)
        min_w = abs(rlen - l_query) + 3
        w = max(w, min_w)
        if trace.verbose >= 4:
            # bwa.c:338-342 (query/rseq already reversed here when rb >= l_pac)
            trace.out("* Global bandwidth: %d\n" % w)
            trace.out("* Global ref:   ")
            trace.print_bases(rseq)
            trace.out("\n* Global query: ")
            trace.print_bases(query)
            trace.out("\n")
        if global_fn is not None and want_cigar:
            res.score, cig = global_fn(query, rseq, w)
        else:
            res.score, cig = sw.sw_global(query, rseq, mat, opt.o_del,
                                          opt.e_del, opt.o_ins, opt.e_ins, w,
                                          want_cigar=want_cigar)
        res.cigar = cig
        n_cigar_flag = want_cigar and cig is not None

    if n_cigar_flag:
        int2base = "ACGTN" if rb < l_pac else "TGCAN"
        md = []
        x = y = u = 0
        n_mm = n_gap = 0
        n_conv_ct = n_ret_c = n_conv_ga = n_ret_g = 0
        n_cigar = len(res.cigar)
        qa = np.asarray(query, dtype=np.int8)
        ra = np.asarray(rseq, dtype=np.int8)
        for k, (op, ln) in enumerate(res.cigar):
            if op == 0:
                qs = qa[x:x + ln]
                rs_ = ra[y:y + ln]
                eq = qs == rs_
                n_ret_c += int(np.count_nonzero(eq & (qs == 1)))
                n_ret_g += int(np.count_nonzero(eq & (qs == 2)))
                if parent:
                    conv = (~eq) & (qs == 3) & (rs_ == 1)
                else:
                    conv = (~eq) & (qs == 0) & (rs_ == 2)
                n_conv = int(np.count_nonzero(conv))
                if parent:
                    n_conv_ct += n_conv
                else:
                    n_conv_ga += n_conv
                breaks = np.nonzero(~eq)[0]
                n_mm += len(breaks) - n_conv
                prev = 0
                for i in breaks:
                    md.append(str(u + (i - prev)))
                    md.append(int2base[rs_[i]])
                    prev = i + 1
                    u = 0
                u += ln - prev
                x += ln; y += ln
            elif op == 2:
                if 0 < k < n_cigar - 1:
                    md.append(str(u)); md.append("^")
                    md.append("".join(int2base[c] for c in ra[y:y + ln]))
                    u = 0; n_gap += ln
                y += ln
            elif op == 1:
                x += ln; n_gap += ln
        md.append(str(u))
        res.md = "".join(md)
        res.NM = n_mm + n_gap
        res.ZC = n_conv_ct if parent else n_conv_ga
        res.ZR = n_ret_c if parent else n_ret_g
        res.bss_u = 1 if (n_conv_ct == 0 and n_conv_ga == 0) else 0
    return res


def alnreg_setSAM(opt: MemOpt, idx, seq, reg: AlnReg,
                  global_fn=None) -> None:
    """mem_alnreg_setSAM (mem_alnreg_format.c:40-123)."""
    if reg.n_cigar > 0:
        # already formatted (device prefill or the early PE invocation):
        # re-apply the orientation bit a fresh run would set — callers
        # reset reg.flag to 0 between invocations
        if reg.is_rev:
            reg.flag |= 0x10
        return
    query = seq.seq
    _w1 = infer_bw(reg.qe - reg.qb, reg.re - reg.rb, reg.truesc, opt.a, opt.o_del, opt.e_del)
    _w2 = infer_bw(reg.qe - reg.qb, reg.re - reg.rb, reg.truesc, opt.a, opt.o_ins, opt.e_ins)
    w = max(_w1, _w2)
    if w > opt.w:
        w = min(w, reg.w)
    if trace.verbose >= 4:
        trace.out("[mem_alnreg_setSAM] Generate cigar for\n")
        trace.print_region1(idx, reg)
        trace.out("\n")
    last_sc = -(1 << 30)
    res = None
    for i in range(3):
        w = min(w, opt.w << 2)
        # the port's global_fn(reg, query, rseq, w) learns the region it
        # aligns for: the device engine's cache is keyed by region and band
        res = gen_cigar(opt, idx, query[reg.qb:reg.qe], reg.rb, reg.re,
                        reg.parent, w, global_fn=(
                            None if global_fn is None
                            else partial(global_fn, reg)))
        if trace.verbose >= 4:
            trace.out("[mem_alnreg_setSAM] w=%d, global_sc=%d, local_sc=%d\n"
                      % (w, res.score, reg.truesc))
        if res.score == last_sc:
            break
        if w == opt.w << 2:
            break
        if res.score >= reg.truesc - opt.a:
            break
        last_sc = res.score
        w <<= 1
    reg.NM = res.NM
    reg.ZC = res.ZC
    reg.ZR = res.ZR
    reg.bss_u = res.bss_u
    reg.md = res.md
    cigar = list(res.cigar) if res.cigar else []
    rpos, is_rev = bnsmod.depos(idx, reg.rb if reg.rb < idx.l_pac else reg.re - 1)
    reg.is_rev = 1 if is_rev else 0
    reg.flag |= 0x10 if is_rev else 0
    # squeeze leading/trailing deletions
    if cigar:
        if cigar[0][0] == 2:
            rpos += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == 2:
            cigar = cigar[:-1]
    # add clipping
    if reg.qb != 0 or reg.qe != seq.l_seq or seq.clip5 or seq.clip3:
        if reg.is_rev:
            clip5 = seq.l_seq - reg.qe + seq.clip3
            clip3 = reg.qb + seq.clip5
        else:
            clip5 = reg.qb + seq.clip5
            clip3 = seq.l_seq - reg.qe + seq.clip3
        if clip5:
            cigar = [(3, clip5)] + cigar
        if clip3:
            cigar = cigar + [(3, clip3)]
    reg.n_cigar = len(cigar)
    reg.cigar = cigar if cigar else None
    assert bnsmod.pos2rid(idx, rpos) == reg.rid
    reg.pos = rpos - idx.anns[reg.rid].offset


def mapq_se(opt: MemOpt, a: AlnReg) -> int:
    """mem_approx_mapq_se (bwamem.c:134-157)."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    l = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (l * opt.a - a.score) / (opt.a + opt.b) / l
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if l < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(30.0 * (1.0 - sub / a.score) * math.log(a.seedcov) + 0.499)
        mapq = int(mapq * identity * identity + 0.499) if identity < 0.95 else mapq
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    mapq = int(mapq * (1.0 - a.frac_rep) + 0.499)
    return mapq


def get_pri_idx(xa_drop_ratio: float, regs: AlnRegs, i: int) -> int:
    k = regs[i].secondary_all
    if k >= 0 and regs[i].score >= regs[k].score * xa_drop_ratio:
        return k
    return -1


def _cigar_str(cigar, is_primary, opt, is_alt, is_rev=False) -> str:
    out = []
    for op, ln in cigar:
        c = op
        if not (opt.flag & MEM_F_SOFTCLIP) and not is_alt and c in (3, 4):
            c = 3 if is_primary else 4
        out.append(f"{ln}{CIGAR_OPS[c]}")
    return "".join(out)


def _tag_XAXB(opt: MemOpt, idx, seq, p0: AlnReg, regs0: Optional[AlnRegs],
              out: List[str], global_fn=None) -> None:
    """mem_alnreg_tagXAXB (mem_alnreg_format.c:126-191)."""
    if regs0 is None or (opt.flag & MEM_F_ALL):
        return
    cnt_pri = cnt_alt = 0
    for i in range(len(regs0)):
        r = get_pri_idx(opt.XA_drop_ratio, regs0, i)
        if r >= 0 and regs0[r] is p0:
            if regs0[i].is_alt:
                cnt_alt += 1
            else:
                cnt_pri += 1
    if cnt_pri <= opt.max_XA_hits and cnt_alt <= opt.max_XA_hits_alt:
        parts = []
        for i in range(len(regs0)):
            q = regs0[i]
            r = get_pri_idx(opt.XA_drop_ratio, regs0, i)
            if r < 0 or regs0[r] is not p0:
                continue
            if q.n_cigar == 0:
                alnreg_setSAM(opt, idx, seq, q, global_fn=global_fn)
                if q.n_cigar == 0:
                    continue
            cig = "".join(f"{ln}{'MIDSHN'[op]}" for op, ln in q.cigar)
            parts.append(f"{idx.anns[q.rid].name},{'+-'[q.is_rev]}{q.pos + 1},{cig},{q.NM}")
        if parts:
            out.append("\tXA:Z:" + ";".join(parts))
    if cnt_pri > 0 or cnt_alt > 0:
        out.append(f"\tXB:Z:{cnt_pri},{cnt_alt}")


def _tag_SA(opt: MemOpt, idx, seq, p0: AlnReg, regs0: Optional[AlnRegs],
            out: List[str]) -> None:
    """mem_alnreg_tagSA (mem_alnreg_format.c:194-228)."""
    if regs0 is None or (p0.flag & 0x100):
        return
    parts = []
    for q in regs0:
        if q is p0 or q.n_cigar == 0 or (q.flag & 0x100):
            continue
        cig = "".join(f"{ln}{CIGAR_OPS[op]}" for op, ln in q.cigar)
        parts.append(f"{idx.anns[q.rid].name},{q.pos + 1},{'+-'[q.is_rev]},{cig},{q.mapq},{q.NM};")
    if parts:
        out.append("\tSA:Z:" + "".join(parts))


COMP_BASES = "TGCAN"
FWD_BASES = "ACGTN"
_FWD_TBL = bytes(ord(FWD_BASES[min(i, 4)]) for i in range(256))
_COMP_TBL = bytes(ord(COMP_BASES[min(i, 4)]) for i in range(256))


def format_sam(opt: MemOpt, idx, seq, p0: AlnReg, m0: Optional[AlnReg],
               regs0: Optional[AlnRegs], is_primary: int,
               pes=None, rg_id: str = "", global_fn=None) -> str:
    """mem_alnreg_formatSAM (mem_alnreg_format.c:237-436)."""
    import copy
    p = copy.copy(p0)
    m = copy.copy(m0) if m0 is not None else None

    p.flag |= 0x1 if m0 is not None else 0
    p.flag |= 0x8 if (m0 is not None and m.rid < 0) else 0
    if m0 is not None and m0.bss_u == 0:
        p.bss_u = 0
    if p.rid >= 0 and m0 is not None and m.rid >= 0 and pes is not None \
            and is_proper_pair(idx, p, m, pes):
        p.flag |= 2
        m.flag |= 2
    if p.rid < 0 and m0 is not None and m.rid >= 0:
        p.rid = m.rid
        p.pos = m.pos
        p.is_rev = m.is_rev
        p.n_cigar = 0
        p.cigar = None
    if m0 is not None and m.rid < 0 and p.rid >= 0:
        m.rid = p.rid
        m.pos = p.pos
        m.is_rev = p.is_rev
        m.n_cigar = 0
        m.cigar = None
    p.flag |= 0x20 if (m0 is not None and m.is_rev) else 0

    out: List[str] = []
    name = seq.name
    if seq.comment:
        name = f"{name}_{seq.comment}"
    out.append(name)
    out.append("\t")
    out.append(str((p.flag & 0xFFFF) | (0x100 if p.flag & 0x10000 else 0)))
    out.append("\t")
    if p.rid >= 0:
        out.append(idx.anns[p.rid].name)
        out.append(f"\t{p.pos + 1}\t{p.mapq}\t")
        if p.n_cigar:
            out.append(_cigar_str(p.cigar, is_primary, opt, p.is_alt))
        else:
            out.append("*")
    else:
        out.append("*\t0\t0\t*")
    out.append("\t")
    if m0 is not None and m.rid >= 0:
        out.append("=" if p.rid == m.rid else idx.anns[m.rid].name)
        out.append(f"\t{m.pos + 1}\t")
        if p.rid == m.rid:
            pp0 = pp1 = -1
            if p.is_rev:
                pp1 = p.pos + get_rlen(p.cigar if p.n_cigar else None) - 1
            else:
                pp0 = p.pos
            if m.is_rev:
                pp1 = m.pos + get_rlen(m.cigar if m.n_cigar else None) - 1
            else:
                pp0 = m.pos
            if p.n_cigar > 0 and m.n_cigar > 0 and pp0 >= 0 and pp1 >= 0:
                out.append(str(pp1 - pp0 + 1))
            else:
                out.append("0")
        else:
            out.append("0")
    else:
        out.append("*\t0\t0")
    out.append("\t")

    # SEQ/QUAL
    seq0 = seq.seq0
    qual = seq.qual
    if p.flag & 0x100:
        out.append("*\t*")
    else:
        qb, qe = 0, seq.l_seq0
        hard = p.n_cigar and not is_primary and not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt
        if p.is_rev:
            if hard:
                if p.cigar[0][0] in (3, 4):
                    qe -= p.cigar[0][1]
                if p.cigar[-1][0] in (3, 4):
                    qb += p.cigar[-1][1]
            out.append(bytes(seq0[qb:qe]).translate(_COMP_TBL)[::-1].decode())
            out.append("\t")
            out.append(qual[qb:qe][::-1] if qual is not None else "*")
        else:
            if hard:
                if p.cigar[0][0] in (3, 4):
                    qb += p.cigar[0][1]
                if p.cigar[-1][0] in (3, 4):
                    qe -= p.cigar[-1][1]
            out.append(bytes(seq0[qb:qe]).translate(_FWD_TBL).decode())
            out.append("\t")
            out.append(qual[qb:qe] if qual is not None else "*")

    # TAGS
    if p.n_cigar:
        out.append(f"\tNM:i:{p.NM}\tMD:Z:{p.md}\tZC:i:{p.ZC}\tZR:i:{p.ZR}")
    if p.score >= 0:
        out.append(f"\tAS:i:{p.score}")
    if p.sub >= 0:
        out.append(f"\tXS:i:{max(p.sub, p.csub)}")
    if rg_id:
        out.append(f"\tRG:Z:{rg_id}")
    if regs0 is not None:
        _tag_SA(opt, idx, seq, p0, regs0, out)
    if is_primary and p.alt_sc > 0:
        out.append("\tPA:f:%.3f" % (p.score / p.alt_sc))
    out.append(f"\tXL:i:{seq.l_seq}")
    if regs0 is not None:
        _tag_XAXB(opt, idx, seq, p0, regs0, out, global_fn=global_fn)
    if (opt.flag & MEM_F_REF_HDR) and p.rid >= 0 and idx.anns[p.rid].anno \
            and idx.anns[p.rid].anno != "":
        out.append("\tXR:Z:" + idx.anns[p.rid].anno.replace("\t", " "))
    if getattr(seq, "barcode", None):
        out.append(f"\tCB:Z:{seq.barcode}")
    if getattr(seq, "umi", None):
        out.append(f"\tRX:Z:{seq.umi}")
    out.append("\tMC:Z:")
    if m is not None and m.n_cigar:
        out.append(_cigar_str(m.cigar, is_primary, opt, m.is_alt))
    else:
        out.append("*")
    out.append(f"\tMQ:i:{m.mapq if m is not None else 0}")
    out.append("\tYD:A:")
    out.append("u" if p.bss_u else "fr"[p.bss])
    out.append("\n")
    return "".join(out)


def select_format(opt: MemOpt, idx, seq, regs: AlnRegs,
                  global_fn=None) -> List[int]:
    """mem_alnreg_select_format (mem_alnreg_format.c:445-488)."""
    to_output = []
    l = 0
    for k in range(len(regs)):
        p = regs[k]
        if p.rb < 0 or p.re < 0:
            continue
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if p.secondary >= 0 and p.secondary < INT_MAX \
                and p.score < regs[p.secondary].score * opt.drop_ratio:
            continue
        if l and p.secondary < 0:
            p.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if p.secondary >= 0:
            p.flag |= 0x100
        p.mapq = mapq_se(opt, p) if p.secondary < 0 else 0
        if not (opt.flag & MEM_F_KEEP_SUPP_MAPQ) and l and not p.is_alt:
            p.mapq = min(p.mapq, regs[0].mapq)
        alnreg_setSAM(opt, idx, seq, p, global_fn=global_fn)
        to_output.append(k)
        l += 1
    return to_output


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + 0.499)


def reg2sam_pe_nopairing(opt: MemOpt, idx, seqs, regs_pair, pes,
                         rg_id: str = "", global_fn=None) -> Tuple[str, str]:
    """mem_reg2sam_pe_nopairing (mem_alnreg_format.c:519-559)."""
    if trace.verbose >= 4:
        trace.out("PE no pairing.\n")
    best = [None, None]
    to_outputs = []
    for i in range(2):
        regs = regs_pair[i]
        to = select_format(opt, idx, seqs[i], regs, global_fn=global_fn)
        to_outputs.append(to)
        if to:
            best[i] = regs[to[0]]
        else:
            u = AlnReg()
            u.rid = -1
            u.flag = (0x40 << i) | 0x1 | 0x4
            u.sub = 0
            best[i] = u
    sams = []
    for i in range(2):
        regs = regs_pair[i]
        if to_outputs[i]:
            parts = []
            for j, k in enumerate(to_outputs[i]):
                p = regs[k]
                parts.append(format_sam(opt, idx, seqs[i], p, best[1 - i], regs,
                                        1 if j == 0 else 0, pes, rg_id,
                                        global_fn=global_fn))
            sams.append("".join(parts))
        else:
            sams.append(format_sam(opt, idx, seqs[i], best[i], best[1 - i],
                                   None, 1, pes, rg_id, global_fn=global_fn))
    return sams[0], sams[1]


def reg2sam_pe(opt: MemOpt, idx, pair_id: int, seqs, regs_pair, pes,
               rg_id: str = "", global_fn=None) -> Tuple[str, str]:
    """mem_reg2sam_pe (mem_alnreg_format.c:562-696)."""
    import math as _math
    from .pair import mem_pair
    if trace.verbose >= 4:
        trace.out("[mem_reg2sam_pe] Read 1 in pairing:\n")
        trace.print_regions(idx, regs_pair[0])
        trace.out("[mem_reg2sam_pe] Read 2 in pairing:\n")
        trace.print_regions(idx, regs_pair[1])
        trace.out("\n")
    for i in range(2):
        for r in regs_pair[i]:
            r.flag |= (0x40 << i) | 1
    if opt.flag & MEM_F_NOPAIRING:
        return reg2sam_pe_nopairing(opt, idx, seqs, regs_pair, pes, rg_id,
                                    global_fn=global_fn)
    if regs_pair[0].n_pri == 0 or regs_pair[1].n_pri == 0:
        return reg2sam_pe_nopairing(opt, idx, seqs, regs_pair, pes, rg_id,
                                    global_fn=global_fn)

    # multi-hit check
    is_multi = [False, False]
    for i in range(2):
        j = 1
        while j < regs_pair[i].n_pri:
            if regs_pair[i][j].secondary < 0 and regs_pair[i][j].score >= opt.T:
                break
            j += 1
        is_multi[i] = j < regs_pair[i].n_pri
    if is_multi[0] or is_multi[1]:
        return reg2sam_pe_nopairing(opt, idx, seqs, regs_pair, pes, rg_id,
                                    global_fn=global_fn)

    pscore, sub_pscore, n_subpairings, z = mem_pair(opt, idx, pes, regs_pair, pair_id)
    if pscore <= 0:
        return reg2sam_pe_nopairing(opt, idx, seqs, regs_pair, pes, rg_id,
                                    global_fn=global_fn)

    if trace.verbose >= 4:
        # mem_alnreg_format.c:605-611: setSAM is invoked early here (idempotent)
        # so the paired regions' pos fields are printable
        p1 = regs_pair[0][z[0]]
        p2 = regs_pair[1][z[1]]
        alnreg_setSAM(opt, idx, seqs[0], p1, global_fn=global_fn)
        alnreg_setSAM(opt, idx, seqs[1], p2, global_fn=global_fn)
        trace.out("** pairing read 1: %d, [%d,%d) <=> [%d,%d,%s,%d) <> "
                  "read 2: %d, [%d,%d) <=> [%d,%d,%s,%d)\n"
                  % (p1.score, p1.qb, p1.qe, p1.rb, p1.re,
                     idx.anns[p1.rid].name, p1.pos,
                     p2.score, p2.qb, p2.qe, p2.rb, p2.re,
                     idx.anns[p2.rid].name, p2.pos))

    score_unpaired = regs_pair[0][0].score + regs_pair[1][0].score - opt.pen_unpaired
    if pscore > score_unpaired:
        if trace.verbose >= 4:
            trace.out("Favor pairing\n")
        sub_pscore = max(sub_pscore, score_unpaired)
        q_pe = raw_mapq(pscore - sub_pscore, opt.a)
        if n_subpairings > 0:
            q_pe -= int(4.343 * _math.log(n_subpairings + 1) + 0.499)
        q_pe = max(0, min(60, q_pe))
        q_pe = int(q_pe * (1.0 - 0.5 * (regs_pair[0][0].frac_rep
                                        + regs_pair[1][0].frac_rep)) + 0.499)
        q_se = [0, 0]
        c = [regs_pair[0][z[0]], regs_pair[1][z[1]]]
        for i in range(2):
            if c[i].secondary >= 0:
                c[i].sub = regs_pair[i][c[i].secondary].score
                c[i].secondary = -2
            q_se[i] = mapq_se(opt, c[i])
        q_se[0] = max(q_se[0], min(q_pe, q_se[0] + 40))
        q_se[1] = max(q_se[1], min(q_pe, q_se[1] + 40))
        c[0].mapq = min(q_se[0], raw_mapq(c[0].score - c[0].csub, opt.a))
        c[1].mapq = min(q_se[1], raw_mapq(c[1].score - c[1].csub, opt.a))
    else:
        if trace.verbose >= 4:
            trace.out("Favor best hits in pairing\n")
        z = [0, 0]
        regs_pair[0][0].mapq = mapq_se(opt, regs_pair[0][0])
        regs_pair[1][0].mapq = mapq_se(opt, regs_pair[1][0])

    # secondary/primary switch
    for i in range(2):
        regs = regs_pair[i]
        k = regs[z[i]].secondary_all
        if 0 <= k < regs.n_pri:
            assert regs[k].secondary_all < 0
            for j in range(len(regs)):
                if regs[j].secondary_all == k or j == k:
                    regs[j].secondary_all = z[i]
            regs[z[i]].secondary_all = -1

    for i in range(2):
        alnreg_setSAM(opt, idx, seqs[i], regs_pair[i][z[i]],
                      global_fn=global_fn)

    sams = []
    for i in range(2):
        regs = regs_pair[i]
        reg = regs[z[i]]
        mreg = regs_pair[1 - i][z[1 - i]]
        parts = [format_sam(opt, idx, seqs[i], reg, mreg, regs, 1, pes, rg_id,
                            global_fn=global_fn)]
        if regs.n_pri < len(regs):
            p = regs[regs.n_pri]
            if p.score >= opt.T and p.secondary < 0:
                p.flag |= 0x800
                alnreg_setSAM(opt, idx, seqs[i], p, global_fn=global_fn)
                parts.append(format_sam(opt, idx, seqs[i], p, None, regs, 0, pes,
                                        rg_id, global_fn=global_fn))
        sams.append("".join(parts))
    return sams[0], sams[1]


def reg2sam_se(opt: MemOpt, idx, seq, regs: AlnRegs, rg_id: str = "",
               global_fn=None) -> str:
    """mem_reg2sam_se (mem_alnreg_format.c:492-515)."""
    to_output = select_format(opt, idx, seq, regs, global_fn=global_fn)
    if to_output:
        return "".join(
            format_sam(opt, idx, seq, regs[k], None, regs, 1 if i == 0 else 0,
                       None, rg_id, global_fn=global_fn)
            for i, k in enumerate(to_output))
    reg = AlnReg()
    reg.rid = -1
    reg.flag = 0x4
    reg.sub = 0
    return format_sam(opt, idx, seq, reg, None, regs, 1, None, rg_id,
                      global_fn=global_fn)
