"""biscuit epiread port (src/epiread.c): per-read methylation
haplotypes in epiBED (RLE), old-epiread, or pairwise formats; SNP-aware via a
`vcf2bed -t snp` BED; NOMe-seq mode; basic modBAM (MM/ML) support.

Copy of biscuit_tpu/subcmds/epiread.py. BAM input runs on the C++
raw-BAM window engine (pileup_native.cpp, bt_epiread_window_raw) unless
BISCUIT_TPU_TORCH_PILEUP is set to another value than `native`; then the
Python window walk runs. The CLI (cli.main_epiread) takes only `native`
and `device`, which names that walk. That switch, the port's own, stands
where the source reads BISCUIT_TPU_PILEUP; the rest is the source's code,
which tests/test_torch_engine.py holds the copy to. Nothing here uses
torch.
"""
import getopt
import gzip
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..io.sambam import (AlignmentFile, AlnRecord, FLAG_DUP, FLAG_PAIRED,
                         FLAG_PROPER, FLAG_QCFAIL, FLAG_READ2, FLAG_REVERSE,
                         FLAG_SECONDARY)
from ..pileup.common import (BiscCommon, BiscThreads, MethFilter, RefCache,
                             cnt_retention, get_bsstrand, get_mate_length,
                             revcomp_str)

SKIP_EPI = "-"
SKIP_INS = "i"
SKIP_DEL = "d"
FILTERED = "F"
IGNORED = "x"
DELETION = "D"
SOFTCLIP = "P"
METHYLAT = "M"
UNMETHYL = "U"
OPEN_ACC = "O"
SHUT_ACC = "S"
AMBIG_GA = "R"
AMBIG_CT = "Y"


@dataclass
class EpireadConf:
    comm: BiscCommon = field(default_factory=BiscCommon)
    bt: BiscThreads = field(default_factory=BiscThreads)
    filt: MethFilter = field(default_factory=MethFilter)
    epiread_reg_start: int = 0
    epiread_reg_end: int = 0
    modbam_prob: float = 0.9
    filter_empty_epiread: int = 1
    max_read_length: int = 302
    epiread_old: int = 0
    epiread_pair: int = 0
    print_all_locations: int = 0
    use_modbam: int = 0


def run_length_encode(s: str) -> str:
    out = []
    i = 0
    n = len(s)
    while i < n:
        out.append(s[i])
        run = 1
        while i + 1 < n and s[i] == s[i + 1]:
            run += 1
            i += 1
        if run > 1:
            out.append(str(run))
        i += 1
    return "".join(out)


def read_episnp(path: str):
    """bed_init_episnp (epiread.c:1056-1148): 9-column `vcf2bed -t snp` BED ->
    {chrm: (locs list (1-based), meth flags list)}."""
    out: Dict[str, Tuple[List[int], List[int]]] = {}
    opener = gzip.open if path.endswith(".gz") else open
    empty = True
    with opener(path, "rt") as f:
        for line in f:
            empty = False
            fields = line.rstrip("\n").split("\t")
            if len(fields) != 9:
                continue
            chrm = fields[0]
            loc = int(fields[1]) + 1
            ref, alt = fields[3], fields[4]
            try:
                vaf = float(fields[8])
            except ValueError:
                vaf = 0.0
            meth_callable = 0
            if ref == "C" and (alt != "T" or vaf < 0.05):
                meth_callable = 1
            if ref == "G" and (alt != "A" or vaf < 0.05):
                meth_callable = 1
            locs, meths = out.setdefault(chrm, ([], []))
            locs.append(loc)
            meths.append(meth_callable)
    if empty:
        raise SystemExit(f"SNP BED ({path}) is empty")
    return out


def modbam_quals(b: AlnRecord) -> Tuple[Dict[int, int], int, str]:
    """Parse MM/ML into {stored-seq qpos: qual}; returns (quals, strand,
    canonical_base). Only a single 'm' (5mC) modification is supported, like
    the reference."""
    mm = b.get_tag("MM") or b.get_tag("Mm")
    ml = b.get_tag("ML") or b.get_tag("Ml")
    quals: Dict[int, int] = {}
    if not mm:
        return quals, 0, "C"
    spec = mm.rstrip(";").split(";")[0]
    head, *deltas = spec.split(",")
    canonical = head[0]
    strand = 0 if head[1] == "+" else 1
    if "m" not in head:
        raise SystemExit("ERROR: must be a methylation modification ('m')")
    if canonical not in ("C", "G"):
        raise SystemExit("ERROR: modification must fall on a C or G")
    mlv = ml[1] if isinstance(ml, tuple) else ml
    deltas = [int(d) for d in deltas]
    # original-orientation sequence
    stored = b.seq
    orig = revcomp_str(stored) if (b.flag & FLAG_REVERSE) else stored
    positions = [i for i, c in enumerate(orig) if c == canonical]
    idx = -1
    for k, d in enumerate(deltas):
        idx += d + 1
        if idx >= len(positions):
            break
        opos = positions[idx]
        spos = len(stored) - 1 - opos if (b.flag & FLAG_REVERSE) else opos
        q = mlv[k] if mlv is not None and k < len(mlv) else -1
        quals[spos] = q
    return quals, strand, canonical


def is_modbam_cpg(flag, strand, can_base, qb, rb, rs, pos) -> int:
    """bisc_utils.h:227-251."""
    if can_base == "C" and strand == 0:
        if qb == "G" and (flag & FLAG_REVERSE):
            if rb == "G" and pos - 1 >= rs.beg and rs.getbase_upcase(pos - 1) == "C":
                return 1
        elif qb == "C" and not (flag & FLAG_REVERSE):
            if rb == "C" and pos + 1 <= rs.end and rs.getbase_upcase(pos + 1) == "G":
                return 1
    elif can_base == "G" and strand == 1:
        if qb == "C" and (flag & FLAG_REVERSE):
            if rb == "C" and pos + 1 <= rs.end and rs.getbase_upcase(pos + 1) == "G":
                return 1
        elif qb == "G" and not (flag & FLAG_REVERSE):
            if rb == "G" and pos - 1 >= rs.beg and rs.getbase_upcase(pos - 1) == "C":
                return 1
    return 0


def _skipped_base_old(rs, rb, bss, rj, qj, conf, skip_epi, hcg, gch, cg):
    """epiread.c:475-512. hcg/gch/cg are (positions, chars) pairs."""
    if bss and rb == "G" and rj - 1 >= rs.beg:
        rb0 = rs.getbase_upcase(rj - 1)
        if conf.comm.is_nome:
            if rj + 1 <= rs.end:
                rb1 = rs.getbase_upcase(rj + 1)
                if rb0 == "C" and rb1 != "C" and qj > 0:
                    hcg[0].append(rj - 1); hcg[1].append(skip_epi)
                elif rb0 != "C" and rb1 == "C":
                    gch[0].append(rj); gch[1].append(skip_epi)
        else:
            if rb0 == "C":
                cg[0].append(rj - 1); cg[1].append(skip_epi)
    if not bss and rb == "C" and rj + 1 <= rs.end:
        rb1 = rs.getbase_upcase(rj + 1)
        if conf.comm.is_nome:
            if rj - 1 >= rs.beg:
                rb0 = rs.getbase_upcase(rj - 1)
                if rb0 != "G" and rb1 == "G":
                    hcg[0].append(rj); hcg[1].append(skip_epi)
                elif rb0 == "G" and rb1 != "G":
                    gch[0].append(rj); gch[1].append(skip_epi)
        else:
            if rb1 == "G":
                cg[0].append(rj); cg[1].append(skip_epi)


def process_window(bam: AlignmentFile, rs: RefCache, conf: EpireadConf,
                   snp_table, tid: int, chrm: str, beg: int, end: int,
                   out: List[str]) -> None:
    """epiread process_func window body (epiread.c:540-1046)."""
    flank = conf.max_read_length if conf.max_read_length > 1000 else 1000
    snp_beg = beg - flank if beg > flank else 1
    snp_end = end + flank
    snps = None
    meth = None
    if snp_table is not None:
        snps = set()
        meth = set()
        if chrm in snp_table:
            for l, m in zip(*snp_table[chrm]):
                if snp_beg <= l < snp_end:
                    snps.add(l)
                    if m:
                        meth.add(l)
    rs.fetch(chrm, beg - flank if beg > flank else 1, end + flank)
    print_w_beg = (beg - conf.max_read_length) if conf.epiread_reg_start == beg else beg
    print_w_end = (end + conf.max_read_length) if conf.epiread_reg_end == end else end

    for b in bam.fetch(tid, (beg - 1) if beg > 1 else 1, end):
        if b.mapq < conf.filt.min_mapq:
            continue
        if b.l_qseq < conf.filt.min_read_len:
            continue
        if b.flag > 0:
            if conf.filt.filter_secondary and (b.flag & FLAG_SECONDARY):
                continue
            if conf.filt.filter_duplicate and (b.flag & FLAG_DUP):
                continue
            if conf.filt.filter_ppair and (b.flag & FLAG_PAIRED) and not (b.flag & FLAG_PROPER):
                continue
            if conf.filt.filter_qcfail and (b.flag & FLAG_QCFAIL):
                continue
        nm = b.get_tag("NM")
        if nm is not None and nm > conf.filt.max_nm:
            continue
        as_ = b.get_tag("AS")
        if as_ is not None and as_ < conf.filt.min_score:
            continue
        bsstrand = 0 if conf.use_modbam else get_bsstrand(rs, b, conf.filt.min_base_qual, 0)
        cnt_ret = 0 if conf.use_modbam else cnt_retention(rs, b, bsstrand)
        if cnt_ret > conf.filt.max_retention:
            continue

        if b.l_qseq >= conf.max_read_length:
            raise SystemExit(
                f"ERROR: Read (length = {b.l_qseq}) longer than max read length "
                f"({conf.max_read_length}). Rerun with larger -L value")

        snp_pc = ([], [])
        hcg = ([], [])
        gch = ([], [])
        cg = ([], [])
        L = conf.max_read_length
        rle_cg = [""] * (2 * L)
        rle_gc = [""] * (2 * L)
        rle_vr = [""] * (2 * L)
        n_del = 0
        n_ins = 0
        softclip_start = 0
        rpos0 = b.pos + 1
        rmpos = b.mpos + 1
        qpos = 0
        read_length = b.rlen()
        mc = b.get_tag("MC")
        mate_length = get_mate_length(mc) if mc is not None else read_length
        rend = rpos0 + read_length - 1
        rmend = rmpos + mate_length - 1
        seq = b.seq
        qual = b.qual
        rpos = rpos0
        mq = {}
        mstrand = 0
        mcanon = "C"
        if conf.use_modbam:
            mq, mstrand, mcanon = modbam_quals(b)

        for op, oplen in b.cigar:
            if op in (0, 7, 8):  # M/=/X
                for j in range(oplen):
                    qj = qpos + j
                    qjd = qj + n_del
                    rb = rs.getbase_upcase(rpos + j)
                    qb = seq[qj] if qj < len(seq) else "N"
                    rle_set = False
                    q = (ord(qual[qj]) - 33) if qual != "*" else 0
                    if q < conf.filt.min_base_qual:
                        _skipped_base_old(rs, rb, bsstrand, rpos + j, qj, conf, SKIP_EPI, hcg, gch, cg)
                        rle_cg[qjd] = rle_vr[qjd] = rle_gc[qjd] = FILTERED
                        continue
                    if qj + 1 <= conf.filt.min_dist_end_5p or b.l_qseq < qj + 1 + conf.filt.min_dist_end_3p:
                        _skipped_base_old(rs, rb, bsstrand, rpos + j, qj, conf, SKIP_EPI, hcg, gch, cg)
                        rle_cg[qjd] = rle_vr[qjd] = rle_gc[qjd] = FILTERED
                        continue
                    if (conf.filt.filter_doublecnt and (b.flag & FLAG_READ2)
                            and rpos + j >= max(rpos0, rmpos) and rpos + j <= min(rend, rmend)):
                        _skipped_base_old(rs, rb, bsstrand, rpos + j, qj, conf, SKIP_EPI, hcg, gch, cg)
                        rle_cg[qjd] = rle_vr[qjd] = rle_gc[qjd] = FILTERED
                        continue

                    if conf.use_modbam:
                        qv = mq.get(qj)
                        if qv is not None:
                            is_cpg = is_modbam_cpg(b.flag, mstrand, mcanon, qb, rb, rs, rpos + j)
                            prob = (qv + 0.5) / 256.0 if qv >= 0 else -1.0
                            cg[0].append(rpos + j)
                            if is_cpg and qv >= 0 and prob > conf.modbam_prob:
                                cg[1].append("C")
                                rle_cg[qjd] = METHYLAT
                                rle_set = True
                            elif is_cpg and qv >= 0 and prob < 1.0 - conf.modbam_prob:
                                cg[1].append("T")
                                rle_cg[qjd] = UNMETHYL
                                rle_set = True
                            else:
                                cg[1].append("N")
                    else:
                        if bsstrand and rb == "G" and rpos + j - 1 >= rs.beg:
                            rb0 = rs.getbase_upcase(rpos + j - 1)
                            if conf.comm.is_nome:
                                if rpos + j + 1 <= rs.end:
                                    rb1 = rs.getbase_upcase(rpos + j + 1)
                                    if rb0 == "C" and rb1 != "C":
                                        if qj > 0:
                                            hcg[0].append(rpos + j - 1)
                                        if qb == "A":
                                            hcg[1].append("T")
                                            rle_cg[qjd] = UNMETHYL
                                            rle_gc[qjd] = IGNORED
                                            rle_set = True
                                        elif qb == "G":
                                            hcg[1].append("C")
                                            rle_cg[qjd] = METHYLAT
                                            rle_gc[qjd] = IGNORED
                                            rle_set = True
                                        else:
                                            hcg[1].append("N")
                                    elif rb0 != "C" and rb1 == "C":
                                        gch[0].append(rpos + j)
                                        if qb == "A":
                                            gch[1].append("T")
                                            rle_cg[qjd] = IGNORED
                                            rle_gc[qjd] = SHUT_ACC
                                            rle_set = True
                                        elif qb == "G":
                                            gch[1].append("C")
                                            rle_cg[qjd] = IGNORED
                                            rle_gc[qjd] = OPEN_ACC
                                            rle_set = True
                                        else:
                                            gch[1].append("N")
                            else:
                                rle_gc[qjd] = IGNORED
                                if rb0 == "C":
                                    cg[0].append(rpos + j - 1)
                                    if qb == "A":
                                        cg[1].append("T")
                                        rle_cg[qjd] = UNMETHYL
                                        rle_set = True
                                    elif qb == "G":
                                        cg[1].append("C")
                                        rle_cg[qjd] = METHYLAT
                                        rle_set = True
                                    else:
                                        cg[1].append("N")
                        if (not bsstrand) and rb == "C" and rpos + j + 1 <= rs.end:
                            rb1 = rs.getbase_upcase(rpos + j + 1)
                            if conf.comm.is_nome:
                                if rpos + j - 1 >= rs.beg:
                                    rb0 = rs.getbase_upcase(rpos + j - 1)
                                    if rb0 != "G" and rb1 == "G":
                                        hcg[0].append(rpos + j)
                                        if qb == "T":
                                            hcg[1].append("T")
                                            rle_cg[qjd] = UNMETHYL
                                            rle_gc[qjd] = IGNORED
                                            rle_set = True
                                        elif qb == "C":
                                            hcg[1].append("C")
                                            rle_cg[qjd] = METHYLAT
                                            rle_gc[qjd] = IGNORED
                                            rle_set = True
                                        else:
                                            hcg[1].append("N")
                                    elif rb0 == "G" and rb1 != "G":
                                        gch[0].append(rpos + j)
                                        if qb == "T":
                                            gch[1].append("T")
                                            rle_cg[qjd] = IGNORED
                                            rle_gc[qjd] = SHUT_ACC
                                            rle_set = True
                                        elif qb == "C":
                                            gch[1].append("C")
                                            rle_cg[qjd] = IGNORED
                                            rle_gc[qjd] = OPEN_ACC
                                            rle_set = True
                                        else:
                                            gch[1].append("N")
                            else:
                                rle_gc[qjd] = IGNORED
                                if rb1 == "G":
                                    cg[0].append(rpos + j)
                                    if qb == "T":
                                        cg[1].append("T")
                                        rle_cg[qjd] = UNMETHYL
                                        rle_set = True
                                    elif qb == "C":
                                        cg[1].append("C")
                                        rle_cg[qjd] = METHYLAT
                                        rle_set = True
                                    else:
                                        cg[1].append("N")

                    # SNP check
                    if snps is not None and (rpos + j) in snps:
                        snp_pc[1].append(qb)
                        snp_pc[0].append(rpos + j)
                        if not rle_set:
                            rle_cg[qjd] = IGNORED
                            rle_gc[qjd] = IGNORED
                        if rle_set and (rpos + j) not in meth:
                            rle_cg[qjd] = IGNORED
                            rle_gc[qjd] = IGNORED
                        if bsstrand and qb == "A":
                            rle_vr[qjd] = AMBIG_GA
                        elif not bsstrand and qb == "T":
                            rle_vr[qjd] = AMBIG_CT
                        else:
                            rle_vr[qjd] = qb
                        rle_set = True
                    else:
                        rle_vr[qjd] = IGNORED
                        if not rle_set:
                            rle_cg[qjd] = IGNORED
                            rle_gc[qjd] = IGNORED
                    if not rle_set:
                        rle_cg[qjd] = IGNORED
                        rle_gc[qjd] = IGNORED
                rpos += oplen
                qpos += oplen
            elif op == 1:  # I
                for j in range(oplen):
                    qj = qpos + j
                    qjd = qj + n_del
                    qb = seq[qj] if qj < len(seq) else "N"
                    rle_vr[qjd] = qb.lower()
                    rle_cg[qjd] = SKIP_INS
                    rle_gc[qjd] = SKIP_INS
                n_ins += oplen
                qpos += oplen
            elif op == 2:  # D
                for j in range(oplen):
                    qjd = qpos + j + n_del
                    rle_cg[qjd] = SKIP_DEL
                    rle_gc[qjd] = SKIP_DEL
                    rle_vr[qjd] = DELETION
                n_del += oplen
                rpos += oplen
            elif op == 4 or op == 5:  # S (reference also hits H here via default? no: H aborts)
                if op == 5:
                    raise SystemExit(f"Unknown cigar {op}")
                for j in range(oplen):
                    qj = qpos + j
                    qjd = qj + n_del
                    if qj <= softclip_start:
                        softclip_start += 1
                    rle_cg[qjd] = SOFTCLIP
                    rle_gc[qjd] = SOFTCLIP
                    rle_vr[qjd] = SOFTCLIP
                qpos += oplen
            else:
                raise SystemExit(f"Unknown cigar {op}")

        start = b.pos + 1 - softclip_start
        end_ = start + b.l_qseq + n_del - n_ins - 1
        s_cg = "".join(rle_cg[:b.l_qseq + n_del])
        s_gc = "".join(rle_gc[:b.l_qseq + n_del])
        s_vr = "".join(rle_vr[:b.l_qseq + n_del])

        if conf.epiread_pair:
            for k in range(len(snp_pc[0])):
                sp = snp_pc[0][k]
                if not (print_w_beg <= sp < print_w_end):
                    continue
                if conf.comm.is_nome:
                    for jj in range(len(hcg[0])):
                        out.append(f"{chrm}\t{sp}\t{hcg[0][jj]}\t{snp_pc[1][k]}\t{hcg[1][jj]}\n")
                    for jj in range(len(gch[0])):
                        out.append(f"{chrm}\t{sp}\t{gch[0][jj]}\t{snp_pc[1][k]}\t{gch[1][jj]}\n")
                else:
                    for jj in range(len(cg[0])):
                        out.append(f"{chrm}\t{sp}\t{cg[0][jj]}\t{snp_pc[1][k]}\t{cg[1][jj]}\n")
        if conf.epiread_old:
            _format_old(out, b, bsstrand, chrm, conf, snps is not None,
                        print_w_beg, print_w_end, snp_pc, hcg, gch, cg)
        if not conf.epiread_pair and not conf.epiread_old:
            _format_epibed(out, b, bsstrand, chrm, conf, print_w_beg, print_w_end,
                           s_cg, s_gc, s_vr, b.pos + 1, start, end_)


def _format_old(out, b, bsstrand, chrm, conf, have_snps, print_w_beg,
                print_w_end, snp_pc, hcg, gch, cg):
    """format_epiread_old (epiread.c:285-421)."""
    def emit(groups):
        out.append("%s\t%s\t%c\t%c" % (chrm, b.qname,
                                       "2" if (b.flag & FLAG_READ2) else "1",
                                       "-" if bsstrand else "+"))
        for (positions, chars) in groups:
            if positions is not None and len(positions) > 0:
                out.append(f"\t{positions[0] - 1}")
                if conf.print_all_locations:
                    for p in positions[1:]:
                        out.append(f",{p - 1}")
                out.append("\t" + "".join(chars))
            elif positions is not None:
                out.append("\t.\t.")
        # snp columns
        if len(snp_pc[0]) > 0:
            out.append(f"\t{snp_pc[0][0] - 1}")
            if conf.print_all_locations:
                for p in snp_pc[0][1:]:
                    out.append(f",{p - 1}")
            out.append("\t" + "".join(snp_pc[1]))
        elif have_snps:
            out.append("\t.\t.")
        else:
            out.append("\t\t")
        out.append("\n")

    if conf.comm.is_nome:
        first_epi = 0
        if hcg[0] and gch[0]:
            first_epi = min(hcg[0][0], gch[0][0])
        elif hcg[0]:
            first_epi = hcg[0][0]
        elif gch[0]:
            first_epi = gch[0][0]
        if first_epi > 0 and print_w_beg <= first_epi < print_w_end:
            emit([(hcg[0], hcg[1]), (gch[0], gch[1])])
    else:
        cg_start = cg[0][0] if cg[0] else 0
        if cg_start > 0 and print_w_beg <= cg_start < print_w_end:
            emit([(cg[0], cg[1])])


def _format_epibed(out, b, bsstrand, chrm, conf, print_w_beg, print_w_end,
                   s_cg, s_gc, s_vr, w_start, start, end_):
    """format_epi_bed (epiread.c:195-281)."""
    if not (w_start > 0 and print_w_beg <= w_start < print_w_end):
        return
    write_cg = write_gc = write_vr = True
    if conf.filter_empty_epiread:
        filt = set("FxP")
        write_cg = not all(c in filt for c in s_cg)
        write_vr = not all(c in filt for c in s_vr)
        if conf.comm.is_nome:
            write_gc = not all(c in filt for c in s_gc)
        else:
            write_gc = False
    if write_cg or write_gc or write_vr:
        if start <= 0:
            print(f"WARNING: Softclip-adjusted start position < 0 ({start - 1}). "
                  f"Skipping read {b.qname}", file=sys.stderr)
            return
        out.append("%s\t%d\t%d\t%s\t%c\t%c" % (
            chrm, start - 1, end_, b.qname,
            "2" if (b.flag & FLAG_READ2) else "1",
            "-" if bsstrand else "+"))
        out.append("\t" + run_length_encode(s_cg))
        if conf.comm.is_nome:
            out.append("\t" + run_length_encode(s_gc))
        else:
            out.append("\t.")
        out.append("\t" + run_length_encode(s_vr))
        out.append("\n")


def process_window_native(rawbam, rs: RefCache, conf: EpireadConf,
                          snp_table, tid: int, chrm: str, beg: int, end: int,
                          out: List[str]) -> None:
    """epiBED window via the C++ raw-BAM engine (bt_epiread_window_raw);
    byte-identical to process_window for the default output mode."""
    import ctypes as C

    import numpy as np

    from .. import native
    from ..pileup.native import ConfC

    L = native.lib()  # argtypes/restype centralized in native._declare

    flank = conf.max_read_length if conf.max_read_length > 1000 else 1000
    snp_beg = beg - flank if beg > flank else 1
    snp_end = end + flank
    if snp_table is not None and chrm in snp_table:
        locs, meths = snp_table[chrm]
        la = np.asarray(locs, np.int64)
        ma = np.asarray(meths, np.uint8)
        m = (la >= snp_beg) & (la < snp_end)
        order = np.argsort(la[m], kind="stable")
        snp_locs = np.ascontiguousarray(la[m][order])
        snp_meth = np.ascontiguousarray(ma[m][order])
    else:
        snp_locs = np.zeros(1, np.int64)
        snp_meth = np.zeros(1, np.uint8)
    n_snps = len(snp_locs) if (snp_table is not None and chrm in snp_table) else 0
    rs.fetch(chrm, beg - flank if beg > flank else 1, end + flank)
    print_w_beg = (beg - conf.max_read_length) if conf.epiread_reg_start == beg else beg
    print_w_end = (end + conf.max_read_length) if conf.epiread_reg_end == end else end

    from ..pileup.native import RawBamStream
    if isinstance(rawbam, RawBamStream):
        blob, sel = rawbam.window_blob(tid, beg, end)
        if not blob:
            blob = b"\0"
    else:
        blob = rawbam.data
        sel = np.ascontiguousarray(rawbam.window_offsets(tid, beg, end),
                                   np.int64)
    out_buf = C.c_void_p()
    out_len = C.c_int64()
    cc = ConfC()
    f = conf.filt
    cc.min_base_qual = f.min_base_qual
    cc.min_read_len = f.min_read_len
    cc.min_dist_end_5p = f.min_dist_end_5p
    cc.min_dist_end_3p = f.min_dist_end_3p
    cc.min_mapq = f.min_mapq
    cc.min_score = f.min_score
    cc.max_nm = f.max_nm
    cc.max_retention = f.max_retention
    cc.filter_ppair = f.filter_ppair
    cc.filter_secondary = f.filter_secondary
    cc.filter_duplicate = f.filter_duplicate
    cc.filter_qcfail = f.filter_qcfail
    cc.filter_doublecnt = f.filter_doublecnt
    mode = 2 if conf.epiread_pair else (1 if conf.epiread_old else 0)
    rc = L.bt_epiread_window_raw(
        C.byref(cc), conf.comm.is_nome, conf.filter_empty_epiread,
        conf.max_read_length, mode, conf.print_all_locations,
        1 if snp_table is not None else 0,
        conf.use_modbam, C.c_double(conf.modbam_prob), chrm.encode(),
        rs.arr.ctypes.data_as(C.c_void_p), rs.seqlen,
        C.c_int64(rs.beg), C.c_int64(rs.end),
        C.c_int64(beg), C.c_int64(end),
        C.c_int64(print_w_beg), C.c_int64(print_w_end),
        blob, len(blob) if len(sel) else 0,
        sel.ctypes.data_as(C.c_void_p), C.c_int64(len(sel)),
        snp_locs.ctypes.data_as(C.c_void_p),
        snp_meth.ctypes.data_as(C.c_void_p),
        C.c_int64(n_snps),
        C.byref(out_buf), C.byref(out_len))
    if rc == -2:
        raise SystemExit(
            f"ERROR: Read longer than max read length "
            f"({conf.max_read_length}). Rerun with larger -L value")
    if rc == -4:
        raise SystemExit("ERROR: must be a methylation modification ('m')")
    if rc == -5:
        raise SystemExit("ERROR: modification must fall on a C or G")
    if rc != 0:
        raise RuntimeError(f"bt_epiread_window_raw rc={rc}")
    try:
        out.append(C.string_at(out_buf, out_len.value).decode())
    finally:
        L.bt_buf_free(out_buf)


_EP_POOL = None


def _ep_window1(job):
    tid, name, wbeg, wend, is_last = job
    bam, rs, conf, snp_table = _EP_POOL
    if is_last:
        conf.epiread_reg_end = wend
    out: List[str] = []
    from ..pileup.native import RawBamBase
    fn = (process_window_native if isinstance(bam, RawBamBase)
          else process_window)
    try:
        fn(bam, rs, conf, snp_table, tid, name, wbeg, wend, out)
    except SystemExit as e:
        # SystemExit would kill the worker before the result ships and
        # deadlock imap; surface it as a regular exception instead
        raise RuntimeError(str(e)) from None
    return "".join(out)


def run_epiread_windows_pooled(bam, rs, conf, snp_table, windows):
    """Yield each window's output text in order, computed by a fork pool of
    conf.bt.n_threads workers (copy-on-write shares bam/ref/snp table)."""
    global _EP_POOL
    _EP_POOL = (bam, rs, conf, snp_table)
    import multiprocessing as mp
    ctx = mp.get_context("fork")
    n_procs = min(conf.bt.n_threads, len(windows))
    try:
        with ctx.Pool(n_procs) as pool:
            yield from pool.imap(_ep_window1, windows, chunksize=1)
    finally:
        _EP_POOL = None


def main(argv):
    conf = EpireadConf()
    reg = None
    snp_bed = None
    outfn = None
    # optstring mirrors the reference (epiread.c:1226)
    opts, args = getopt.getopt(argv, "B:g:s:@:o:NL:My:EPOAb:m:a:t:l:5:3:n:cdupvh")
    for o, a in opts:
        c = o[1]
        if c == "B": snp_bed = a
        elif c == "g": reg = a
        elif c == "s": conf.bt.step = int(a)
        elif c == "@": conf.bt.n_threads = int(a)
        elif c == "o": outfn = a
        elif c == "N": conf.comm.is_nome = 1
        elif c == "L": conf.max_read_length = int(a)
        elif c == "M": conf.use_modbam = 1
        elif c == "P": conf.epiread_pair = 1
        elif c == "O": conf.epiread_old = 1
        elif c == "A": conf.print_all_locations = 1
        elif c == "b": conf.filt.min_base_qual = int(a)
        elif c == "m": conf.filt.min_mapq = int(a)
        elif c == "a": conf.filt.min_score = int(a)
        elif c == "t": conf.filt.max_retention = int(a)
        elif c == "l": conf.filt.min_read_len = int(a)
        elif c == "5": conf.filt.min_dist_end_5p = int(a)
        elif c == "3": conf.filt.min_dist_end_3p = int(a)
        elif c == "c": conf.filt.filter_secondary = 0
        elif c == "d": conf.filt.filter_doublecnt = 0
        elif c == "u": conf.filt.filter_duplicate = 0
        elif c == "p": conf.filt.filter_ppair = 0
        elif c == "n": conf.filt.max_nm = int(a)
        elif c == "y": conf.modbam_prob = float(a)
        elif c == "E": conf.filter_empty_epiread = 0
        elif c == "v": conf.comm.verbose = 1
        elif c == "h":
            print("Usage: biscuit_tpu epiread [options] <ref.fa> <in.bam>", file=sys.stderr)
            return 1
    if len(args) < 2:
        print("Please provide reference and input bam.", file=sys.stderr)
        return 1
    if conf.epiread_old and conf.epiread_pair:
        print("-O and -P are not compatible", file=sys.stderr)
        return 1
    if conf.use_modbam and conf.comm.is_nome:
        # The reference SEGFAULTS on -M -N (epiread.c:761: the modBAM branch
        # pushes into cg_p, which is NULL in NOMe mode) and modBAM 'm' calls
        # carry no GC-accessibility channel, so there are no semantics to
        # implement. Refuse cleanly instead of emitting empty output.
        print("-M and -N are not compatible: modBAM methylation calls carry "
              "no NOMe GC-accessibility channel", file=sys.stderr)
        return 1
    if not (0.0 <= conf.modbam_prob <= 1.0):
        print("Minimum modification probability must be between 0.0 and 1.0",
              file=sys.stderr)
        return 1
    reffn, bamfn = args[0], args[1]
    snp_table = read_episnp(snp_bed) if snp_bed else None
    # default epiBED mode on BAM input runs on the C++ raw-record engine;
    # modBAM (-M) runs natively too (MM/ML parsed in parse_raw).
    # -M -N is rejected above (the reference segfaults on it).
    import os as _os
    from ..io.sambam import _is_bam
    use_native = (_os.environ.get("BISCUIT_TPU_TORCH_PILEUP", "native") == "native"
                  and _is_bam(bamfn))
    if use_native:
        from ..pileup.native import raw_bam_open
        bam = raw_bam_open(bamfn)
    else:
        bam = AlignmentFile(bamfn)
    hdr = bam.header
    rs = RefCache(reffn)
    out_f = open(outfn, "w") if outfn else sys.stdout
    out: List[str] = []
    step = conf.bt.step
    if reg:
        if ":" in reg:
            name, rng = reg.split(":", 1)
            beg, end = rng.replace(",", "").split("-")
            beg, end = int(beg), int(end)
        else:
            name, beg, end = reg, 0, 1 << 29
        tid = hdr.name2tid(name)
        beg += 1
        beg = max(beg, 1)
        end = min(end, hdr.lengths[tid])
        conf.epiread_reg_start = beg
        wbeg = beg
        windows = []
        while wbeg < end:
            wend = min(wbeg + step, end)
            windows.append((tid, hdr.names[tid], wbeg, wend,
                            wend == end))
            wbeg += step
    else:
        targets = sorted(range(len(hdr.names)), key=lambda t: hdr.names[t])
        windows = []
        for t in targets:
            tlen = hdr.lengths[t]
            wbeg = 1
            while wbeg < tlen:
                windows.append((t, hdr.names[t], wbeg, min(wbeg + step, tlen),
                                False))
                wbeg += step

    if conf.bt.n_threads > 1 and len(windows) > 1:
        # window fork pool, ordered output (the reference runs epiread on the
        # same wqueue/record-shelf runtime as pileup; epiread.c:540,1153)
        try:
            for text in run_epiread_windows_pooled(bam, rs, conf, snp_table,
                                                   windows):
                out.append(text)
        except RuntimeError as e:
            raise SystemExit(str(e))
    else:
        for tid_, name_, wbeg_, wend_, is_last in windows:
            if is_last:
                conf.epiread_reg_end = wend_
            fn = process_window_native if use_native else process_window
            fn(bam, rs, conf, snp_table, tid_, name_, wbeg_, wend_, out)
    out_f.write("".join(out))
    if out_f is not sys.stdout:
        out_f.close()
    return 0
