"""biscuit cinread port (src/cinread.c): long-form
per-cytosine-in-read table; feeds read-position retention QC.

Copy of biscuit_tpu/subcmds/cinread.py with only this docstring changed: its
imports are relative, and resolve to the port's own modules.
tests/test_torch_engine.py holds the copy to its source.
"""
import getopt
import sys
from dataclasses import dataclass, field

import numpy as np

from ..io.sambam import (AlignmentFile, AlnRecord, FLAG_READ2, FLAG_REVERSE,
                         FLAG_SECONDARY, FLAG_UNMAP)
from ..pileup.common import (RefCache, aligned_bases_np, fivenuc_context,
                             get_bsstrand)

_COMP_TBL_NP = np.full(256, ord("N"), np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("G", "C"), ("T", "A")):
    _COMP_TBL_NP[ord(_a)] = ord(_b)

TP_NAMES = ["QNAME", "QPAIR", "STRAND", "BSSTRAND", "MAPQ", "QBEG", "QEND",
            "CHRM", "CRPOS", "CGRPOS", "CQPOS", "CRBASE", "CCTXT", "CQBASE",
            "CRETENTION"]
TGT_NAMES = ["c", "cg", "ch", "hcg", "gch", "hch"]
SL_C, SL_CG, SL_CH, SL_HCG, SL_GCH, SL_HCH = range(6)
CIN_READ_LEN = 301


@dataclass
class CinreadConf:
    tgt: int = SL_CG
    tp_names: list = field(default_factory=lambda: ["QNAME", "QPAIR", "BSSTRAND",
                                                    "CRBASE", "CQBASE"])
    skip_secondary: int = 1
    skip_printing: int = 0


@dataclass
class CinreadData:
    # [read-in-pair, qpos (<= CIN_READ_LEN), state C/R/N] counters
    counts: "np.ndarray" = field(
        default_factory=lambda: np.zeros((2, CIN_READ_LEN + 2, 3), np.int64))


def _cinread_counts_vec(b, rs, conf, d, bsstrand) -> None:
    """Vectorized count accumulation (the qc path, skip_printing=1): the
    fivenuc[1]/[3] context characters reduce to prev/next ref-base lookups
    (see fivenuc_context, pileup/common.py:111)."""
    rp, qp = aligned_bases_np(b)
    if not len(rp):
        return
    arr = rs.arr
    n = rs.seqlen
    qarr = np.frombuffer(b.seq.encode(), dtype=np.uint8)
    qb = np.where(qp < len(qarr), qarr[np.minimum(qp, len(qarr) - 1)],
                  ord("N"))
    rbv = np.where((rp >= 1) & (rp <= n), arr[np.minimum(rp, n) - 1],
                   ord("N"))
    prev = np.where(rp - 1 >= 1, arr[np.maximum(rp - 2, 0)], ord("N"))
    nxt = np.where(rp + 1 <= n, arr[np.minimum(rp, n - 1)], ord("N"))
    if bsstrand:
        site = rbv == ord("G")
        f3 = _COMP_TBL_NP[prev]     # fivenuc[3] after revcomp
        f1 = _COMP_TBL_NP[nxt]      # fivenuc[1] after revcomp
        ret = np.where(qb == ord("G"), 1, np.where(qb == ord("A"), 0, 2))
    else:
        site = rbv == ord("C")
        f3 = nxt
        f1 = prev
        ret = np.where(qb == ord("C"), 1, np.where(qb == ord("T"), 0, 2))
    G = ord("G")
    if conf.tgt == SL_C:
        tgt = np.ones(len(rp), bool)
    elif conf.tgt == SL_CG:
        tgt = f3 == G
    elif conf.tgt == SL_CH:
        tgt = f3 != G
    elif conf.tgt == SL_HCG:
        tgt = (f3 == G) & (f1 != G)
    elif conf.tgt == SL_GCH:
        tgt = (f3 != G) & (f1 == G)
    else:  # SL_HCH
        tgt = (f3 != G) & (f1 != G)
    # leading hard clips extend the effective l_qseq like the scalar walk
    l_eff = b.l_qseq + (b.cigar[0][1] if b.cigar and b.cigar[0][0] == 5 else 0)
    idx_qpos = np.where(b.flag & FLAG_REVERSE, l_eff - qp, qp)
    mask = site & tgt & (idx_qpos <= CIN_READ_LEN)
    idx_read = 1 if (b.flag & FLAG_READ2) else 0
    np.add.at(d.counts, (idx_read, idx_qpos[mask], ret[mask]), 1)


def cinread_func(b: AlnRecord, rs: RefCache, conf: CinreadConf,
                 d: CinreadData, names, out) -> None:
    if b.flag & FLAG_UNMAP:
        return
    if conf.skip_secondary and (b.flag & FLAG_SECONDARY):
        return
    rs.fetch(names[b.tid], max(1, b.pos - 10), b.pos + b.rlen() + 10)
    bsstrand = get_bsstrand(rs, b, 0, 0)
    if conf.skip_printing:  # counts only (the qc path): vectorized
        _cinread_counts_vec(b, rs, conf, d, bsstrand)
        return
    seq = b.seq
    l_qseq = b.l_qseq
    rpos = b.pos + 1
    qpos = 0
    for op, oplen in b.cigar:
        if op in (0, 7, 8):
            for j in range(oplen):
                rb = rs.getbase_upcase(rpos + j)
                if rb not in ("C", "G"):
                    continue
                if bsstrand and rb == "C":
                    continue
                if not bsstrand and rb == "G":
                    continue
                _ctxt, fivenuc = fivenuc_context(rs, rpos + j, rb)
                is_tgt = False
                if conf.tgt == SL_C:
                    is_tgt = True
                elif conf.tgt == SL_CG:
                    is_tgt = fivenuc[3] == "G"
                elif conf.tgt == SL_CH:
                    is_tgt = fivenuc[3] != "G"
                elif conf.tgt == SL_HCG:
                    is_tgt = fivenuc[3] == "G" and fivenuc[1] != "G"
                elif conf.tgt == SL_GCH:
                    is_tgt = fivenuc[3] != "G" and fivenuc[1] == "G"
                elif conf.tgt == SL_HCH:
                    is_tgt = fivenuc[3] != "G" and fivenuc[1] != "G"
                if not is_tgt:
                    continue
                qb = (seq[qpos + j] if qpos + j < len(seq) else "N").upper()
                if bsstrand and rb == "G":
                    retention = "R" if qb == "G" else ("C" if qb == "A" else "N")
                elif not bsstrand and rb == "C":
                    retention = "R" if qb == "C" else ("C" if qb == "T" else "N")
                else:
                    retention = "N"
                idx_read = 1 if (b.flag & FLAG_READ2) else 0
                idx_qpos = (l_qseq - qpos - j) if (b.flag & FLAG_REVERSE) else (qpos + j)
                idx_retn = {"C": 0, "R": 1}.get(retention, 2)
                if idx_qpos > CIN_READ_LEN:
                    continue
                d.counts[idx_read, idx_qpos, idx_retn] += 1
                if not conf.skip_printing:
                    cols = []
                    for name in conf.tp_names:
                        if name == "QNAME":
                            cols.append(b.qname)
                        elif name == "QPAIR":
                            cols.append("2" if (b.flag & FLAG_READ2) else "1")
                        elif name == "QBEG":
                            cols.append(str(b.pos + 1))
                        elif name == "QEND":
                            cols.append(str(b.pos + b.rlen()))
                        elif name == "STRAND":
                            cols.append("-" if (b.flag & FLAG_REVERSE) else "+")
                        elif name == "BSSTRAND":
                            cols.append("-" if bsstrand else "+")
                        elif name == "MAPQ":
                            cols.append(str(b.mapq))
                        elif name == "CHRM":
                            cols.append(names[b.tid])
                        elif name == "CRPOS":
                            cols.append(str(rpos + j))
                        elif name == "CGRPOS":
                            if fivenuc[3] == "G":
                                cols.append(str(rpos + j) if rb == "C" else str(rpos + j - 1))
                            else:
                                cols.append("-1")
                        elif name == "CQPOS":
                            cols.append(str((l_qseq - qpos - j) if (b.flag & FLAG_REVERSE) else (qpos + j)))
                        elif name == "CRBASE":
                            cols.append(rb)
                        elif name == "CCTXT":
                            cols.append(fivenuc[:5])
                        elif name == "CQBASE":
                            cols.append(qb)
                        elif name == "CRETENTION":
                            cols.append(retention)
                    out.write("\t".join(cols) + "\n")
            rpos += oplen
            qpos += oplen
        elif op == 1 or op == 4:
            qpos += oplen
        elif op == 2:
            rpos += oplen
        elif op == 5:
            qpos += oplen
            l_qseq += oplen  # c->l_qseq excludes hard clips; add back
        else:
            raise SystemExit(f"Unknown cigar, {op}")


def main(argv):
    conf = CinreadConf()
    reg = None
    outfn = None
    tgt_str = None
    tp_str = None
    opts, args = getopt.getopt(argv, "g:o:t:p:sh")
    for o, a in opts:
        if o == "-g": reg = a
        elif o == "-o": outfn = a
        elif o == "-t": tgt_str = a
        elif o == "-p": tp_str = a
        elif o == "-s": conf.skip_secondary = 0
        elif o == "-h":
            print("Usage: biscuit_tpu cinread [options] <ref.fa> <in.bam>",
                  file=sys.stderr)
            return 1
    if tgt_str:
        if tgt_str not in TGT_NAMES:
            print(f"Target name {tgt_str} unrecognized.", file=sys.stderr)
            return 1
        conf.tgt = TGT_NAMES.index(tgt_str)
    if tp_str:
        conf.tp_names = []
        for p in tp_str.split(","):
            if p not in TP_NAMES:
                print(f"Print name {p} unrecognized.", file=sys.stderr)
                return 1
            conf.tp_names.append(p)
    if len(args) < 2:
        print("Please provide reference and input bam.", file=sys.stderr)
        return 1
    rs = RefCache(args[0])
    bam = AlignmentFile(args[1])
    out = open(outfn, "w") if outfn else sys.stdout
    d = CinreadData()
    it = bam
    if reg:
        name = reg.split(":")[0]
        tid = bam.header.name2tid(name)
        if ":" in reg:
            rng = reg.split(":", 1)[1].replace(",", "")
            beg, end = (int(x) for x in rng.split("-"))
        else:
            beg, end = 0, 1 << 29
        it = bam.fetch(tid, beg, end)
    for b in it:
        cinread_func(b, rs, conf, d, bam.header.names, out)
    if outfn:
        out.close()
    return 0
