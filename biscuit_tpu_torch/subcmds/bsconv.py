"""biscuit bsconv port (src/bsconv.c): per-read
retention/conversion counts stratified by 2-base context (CpA/C/G/T), read
filtering by CpH retention, ZN tag annotation or tab output.

Copy of biscuit_tpu/subcmds/bsconv.py with only this docstring changed: its
imports are relative, and resolve to the port's own modules.
tests/test_torch_engine.py holds the copy to its source.
"""
import getopt
import sys
from dataclasses import dataclass, field

import numpy as np

from ..io.sambam import (AlignmentFile, AlnRecord, FLAG_QCFAIL, FLAG_UNMAP,
                         format_sam_record, write_bam, write_sam)
from ..pileup.common import (RefCache, aligned_bases_np, char_to_int8,
                             fivenuc_context, get_bsstrand,
                             iter_aligned_bases)

# byte-level complement and base-code tables for the vectorized count path
_COMP_TBL_NP = np.full(256, ord("N"), np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("G", "C"), ("T", "A")):
    _COMP_TBL_NP[ord(_a)] = ord(_b)
_CHAR2INT8_NP = np.full(256, 4, np.int64)  # N bucket
for _i, _c in enumerate("ACGT"):
    _CHAR2INT8_NP[ord(_c)] = _i


@dataclass
class BsconvConf:
    max_cph: int = -1
    max_cpa: int = -1
    max_cpc: int = -1
    max_cpt: int = -1
    max_cpy: int = -1
    max_cph_frac: float = 1.0
    max_cpy_frac: float = 1.0
    filter_u: int = 0
    show_filtered: int = 0
    print_in_tab: int = 0
    no_printing: int = 0


@dataclass
class BsconvData:
    n: int = 0
    n_filtered: int = 0
    retn_conv_counts: list = field(default_factory=lambda: [0] * 8)


A, C, G, T = 0, 1, 2, 3


def bsconv_func(b: AlnRecord, rs: RefCache, conf: BsconvConf, d: BsconvData,
                names):
    """Returns (tofilter, retn[4], conv[4]) and updates d; caller handles
    output."""
    retn = [0] * 5
    conv = [0] * 5
    tofilter = 0
    if (b.flag & FLAG_UNMAP) or (b.flag & FLAG_QCFAIL):
        tofilter = 1
    else:
        rs.fetch(names[b.tid], max(1, b.pos - 10), b.pos + b.rlen() + 10)
        bsstrand = get_bsstrand(rs, b, 0, conf.filter_u)
        if bsstrand == 2:
            tofilter = 1
        else:
            # vectorized context-stratified retention/conversion counting.
            # fivenuc[3] reduces to: BSW (rb=C) -> the next ref base;
            # BSC (rb=G) -> complement of the previous ref base (the 5-mer
            # is revcomped); chromosome ends yield 'N' (common.py:111).
            rp, qp = aligned_bases_np(b)
            if len(rp):
                qarr = np.frombuffer(b.seq.encode(), dtype=np.uint8)
                qb = np.where(qp < len(qarr),
                              qarr[np.minimum(qp, len(qarr) - 1)], ord("N"))
                arr = rs.arr
                n = rs.seqlen
                rbv = np.where((rp >= 1) & (rp <= n),
                               arr[np.minimum(rp, n) - 1], ord("N"))
                if bsstrand:
                    site = rbv == ord("G")
                    nxt = np.where(rp - 1 >= 1,
                                   _COMP_TBL_NP[arr[np.maximum(rp - 2, 0)]],
                                   ord("N"))
                    is_ret = qb == ord("G")
                    is_conv = qb == ord("A")
                else:
                    site = rbv == ord("C")
                    nxt = np.where(rp + 1 <= n, arr[np.minimum(rp, n - 1)],
                                   ord("N"))
                    is_ret = qb == ord("C")
                    is_conv = qb == ord("T")
                code = _CHAR2INT8_NP[nxt]
                retn_a = np.zeros(5, np.int64)
                conv_a = np.zeros(5, np.int64)
                np.add.at(retn_a, code[site & is_ret], 1)
                np.add.at(conv_a, code[site & is_conv], 1)
                for i in range(5):
                    retn[i] += int(retn_a[i])
                    conv[i] += int(conv_a[i])
            if conf.max_cpa >= 0 and retn[A] > conf.max_cpa:
                tofilter = 1
            if conf.max_cpc >= 0 and retn[C] > conf.max_cpc:
                tofilter = 1
            if conf.max_cpt >= 0 and retn[T] > conf.max_cpt:
                tofilter = 1
            if conf.max_cph >= 0 and retn[A] + retn[C] + retn[T] > conf.max_cph:
                tofilter = 1
            if conf.max_cpy >= 0 and retn[C] + retn[T] > conf.max_cpy:
                tofilter = 1
            if conf.max_cph_frac < 1.0:
                r = retn[A] + retn[C] + retn[T]
                cv = conv[A] + conv[C] + conv[T]
                if r + cv > 0 and r / (r + cv) > conf.max_cph_frac:
                    tofilter = 1
            if conf.max_cpy_frac < 1.0:
                r = retn[C] + retn[T]
                cv = conv[C] + conv[T]
                if r + cv > 0 and r / (r + cv) > conf.max_cpy_frac:
                    tofilter = 1
    d.n += 1
    if tofilter:
        d.n_filtered += 1
    show = tofilter
    if conf.show_filtered:
        show = not tofilter
    if show:
        return None  # filtered out
    if conf.no_printing:
        for i in range(4):
            d.retn_conv_counts[2 * i] += retn[i]
            d.retn_conv_counts[2 * i + 1] += conv[i]
        return None
    return retn, conv


def main(argv):
    conf = BsconvConf()
    reg = None
    opts, args = getopt.getopt(argv, "g:m:a:c:f:y:pt:x:uvh")
    for o, a in opts:
        cc = o[1]
        if cc == "g": reg = a
        elif cc == "m": conf.max_cph = int(a)
        elif cc == "f": conf.max_cph_frac = float(a)
        elif cc == "x": conf.max_cpy = int(a)
        elif cc == "y": conf.max_cpy_frac = float(a)
        elif cc == "a": conf.max_cpa = int(a)
        elif cc == "c": conf.max_cpc = int(a)
        elif cc == "t": conf.max_cpt = int(a)
        elif cc == "u": conf.filter_u = 1
        elif cc == "p": conf.print_in_tab = 1
        elif cc == "v": conf.show_filtered = 1
        elif cc == "h":
            print("Usage: biscuit_tpu bsconv [options] <ref.fa> <in.bam> [out.bam]",
                  file=sys.stderr)
            return 1
    if len(args) < 2:
        print("Please provide reference and input bam.", file=sys.stderr)
        return 1
    reffn, infn = args[0], args[1]
    outfn = args[2] if len(args) > 2 else "-"
    rs = RefCache(reffn)
    bam = AlignmentFile(infn)
    d = BsconvData()
    out_records = []
    if outfn == "-":
        # reference streams SAM text to stdout *with* the header
        # (bamfilter.c:37-41 writes it whenever ofn is given, incl. "-"),
        # even in -p tab mode where the tab rows then follow it
        for line in bam.header.lines:
            sys.stdout.write(line + "\n")
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
        res = bsconv_func(b, rs, conf, d, bam.header.names)
        if res is None:
            continue
        retn, conv = res
        if conf.print_in_tab:
            cols = []
            for i in range(4):
                cols.append(f"{retn[i]}\t{conv[i]}")
            sys.stdout.write("\t".join(cols) + f"\t{b.qname}\n")
        else:
            zn = ",".join("C%c_R%dC%d" % ("ACGTN"[i], retn[i], conv[i])
                          for i in range(4))
            b.tags["ZN"] = ("Z", zn)
            if outfn == "-":
                sys.stdout.write(format_sam_record(b, bam.header) + "\n")
            else:
                out_records.append(b)
    if outfn not in ("-", None) and not conf.print_in_tab:
        if outfn.endswith(".sam"):
            write_sam(outfn, bam.header, out_records)
        else:
            write_bam(outfn, bam.header, out_records)
    print(f"\n[main_bsconv] Processed {d.n} reads, {d.n - d.n_filtered} "
          f"({(d.n - d.n_filtered) / d.n * 100 if d.n else 0:f}%) remains.",
          file=sys.stderr)
    return 0
