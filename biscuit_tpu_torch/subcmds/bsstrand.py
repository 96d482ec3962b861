"""biscuit bsstrand port (src/bsstrand.c): recompute
bisulfite strand from nC2T/nG2A, compare with YD/ZS/XG tags, optionally
correct YD and append YC/YG counts.

Copy of biscuit_tpu/subcmds/bsstrand.py with only this docstring changed:
its imports are relative, and resolve to the port's own modules.
tests/test_torch_engine.py holds the copy to its source.
"""
import getopt
import sys
from dataclasses import dataclass, field

import numpy as np

from ..io.sambam import (AlignmentFile, AlnRecord, FLAG_READ1, FLAG_REVERSE,
                         FLAG_UNMAP, write_bam, write_sam)
from ..pileup.common import RefCache, aligned_bases_np, iter_aligned_bases

TAG_BSW, TAG_BSC, TAG_CONFLICT, TAG_UNKNOWN = 0, 1, 2, 3
CONVERSION_TAGS = "frcu"


def bam_tag_get_bsstrand(b: AlnRecord) -> int:
    """bsstrand.c:29-57 (note: ZS has priority here, unlike get_bsstrand)."""
    zs = b.get_tag("ZS")
    if zs is not None:
        s = str(zs)
        if s.startswith("+"):
            return TAG_BSW
        if s.startswith("-"):
            return TAG_BSC
    yd = b.get_tag("YD")
    if yd is not None:
        if yd == "f":
            return TAG_BSW
        if yd == "r":
            return TAG_BSC
        if yd == "c":
            return TAG_CONFLICT
        if yd == "u":
            return TAG_UNKNOWN
    xg = b.get_tag("XG")
    if xg is not None:
        if xg == "CT":
            return TAG_BSW
        if xg == "GA":
            return TAG_BSC
    return TAG_UNKNOWN


@dataclass
class BsstrandData:
    n_mapped: int = 0
    n_unmapped: int = 0
    n_corr: int = 0
    confusion: list = field(default_factory=lambda: [0] * 16)
    strandcnt: list = field(default_factory=lambda: [0] * 16)


def bsstrand_func(b: AlnRecord, rs: RefCache, d: BsstrandData, names,
                  correct_bsstrand: bool, output_count: bool) -> None:
    if b.flag & FLAG_UNMAP:
        d.n_unmapped += 1
        return
    rs.fetch(names[b.tid], max(b.pos, 1), b.pos + b.rlen() + 1)
    # vectorized C2T/G2A count (was a per-base Python walk)
    rp, qp = aligned_bases_np(b)
    qarr = np.frombuffer(b.seq.encode(), dtype=np.uint8)
    qb = np.where(qp < len(qarr), qarr[np.minimum(qp, len(qarr) - 1)],
                  ord("N"))
    valid = (rp >= 1) & (rp <= rs.seqlen)
    rb = np.where(valid, rs.arr[np.minimum(rp, rs.seqlen) - 1], ord("N"))
    nC2T = int(np.count_nonzero((rb == ord("C")) & (qb == ord("T"))))
    nG2A = int(np.count_nonzero((rb == ord("G")) & (qb == ord("A"))))
    if nC2T == 0 and nG2A == 0:
        bsstrand = TAG_UNKNOWN
    else:
        # NB: reference computes s with INTEGER division (min/max typeof
        # macros on ints), so s is 0 unless nC2T == nG2A (bsstrand.c:117)
        s = min(nG2A, nC2T) // max(nG2A, nC2T)
        if nC2T > nG2A:
            bsstrand = TAG_BSW if (nG2A == 0 or s <= 0.5) else TAG_CONFLICT
        else:
            bsstrand = TAG_BSC if (nC2T == 0 or s <= 0.5) else TAG_CONFLICT
    tag = bam_tag_get_bsstrand(b)
    d.confusion[tag * 4 + bsstrand] += 1
    if correct_bsstrand:
        if b.get_tag("YD") is not None:
            if bsstrand != tag:
                b.tags["YD"] = ("A", CONVERSION_TAGS[bsstrand])
                d.n_corr += 1
        else:
            b.tags["YD"] = ("A", CONVERSION_TAGS[bsstrand])
    d.strandcnt[(0 if b.flag & FLAG_READ1 else 1) * 8 +
                (1 if b.flag & FLAG_REVERSE else 0) * 4 + tag] += 1
    if output_count:
        b.tags["YC"] = ("i", nC2T)
        b.tags["YG"] = ("i", nG2A)
    d.n_mapped += 1


def print_report(d: BsstrandData, err=sys.stderr) -> None:
    """bsstrand.c:221-263 stats output."""
    p = lambda *a, **k: print(*a, file=err, **k)
    p(f"Mapped reads: {d.n_mapped}")
    p(f"Unmapped reads: {d.n_unmapped}")
    pct = (d.n_corr / d.n_mapped * 100.0) if d.n_mapped else 0.0
    p(f"Corrected reads: {d.n_corr} ({pct:.2f}%)")
    p("\nStrand Distribution:")
    p("strand\\BS      BSW (f)      BSC (r)")
    for label, off in (("     R1 (f):   ", 0), ("     R1 (r):   ", 4),
                       ("     R2 (f):   ", 8), ("     R2 (r):   ", 12)):
        p(label + "".join("%-13d" % d.strandcnt[off + i] for i in range(2)))
    p("")
    for i in range(2):
        p(f"\nR{i+1} mapped to OT/OB:   "
          f"{d.strandcnt[i*8+0*4+TAG_BSW] + d.strandcnt[i*8+1*4+TAG_BSC]}", end="")
        p(f"\nR{i+1} mapped to CTOT/CTOB: "
          f"{d.strandcnt[i*8+1*4+TAG_BSW] + d.strandcnt[i*8+0*4+TAG_BSC]}", end="")
    p("")
    p("\nConfusion counts (single-end):")
    p("orig\\infer      BSW (f)      BSC (r)      Conflict (c) Unknown (u)")
    for label, off in (("     BSW (f):   ", 0), ("     BSC (r):   ", 4),
                       ("Conflict (c):   ", 8), (" Unknown (u):   ", 12)):
        p(label + "".join("%-13d" % d.confusion[off + i] for i in range(4)))
    p("")


def main(argv):
    reg = None
    output_count = correct = False
    opts, args = getopt.getopt(argv, "g:cyh")
    for o, a in opts:
        if o == "-g":
            reg = a
        elif o == "-y":
            output_count = True
        elif o == "-c":
            correct = True
        elif o == "-h":
            print("Usage: biscuit_tpu bsstrand [options] <ref.fa> <in.bam> [out.bam]",
                  file=sys.stderr)
            return 1
    if len(args) < 2:
        print("Please provide reference and input bam.", file=sys.stderr)
        return 1
    reffn, infn = args[0], args[1]
    outfn = args[2] if len(args) > 2 else None
    rs = RefCache(reffn)
    bam = AlignmentFile(infn)
    d = BsstrandData()
    out_records = []
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
        bsstrand_func(b, rs, d, bam.header.names, correct, output_count)
        if outfn:
            out_records.append(b)
    if outfn:
        if outfn.endswith(".sam") or outfn == "-":
            write_sam(sys.stdout if outfn == "-" else outfn, bam.header, out_records)
        else:
            write_bam(outfn, bam.header, out_records)
    print_report(d)
    return 0
