"""biscuit qc port (src/qc.c): single-pass BAM QC reusing the
bsstrand/bsconv/cinread accumulators.

Copy of biscuit_tpu/subcmds/qc.py with only this docstring changed: its
imports are relative, and resolve to the port's own modules. It runs the
port's bsstrand, bsconv and cinread accumulators. tests/test_torch_engine.py
holds the copy to its source.
"""
import getopt
import sys

from ..io.sambam import (AlignmentFile, FLAG_DUP, FLAG_PAIRED, FLAG_PROPER,
                         FLAG_SECONDARY, FLAG_UNMAP)
from ..pileup.common import RefCache
from .bsconv import BsconvConf, BsconvData, bsconv_func
from .bsstrand import BsstrandData, bsstrand_func
from .cinread import (CIN_READ_LEN, CinreadConf, CinreadData, SL_CG, SL_CH,
                      cinread_func)

N_MAPQ = 61
ISIZE = 1000


def main(argv):
    single_end = False
    opts, args = getopt.getopt(argv, "hs")
    for o, a in opts:
        if o == "-s":
            single_end = True
        elif o == "-h":
            print("Usage: biscuit_tpu qc [options] <ref.fa> <in.bam> <sample_name>",
                  file=sys.stderr)
            return 1
    if len(args) < 3:
        print("Please provide a reference FASTA, input bam, and sample name.",
              file=sys.stderr)
        return 1
    reffn, infn, samp = args[0], args[1], args[2]
    rs = RefCache(reffn)
    bam = AlignmentFile(infn)
    names = bam.header.names

    data_bsstrand = BsstrandData()
    # the reference zero-initializes bsconv_conf_t and only resets
    # max_cph/max_cpa/max_cpc/max_cpt to -1 (qc.c:226-229) — max_cpy stays
    # 0, so any read with >=1 CpC/CpT retention is excluded from the
    # conversion-rate table. Reproduced for parity.
    conf_bsconv = BsconvConf(no_printing=1, max_cpy=0)
    data_bsconv = BsconvData()
    conf_cin_cg = CinreadConf(tgt=SL_CG, skip_printing=1,
                              tp_names=["QPAIR", "CQPOS", "CRETENTION"])
    data_cin_cg = CinreadData()
    conf_cin_ch = CinreadConf(tgt=SL_CH, skip_printing=1,
                              tp_names=["QPAIR", "CQPOS", "CRETENTION"])
    data_cin_ch = CinreadData()

    all_tot = all_dup = q40_tot = q40_dup = 0
    count_isizes = 0
    mapqs = [0] * (N_MAPQ + 1)
    isize = [0] * (ISIZE + 1)
    for b in bam:
        all_tot += 1
        if b.flag & FLAG_DUP:
            all_dup += 1
        if b.mapq >= 40:
            q40_tot += 1
            cinread_func(b, rs, conf_cin_cg, data_cin_cg, names, sys.stdout)
            cinread_func(b, rs, conf_cin_ch, data_cin_ch, names, sys.stdout)
        if (b.flag & FLAG_DUP) and b.mapq >= 40:
            q40_dup += 1
        if not (b.flag & FLAG_SECONDARY):
            if b.flag & FLAG_UNMAP:
                mapqs[N_MAPQ] += 1
            else:
                mapqs[min(b.mapq, N_MAPQ - 1)] += 1
            if (not single_end) and (b.flag & FLAG_PROPER) and b.mapq >= 40:
                if 0 <= b.tlen <= ISIZE:
                    count_isizes += 1
                    isize[b.tlen] += 1
            if (not (b.flag & FLAG_DUP) and (b.flag & FLAG_PAIRED)
                    and (b.flag & FLAG_PROPER) and b.mapq >= 40):
                bsconv_func(b, rs, conf_bsconv, data_bsconv, names)
        bsstrand_func(b, rs, data_bsstrand, names, False, False)

    def w(path):
        return open(samp + path, "w")

    with w("_mapq_table.txt") as f:
        f.write("BISCUITqc Mapping Quality Table\nMapQ\tCount\n")
        f.write(f"unmapped\t{mapqs[N_MAPQ]}\n")
        for i in range(N_MAPQ):
            f.write(f"{i}\t{mapqs[i]}\n")
    with w("_dup_report.txt") as f:
        f.write("BISCUITqc Read Duplication Table\n")
        f.write(f"Number of duplicate reads:\t{all_dup}\n")
        f.write(f"Number of reads:\t{all_tot}\n")
        f.write(f"Number of duplicate q40-reads:\t{q40_dup}\n")
        f.write(f"Number of q40-reads:\t{q40_tot}\n")
    with w("_strand_table.txt") as f:
        f.write("BISCUITqc Strand Table")
        f.write("\nStrand Distribution:\n")
        f.write("strand\\BS      BSW (f)      BSC (r)\n")
        d = data_bsstrand
        for label, off in (("     R1 (f):   ", 0), ("     R1 (r):   ", 4),
                           ("     R2 (f):   ", 8), ("     R2 (r):   ", 12)):
            f.write(label)
            # NB: reference emits a newline after EACH count (qc.c:66-76)
            for i in range(2):
                f.write("%-13d" % d.strandcnt[off + i])
                f.write("\n")
    with w("_totalReadConversionRate.txt") as f:
        f.write("BISCUITqc Conversion Rate by Read Average Table\n")
        f.write("CpA\tCpC\tCpG\tCpT\n")
        cols = []
        for i in range(4):
            tot = data_bsconv.retn_conv_counts[2 * i] + data_bsconv.retn_conv_counts[2 * i + 1]
            cols.append("%.8f" % (data_bsconv.retn_conv_counts[2 * i] / tot if tot else float("nan")))
        f.write("\t".join(cols) + "\n")
    for data, path, typ in ((data_cin_cg, "_CpGRetentionByReadPos.txt", "CpG"),
                            (data_cin_ch, "_CpHRetentionByReadPos.txt", "CpH")):
        with w(path) as f:
            f.write(f"BISCUITqc {typ} Retention by Read Position Table\n")
            f.write("ReadInPair\tPosition\tConversion/Retention\tCount\n")
            for i in range(2):
                for j in range(CIN_READ_LEN):
                    for k in range(2):  # skip the N state
                        n = int(data.counts[i, j, k])
                        if n > 0:
                            f.write(f"{i + 1}\t{j}\t{'R' if k else 'C'}\t{n}\n")
    if not single_end:
        with w("_isize_table.txt") as f:
            f.write("BISCUITqc Insert Size Table\nInsertSize\tFraction\tReadCount\n")
            for i in range(ISIZE + 1):
                if isize[i] > 0:
                    f.write("%d\t%.8f\t%d\n" % (i, isize[i] / count_isizes, isize[i]))
    return 0
