#!/usr/bin/env python3
"""BISCUIT QC pipeline — the reference's scripts/QC.sh rebuilt on this
package: no samtools/bedtools/GNU-awk dependency; coverage is computed
directly from the BAM with numpy depth arrays instead of four
`bedtools genomecov | sort` pipelines.

Same CLI and the same output files/formats as QC.sh (MultiQC-compatible):
  {sample}_covdist_{all,q40}_{base,cpg}[_topgc|_botgc]_table.txt
  {sample}_cv_table.txt
  {sample}_totalBaseConversionRate.txt          (with -v in.vcf)
plus everything the port's `qc` itself emits (mapq/isize/dup/strand/
read-position retention tables).

Semantics mirrored from QC.sh:
  * genomecov -bga -split: M/=/X/D CIGAR ops cover, N splits, zero-depth
    regions included (so depth-0 rows enter the distributions and mu/cv).
  * q40 = mapq >= 40 (samtools view -q 40); dup = FLAG 0x400.
  * CpG depth = min depth over the 2 bases (bedtools groupby -g 1-3 -o min).
  * top/bot GC tables restrict to the assets' decile windows; a CpG
    overlapping two adjacent decile windows counts twice, as the
    intersect|awk pipeline did.
  * numbers print with awk's default %.6g.

Usage: python -m biscuit_tpu_torch.scripts.QC [-s] [-v in.vcf] [-o outdir] [-n]
           assets_dir genome sample in.bam
(assets from scripts/build_qc_assets.py, which imports neither package)

Copy of scripts/QC.py on the port's modules: its imports name
biscuit_tpu_torch, and REPO, the repository's root, lies one directory
further up. tests/test_torch_engine.py holds the copy to its source.
"""
import argparse
import gzip
import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

BAM_FUNMAP = 0x4
BAM_FDUP = 0x400


def g6(v):
    """awk default OFMT/CONVFMT."""
    return "%.6g" % v


def coverage_blocks(pos, cigar):
    """bedtools -split blocks: [beg, end) spans covered by M/=/X/D; N splits;
    I/S/H/P consume no reference."""
    blocks = []
    beg = cur = pos
    for op, ln in cigar:
        if op in (0, 2, 7, 8):      # M, D, =, X
            cur += ln
        elif op == 3:               # N: close the block
            if cur > beg:
                blocks.append((beg, cur))
            cur += ln
            beg = cur
    if cur > beg:
        blocks.append((beg, cur))
    return blocks


def load_bed(path):
    """{chrom: (starts[int64], ends[int64])} sorted by start."""
    out = {}
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            p = line.split("\t")
            out.setdefault(p[0], []).append((int(p[1]), int(p[2])))
    return {c: (np.array(sorted(iv))[:, 0], np.array(sorted(iv))[:, 1])
            for c, iv in out.items()}


def depth_hists(bam_path, cpgs, topgc, botgc):
    """One BAM pass -> per-combo depth histograms for bases and CpGs,
    overall and restricted to the GC-decile windows."""
    from biscuit_tpu_torch.io.sambam import AlignmentFile

    bam = AlignmentFile(bam_path)
    names = bam.header.names
    lengths = bam.header.lengths
    ntid = len(names)
    diffs = [[None] * ntid for _ in range(4)]  # all, q40, dup, q40dup

    for b in bam:
        if b.tid < 0 or (b.flag & BAM_FUNMAP):
            continue
        combos = [0]
        if b.mapq >= 40:
            combos.append(1)
        if b.flag & BAM_FDUP:
            combos.append(2)
            if b.mapq >= 40:
                combos.append(3)
        blocks = coverage_blocks(b.pos, b.cigar)
        ln = lengths[b.tid]
        for ci in combos:
            d = diffs[ci][b.tid]
            if d is None:
                d = diffs[ci][b.tid] = np.zeros(ln + 1, np.int32)
            for s, e in blocks:
                d[min(s, ln)] += 1
                d[min(e, ln)] -= 1

    base_h = [{} for _ in range(4)]       # combo -> {depth: n_bases}
    cpg_h = [{} for _ in range(4)]        # combo -> {depth: n_cpgs}
    base_h_gc = [[{} for _ in range(4)] for _ in range(2)]  # [top/bot]
    cpg_h_gc = [[{} for _ in range(4)] for _ in range(2)]

    def add(hist, depths, weights=None):
        bc = np.bincount(depths, weights=weights).astype(np.int64)
        for dep in np.nonzero(bc)[0]:
            hist[int(dep)] = hist.get(int(dep), 0) + int(bc[dep])

    for tid in range(ntid):
        chrom, ln = names[tid], lengths[tid]
        cs = cpgs.get(chrom)
        gcm = []
        for gci, bed in enumerate((topgc, botgc)):
            iv = bed.get(chrom) if bed else None
            mask = np.zeros(ln, bool)
            if iv is not None:
                for s, e in zip(*iv):
                    mask[s:min(e, ln)] = True
            gcm.append(mask)
        for ci in range(4):
            d = diffs[ci][tid]
            depth = np.cumsum(d[:ln], dtype=np.int64) if d is not None \
                else np.zeros(ln, np.int64)
            add(base_h[ci], depth.astype(np.int64))
            for gci in range(2):
                if gcm[gci].any():
                    add(base_h_gc[gci][ci], depth[gcm[gci]])
            if cs is not None:
                s0 = np.minimum(cs[0], ln - 1)
                s1 = np.minimum(cs[0] + 1, ln - 1)
                mind = np.minimum(depth[s0], depth[s1]).astype(np.int64)
                add(cpg_h[ci], mind)
                for gci, bed in enumerate((topgc, botgc)):
                    iv = bed.get(chrom) if bed else None
                    if iv is None:
                        continue
                    starts, ends = iv
                    # number of decile windows overlapping each CpG [s, s+2)
                    nov = (np.searchsorted(starts, cs[0] + 2, side="left")
                           - np.searchsorted(ends, cs[0], side="right"))
                    keep = nov > 0
                    if keep.any():
                        add(cpg_h_gc[gci][ci], mind[keep],
                            weights=nov[keep].astype(np.float64))
    return base_h, cpg_h, base_h_gc, cpg_h_gc


def write_covdist(path, title, hist, cv_rows, group):
    with open(path, "w") as f:
        f.write(f"BISCUITqc Depth Distribution - {title}\n")
        f.write("depth\tcount\n")
        for dep in sorted(hist):
            f.write(f"{dep}\t{hist[dep]}\n")
    scnt = sum(hist.values())
    scov = sum(d * n for d, n in hist.items())
    if scnt > 0 and scov > 0:
        mu = scov / scnt
        var = sum(n * (d - mu) ** 2 for d, n in hist.items()) / scnt
        sig = var ** 0.5
        cv_rows.append(f"{group}\t{g6(mu)}\t{g6(sig)}\t{g6(sig / mu)}\n")


def conversion_rate_table(vcf_path, out_path):
    from biscuit_tpu_torch.io.vcf import VcfFile
    from biscuit_tpu_torch.subcmds.vcf2bed import vcf2bed_ctxt

    vcf = VcfFile(vcf_path)
    vcf.select_samples("FIRST")
    buf = io.StringIO()
    vcf2bed_ctxt(vcf, 1, True, False, "C", buf)
    vcf.close()
    beta_sum, beta_cnt = {}, {}
    for line in buf.getvalue().splitlines():
        p = line.split("\t")
        dinuc = p[5]
        try:
            beta = float(p[7])
        except ValueError:
            beta = 0.0      # awk treats "." as 0 but still counts the row
        beta_sum[dinuc] = beta_sum.get(dinuc, 0.0) + beta
        beta_cnt[dinuc] = beta_cnt.get(dinuc, 0) + 1
    with open(out_path, "w") as f:
        f.write("BISCUITqc Conversion Rate by Base Average Table\n")
        f.write("CA\tCC\tCG\tCT\n")
        vals = []
        for k in ("CA", "CC", "CG", "CT"):
            if beta_cnt.get(k, 0) < 20:
                vals.append("-1")
            else:
                vals.append(g6(beta_sum[k] / beta_cnt[k]))
        f.write("\t".join(vals) + "\n")


def main():
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-s", "--single-end", action="store_true")
    ap.add_argument("-v", "--vcf", default=None)
    ap.add_argument("-o", "--outdir", default="BISCUITqc")
    ap.add_argument("-k", "--keep-tmp-files", action="store_true")
    ap.add_argument("-n", "--no-cov-qc", action="store_true")
    ap.add_argument("assets")
    ap.add_argument("genome")
    ap.add_argument("sample")
    ap.add_argument("in_bam")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    pre = os.path.join(args.outdir, args.sample)

    print("## Running BISCUIT QC script with following configuration ##",
          file=sys.stderr)
    for k, v in (("Sample Name", args.sample), ("Input BAM", args.in_bam),
                 ("Output Directory", args.outdir),
                 ("Assets Directory", args.assets),
                 ("Reference", args.genome)):
        print(f"{k:<19}: {v}", file=sys.stderr)

    # MAPQ, insert size, duplicate, strand, retention tables
    from biscuit_tpu_torch.subcmds import qc as qcmod
    qargs = (["-s"] if args.single_end else []) + \
        [args.genome, args.in_bam, pre]
    rc = qcmod.main(qargs)
    if rc not in (0, None):
        return rc

    if not args.no_cov_qc:
        cpg_bed = os.path.join(args.assets, "cpg.bed.gz")
        top_bed = os.path.join(args.assets,
                               "windows100bp.gc_content.top10p.bed.gz")
        bot_bed = os.path.join(args.assets,
                               "windows100bp.gc_content.bot10p.bed.gz")
        if not os.path.exists(cpg_bed):
            print(f"missing {cpg_bed}; build assets with "
                  "scripts/build_qc_assets.py", file=sys.stderr)
            return 1
        cpgs = {c: (np.asarray(s), np.asarray(e))
                for c, (s, e) in load_bed(cpg_bed).items()}
        have_gc = os.path.exists(top_bed) and os.path.exists(bot_bed)
        topgc = load_bed(top_bed) if have_gc else None
        botgc = load_bed(bot_bed) if have_gc else None
        base_h, cpg_h, base_gc, cpg_gc = depth_hists(
            args.in_bam, cpgs, topgc, botgc)

        cv = []
        write_covdist(f"{pre}_covdist_all_base_table.txt",
                      "All Bases", base_h[0], cv, "all_base")
        write_covdist(f"{pre}_covdist_all_cpg_table.txt",
                      "All CpGs", cpg_h[0], cv, "all_cpg")
        write_covdist(f"{pre}_covdist_q40_base_table.txt",
                      "Q40 Bases", base_h[1], cv, "q40_base")
        write_covdist(f"{pre}_covdist_q40_cpg_table.txt",
                      "Q40 CpGs", cpg_h[1], cv, "q40_cpg")
        if have_gc:
            write_covdist(f"{pre}_covdist_all_base_topgc_table.txt",
                          "All Top GC Bases", base_gc[0][0], cv,
                          "all_base_topgc")
            write_covdist(f"{pre}_covdist_all_cpg_topgc_table.txt",
                          "All Top GC CpGs", cpg_gc[0][0], cv,
                          "all_cpg_topgc")
            write_covdist(f"{pre}_covdist_q40_base_topgc_table.txt",
                          "Q40 Top GC Bases", base_gc[0][1], cv,
                          "q40_base_topgc")
            write_covdist(f"{pre}_covdist_q40_cpg_topgc_table.txt",
                          "Q40 Top GC CpGs", cpg_gc[0][1], cv,
                          "q40_cpg_topgc")
            write_covdist(f"{pre}_covdist_all_base_botgc_table.txt",
                          "All Bot GC Bases", base_gc[1][0], cv,
                          "all_base_botgc")
            write_covdist(f"{pre}_covdist_all_cpg_botgc_table.txt",
                          "All Bot GC CpGs", cpg_gc[1][0], cv,
                          "all_cpg_botgc")
            write_covdist(f"{pre}_covdist_q40_base_botgc_table.txt",
                          "Q40 Bot GC Bases", base_gc[1][1], cv,
                          "q40_base_botgc")
            write_covdist(f"{pre}_covdist_q40_cpg_botgc_table.txt",
                          "Q40 Bot GC CpGs", cpg_gc[1][1], cv,
                          "q40_cpg_botgc")
        else:
            print("top/bot GC decile beds not found: *_topgc/_botgc tables "
                  "and their uniformity rows skipped", file=sys.stderr)
        with open(f"{pre}_cv_table.txt", "w") as f:
            f.write("BISCUITqc Uniformity Table\n")
            f.write("group\tmu\tsigma\tcv\n")
            f.writelines(cv)

    if args.vcf:
        conversion_rate_table(args.vcf, f"{pre}_totalBaseConversionRate.txt")

    print("\nFinished BISCUIT QC", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
