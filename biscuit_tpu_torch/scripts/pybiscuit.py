#!/usr/bin/env python3
"""Companion conversions — the reference's scripts/pybiscuit.py rebuilt on
this package's own BAM reader (no pysam) and modern Python.

  to_mr         BAM -> methpipe .mr fragments (PE mates merged on the
                reference frame; deletions filled with N/B; MD+XM/XG-based
                mismatch masking for bismark-style inputs, NM fallback for
                biscuit BAMs)
  to_methylKit  `vcf2bed` beta/coverage table -> methylKit input

Usage: python -m biscuit_tpu_torch.scripts.pybiscuit {to_mr,to_methylKit} ...

Copy of scripts/pybiscuit.py on the port's modules: its imports name
biscuit_tpu_torch, and the repository's root, put on sys.path, lies one
directory further up. tests/test_torch_engine.py holds the copy to its
source.
"""
import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

COMP = str.maketrans("ATGCND.", "TACGND.")


def revcomp(s):
    return s.translate(COMP)[::-1]


def _expand(r):
    """Reference-frame sequence/qual: M copies, D fills N/B, I/S skipped."""
    s, q = [], []
    qpos = 0
    for ct, cl in r.cigar:
        if ct in (0, 7, 8):
            s.append(r.seq[qpos:qpos + cl])
            q.append(r.qual[qpos:qpos + cl])
            qpos += cl
        elif ct == 1:
            qpos += cl
        elif ct == 2:
            s.append("N" * cl)
            q.append("B" * cl)
        elif ct == 4:
            qpos += cl
    return "".join(s), "".join(q)


def _mismatch_string(md, bs, s):
    """Dot-mask per-base mismatch string from MD, forgiving bisulfite
    conversions on the read's strand (C>T for XG=CT, G>A for XG=GA)."""
    n = []
    qpos = 0
    for m in re.finditer(r"(\d+)(\^?[ATCGN]+)", md):
        skip = int(m.group(1))
        qpos += skip
        n.append("." * skip)
        c = m.group(2)
        if c[0] == "^":
            n.append("D" + "." * (len(c) - 2))
        elif bs == "CT" and c == "C" and qpos < len(s) and s[qpos] == "T":
            n.append(".")
            qpos += len(c)
        elif bs == "GA" and c == "G" and qpos < len(s) and s[qpos] == "A":
            n.append(".")
            qpos += len(c)
        else:
            n.append(c)
            qpos += len(c)
    m = re.match(r".*?(\d+)$", md)
    if m:
        n.append("." * int(m.group(1)))
    return "".join(n)


def main_to_mr(args):
    from biscuit_tpu_torch.io.sambam import AlignmentFile

    bam = AlignmentFile(args.i)
    names = bam.header.names
    out = args.o
    pending = {}
    for x in bam:
        if (x.flag & 0x4) or (x.flag & 0x200) or (x.flag & 0x400) \
                or (x.flag & 0x100):
            continue
        if x.qname not in pending:
            pending[x.qname] = x
            continue
        y = pending.pop(x.qname)
        r1, r2 = (x, y) if (x.flag & 0x40) else (y, x)
        if not ((r1.flag & 0x40) and (r2.flag & 0x80)):
            sys.stderr.write(f"multiple mapping detected for {x.qname}, skip")
            continue
        if r1.tid != r2.tid:
            continue
        get = lambda r, t: r.get_tag(t)
        md1, md2 = get(r1, "MD"), get(r2, "MD")
        bs1, bs2 = get(r1, "XG"), get(r2, "XG")
        xm1, xm2 = get(r1, "XM"), get(r2, "XM")
        nm1, nm2 = get(r1, "NM"), get(r2, "NM")
        s1, q1 = _expand(r1)
        s2, q2 = _expand(r2)
        n1 = n2 = ""
        if None not in (md1, md2, xm1, xm2, bs1, bs2):
            n1 = _mismatch_string(md1, bs1, s1)
            n2 = _mismatch_string(md2, bs2, s2)

        ref_end = lambda r: r.pos + sum(
            l for op, l in r.cigar if op in (0, 2, 3, 7, 8))
        if r1.flag & 0x10:
            strand = "-"
            rbeg, rend = r2.pos, ref_end(r1)
            rlen = rend - rbeg
            if rlen > args.maxrlen or rlen < args.k:
                continue
            s = revcomp(s1)[:rlen]
            q = q1[::-1][:rlen]
            n = revcomp(n1)[:rlen]
            gap = r1.pos - ref_end(r2)
            if gap > 0:
                s += "N" * gap + revcomp(s2)
                q += "B" * gap + q2[::-1]
                if n:
                    n += "N" * gap
                n += revcomp(n2)
            else:
                s += revcomp(s2)[-gap:]
                n += revcomp(n2)[-gap:]
                q += q2[::-1][-gap:]
        else:
            strand = "+"
            rbeg, rend = r1.pos, ref_end(r2)
            rlen = rend - rbeg
            if rlen > args.maxrlen or rlen < args.k:
                continue
            s, q, n = s1[:rlen], q1[:rlen], n1[:rlen]
            gap = r2.pos - ref_end(r1)
            if gap > 0:
                s += "N" * gap + s2
                q += "B" * gap + q2
                if n:
                    n += "N" * gap
                n += n2
            else:
                s += s2[-gap:]
                q += q2[-gap:]
                n += n2[-gap:]

        if n:
            nm = len(n) - n.count(".") - n.count("N")
        elif nm1 is not None and nm2 is not None:
            nm = nm1 + nm2
        else:
            nm = 0
        out.write(f"{names[r1.tid]}\t{rbeg}\t{rend}\tFRAG:{r1.qname}\t"
                  f"{nm}\t{strand}\t{s}\t{q}\n")


def main_to_methylKit(args):
    out = open(args.o, "w") if args.o is not None else sys.stdout
    out.write("chrBase\tchr\tbase\tstrand\tcoverage\tfreqC\tfreqT\n")
    for line in args.i:
        f = line.strip().split("\t")
        strand = "F" if f[5] == "C" else "R"
        out.write("%s.%s\t%s\t%s\t%s\t%d\t%1.2f\t%1.2f\n" % (
            f[0], f[2], f[0], f[2], strand, int(f[4]),
            float(f[3]) * 100, (1 - float(f[3])) * 100))


def main():
    p = argparse.ArgumentParser(description="Python scripts for Biscuits")
    sub = p.add_subparsers(required=True)
    mr = sub.add_parser("to_mr", help="convert bam to mr file for methpipe")
    mr.add_argument("-i", required=True, help="input bam")
    mr.add_argument("-o", type=argparse.FileType("w"), default=sys.stdout)
    mr.add_argument("-v", type=int, default=0)
    mr.add_argument("-l", "--maxrlen", type=int, default=1000)
    mr.add_argument("-k", type=int, default=40)
    mr.set_defaults(func=main_to_mr)
    mk = sub.add_parser("to_methylKit",
                        help="convert vcf2bed output to methylKit format")
    mk.add_argument("-i", type=argparse.FileType("r"), default="-")
    mk.add_argument("-o", default=None)
    mk.set_defaults(func=main_to_methylKit)
    args = p.parse_args()
    try:
        args.func(args)
    except BrokenPipeError:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
