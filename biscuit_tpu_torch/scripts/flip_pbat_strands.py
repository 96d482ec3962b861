#!/usr/bin/env python3
"""Flip the 0x10 (read-reverse-strand) FLAG bit of every record — the
reference's scripts/flip_pbat_strands.sh (samtools|awk pipeline) rebuilt on
this package's BAM reader/writer; writes the flipped BAM plus its .bai.

Usage: python -m biscuit_tpu_torch.scripts.flip_pbat_strands [-r chr:start-end]
           in.bam out.bam

Copy of scripts/flip_pbat_strands.py on the port's modules: its imports
name biscuit_tpu_torch, and the repository's root, put on sys.path, lies
one directory further up. tests/test_torch_engine.py holds the copy to
its source.
"""
import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-r", "--region", default=None,
                    help="region to flip, chr:start-end")
    ap.add_argument("in_bam")
    ap.add_argument("out_bam")
    args = ap.parse_args()

    from biscuit_tpu_torch.io.sambam import AlignmentFile, write_bam
    from biscuit_tpu_torch.io import bai as baimod

    bam = AlignmentFile(args.in_bam)
    it = bam
    if args.region:
        m = re.match(r"^([^:]+)(?::(\d+)-(\d+))?$", args.region)
        if not m:
            print(f"bad region: {args.region}", file=sys.stderr)
            return 1
        tid = bam.header.names.index(m.group(1))
        beg = int(m.group(2)) if m.group(2) else 1
        end = int(m.group(3)) if m.group(3) else bam.header.lengths[tid]
        it = bam.fetch(tid, beg, end)

    recs = []
    for r in it:
        r.flag = (r.flag - 0x10) if (r.flag & 0x10) else (r.flag + 0x10)
        recs.append(r)
    write_bam(args.out_bam, bam.header, recs)
    baimod.build_bai(args.out_bam).write(args.out_bam + ".bai")
    print(f"flipped {len(recs)} records", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
