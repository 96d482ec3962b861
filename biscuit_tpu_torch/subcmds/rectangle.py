"""biscuit rectangle port (src/epiread_rectangle.c): pad
old-format epireads to an aligned rectangular matrix over CpG columns.

Copy of biscuit_tpu/subcmds/rectangle.py with only this docstring
changed: its imports are relative, and resolve to the port's own modules.
tests/test_torch_engine.py holds the copy to its source.
"""
import getopt
import gzip
import sys

from ..pileup.common import RefCache


def next_cg(seq: str, pos: int) -> int:
    """refcache_next_cg: first position >= pos (1-based) with C followed by G."""
    n = len(seq)
    while pos + 1 <= n:
        if pos >= 1 and seq[pos - 1].upper() == "C" and pos < n and seq[pos].upper() == "G":
            return pos
        pos += 1
    raise SystemExit("rectangle ran off the end of the chromosome")


def main(argv):
    out_fn = None
    opts, args = getopt.getopt(argv, "o:h")
    for o, a in opts:
        if o == "-o":
            out_fn = a
        elif o == "-h":
            print("Usage: biscuit_tpu rectangle [options] <ref.fa> <in.epiread>",
                  file=sys.stderr)
            return 1
    if len(args) < 2:
        print("Reference file or epiread file is missing", file=sys.stderr)
        return 1
    rc = RefCache(args[0])
    region_beg = 0
    region_width = -1
    chrm = None
    chrom_seq = ""
    reads = []  # (padded_seq or None, original_line)
    opener = gzip.open if args[1].endswith(".gz") else open
    with opener(args[1], "rt") as f:
        for line in f:
            if not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            if fields[4][0] == ".":
                reads.append((None, line.rstrip("\n")))
                continue
            read_beg = int(fields[4])
            if not region_beg:
                region_beg = read_beg
            if chrm is None:
                chrm = fields[0]
                chrom_seq = rc.chroms[chrm]
            elif chrm != fields[0]:
                raise SystemExit("Error, rectangle cannot cross chromosomes.")
            pad = 0
            p = region_beg
            while p < read_beg:
                p = next_cg(chrom_seq, p) + 1
                pad += 1
            seq = "N" * pad + fields[5]
            if region_width < 0 or region_width < len(seq):
                region_width = len(seq)
            reads.append((seq, line.rstrip("\n")))
    out = open(out_fn, "w") if out_fn else sys.stdout
    for seq, other in reads:
        s = seq if seq is not None else ""
        if len(s) < region_width:
            s = s + "N" * (region_width - len(s))
        out.write(other + "\t" + s + "\n")
    if out_fn:
        out.close()
    return 0
