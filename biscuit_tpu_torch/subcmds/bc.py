"""biscuit bc port (src/bc.c): extract inline cell barcodes
from FASTQ, rewrite read names to name_bc_umi (artificial AAAAAAAA UMI),
gzip output.

Copy of biscuit_tpu/subcmds/bc.py with only this docstring changed: it
imports only the standard library. tests/test_torch_engine.py holds the copy
to its source.
"""
import getopt
import gzip
import sys


def _remove_read_number(name: str) -> str:
    if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
        return name[:-2]
    return name


def _fastq_records(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        while True:
            h = f.readline()
            if not h:
                return
            seq = f.readline().rstrip("\n")
            f.readline()
            qual = f.readline().rstrip("\n")
            parts = h.rstrip("\n")[1:].split(None, 1)
            yield parts[0], (parts[1] if len(parts) > 1 else ""), seq, qual


def _null_comment(comment):
    # the reference printfs kseq's comment.s unconditionally (bc.c:77,127);
    # with no FASTQ comment that pointer is NULL and glibc renders "(null)"
    return comment if comment else "(null)"


def _fmt_with_bc(name, comment, seq, qual, bc, start, length):
    comment = _null_comment(comment)
    return "@%s_%s_AAAAAAAA %s\n%s%s\n+\n%s%s\n" % (
        name, bc, comment, seq[:start], seq[start + length:],
        qual[:start], qual[start + length:])


def _fmt_keep(name, comment, seq, qual, bc):
    comment = _null_comment(comment)
    return "@%s_%s_AAAAAAAA %s\n%s\n+\n%s\n" % (name, bc, comment, seq, qual)


def main(argv):
    mate = 1
    bc_start = 1
    bc_length = 8
    ofile = None
    opts, args = getopt.getopt(argv, "l:m:o:s:h",
                               ["mate=", "bc-start=", "bc-length=", "output=", "help"])
    for o, a in opts:
        if o in ("-l", "--bc-length"):
            bc_length = int(a)
        elif o in ("-m", "--mate"):
            mate = int(a)
        elif o in ("-o", "--output"):
            ofile = a
        elif o in ("-s", "--bc-start"):
            bc_start = int(a)
        elif o in ("-h", "--help"):
            print("Usage: biscuit_tpu bc [options] <FASTQ 1> [FASTQ 2]", file=sys.stderr)
            return 0
    if mate < 1 or mate > 2:
        print("ERROR: -m,--mate must be 1 or 2", file=sys.stderr)
        return 1
    if bc_start == 0:
        print("ERROR: barcode start position should be 1-based, did you mean -s 1?",
              file=sys.stderr)
        return 1
    bc_start -= 1
    if bc_length == 0:
        print("ERROR: barcode length must be at least 1", file=sys.stderr)
        return 1
    if not args:
        print("ERROR: no read FASTQ files provided", file=sys.stderr)
        return 1
    it1 = _fastq_records(args[0])
    it2 = _fastq_records(args[1]) if len(args) > 1 else None
    if mate == 2 and it2 is None:
        mate = 1
    oh1 = oh2 = None
    if ofile:
        if it2 is not None:
            oh1 = gzip.open(ofile + "_R1.fq.gz", "wt", compresslevel=6)
            oh2 = gzip.open(ofile + "_R2.fq.gz", "wt", compresslevel=6)
        else:
            oh1 = gzip.open(ofile + ".fq.gz", "wt", compresslevel=6)
    for rec1 in it1:
        if it2 is not None:
            try:
                rec2 = next(it2)
            except StopIteration:
                print("WARNING: read 2 has fewer sequences", file=sys.stderr)
                break
        if it2 is None:
            name, comment, seq, qual = rec1
            if bc_start + bc_length > len(seq):
                print("WARNING: read is too short to extract barcode, dropping read",
                      file=sys.stderr)
                continue
            bc = seq[bc_start:bc_start + bc_length]
            s1 = _fmt_with_bc(_remove_read_number(name), comment, seq, qual,
                              bc, bc_start, bc_length)
            (oh1 or sys.stdout).write(s1)
        else:
            kb, kn = (rec1, rec2) if mate == 1 else (rec2, rec1)
            if bc_start + bc_length > len(kb[2]):
                print("WARNING: read is too short to extract barcode, dropping read",
                      file=sys.stderr)
                continue
            bc = kb[2][bc_start:bc_start + bc_length]
            s_bc = _fmt_with_bc(_remove_read_number(kb[0]), kb[1], kb[2], kb[3],
                                bc, bc_start, bc_length)
            s_nb = _fmt_keep(_remove_read_number(kn[0]), kn[1], kn[2], kn[3], bc)
            s1, s2 = (s_bc, s_nb) if mate == 1 else (s_nb, s_bc)
            if oh1 and oh2:
                oh1.write(s1)
                oh2.write(s2)
            else:
                sys.stdout.write(s1)
                sys.stdout.write(s2)
    if it2 is not None:
        try:
            next(it2)
            print("WARNING: read 1 has fewer sequences", file=sys.stderr)
        except StopIteration:
            pass
    if oh1:
        oh1.close()
    if oh2:
        oh2.close()
    return 0
