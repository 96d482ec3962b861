"""biscuit asm port (src/asm_pairwise.c): allele-specific
methylation from pairwise epireads — 5x5 SNP-allele x CpG-call contingency,
top-2 rows/cols, Fisher exact + chi-square p-values.

Copy of biscuit_tpu/subcmds/asm.py with only this docstring
changed: its imports are relative, and resolve to the port's own modules.
tests/test_torch_engine.py holds the copy to its source.
"""
import getopt
import sys

from ..pileup.common import char_to_int8
from ..pileup.stats import chisq_sf_1df, fisher_exact, two_by_two_chisq

NT = "ACGTN"


def _max2(v):
    """asm_pairwise.c:51-59: indices of the two largest entries."""
    maxes = [0, 1]
    for i in range(2, len(v)):
        minmax = 0 if v[maxes[0]] < v[maxes[1]] else 1
        if v[i] >= v[maxes[minmax]]:
            maxes[minmax] = i
    return maxes


def test_asm(cross, chrm, snp_loc, cg_loc, out):
    rs = [sum(cross[i * 5 + j] for j in range(5)) for i in range(5)]
    smax = _max2(rs)
    cs = [sum(cross[i * 5 + j] for i in range(5)) for j in range(5)]
    cmax = _max2(cs)
    if rs[smax[0]] > 0 and rs[smax[1]] > 0 and cs[cmax[0]] > 0 and cs[cmax[1]] > 0:
        a = cross[smax[0] * 5 + cmax[0]]
        b = cross[smax[0] * 5 + cmax[1]]
        c = cross[smax[1] * 5 + cmax[0]]
        d = cross[smax[1] * 5 + cmax[1]]
        two = fisher_exact(a, b, c, d)
        pchisq = chisq_sf_1df(two_by_two_chisq(a, b, c, d))
        if snp_loc != cg_loc and NT[cmax[0]] != "N" and NT[cmax[1]] != "N":
            out.write("%s\t%d\t%d\t%c/%c\t%c/%c\t%d\t%d\t%d\t%d\t%e\t%e\n" % (
                chrm, snp_loc, cg_loc, NT[smax[0]], NT[smax[1]],
                NT[cmax[0]], NT[cmax[1]], a, b, c, d, two, pchisq))


def main(argv):
    opts, args = getopt.getopt(argv, "h")
    for o, a in opts:
        if o == "-h":
            print("Usage: biscuit_tpu asm [options] <in.epiread>", file=sys.stderr)
            return 1
    if not args:
        print("Missing in.epiread", file=sys.stderr)
        return 1
    chrm = None
    snp_loc = cg_loc = -1
    cross = [0] * 25
    n_lines = 0
    count_non_pairwise = 0
    out = sys.stdout
    import gzip
    opener = gzip.open if args[0].endswith(".gz") else open
    with opener(args[0], "rt") as f:
        for line in f:
            fields = line.rstrip("\n").split("\t") if line.strip() else []
            if fields:
                n_lines += 1
            if len(fields) < 5:
                continue
            if len(fields) > 7:
                count_non_pairwise += 1
                if count_non_pairwise >= 100 and count_non_pairwise == n_lines:
                    print(f"The first {n_lines} lines are not in pairwise epiread "
                          f"format. Be sure to run biscuit epiread in pairwise mode.",
                          file=sys.stderr)
                    break
                continue
            _snp_loc = int(fields[1])
            _cg_loc = int(fields[2])
            if chrm is None or cg_loc != _cg_loc or snp_loc != _snp_loc or chrm != fields[0]:
                if chrm is not None:
                    test_asm(cross, chrm, snp_loc, cg_loc, out)
                chrm = fields[0]
                cg_loc = _cg_loc
                snp_loc = _snp_loc
                cross = [0] * 25
            snp_code = char_to_int8(fields[3][0])
            cg_code = char_to_int8(fields[4][0])
            if snp_code > 4:
                snp_code = 4
            if cg_code > 4:
                cg_code = 4
            cross[snp_code * 5 + cg_code] += 1
    if chrm is not None:
        test_asm(cross, chrm, snp_loc, cg_loc, out)
    if n_lines < 100 and count_non_pairwise == n_lines and n_lines > 0:
        print("All lines in file are not in pairwise epiread format. "
              "Be sure to run biscuit epiread in pairwise mode.", file=sys.stderr)
    return 0
