"""The plain reference of the pileup cells: the VCF records and the
`_meth_average.tsv` of biscuit's `pileup` at its defaults, for one sample
of one region, worked out in numpy and Python from the alignments the
harness wrote into the BAM and the reference genome.

It imports nothing of the program. It follows biscuit's pileup (pileup.c:
the read filters, the per-base retention and conversion calls of a read's
bisulfite strand, the base-quality and read-end filters, mates' overlaps
counted once, ambiguous calls redistributed, the genotype likelihoods and
their Phred qualities, the cytosine context and the VCF and tsv formats).
`dtype` sets the precision of the genotyping arithmetic: float64, as
biscuit's doubles, or float32 for the control.
"""
import math
from collections import Counter

import numpy as np

A, C, G, T, N, Y, R = range(7)
RET, CONV, NA = 0, 1, 2
BASECODE = "ACGTNYR"
CONTEXT = ["CG", "CHG", "CHH", "CG", "CHG", "CHH", "CN"]
CTXT_NA = 6
ASCII = np.frombuffer(b"ACGTN", np.uint8)
RC = str.maketrans("ACGTN", "TGCAN")

# biscuit pileup's documented defaults (`biscuit pileup -h`)
MIN_BASE_QUAL, MIN_READ_LEN, MIN_DIST_5P, MIN_DIST_3P = 20, 10, 3, 3
MIN_MAPQ, MIN_SCORE = 40, 40
ERROR, CONTAM, PRIOR1, PRIOR2 = 0.001, 0.01, 0.33333, 0.33333


def _aligned(r):
    """(1-based reference positions, 0-based query positions) of a record's
    M bases."""
    rp, qp = [], []
    x, y = 0, r.pos + 1
    for op, n in r.cigar:
        if op in "M=X":
            rp.append(np.arange(y, y + n))
            qp.append(np.arange(x, x + n))
            x += n
            y += n
        elif op in "ISH":
            x += n if op != "H" else 0
        elif op in "DN":
            y += n
    return np.concatenate(rp), np.concatenate(qp)


def counts(records, ref: np.ndarray, beg: int, end: int):
    """cm [P, 3], cb [P, 7], dp [P] over positions beg..end-1 (1-based) of
    chromosome `ref` (codes), from every record that passes the filters."""
    P = end - beg
    pos_l, code_l, pass_l = [], [], []
    for r in records:
        t = {k: v for k, _t, v in r.tags}
        if r.mapq < MIN_MAPQ or len(r.seq) < MIN_READ_LEN or \
                r.flag & 0x700 or (r.flag & 0x1 and not r.flag & 0x2) or \
                t.get("AS", MIN_SCORE) < MIN_SCORE:
            continue
        rp, qp = _aligned(r)
        keep = (rp >= beg) & (rp < end)
        if r.flag & 0x80:  # a mate's overlap counted once, in mate 1
            mlen = sum(int(n) for n, o in _ops(t["MC"]) if o in "MDN=X")
            lo = max(r.pos + 1, r.mpos + 1)
            hi = min(r.pos + r.ref_len(), r.mpos + mlen)
            keep &= ~((rp >= lo) & (rp <= hi))
        rp, qp = rp[keep], qp[keep]
        if not len(rp):
            continue
        qb = r.seq[qp]
        rb = ref[rp - 1]
        base = qb.astype(np.int64)
        if t["YD"] == "r":
            meth = np.where(rb == G, np.where(qb == A, CONV, np.where(
                qb == G, RET, NA)), NA)
            base = np.where(qb == A, R, base)
        else:
            meth = np.where(rb == C, np.where(qb == T, CONV, np.where(
                qb == C, RET, NA)), NA)
            base = np.where(qb == T, Y, base)
        q = np.frombuffer(r.qual, np.uint8)[qp].astype(np.int64) - 33
        pos_l.append(rp - beg)
        code_l.append(base * 3 + meth)
        pass_l.append((q >= MIN_BASE_QUAL) & (qp + 1 > MIN_DIST_5P)
                      & (len(r.seq) >= qp + 1 + MIN_DIST_3P))
    p = np.concatenate(pos_l)
    code = np.concatenate(code_l)
    ok = np.concatenate(pass_l)
    cm = np.bincount(p[ok] * 3 + code[ok] % 3, minlength=3 * P).reshape(P, 3)
    cb = np.bincount(p[ok] * 7 + code[ok] // 3, minlength=7 * P).reshape(P, 7)
    return cm, cb, np.bincount(p, minlength=P)


def _ops(cigar: str):
    out, num = [], ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((num, ch))
            num = ""
    return out


def _redistribute(cb, rb):
    cb = list(cb)
    if (rb == T or cb[T]) and cb[C] == 0 and rb != C:
        cb[T] += cb[Y]
        cb[Y] = 0
    if (rb == C or cb[C]) and cb[T] == 0 and rb != T:
        cb[C] += cb[Y]
        cb[Y] = 0
    if (rb == A or cb[A]) and cb[G] == 0 and rb != G:
        cb[A] += cb[R]
        cb[R] = 0
    if (rb == G or cb[G]) and cb[A] == 0 and rb != A:
        cb[G] += cb[R]
        cb[R] = 0
    return cb


def _top_mutant(cb, rb) -> int:
    supp = sorted(((cb[i] << 4) | i if i != N else 0 for i in range(7)),
                  key=lambda v: -(v >> 4))
    for v in supp:
        b = v & 0xF
        if (b == R and rb in (A, G)) or (b == Y and rb in (C, T)):
            continue
        if b != N and b != rb and v >> 4 > 0:
            return b
    return -1


def _math(f):
    """log, exp and log10 computed in the float type f."""
    if f is float:
        return math.log, math.exp, math.log10
    return tuple((lambda g: lambda x: f(g(f(x))))(g)
                 for g in (np.log, np.exp, np.log10))


def _genotype(nref: int, nalt: int, f):
    """(gt, gl0, gl1, gl2, gq) in the float type f."""
    log, exp, log10 = _math(f)

    def lnlik(p):
        p = min(max(p, 1e-12), 1 - 1e-12)
        return f(nref) * log(f(1.0) - f(p)) + f(nalt) * log(p)

    def qual(p):
        return f(255.0) if p <= 0.0 else max(f(-10.0) * log10(p), f(0.0))
    prior0 = 1.0 - PRIOR1 - PRIOR2
    gl0 = log(prior0) + lnlik(ERROR + CONTAM)
    gl1 = log(PRIOR1) + lnlik(0.5)
    gl2 = log(PRIOR2) + lnlik(1.0 - ERROR - CONTAM)
    m = max(gl0, gl1, gl2)
    lsum = m + log(exp(gl0 - m) + exp(gl1 - m) + exp(gl2 - m))
    if gl0 > gl1:
        if gl0 > gl2:
            return "0/0", gl0, gl1, gl2, qual(f(1) - exp(gl0 - lsum))
        return "1/1", gl0, gl1, gl2, qual(f(1) - exp(gl2 - lsum))
    if gl1 > gl2:
        return "0/1", gl0, gl1, gl2, qual(f(1) - exp(gl1 - lsum))
    return "1/1", gl0, gl1, gl2, qual(f(1) - exp(gl2 - lsum))


def _context(seq: str, rpos: int, rb: str):
    n = len(seq)
    five = ["N"] * 5
    sub = lambda p, k: list(seq[p - 1:p - 1 + k])
    if rpos == 1:
        five[2:5] = sub(1, 3)
    elif rpos == 2:
        five[1:5] = sub(1, 4)
    elif rpos == n:
        five[0:3] = sub(rpos - 2, 3)
    elif rpos == n - 1:
        five[0:4] = sub(rpos - 2, 4)
    else:
        five[0:5] = sub(rpos - 2, 5)
    if rb == "G":
        five = list("".join(five).translate(RC)[::-1])
    s = "".join(five)
    if "N" in five:
        return CTXT_NA, s
    if five[3] == "G":
        return (3 if five[1] == "G" else 0), s
    if five[4] == "G":
        return (4 if five[1] == "G" else 1), s
    return (5 if five[1] == "G" else 2), s


def site(chrm: str, seq: str, rpos: int, cm, cb, dp, bsum, bcnt, f):
    """The VCF line of one site (biscuit's plp_format for one sample), or
    None; adds a methylation-callable site's beta to bsum and bcnt."""
    rb = seq[rpos - 1]
    rbc = "ACGTN".index(rb)
    cbr = _redistribute(cb, rbc)
    cm1 = _top_mutant(cbr, rbc)
    if cm1 < 0 and cm[RET] == 0 and cm[CONV] == 0:
        return None
    callable_ = 0
    if cm[RET] + cm[CONV] > 0:
        if rb == "C" and (cbr[T] == 0 or (cbr[C] > 0 and cbr[T] / cbr[C] < 0.05)):
            callable_ = 1
        if rb == "G" and (cbr[A] == 0 or (cbr[G] > 0 and cbr[A] / cbr[G] < 0.05)):
            callable_ = 1
    nref = cbr[rbc]
    nalt = cbr[cm1] if cm1 >= 0 else 0
    gt, gl0, gl1, gl2, gq = "./.", -1.0, -1.0, -1.0, 0.0
    if nref + nalt > 0:
        gt, gl0, gl1, gl2, gq = _genotype(nref, nalt, f)
    s = [f"{chrm}\t{rpos}\t.\t{rb}\t"]
    s.append(("N" if cm1 in (Y, R) else BASECODE[cm1]) if cm1 >= 0 else ".")
    s.append(f"\t{int(gq)}")
    s.append("\tPASS\t" if gq > 5 else "\tLowQual\t")
    s.append("NS=1")
    ctt = CTXT_NA
    if rb in "CG":
        ctt, five = _context(seq, rpos, rb)
        s.append(f";CX={CONTEXT[ctt]};N5={five[:5]}")
    if cm1 in (Y, R):
        s.append(";AB=" + BASECODE[cm1])
    s.append("\tGT:GL1:GQ:DP:SP")
    if cm1 >= 0:
        s.append(":AC:AF1")
    if callable_:
        s.append(":CV:BT")
    if gq > 0 and dp:
        s.append("\t%s:%1.0f,%1.0f,%1.0f:%1.0f" % (
            gt, max(-1000, gl0), max(-1000, gl1), max(-1000, gl2), gq))
    else:
        s.append("\t./.:.,.,.:0")
    s.append(f":{dp}:")
    parts = [f"{rb}{cb[rbc]}"] if cb[rbc] else []
    parts += [f"{BASECODE[i]}{cb[i]}" for i in range(7)
              if i not in (N, rbc) and cb[i] > 0]
    s.append("".join(parts) if parts else ".")
    if cm1 >= 0:
        s.append(f":{nref + nalt}:")
        s.append("%1.2f" % (nalt / (nref + nalt)) if nref + nalt else ".")
    if callable_:
        beta = cm[RET] / (cm[RET] + cm[CONV])
        if ctt != CTXT_NA:
            bsum[ctt] += beta
            bcnt[ctt] += 1
        s.append(":%d:%1.3f" % (cm[RET] + cm[CONV], beta))
    s.append("\n")
    return "".join(s)


def pileup(records, names, lengths, tid: int, ref: np.ndarray, region,
           sample: str, dtype=float):
    """(VCF records, tsv lines) of `pileup -g <chrom>:<start>-<end>` on one
    sample, where `ref` is the chromosome's codes and `region` the
    command's (start, end)."""
    beg, end = region[0] + 1, min(region[1], lengths[tid])
    cm, cb, dp = counts(records, ref, beg, end)
    seq = ASCII[ref].tobytes().decode()
    P = end - beg
    rbw = ref[beg - 1:end - 1]
    meth = (cm[:, RET] + cm[:, CONV]) > 0
    nonref = cb.sum(1) - cb[np.arange(P), np.minimum(rbw, 6)] - cb[:, N]
    maybe_alt = nonref - np.where(np.isin(rbw, (C, T)), cb[:, Y], 0) - \
        np.where(np.isin(rbw, (A, G)), cb[:, R], 0) > 0
    emit = (dp > 0) & (rbw != N) & (meth | maybe_alt)
    bsum, bcnt = [0.0] * 7, [0] * 7
    lines = []
    for p in np.nonzero(emit)[0]:
        line = site(names[tid], seq, beg + int(p), cm[p].tolist(),
                    cb[p].tolist(), int(dp[p]), bsum, bcnt, dtype)
        if line:
            lines.append(line)
    tsv = ["sample\tchrm\tCGn\tCGb\tCHGn\tCHGb\tCHHn\tCHHb\tCHn\tCHb\n"]
    for chrom in sorted(names) + ["WholeGenome"]:
        b, c = (bsum, bcnt) if chrom in (names[tid], "WholeGenome") else \
            ([0.0] * 7, [0] * 7)
        k_cg, b_cg = c[3] + c[0], b[3] + b[0]
        k_chg, b_chg = c[4] + c[1], b[4] + b[1]
        k_chh, b_chh = c[5] + c[2], b[5] + b[2]
        k_ch, b_ch = k_chg + k_chh, b_chg + b_chh
        if k_cg > 0:
            pct = lambda x, k: (x / k * 100) if k else 0
            tsv.append("%s\t%s\t%d\t%1.3f%%\t%d\t%1.3f%%\t%d\t%1.3f%%\t%d\t"
                       "%1.3f%%\n" % (sample, chrom, k_cg, pct(b_cg, k_cg),
                                      k_chg, pct(b_chg, k_chg), k_chh,
                                      pct(b_chh, k_chh), k_ch, pct(b_ch, k_ch)))
    return lines, tsv


def differ(got, want) -> int:
    """Lines in one list and not the other, as multisets."""
    a, b = Counter(got), Counter(want)
    return sum(((a - b) + (b - a)).values())
