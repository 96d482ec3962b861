"""The plain reference of the align cells: every SAM record the window wrote
is held to the inputs, the genome and each read's origin.

It imports nothing of the program. Its inputs are the harness's: the
reference genome's codes, each chunk's reads (names, sequences, qualities)
and their truth (origin and the score of the ungapped alignment there). The
program's SAM text is what is judged. Three numbers:

- `unaccounted`: reads of the window without exactly one primary record,
  in input order, under their own name and mate flag (every read).
- `inconsistent`: sampled reads with a record that its inputs contradict:
  SEQ or QUAL not the read's; a CIGAR whose query length is not the read's
  or that leaves its chromosome; NM, MD, ZC or ZR other than the reference
  recomputes from the CIGAR, the read and the genome under the record's
  bisulfite strand (YD); for pairs, mate fields (RNEXT, PNEXT, TLEN, MC,
  MQ, flags 0x8 and 0x20) other than the mate's primary record gives;
  where the reads carry a barcode and a UMI in their names (`align -9`),
  a CB:Z or RX:Z other than the read's.
- `missed_per_1e5`: of the other sampled reads whose true alignment at
  their origin scores at least biscuit's output threshold, those whose
  primary alignment falls short, per 10^5: unmapped, its AS below the true
  alignment's score, or its CIGAR's score not within AS_ABOVE_CIGAR below
  its AS.
"""
import numpy as np

from ..gen.reads import COMP, MATCH, SCORE

# biscuit align's documented defaults (`biscuit align -h`): gap open and
# extension (both directions), the clipping penalties of either end, the
# least score it reports
GAP_OPEN, GAP_EXT, PEN_CLIP, MIN_SCORE = 6, 1, 10, 30
# AS is the local extension's best score, the CIGAR the alignment it chose:
# to a read's end wherever that scores within the clipping penalty of the
# best, so AS exceeds the CIGAR's score by at most both penalties (and by
# one match more where the band of the global alignment narrows it)
AS_ABOVE_CIGAR = 2 * PEN_CLIP + MATCH
BASES = "ACGTN"
CIGAR_OPS = "MIDNSHP=X"


def parse_cigar(s: str):
    out, num = [], 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((CIGAR_OPS.index(ch), num))
            num = 0
    return out


def group_records(sam_text: str):
    """Lines of the window's SAM (no header) grouped by read: a list of
    (qname, [fields of each record]) in order, mates apart."""
    groups = []
    for line in sam_text.splitlines():
        f = line.split("\t")
        flag = int(f[1])
        key = (f[0], flag & 0xC0)
        if not groups or groups[-1][0] != key:
            groups.append((key, []))
        groups[-1][1].append(f)
    return groups


def _tags(f):
    return {t[:2]: t[5:] for t in f[11:]}


def recompute(fwd: np.ndarray, ref: np.ndarray, pos: int, cigar, kind: str):
    """(NM, MD, ZC, ZR, score) of the read's forward form `fwd` aligned at
    0-based `pos` of the chromosome `ref` by `cigar`, as biscuit's SAM
    states them: NM counts the differences that are no bisulfite
    conversion and every gap base; MD marks every differing base; ZC counts
    conversions (read T over C for `ct`, A over G for `ga`), ZR retained
    cytosines (C over C, G over G); the score is the CIGAR's under the
    strand's scoring with affine gaps."""
    mat = SCORE[kind]
    conv_q, conv_r = (3, 1) if kind == "ct" else (0, 2)
    ret = 1 if kind == "ct" else 2
    x, y = 0, pos
    nm = zc = zr = score = 0
    md, run = [], 0
    for op, ln in cigar:
        if op == 0:
            q, r = fwd[x:x + ln], ref[y:y + ln]
            ne = q != r
            conv = ne & (q == conv_q) & (r == conv_r)
            zc += int(conv.sum())
            zr += int(((q == ret) & (r == ret)).sum())
            nm += int(ne.sum()) - int(conv.sum())
            score += int(mat[r, q].sum())
            prev = 0
            for i in np.nonzero(ne)[0]:
                md.append(str(run + i - prev))
                md.append(BASES[r[i]])
                prev, run = i + 1, 0
            run += ln - prev
            x += ln
            y += ln
        elif op == 1:
            nm += ln
            score -= GAP_OPEN + GAP_EXT * ln
            x += ln
        elif op == 2:
            md.append(str(run))
            md.append("^" + "".join(BASES[c] for c in ref[y:y + ln]))
            run = 0
            nm += ln
            score -= GAP_OPEN + GAP_EXT * ln
            y += ln
        elif op in (4, 5):
            x += ln
    md.append(str(run))
    return nm, "".join(md), zc, zr, score


def _ref_span(cigar) -> int:
    return sum(ln for op, ln in cigar if op in (0, 2, 3, 7, 8))


def check_record(f, read: np.ndarray, qual: bytes, chroms, genome,
                 starts) -> str:
    """'' if the record agrees with its inputs, else what disagrees."""
    flag = int(f[1])
    rev = bool(flag & 0x10)
    fwd = COMP[read[::-1]] if rev else read
    fq = qual[::-1] if rev else qual
    if flag & 0x4:
        # an unmapped mate takes its mapped mate's strand for SEQ, not 0x10
        for s, q in ((read, qual), (COMP[read[::-1]], qual[::-1])):
            if f[9] == "".join(BASES[c] for c in s) and f[10].encode() == q:
                return ""
        return "SEQ or QUAL of an unmapped record"
    cigar = parse_cigar(f[5])
    if sum(ln for op, ln in cigar if op in (0, 1, 4, 5, 7, 8)) != len(read):
        return "CIGAR length"
    lead = cigar[0][1] if cigar[0][0] == 5 else 0
    trail = cigar[-1][1] if cigar[-1][0] == 5 else 0
    if f[9] != "*":
        want = fwd[lead:len(fwd) - trail]
        if f[9] != "".join(BASES[c] for c in want):
            return "SEQ"
        if f[10].encode() != fq[lead:len(fq) - trail]:
            return "QUAL"
    if f[2] not in chroms:
        return "RNAME"
    c = chroms[f[2]]
    pos = int(f[3]) - 1
    if pos < 0 or pos + _ref_span(cigar) > starts[c + 1] - starts[c]:
        return "POS"
    ref = genome[starts[c]:starts[c + 1]]
    t = _tags(f)
    kinds = {"f": ("ct",), "r": ("ga",), "u": ("ct", "ga")}.get(t.get("YD"))
    if kinds is None:
        return "YD"
    for kind in kinds:
        nm, md, zc, zr, sc = recompute(fwd, ref, pos, cigar, kind)
        if t.get("YD") == "u" and zc:
            continue
        if (str(nm), md, str(zc), str(zr)) == (t.get("NM"), t.get("MD"),
                                               t.get("ZC"), t.get("ZR")):
            return ""
    return "NM, MD, ZC or ZR"


def cigar_score(f, read: np.ndarray, chroms, genome, starts) -> int:
    """The score of mapped record f's CIGAR under its strand's scoring."""
    rev = bool(int(f[1]) & 0x10)
    fwd = COMP[read[::-1]] if rev else read
    c = chroms[f[2]]
    kind = "ga" if _tags(f).get("YD") == "r" else "ct"
    return recompute(fwd, genome[starts[c]:starts[c + 1]], int(f[3]) - 1,
                     parse_cigar(f[5]), kind)[4]


def _mate_fields(p, m) -> str:
    """'' if primary record p states its mate's primary m as biscuit does."""
    pf, mf = int(p[1]), int(m[1])
    # an unmapped mate is placed at its mate, on its strand
    mrev = pf & 0x10 if mf & 0x4 else mf & 0x10
    if bool(pf & 0x8) != bool(mf & 0x4) or bool(pf & 0x20) != bool(mrev):
        return "mate flags"
    if mf & 0x4 and pf & 0x4:
        return "" if (p[6], p[7], p[8]) == ("*", "0", "0") else "mate position"
    same = m[2] == p[2]
    if (p[6] != ("=" if same else m[2])) or p[7] != m[3]:
        return "RNEXT or PNEXT"
    tlen = 0
    if same and not (pf & 0x4) and not (mf & 0x4):
        ends = {}
        for r in (p, m):
            start = int(r[3]) - 1
            key = "hi" if int(r[1]) & 0x10 else "lo"
            ends[key] = (start + _ref_span(parse_cigar(r[5])) - 1
                         if key == "hi" else start)
        if "hi" in ends and "lo" in ends:
            tlen = ends["hi"] - ends["lo"] + 1
    if p[8] != str(tlen):
        return "TLEN"
    t = _tags(p)
    if t.get("MC") != (m[5] if not mf & 0x4 else "*") or t.get("MQ") != m[4]:
        return "MC or MQ"
    return ""


def check_window(chunks, outputs, genome, starts, names, sample_ids,
                 pe: bool):
    """The numbers over the window.

    chunks: the pool's chunks (gen.reads.Chunk); outputs: the window's
    (pool index, SAM text) in order; sample_ids: for each output, the read
    indices drawn from the seed for the detailed checks. Returns (numbers,
    attempted, failed, notes)."""
    chroms = {n: i for i, n in enumerate(names)}
    unaccounted = inconsistent = missed = eligible = attempted = 0
    notes = {}
    for (k, text), sel in zip(outputs, sample_ids):
        ch = chunks[k]
        n = len(ch.names)
        attempted += n
        groups = group_records(text)
        prim = [None] * n
        recs = [[] for _ in range(n)]
        gi = 0
        for i in range(n):
            want = (ch.names[i], (0x40 if i % 2 == 0 else 0x80) if pe else 0)
            if gi < len(groups) and groups[gi][0] == want:
                recs[i] = groups[gi][1]
                gi += 1
            p = [f for f in recs[i]
                 if not int(f[1]) & 0x900]
            if len(p) == 1:
                prim[i] = p[0]
            else:
                unaccounted += 1
        unaccounted += len(groups) - gi
        for i in sel:
            bad = ""
            for f in recs[i]:
                bad = check_record(f, ch.seqs[i], ch.quals[i], chroms,
                                   genome, starts)
                if not bad and ch.tags is not None:
                    t = _tags(f)
                    if (t.get("CB"), t.get("RX")) != ch.tags[i]:
                        bad = "CB or RX"
                if bad:
                    break
            if not bad and pe and prim[i] is not None and \
                    prim[i ^ 1] is not None:
                bad = _mate_fields(prim[i], prim[i ^ 1])
            if bad:
                inconsistent += 1
                notes[bad] = notes.get(bad, 0) + 1
            if ch.true_score[i] >= MIN_SCORE and not bad:
                eligible += 1
                p = prim[i]
                if p is None or int(p[1]) & 0x4:
                    missed += 1
                    continue
                got = int(_tags(p).get("AS", 0))
                gap = got - cigar_score(p, ch.seqs[i], chroms, genome, starts)
                missed += got < ch.true_score[i] or not 0 <= gap <= \
                    AS_ABOVE_CIGAR
    numbers = {"unaccounted": unaccounted, "inconsistent": inconsistent,
               "missed_per_1e5": 1e5 * missed / max(eligible, 1)}

    return numbers, attempted, unaccounted + inconsistent, notes
