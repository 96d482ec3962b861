"""Shared config structs + bisulfite read helpers for BAM-downstream
subcommands. Ports bisc_common_t/bisc_threads_t/meth_filter_t and the
bisc_utils.c helper functions (src/bisc_utils.{c,h}),
plus a refcache equivalent (src/refcache.h).

Copy of biscuit_tpu/pileup/common.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..index.fasta import read_fasta
from ..io.sambam import AlnRecord, FLAG_REVERSE

# methylation status codes
METH_RETENTION, METH_CONVERSION, METH_NA = 0, 1, 2
# base status codes
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N, BASE_Y, BASE_R = range(7)
NSTATUS_METH = 3
NSTATUS_BASE = 7
METHCODE = "RCN"
BASECODE = "ACGTNYR"

# cytosine context codes
CTXT_HCG, CTXT_HCHG, CTXT_HCHH, CTXT_GCG, CTXT_GCHG, CTXT_GCHH, CTXT_NA = range(7)
NCONTXTS = 6
CYTOSINE_CONTEXT = ["CG", "CHG", "CHH", "CG", "CHG", "CHH", "CN"]
CYTOSINE_CONTEXT_NOME = ["HCG", "HCHG", "HCHH", "GCG", "GCH", "GCH", "CN"]

CHAR2INT8: Dict[str, int] = {"A": BASE_A, "C": BASE_C, "G": BASE_G, "T": BASE_T,
                             "Y": BASE_Y, "R": BASE_R}


def char_to_int8(c: str) -> int:
    return CHAR2INT8.get(c, BASE_N)


_COMP = str.maketrans("ACGTNacgtnYRyr", "TGCANtgcanRYry")


def revcomp_str(s: str) -> str:
    return s.translate(_COMP)[::-1]


@dataclass
class BiscCommon:
    is_nome: int = 0
    verbose: int = 0


@dataclass
class BiscThreads:
    step: int = 100000
    n_threads: int = 3


@dataclass
class MethFilter:
    min_base_qual: int = 20
    min_read_len: int = 10
    min_dist_end_5p: int = 3
    min_dist_end_3p: int = 3
    min_mapq: int = 40
    min_score: int = 40
    max_nm: int = 999999
    max_retention: int = 999999
    filter_ppair: int = 1
    filter_secondary: int = 1
    filter_duplicate: int = 1
    filter_qcfail: int = 1
    filter_doublecnt: int = 1


class RefCache:
    """faidx-backed windowed reference equivalent: whole-chrom strings with
    1-based accessors (refcache.h:52-207). Also exposes an uppercase byte
    array per chromosome for vectorized base access."""

    def __init__(self, fasta_path: str):
        self.chroms: Dict[str, str] = {}
        self.chrom_arrs: Dict[str, "np.ndarray"] = {}
        for name, _c, seq in read_fasta(fasta_path):
            self.chroms[name] = seq.decode()
        self.chrm: Optional[str] = None
        self.seq: str = ""
        self.arr = None  # uppercase byte array of the current chromosome
        self.seqlen: int = 0
        self.beg = 1
        self.end = 0

    def fetch(self, chrm: str, beg: int, end: int) -> None:
        self.chrm = chrm
        self.seq = self.chroms[chrm]
        if chrm not in self.chrom_arrs:
            import numpy as np
            self.chrom_arrs[chrm] = np.frombuffer(
                self.seq.upper().encode(), dtype=np.uint8).copy()
        self.arr = self.chrom_arrs[chrm]
        self.seqlen = len(self.seq)
        self.beg = max(beg, 1)
        self.end = min(end, self.seqlen)

    def getbase_upcase(self, pos: int) -> str:
        """1-based."""
        if pos < 1 or pos > self.seqlen:
            return "N"
        return self.seq[pos - 1].upper()

    def subseq(self, pos: int, n: int) -> str:
        """1-based, n bases, uppercased."""
        return self.seq[pos - 1:pos - 1 + n].upper()


def fivenuc_context(rs: RefCache, rpos: int, rb: str) -> Tuple[int, str]:
    """bisc_utils.c:33-72. Returns (context_code, fivenuc string)."""
    five = ["N"] * 5
    if rpos == 1:
        five[2:5] = list(rs.subseq(1, 3))
    elif rpos == 2:
        five[1:5] = list(rs.subseq(1, 4))
    elif rpos == rs.seqlen:
        five[0:3] = list(rs.subseq(rpos - 2, 3))
    elif rpos == rs.seqlen - 1:
        five[0:4] = list(rs.subseq(rpos - 2, 4))
    else:
        five[0:5] = list(rs.subseq(rpos - 2, 5))
    if rb == "G":
        five = list(revcomp_str("".join(five)))
    fivenuc = "".join(five)
    if "N" in five:
        return CTXT_NA, fivenuc
    if rb not in ("C", "G"):
        return CTXT_NA, fivenuc
    if five[3] == "G":
        return (CTXT_GCG if five[1] == "G" else CTXT_HCG), fivenuc
    elif five[4] == "G":
        return (CTXT_GCHG if five[1] == "G" else CTXT_HCHG), fivenuc
    else:
        return (CTXT_GCHH if five[1] == "G" else CTXT_HCHH), fivenuc


def iter_aligned_bases(r: AlnRecord):
    """Yield (rpos 1-based, qpos 0-based) for M/=/X cigar ops, mimicking the
    reference CIGAR walks (note: the reference advances qpos over hard
    clips too, reproduced here)."""
    rpos = r.pos + 1
    qpos = 0
    for op, ln in r.cigar:
        if op in (0, 7, 8):  # M, =, X
            for j in range(ln):
                yield rpos + j, qpos + j
            rpos += ln
            qpos += ln
        elif op == 1 or op == 4 or op == 5:  # I, S, H
            qpos += ln
        elif op == 2:  # D
            rpos += ln
        else:
            raise ValueError(f"Unknown cigar op {op}")


def aligned_bases_np(r: AlnRecord):
    """Vectorized iter_aligned_bases: (rpos 1-based, qpos 0-based) int64
    arrays over M/=/X ops (same hard-clip qpos semantics)."""
    import numpy as np
    rp_parts = []
    qp_parts = []
    rpos = r.pos + 1
    qpos = 0
    for op, ln in r.cigar:
        if op in (0, 7, 8):
            a = np.arange(ln, dtype=np.int64)
            rp_parts.append(rpos + a)
            qp_parts.append(qpos + a)
            rpos += ln
            qpos += ln
        elif op == 1 or op == 4 or op == 5:
            qpos += ln
        elif op == 2:
            rpos += ln
        else:
            raise ValueError(f"Unknown cigar op {op}")
    if not rp_parts:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    return np.concatenate(rp_parts), np.concatenate(qp_parts)


def cnt_retention_np(rs: RefCache, r: AlnRecord, bsstrand: int,
                     rp=None, qp=None, qarr=None) -> int:
    """Vectorized cnt_retention (bisc_utils.c:76-122)."""
    import numpy as np
    if rp is None:
        rp, qp = aligned_bases_np(r)
    if qarr is None:
        qarr = np.frombuffer(r.seq.encode(), dtype=np.uint8)
    rb = rs.arr[rp - 1]
    ok = qp < len(qarr)
    qb = np.where(ok, qarr[np.minimum(qp, len(qarr) - 1)], ord("N"))
    if bsstrand:
        return int(np.count_nonzero((rb == ord("C")) & (qb == ord("C"))))
    return int(np.count_nonzero((rb == ord("G")) & (qb == ord("G"))))


def infer_bsstrand_np(rs: RefCache, r: AlnRecord, min_base_qual: int,
                      rp=None, qp=None, qarr=None) -> int:
    """Vectorized infer_bsstrand (bisc_utils.c:163-206)."""
    import numpy as np
    if rp is None:
        rp, qp = aligned_bases_np(r)
    if qarr is None:
        qarr = np.frombuffer(r.seq.encode(), dtype=np.uint8)
    ok = qp < len(qarr)
    qb = np.where(ok, qarr[np.minimum(qp, len(qarr) - 1)], ord("N"))
    rb = rs.arr[rp - 1]
    if r.qual != "*":
        quals = np.frombuffer(r.qual.encode(), dtype=np.uint8)
        qual_ok = np.where(qp < len(quals),
                           quals[np.minimum(qp, len(quals) - 1)], 0) - 33 >= min_base_qual
    else:
        qual_ok = np.ones(len(rp), bool)
    nC2T = int(np.count_nonzero(qual_ok & (rb == ord("C")) & (qb == ord("T"))))
    nG2A = int(np.count_nonzero(qual_ok & (rb == ord("G")) & (qb == ord("A"))))
    return 0 if nC2T >= nG2A else 1


def get_bsstrand_np(rs: RefCache, r: AlnRecord, min_base_qual: int,
                    allow_u: int = 0, rp=None, qp=None, qarr=None) -> int:
    """get_bsstrand with the vectorized inference fallback."""
    yd = r.get_tag("YD")
    if yd is not None:
        if yd == "f":
            return 0
        if yd == "r":
            return 1
        if yd == "u" and allow_u:
            return 2
    zs = r.get_tag("ZS")
    if zs is not None:
        if str(zs).startswith("+"):
            return 0
        if str(zs).startswith("-"):
            return 1
    xg = r.get_tag("XG")
    if xg is not None:
        if xg == "CT":
            return 0
        if xg == "GA":
            return 1
    return infer_bsstrand_np(rs, r, min_base_qual, rp, qp, qarr)


def cnt_retention(rs: RefCache, r: AlnRecord, bsstrand: int) -> int:
    """bisc_utils.c:76-122."""
    cnt = 0
    seq = r.seq
    for rpos, qpos in iter_aligned_bases(r):
        rb = rs.getbase_upcase(rpos)
        qb = seq[qpos] if qpos < len(seq) else "N"
        if bsstrand:
            if rb == "C" and qb == "C":
                cnt += 1
        else:
            if rb == "G" and qb == "G":
                cnt += 1
    return cnt


def infer_bsstrand(rs: RefCache, r: AlnRecord, min_base_qual: int) -> int:
    """bisc_utils.c:163-206."""
    nC2T = nG2A = 0
    seq, qual = r.seq, r.qual
    for rpos, qpos in iter_aligned_bases(r):
        if qpos >= len(seq):
            continue
        if qual != "*" and ord(qual[qpos]) - 33 < min_base_qual:
            continue
        rb = rs.getbase_upcase(rpos)
        qb = seq[qpos]
        if rb == "C" and qb == "T":
            nC2T += 1
        if rb == "G" and qb == "A":
            nG2A += 1
    return 0 if nC2T >= nG2A else 1


def get_bsstrand(rs: RefCache, r: AlnRecord, min_base_qual: int,
                 allow_u: int = 0) -> int:
    """bisc_utils.c:208-238: YD > ZS > XG > inference."""
    yd = r.get_tag("YD")
    if yd is not None:
        if yd == "f":
            return 0
        if yd == "r":
            return 1
        if yd == "u" and allow_u:
            return 2
    zs = r.get_tag("ZS")
    if zs is not None:
        if str(zs).startswith("+"):
            return 0
        if str(zs).startswith("-"):
            return 1
    xg = r.get_tag("XG")
    if xg is not None:
        if xg == "CT":
            return 0
        if xg == "GA":
            return 1
    return infer_bsstrand(rs, r, min_base_qual)


def get_mate_length(mc: str) -> int:
    """bisc_utils.c:124-161: reference length from an MC tag cigar."""
    if mc == "*" or not mc:
        return 0
    from ..io.sambam import parse_cigar, CIGAR_CONSUME_REF
    return sum(l for op, l in parse_cigar(mc) if op in CIGAR_CONSUME_REF)
