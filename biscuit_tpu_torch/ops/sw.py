"""Banded affine-gap Smith-Waterman kernels (host/numpy, exact semantics).

Ports the behavior of the reference kernels (lib/aln/ksw.c):
  sw_extend  == ksw_extend2  (:380-479)  seed extension w/ z-drop + end bonus
  sw_global  == ksw_global2  (:504-606)  banded global + CIGAR backtrack
  sw_align   == ksw_align2   (:343-365)  local SW w/ 2nd-best + start position
                                         (i16 path; callers never set KSW_XBYTE)

Rows are vectorized with numpy; the F (gap-in-query) recurrence is a closed
-form prefix-max scan because ksw computes E/F from M (diagonal) rather than
H, so there is no F->H->F cascade. The batched-device versions (Pallas/JAX)
must match these exactly; these are their ground truth.

A CIGAR is a list of (op, len) with op in 0..4 = MIDSH (SAM order).

Copy of biscuit_tpu/ops/sw.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
from typing import List, Optional, Tuple

import numpy as np

MINUS_INF = -0x40000000


def _f_scan(t: np.ndarray, e_ins: int, f0: int) -> np.ndarray:
    """F(j) recurrence F(j+1) = max(F(j) - e_ins, t(j)) as a prefix scan.
    Returns F over positions [0..n) where F(0) = f0 and t has length n-0...
    t[j] contributes t[j] - (j'-j-1)*e_ins to F(j') for j' > j."""
    n = len(t)
    out = np.empty(n, dtype=np.int64)
    if n == 0:
        return out
    idx = np.arange(n, dtype=np.int64)
    b = np.maximum.accumulate(t + idx * e_ins)
    out[0] = f0
    if n > 1:
        out[1:] = np.maximum(f0 - idx[1:] * e_ins, b[:-1] - (idx[1:] - 1) * e_ins)
    return out


def sw_extend(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
              o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
              end_bonus: int, zdrop: int, h0: int):
    """Exact ksw_extend2. Returns (score, qle, tle, gtle, gscore, max_off)."""
    qlen, tlen = len(query), len(target)
    assert h0 > 0
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = mat[:, :].astype(np.int64)[np.asarray(target, dtype=np.int64)][:, np.asarray(query, dtype=np.int64)]
    # qp[i, j] = mat[target[i], query[j]]

    h_row = np.zeros(qlen + 1, dtype=np.int64)  # eh[j].h
    e_row = np.zeros(qlen + 1, dtype=np.int64)  # eh[j].e
    h_row[0] = h0
    if qlen >= 1:
        h_row[1] = h0 - oe_ins if h0 > oe_ins else 0
        j = 2
        while j <= qlen and h_row[j - 1] > e_ins:
            h_row[j] = h_row[j - 1] - e_ins
            j += 1

    mmax = int(mat.max())
    max_ins = int((qlen * mmax + end_bonus - o_ins) / e_ins + 1.0)
    max_ins = max(max_ins, 1)
    w = min(w, max_ins)
    max_del = int((qlen * mmax + end_bonus - o_del) / e_del + 1.0)
    max_del = max(max_del, 1)
    w = min(w, max_del)

    max_sc, max_i, max_j = h0, -1, -1
    max_ie, gscore = -1, -1
    max_off = 0
    beg, end = 0, qlen
    for i in range(tlen):
        # band
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        h1_first = max(h0 - (o_del + e_del * (i + 1)), 0) if beg == 0 else 0
        if beg >= end:
            # collapsed band: the reference still writes eh[end] and may touch
            # gscore with h1 (= the empty-loop first-column value), then
            # breaks on m == 0
            h_row[end] = h1_first
            e_row[end] = 0
            if end == qlen and gscore <= h1_first:
                max_ie = i
                gscore = max(gscore, h1_first)
            break
        sl = slice(beg, end)
        Hdiag = h_row[sl].copy()          # H(i-1, j-1) for j in [beg, end)
        E = e_row[sl].copy()              # E(i, j)
        S = qp[i, sl]
        M = np.where(Hdiag != 0, Hdiag + S, 0)
        # F scan: F(beg) = 0 always (f = 0 at row start)
        tF = np.maximum(M - oe_ins, 0)
        F = _f_scan(tF, e_ins, 0)
        H = np.maximum(np.maximum(M, E), F)
        # h_row shift: eh[j].h = H(i, j-1) -> store h1 (prev col H) into p->h
        h_row[beg] = h1_first
        h_row[beg + 1:end + 1] = H
        # E(i+1,j)
        e_row[sl] = np.maximum(E - e_del, np.maximum(M - oe_del, 0))
        e_row[end] = 0
        # row max m and mj (ties -> larger j; h1_first participates? no:
        # m starts at 0 in reference and h1 set before loop body... reference
        # m=0, compares h per cell only)
        m = int(H.max())
        # reference: mj = m > h ? mj : j  (ties take the later j)
        mj = beg + int(np.nonzero(H == m)[0][-1])
        h1 = int(H[-1])  # H(i, end-1)
        if end == qlen:
            if gscore <= h1:
                max_ie = i
                gscore = max(gscore, h1)
        if m == 0:
            break
        if m > max_sc:
            max_sc, max_i, max_j = m, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if max_sc - m - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if max_sc - m - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # shrink band (reference scans eh[], which post-row holds the SHIFTED
        # H values H(i, j-1) and E(i+1, j); forward scan covers [beg, end),
        # backward scan starts at j == end inclusive)
        nz = (h_row[beg:end + 1] != 0) | (e_row[beg:end + 1] != 0)
        fwd = np.nonzero(nz[:end - beg])[0]
        new_beg = beg + int(fwd[0]) if len(fwd) else end
        bwd = np.nonzero(nz)[0]
        if len(bwd) and beg + int(bwd[-1]) >= new_beg:
            end = min(beg + int(bwd[-1]) + 2, qlen)
        else:
            end = min(new_beg - 1 + 2, qlen)  # j fell below beg
        beg = new_beg
    return max_sc, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off


def sw_global(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
              o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
              want_cigar: bool = True) -> Tuple[int, Optional[List[Tuple[int, int]]]]:
    """Exact ksw_global2. Returns (score, cigar or None)."""
    qlen, tlen = len(query), len(target)
    if qlen == 0 or tlen == 0:
        # reference would read out of bounds; callers guarantee > 0
        return 0, []
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = mat.astype(np.int64)[np.asarray(target, dtype=np.int64)][:, np.asarray(query, dtype=np.int64)]
    n_col = min(qlen, 2 * w + 1)
    z = np.zeros((tlen, n_col), dtype=np.uint8) if want_cigar else None

    h_row = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    e_row = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    h_row[0] = 0
    for j in range(1, qlen + 1):
        if j > w:
            break
        h_row[j] = -(o_ins + e_ins * j)

    for i in range(tlen):
        beg = i - w if i > w else 0
        end = min(i + w + 1, qlen)
        h1_first = -(o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        sl = slice(beg, end)
        Hdiag = h_row[sl].copy()
        E = e_row[sl].copy()
        M = Hdiag + qp[i, sl]
        tF = M - oe_ins
        F = _f_scan(tF, e_ins, MINUS_INF)
        # H with tie priority m >= e > f
        H = np.maximum(np.maximum(M, E), F)
        if want_cigar:
            d = np.where(M >= E, 0, 1).astype(np.uint8)
            d = np.where(H > np.maximum(M, E), 2, d)  # f strictly greater
            # E(i+1): d |= 1<<2 if (E - e_del) > (M - oe_del)
            d |= ((E - e_del) > (M - oe_del)).astype(np.uint8) << 2
            # F(i, j+1): bit per cell j where f_next from extension
            # f_next(j) = max(F(j) - e_ins, M(j) - oe_ins); value 2 in bits
            # 4-5 (reference writes 2<<4) so `which` stays 2 while tracing F
            d |= ((F - e_ins) > (M - oe_ins)).astype(np.uint8) << 5
            z[i, :end - beg] = d
        h_row[beg] = h1_first
        h_row[beg + 1:end + 1] = H
        e_row[sl] = np.maximum(E - e_del, M - oe_del)
        if end < qlen + 1:
            e_row[end] = MINUS_INF
    score = int(h_row[qlen])
    if not want_cigar:
        return score, None
    # backtrack
    cigar: List[Tuple[int, int]] = []

    def push(op, ln):
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + ln)
        else:
            cigar.append((op, ln))

    i = tlen - 1
    k = min(i + w + 1, qlen) - 1
    which = 0
    while i >= 0 and k >= 0:
        which = (int(z[i, k - (i - w if i > w else 0)]) >> (which << 1)) & 3
        if which == 0:
            push(0, 1); i -= 1; k -= 1
        elif which == 1:
            push(2, 1); i -= 1
        else:
            push(1, 1); k -= 1
    if i >= 0:
        push(2, i + 1)
    if k >= 0:
        push(1, k + 1)
    cigar.reverse()
    return score, cigar


class KswResult:
    __slots__ = ("score", "te", "qe", "score2", "te2", "tb", "qb")

    def __init__(self):
        self.score = 0
        self.te = self.qe = self.score2 = self.te2 = self.tb = self.qb = -1


def _local_core(query, target, mat, o_del, e_del, o_ins, e_ins,
                minsc: int, endsc: int, u8: bool = False) -> KswResult:
    """Scalar equivalent of ksw_i16 (ksw.c:232-334), or of ksw_u8 (:111-230)
    when u8=True (16-value lanes + score saturation at 255)."""
    qlen, tlen = len(query), len(target)
    r = KswResult()
    if qlen == 0 or tlen == 0:
        return r
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = mat.astype(np.int64)[np.asarray(target, dtype=np.int64)][:, np.asarray(query, dtype=np.int64)]
    # the striped kernels pad the query to a lane multiple (8 for i16, 16 for
    # u8); the padding lanes score 0 against every target base and participate
    # in row maxima (they echo stale peaks for a few rows, which is visible in
    # score2). Reproduce by extending the profile with zero columns
    # (ksw.c:100-106: `k >= qlen? 0`).
    lanes = 16 if u8 else 8
    shift = (256 - int(mat.min())) & 0xFF if u8 else 0
    ext = (qlen + lanes - 1) // lanes * lanes
    if ext > qlen:
        qp = np.concatenate([qp, np.zeros((tlen, ext - qlen), dtype=np.int64)], axis=1)
    qlen = ext
    H = np.zeros(qlen, dtype=np.int64)
    E = np.zeros(qlen, dtype=np.int64)
    Hmax = np.zeros(qlen, dtype=np.int64)
    gmax, te = 0, -1
    b: List[Tuple[int, int]] = []  # (imax, i) runs
    for i in range(tlen):
        S = qp[i]
        Hdiag = np.empty(qlen, dtype=np.int64)
        Hdiag[0] = 0
        Hdiag[1:] = H[:-1]
        M = np.maximum(Hdiag + S, 0)  # epu8/epi16 adds vs zero floor: H>=0 and
        # e,f >= 0 keep h >= 0; M itself can dip below 0 but is then dominated
        H1 = np.maximum(M, E)
        tF = np.maximum(H1 - oe_ins, 0)
        # NB: local kernel computes F from H (t = h - oe_ins AFTER h includes
        # e), with lazy-F; F(j+1) = max(F(j)-e_ins, H(j)-oe_ins) and H(j) =
        # max(H1(j), F(j)). The cascade converges to the closed form below
        # because oe_ins >= e_ins: F via H1 scan is a fixed point.
        F = _f_scan(tF, e_ins, 0)
        F = np.maximum(F, 0)
        H = np.maximum(H1, F)
        E = np.maximum(E - e_del, np.maximum(H - oe_del, 0))
        imax = int(H.max()) if qlen else 0
        if imax >= minsc:
            if not b or b[-1][1] + 1 != i:
                b.append((imax, i))
            elif b[-1][0] < imax:
                b[-1] = (imax, i)
        if imax > gmax:
            gmax, te = imax, i
            Hmax[:] = H
            if (u8 and gmax + shift >= 255) or gmax >= endsc:
                break
    r.score = 255 if (u8 and gmax + shift >= 255) else gmax
    r.te = te
    if u8 and r.score == 255:
        return r  # reference skips qe/score2 when saturated (ksw.c:211)
    mx = int(Hmax.max()) if qlen else -1
    if mx >= 0:
        r.qe = int(np.nonzero(Hmax == mx)[0][0])
    if b:
        mmax = int(mat.max())
        iw = (r.score + mmax - 1) // mmax
        low, high = te - iw, te + iw
        for sc, e in b:
            if (e < low or e > high) and sc > r.score2:
                r.score2, r.te2 = sc, e
    return r


def sw_align(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
             o_del: int, e_del: int, o_ins: int, e_ins: int,
             xstart: bool = True, xsubo: Optional[int] = None,
             xstop: Optional[int] = None, xbyte: bool = False) -> KswResult:
    """Exact ksw_align2. xsubo/xstop carry the 0xffff score args; xbyte picks
    the u8 kernel variant (16-lane padding + 255 saturation)."""
    minsc = xsubo if xsubo is not None else 0x10000
    endsc = xstop if xstop is not None else 0x10000
    r = _local_core(query, target, mat, o_del, e_del, o_ins, e_ins, minsc, endsc,
                    u8=xbyte)
    if not xstart or (xsubo is not None and r.score < minsc):
        return r
    rq = np.ascontiguousarray(query[:r.qe + 1][::-1])
    rt = np.ascontiguousarray(target[:r.te + 1][::-1])
    rr = _local_core(rq, rt, mat, o_del, e_del, o_ins, e_ins, 0x10000, r.score,
                     u8=xbyte)
    if r.score == rr.score:
        r.tb = r.te - rr.te
        r.qb = r.qe - rr.qe
    return r
