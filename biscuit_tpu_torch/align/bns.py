"""Reference-metadata helpers over BisIndex (reference bntseq.c/bns_*).

Copy of biscuit_tpu/align/bns.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
import re
from typing import List, Optional, Tuple

import numpy as np

from ..index.fmindex import BisIndex


def pos2rid(idx: BisIndex, pos_f: int) -> int:
    """bns_pos2rid (bntseq.c:356-369)."""
    if pos_f >= idx.l_pac:
        return -1
    left, mid, right = 0, 0, len(idx.anns)
    while left < right:
        mid = (left + right) >> 1
        if pos_f >= idx.anns[mid].offset:
            if mid == len(idx.anns) - 1:
                break
            if pos_f < idx.anns[mid + 1].offset:
                break
            left = mid + 1
        else:
            right = mid
    return mid


def depos(idx: BisIndex, pos: int) -> Tuple[int, bool]:
    """bns_depos: forward coordinate + is_rev."""
    is_rev = pos >= idx.l_pac
    return ((idx.l_pac << 1) - 1 - pos) if is_rev else pos, is_rev


def intv2rid(idx: BisIndex, rb: int, re_: int) -> int:
    """bns_intv2rid (bntseq.c:371-378)."""
    if rb < idx.l_pac < re_:
        return -2
    assert rb <= re_
    pos_b, _ = depos(idx, rb)
    rid_b = pos2rid(idx, pos_b)
    if rb < re_:
        pos_e, _ = depos(idx, re_ - 1)
        rid_e = pos2rid(idx, pos_e)
    else:
        rid_e = rid_b
    return rid_b if rid_b == rid_e else -1


def get_seq(idx: BisIndex, beg: int, end: int) -> np.ndarray:
    """bns_get_seq: fetch [beg,end) in forward-reverse coordinates; empty if
    bridging the strand boundary."""
    if end < beg:
        beg, end = end, beg
    if end > idx.l_pac << 1:
        end = idx.l_pac << 1
    if beg < 0:
        beg = 0
    if beg >= idx.l_pac or end <= idx.l_pac:
        if beg >= idx.l_pac:  # reverse strand
            beg_f = (idx.l_pac << 1) - end
            end_f = (idx.l_pac << 1) - beg
            return (3 - idx.pac[beg_f:end_f])[::-1]
        return idx.pac[beg:end]
    return np.empty(0, dtype=np.uint8)


def fetch_seq(idx: BisIndex, beg: int, mid: int, end: int) -> Tuple[np.ndarray, int, int, int]:
    """bns_fetch_seq: clamp [beg,end) to mid's contig, return (seq, rid,
    clamped beg, clamped end)."""
    if end < beg:
        beg, end = end, beg
    assert beg <= mid < end
    pos_m, is_rev = depos(idx, mid)
    rid = pos2rid(idx, pos_m)
    far_beg = idx.anns[rid].offset
    far_end = far_beg + idx.anns[rid].length
    if is_rev:
        far_beg, far_end = (idx.l_pac << 1) - far_end, (idx.l_pac << 1) - far_beg
    beg = max(beg, far_beg)
    end = min(end, far_end)
    seq = get_seq(idx, beg, end)
    assert len(seq) == end - beg
    return seq, rid, beg, end


def infer_alt_chromosomes(idx: BisIndex) -> None:
    """align.c:184-224: auto-mark chrUn/_random/_hap/_alt contigs as ALT when
    the main chr1..22/X/Y/M set is present."""
    if any(getattr(a, "is_alt", 0) for a in idx.anns):
        return
    found = set()
    for a in idx.anns:
        n = a.name
        if n.startswith("chr"):
            if len(n) == 4:
                c = n[3].upper()
                if c == "X":
                    found.add(22)
                elif c == "Y":
                    found.add(23)
                elif c == "M":
                    found.add(24)
                elif c.isdigit() and 0 < int(c) <= 22:
                    found.add(int(c) - 1)
            elif len(n) == 5 and n[3].isdigit() and n[4].isdigit():
                v = int(n[3:5])
                if 0 < v <= 22:
                    found.add(v - 1)
    if len(found) < 20:
        return
    for a in idx.anns:
        if a.name.startswith("chrUn") or "_random" in a.name or "_hap" in a.name \
           or "_alt" in a.name:
            a.is_alt = 1
            from . import trace
            if trace.verbose >= 4:
                trace.err("[M:infer_alt_chromosomes] Set %s as ALT.\n" % a.name)
