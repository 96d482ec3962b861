"""SMEM seeding — host implementation with exact reference semantics.

Ports the behavior of bwt_smem1a / bwt_seed_strategy1
(lib/aln/bwt.c:306-396) and the 3-pass seed collection of
mem_collect_intv (lib/aln/memchain.c:50-106), on the scalar
pure-int FM fast path. The device (batched JAX) SMEM kernel must produce
identical seed sets; this module is its ground truth and the host fallback.

A seed interval is a 5-tuple (start, end, x0, x1, s): query span [start, end),
bi-interval (x0 forward rank, x1 complement rank, s size).

Copy of biscuit_tpu/align/smem.py. Only its imports differ: FMNumpy comes
from biscuit_tpu_torch.ops.fm and every other module from this package,
so the port imports nothing of the JAX package. tests/test_torch_engine.py holds the
copy to its source.
"""
from typing import List, Tuple

import numpy as np

from ..config import MemOpt, MEM_F_SELF_OVLP
from ..ops.fm import FMNumpy

Intv = Tuple[int, int, int, int, int]


def smem1a(fm: FMNumpy, fmc: FMNumpy, q, x: int, min_intv: int,
           max_intv: int = 0) -> Tuple[int, List[Intv]]:
    """Collect SMEMs covering position x. Returns (end of longest match from
    x, seeds). Only the max_intv==0 flavor is exercised by the reference
    pipeline (the max_intv>0 branch in mem_collect_intv is dead code)."""
    assert max_intv == 0
    len_q = len(q)
    if q[x] > 3:
        return x + 1, []
    if min_intv < 1:
        min_intv = 1

    # forward search, recording intervals at every size change
    ik = fm.set_intv_s(fmc, int(q[x])) + (x + 1,)  # (x0, x1, s, end)
    curr: List[Tuple[int, int, int, int]] = []
    i = x + 1
    while i < len_q:
        qi = q[i]
        if qi < 4:
            c = 3 - qi
            ok = fmc.extend_s(ik[:3], False)
            if ok[c][2] != ik[2]:  # interval size changed
                curr.append(ik)
                if ok[c][2] < min_intv:
                    break
            ik = ok[c] + (i + 1,)
        else:
            curr.append(ik)
            break
        i += 1
    if i == len_q:
        curr.append(ik)
    curr.reverse()  # longest matches (smallest intervals) first
    ret = curr[0][3]
    prev = curr

    mem: List[Intv] = []
    i = x - 1
    while i >= -1:
        c = -1 if (i < 0 or q[i] > 3) else int(q[i])
        curr = []
        for p in prev:
            if c >= 0:
                ok = fm.extend_s(p[:3], True)
            if c < 0 or ok[c][2] < min_intv:
                if not curr:
                    if not mem or i + 1 < mem[-1][0]:
                        mem.append((i + 1, p[3], p[0], p[1], p[2]))
            elif not curr or ok[c][2] != curr[-1][2]:
                curr.append(ok[c] + (p[3],))
        if not curr:
            break
        prev = curr
        i -= 1
    mem.reverse()  # sorted by start coordinate
    return ret, mem


def seed_strategy1(fm: FMNumpy, fmc: FMNumpy, q, x: int,
                   min_len: int, max_intv: int) -> Tuple[int, Intv | None]:
    """LAST-like forward-only seeding (bwt_seed_strategy1, bwt.c:376-396)."""
    len_q = len(q)
    if q[x] > 3:
        return x + 1, None
    ik = fm.set_intv_s(fmc, int(q[x]))
    i = x + 1
    while i < len_q:
        qi = q[i]
        if qi < 4:
            c = 3 - qi
            ok = fmc.extend_s(ik, False)
            if ok[c][2] < max_intv and i - x >= min_len:
                return i + 1, (x, i + 1, ok[c][0], ok[c][1], ok[c][2])
            ik = ok[c]
        else:
            return i + 1, None
        i += 1
    return len_q, None


def collect_intv(opt: MemOpt, fm: FMNumpy, fmc: FMNumpy, q) -> List[Intv]:
    """3-pass seed collection (mem_collect_intv, memchain.c:50-106)."""
    if isinstance(q, np.ndarray):
        q = q.tolist()
    len_q = len(q)
    start_width = 2 if (opt.flag & MEM_F_SELF_OVLP) else 1
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    mem: List[Intv] = []

    # pass 1: all SMEMs, keep length >= min_seed_len
    x = 0
    while x < len_q:
        if q[x] < 4:
            x, seeds = smem1a(fm, fmc, q, x, start_width)
            for s in seeds:
                if s[1] - s[0] >= opt.min_seed_len:
                    mem.append(s)
        else:
            x += 1

    # pass 2: re-seed inside long, low-occurrence SMEMs
    old_n = len(mem)
    for k in range(old_n):
        start, end, _, _, size = mem[k]
        if end - start < split_len or size > opt.split_width:
            continue
        _, seeds = smem1a(fm, fmc, q, (start + end) >> 1, size + 1)
        for s in seeds:
            if s[1] - s[0] >= opt.min_seed_len:
                mem.append(s)

    # pass 3: LAST-like forward-only seeds
    if opt.max_mem_intv > 0:
        x = 0
        while x < len_q:
            if q[x] < 4:
                x, m = seed_strategy1(fm, fmc, q, x, opt.min_seed_len, opt.max_mem_intv)
                if m is not None and m[4] > 0:
                    mem.append(m)
            else:
                x += 1

    # sort by info = start<<32 | end (ks_introsort mem_intv)
    mem.sort(key=lambda s: (s[0] << 32) | s[1])
    return mem
