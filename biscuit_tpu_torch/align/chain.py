"""Seed chaining and chain filtering.

Ports the semantics of mem_chain / merge_seed_to_chain / mem_chain_weight /
mem_chain_flt / mem_flt_chained_seeds (lib/aln/memchain.c:
218-568). The reference clusters seeds into a B-tree keyed by the first seed's
reference position; a sorted list + bisect reproduces the same lower-neighbor
lookups and in-order traversal.

Copy of biscuit_tpu/align/chain.py. Its imports differ: FMNumpy comes
from biscuit_tpu_torch.ops.fm and every other module from this package,
so the port imports nothing of the JAX package. mem_chain_batch differs in its call into the
chain scan, which is the port's (ops/chain_batch.py) on the tensors of a
given device, and in leaving out the shape buckets. tests/test_torch_engine.py
holds the rest of the copy to its source.
"""
import bisect
import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..utils.ksort import introsort
from ..config import MemOpt
from ..ops.fm import FMNumpy
from ..ops import sw
from ..align import bns as bnsmod
from . import trace
from .smem import collect_intv

MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05


@dataclass
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int


@dataclass
class Chain:
    pos: int
    seeds: List[Seed]
    seeds_extra: List[Seed] = field(default_factory=list)
    rid: int = -1
    is_alt: int = 0
    w: int = 0
    kept: int = 0
    first: int = -1
    frac_rep: float = 0.0


def getbss(parent: int, idx, rb: int) -> int:
    """mem_getbss (memchain.c:265): (rb > l_pac) == parent ? 1 : 0."""
    return 1 if (rb > idx.l_pac) == bool(parent) else 0


def chain_weight(c: Chain) -> int:
    w = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w += s.len
        elif s.qbeg + s.len > end:
            w += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    tmp, w, end = w, 0, 0
    for s in c.seeds:
        if s.rbeg >= end:
            w += s.len
        elif s.rbeg + s.len > end:
            w += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    w = min(w, tmp)
    return min(w, (1 << 30) - 1)


def _merge_seed_to_chain(opt: MemOpt, l_pac: int, c: Chain, s: Seed, seed_rid: int) -> bool:
    """memchain.c:227-256."""
    last = c.seeds[-1]
    if seed_rid != c.rid:
        return False
    if (s.qbeg >= c.seeds[0].qbeg and s.qbeg + s.len <= last.qbeg + last.len and
            s.rbeg >= c.seeds[0].rbeg and s.rbeg + s.len <= last.rbeg + last.len):
        c.seeds_extra.append(s)
        return True
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and s.rbeg >= l_pac:
        return False
    qdist = s.qbeg - last.qbeg
    rdist = s.rbeg - last.rbeg
    if (rdist >= 0 and qdist - rdist <= opt.w and rdist - qdist <= opt.w
            and qdist - last.len < opt.max_chain_gap and rdist - last.len < opt.max_chain_gap):
        c.seeds.append(s)
        return True
    return False


def _l_rep(opt: MemOpt, mem) -> int:
    """Read length covered by repetitive seeds (memchain.c:292-303)."""
    l_rep = b = e = 0
    for (sb, se, _x0, _x1, size) in mem:
        if size <= opt.max_occ:
            continue
        if sb > e:
            l_rep += e - b
            b, e = sb, se
        else:
            e = max(e, se)
    l_rep += e - b
    return l_rep


def mem_chain(opt: MemOpt, fm: FMNumpy, fmc: FMNumpy, idx, l_seq: int,
              bisseq: np.ndarray, parent: int,
              seeds_intv=None, sa_lookup=None) -> List[Chain]:
    """memchain.c:268-393. `seeds_intv` may carry precomputed collect_intv
    output and `sa_lookup(seed_idx, k, x0)` precomputed SA positions (both
    from the batched device path)."""
    l_pac = idx.l_pac
    chains: List[Chain] = []
    if l_seq < opt.min_seed_len:
        return chains
    mem = seeds_intv if seeds_intv is not None else collect_intv(opt, fm, fmc, bisseq)
    l_rep = _l_rep(opt, mem)

    keys: List[int] = []  # sorted chain positions (B-tree key order)
    tree: List[Chain] = []

    for seed_i, (sb, se, x0, _x1, size) in enumerate(mem):
        slen = se - sb
        k = 0
        count = 0
        while k < size and count < opt.max_occ and \
                ((count > 5 and k < opt.max_occ) or count <= 5):
            rbeg = sa_lookup(seed_i, k, x0) if sa_lookup is not None \
                else fm.sa_s(x0 + k)
            s = Seed(rbeg=rbeg, qbeg=sb, len=slen, score=slen)
            rid = bnsmod.intv2rid(idx, s.rbeg, s.rbeg + s.len)
            k += 1
            if rid < 0:
                continue
            if (opt.bsstrand & 1) and getbss(parent, idx, s.rbeg) != opt.bsstrand >> 1:
                continue
            to_add = False
            if tree:
                # lower = chain with largest pos <= s.rbeg
                j = bisect.bisect_right(keys, rbeg) - 1
                if j < 0 or not _merge_seed_to_chain(opt, l_pac, tree[j], s, rid):
                    to_add = True
            else:
                to_add = True
            if to_add:
                count += 1
                c = Chain(pos=rbeg, seeds=[s], rid=rid,
                          is_alt=1 if idx.anns[rid].is_alt else 0)
                ins = bisect.bisect_right(keys, rbeg)
                keys.insert(ins, rbeg)
                tree.insert(ins, c)

    for c in tree:
        c.frac_rep = l_rep / l_seq
    if trace.verbose >= 4:
        # memchain.c:385-388; the reference computes (float)l_rep/l_seq
        trace.out("[mem_chain] Found %d chains; Fraction of repetitive seeds: %.3f\n"
                  % (len(tree), np.float32(l_rep) / np.float32(l_seq)))
        trace.print_chains(idx, tree)
    return tree


# device chain-scan capacity caps (lanes that would exceed them rerun the
# exact host path; see ops/chain_batch.py's capacity contract)
CHAIN_KMAX = 64     # occurrences per seed (== device_engine.SA_PREFETCH_CAP)
CHAIN_NC = 64       # live chains per lane
CHAIN_JMAX = 1024   # occurrence-stream length per lane


def mem_chain_batch(opt: MemOpt, idx, jobs, device="cpu"):
    """mem_chain for a batch of lanes with the B-tree scan on `device`
    (ops/chain_batch.chain_scan_batch, one occurrence per lane per step);
    the host prepares the occurrence stream (rid/bsstrand filters, SA
    positions already batched by the device sa walk) and replays the
    returned action log into Chain objects.

    jobs: list of (l_seq, parent, mem, sa_lookup) exactly as mem_chain
    consumes them. Returns a list with, per lane, either the Chain list
    (bit-identical to mem_chain) or None — the lane exceeded a capacity
    cap and must rerun on the host path."""
    from ..ops.chain_batch import (K_APPEND, K_EXTRA, K_NEW,
                                   chain_scan_batch)

    out: List[Optional[List[Chain]]] = [None] * len(jobs)
    lanes: List[int] = []
    recs_all: List[list] = []
    for li, (l_seq, parent, mem, sa_lookup) in enumerate(jobs):
        if l_seq < opt.min_seed_len:
            out[li] = []
            continue
        if any(size > CHAIN_KMAX for (_sb, _se, _x0, _x1, size) in mem):
            continue  # host fallback
        recs = []
        for seed_i, (sb, se, x0, _x1, size) in enumerate(mem):
            slen = se - sb
            for k in range(int(size)):
                rbeg = sa_lookup(seed_i, k, x0)
                rid = bnsmod.intv2rid(idx, rbeg, rbeg + slen)
                valid = rid >= 0
                if valid and (opt.bsstrand & 1) and \
                        getbss(parent, idx, rbeg) != opt.bsstrand >> 1:
                    valid = False
                recs.append((sb, slen, rbeg, 1 if valid else 0,
                             rid if rid >= 0 else 0, k))
        if len(recs) > CHAIN_JMAX:
            continue  # host fallback
        lanes.append(li)
        recs_all.append(recs)
    if not lanes:
        return out

    wide = idx.l_pac * 2 >= (1 << 31)
    rdt = np.int64 if wide else np.int32
    B = len(lanes)
    J = max(len(r) for r in recs_all)
    qbeg = np.zeros((J, B), np.int32)
    slen = np.zeros((J, B), np.int32)
    rbeg = np.zeros((J, B), rdt)
    valid = np.zeros((J, B), np.int32)
    rid = np.zeros((J, B), np.int32)
    kocc = np.zeros((J, B), np.int32)
    n_occ = np.zeros(B, np.int32)
    for bi, recs in enumerate(recs_all):
        n_occ[bi] = len(recs)
        for j, (sb, sl, rb, vd, rr, k) in enumerate(recs):
            qbeg[j, bi] = sb
            slen[j, bi] = sl
            rbeg[j, bi] = rb
            valid[j, bi] = vd
            rid[j, bi] = rr
            kocc[j, bi] = k

    def dev(a):
        return torch.from_numpy(a).to(device)
    log, ov = chain_scan_batch(
        dev(qbeg), dev(slen), dev(rbeg), dev(valid), dev(rid), dev(kocc),
        dev(n_occ), int(idx.l_pac), int(opt.w), int(opt.max_chain_gap),
        int(opt.max_occ), NC=CHAIN_NC)
    log = log.cpu().numpy()
    ov = ov.cpu().numpy()

    for bi, li in enumerate(lanes):
        if ov[bi]:
            continue  # host fallback
        l_seq, _parent, mem, _lk = jobs[li]
        chains: List[Chain] = []
        for j, (sb, sl, rb, _vd, rr, _k) in enumerate(recs_all[bi]):
            entry = int(log[j, bi])
            kind = entry & 3
            cid = entry >> 2
            if kind == K_NEW:
                chains.append(Chain(
                    pos=rb, seeds=[Seed(rbeg=rb, qbeg=sb, len=sl, score=sl)],
                    rid=rr, is_alt=1 if idx.anns[rr].is_alt else 0))
            elif kind == K_APPEND:
                chains[cid].seeds.append(
                    Seed(rbeg=rb, qbeg=sb, len=sl, score=sl))
            elif kind == K_EXTRA:
                chains[cid].seeds_extra.append(
                    Seed(rbeg=rb, qbeg=sb, len=sl, score=sl))
        # B-tree order: ascending pos, creation order on ties (bisect_right
        # inserts after equals — python sorted is stable, same tie order)
        tree = sorted(chains, key=lambda c: c.pos)
        l_rep = _l_rep(opt, mem)
        for c in tree:
            c.frac_rep = l_rep / l_seq
        out[li] = tree
    return out


def mem_chain_flt(opt: MemOpt, chns: List[Chain]) -> List[Chain]:
    """memchain.c:406-488."""
    if not chns:
        return chns
    kept_chains = []
    for c in chns:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            kept_chains.append(c)
    chns = kept_chains
    if not chns:
        return chns
    # exact ks_introsort(mem_flt) order (memchain.c:402,425): equal-weight
    # chains land in partition order, and mem_chain_flt keeps the FIRST
    # shadowed chain — tie order decides which chain survives
    introsort(chns, lambda a, b: a.w > b.w)

    def chn_beg(c):
        return c.seeds[0].qbeg

    def chn_end(c):
        s = c.seeds[-1]
        return s.qbeg + s.len

    to_keep = [0]
    chns[0].kept = 3
    for i in range(1, len(chns)):
        large_overlap = False
        broke = False
        for kidx in range(len(to_keep)):
            ci = chns[i]
            ck = chns[to_keep[kidx]]
            b_max = max(chn_beg(ck), chn_beg(ci))
            e_min = min(chn_end(ck), chn_end(ci))
            if e_min > b_max and (not ck.is_alt or ci.is_alt):
                li = chn_end(ci) - chn_beg(ci)
                lj = chn_end(ck) - chn_beg(ck)
                min_l = min(li, lj)
                if e_min - b_max >= min_l * opt.mask_level and min_l < opt.max_chain_gap:
                    large_overlap = True
                    if ck.first < 0:
                        ck.first = i
                    if ci.w < ck.w * opt.drop_ratio and ck.w - ci.w >= opt.min_seed_len << 1:
                        broke = True
                        break
        if not broke:
            to_keep.append(i)
            chns[i].kept = 2 if large_overlap else 3
    for idx_ in to_keep:
        c = chns[idx_]
        if c.first >= 0:
            chns[c.first].kept = 1
    # cap the number of kept==1/2 chains at max_chain_extend
    k = 0
    i = 0
    while i < len(chns):
        if chns[i].kept not in (0, 3):
            k += 1
            if k >= opt.max_chain_extend:
                break
        i += 1
    for j in range(i, len(chns)):
        if chns[j].kept < 3:
            chns[j].kept = 0
    return [c for c in chns if c.kept != 0]


def mem_flt_chained_seeds(opt: MemOpt, idx, l_query: int, query: np.ndarray,
                          chns: List[Chain], parent: int) -> None:
    """memchain.c:539-568 — rarely active for short reads."""
    min_l = MEM_HSP_COEF * opt.min_chain_weight if opt.min_chain_weight \
        else MEM_MINSC_COEF * math.log(l_query)
    if min_l > MEM_SEEDSW_COEF * l_query:
        _flt_chained_trace(idx, chns)
        return
    min_hsp_score = int(opt.a * min_l + 0.499)
    for c in chns:
        kept = []
        for s in c.seeds:
            s.score = _seed_sw(opt, idx, l_query, query, s, parent)
            if s.score < 0 or s.score >= min_hsp_score:
                s.score = s.len * opt.a if s.score < 0 else s.score
                kept.append(s)
        c.seeds = kept
    _flt_chained_trace(idx, chns)


def _flt_chained_trace(idx, chns) -> None:
    # END_CHAIN_FLT (memchain.c:563-568) runs on both the short-read goto
    # path and the normal fall-through
    if trace.verbose >= 4:
        trace.out("[mem_flt_chained_seeds] %d chains remained.\n" % len(chns))
        trace.print_chains(idx, chns)


def _seed_sw(opt: MemOpt, idx, l_query: int, query: np.ndarray, s: Seed,
             parent: int) -> int:
    """memchain.c:501-535 (mem_seed_sw)."""
    if s.len >= MEM_SHORT_LEN:
        return -1
    l_pac = idx.l_pac
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re_ = s.rbeg, s.rbeg + s.len
    mid = (rb + re_) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, l_query)
    rb = max(rb - MEM_SHORT_EXT, 0)
    re_ = min(re_ + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re_:
        if mid < l_pac:
            re_ = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re_ - rb >= MEM_SHORT_LEN:
        return -1
    rseq, _rid, rb, re_ = bnsmod.fetch_seq(idx, rb, mid, re_)
    mat = opt.ctmat if parent else opt.gamat
    r = sw.sw_align(query[qb:qe], rseq, mat, opt.o_del, opt.e_del,
                    opt.o_ins, opt.e_ins, xstart=True)
    return r.score
