"""PE insert-size inference and proper-pair selection.

Ports mem_pestat / mem_pair / cal_sub (lib/aln/mem_pair.c).

Copy of biscuit_tpu/align/pair.py. Only its imports differ: FMNumpy comes
from biscuit_tpu_torch.ops.fm and every other module from this package,
so the port imports nothing of the JAX package. tests/test_torch_engine.py holds the
copy to its source.
"""
import math
from dataclasses import dataclass
from typing import List, Tuple

from ..config import MemOpt
from .region import AlnReg, AlnRegs, alnreg_isize, hash_64, infer_isize
from ..align import bns as bnsmod
from . import trace

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0
U64 = (1 << 64) - 1


@dataclass
class PeStat:
    low: int = 0
    high: int = 0
    set: int = 0
    failed: int = 0
    avg: float = 0.0
    std: float = 0.0


def _cal_sub(opt: MemOpt, regs: AlnRegs) -> int:
    best = regs[0]
    for j in range(1, len(regs)):
        p = regs[j]
        b_max = max(p.qb, best.qb)
        e_min = min(p.qe, best.qe)
        if e_min > b_max:
            min_l = min(p.qe - p.qb, best.qe - best.qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return p.score
    return opt.min_seed_len * opt.a


# Multi-host hook: when set, pestat passes its local candidate isize list
# through this callable (an allgather across shards) before computing the
# boundaries, so every shard derives the SAME pes regardless of how the
# reads were partitioned — the DCN analog of the reference computing pes
# over the whole in-memory chunk (bwamem.c:464-467). Installed by the align
# CLI from BISCUIT_TPU_PES_EXCHANGE (see cli.py / tools/shard_align.py).
ISIZE_EXCHANGE = None


def pestat_isizes(opt: MemOpt, idx, regs_pairs: List[AlnRegs]) -> List[int]:
    """Candidate unique-pair insert sizes (mem_pestat's collection phase)."""
    isize: List[int] = []
    n = len(regs_pairs)
    for i in range(n >> 1):
        r0 = regs_pairs[i << 1]
        r1 = regs_pairs[(i << 1) | 1]
        if not r0 or not r1:
            continue
        best0, best1 = r0[0], r1[0]
        if _cal_sub(opt, r0) > MIN_RATIO * best0.score:
            continue
        if _cal_sub(opt, r1) > MIN_RATIO * best1.score:
            continue
        if best0.rid != best1.rid:
            continue
        if best0.bss != best1.bss:
            continue
        is_ = alnreg_isize(idx, best0, best1)
        if is_ is not None and -opt.max_ins <= is_ <= opt.max_ins:
            isize.append(is_)
    return isize


def pestat(opt: MemOpt, idx, regs_pairs: List[AlnRegs], verbose=True) -> PeStat:
    """mem_pestat (mem_pair.c:60-144)."""
    import sys
    isize = pestat_isizes(opt, idx, regs_pairs)
    if ISIZE_EXCHANGE is not None:
        isize = list(ISIZE_EXCHANGE(isize))
    pes = PeStat()
    if verbose:
        print(f"[M::mem_pestat] # candidate unique pairs: {len(isize)}", file=sys.stderr)
    if len(isize) < MIN_DIR_CNT:
        if verbose:
            print("[M:mem_pestat] There are not enough pairs for insert size inference",
                  file=sys.stderr)
        pes.failed = 1
        return pes
    isize.sort()
    p25 = isize[int(0.25 * len(isize) + 0.499)]
    p50 = isize[int(0.50 * len(isize) + 0.499)]
    p75 = isize[int(0.75 * len(isize) + 0.499)]
    pes.low = int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499)
    pes.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
    if verbose:
        print(f"[M::mem_pestat] (25, 50, 75) percentile: ({p25}, {p50}, {p75})",
              file=sys.stderr)
        print(f"[M::mem_pestat] low and high boundaries for computing mean and std.dev: ({pes.low}, {pes.high})",
              file=sys.stderr)
    vals = [v for v in isize if pes.low <= v <= pes.high]
    x = len(vals)
    pes.avg = sum(vals) / x
    pes.std = math.sqrt(sum((v - pes.avg) ** 2 for v in vals) / x)
    if verbose:
        print(f"[M::mem_pestat] mean and std.dev: ({pes.avg:.2f}, {pes.std:.2f})",
              file=sys.stderr)
    pes.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
    pes.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
    if pes.low > pes.avg - MAX_STDDEV * pes.std:
        pes.low = int(pes.avg - MAX_STDDEV * pes.std + 0.499)
    if pes.high < pes.avg + MAX_STDDEV * pes.std:
        pes.high = int(pes.avg + MAX_STDDEV * pes.std + 0.499)
    if verbose:
        print(f"[M::mem_pestat] low and high boundaries for proper pairs: ({pes.low}, {pes.high})",
              file=sys.stderr)
    return pes


def region_depos(idx, reg: AlnReg) -> int:
    rpos, _ = bnsmod.depos(idx, reg.rb if reg.rb < idx.l_pac else reg.re - 1)
    return rpos - idx.anns[reg.rid].offset


def mem_pair(opt: MemOpt, idx, pes: PeStat, regs_pair, pair_id: int):
    """mem_pair (mem_pair.c:147-270). Returns (score, sub, n_sub, z[2])."""
    l_pac = idx.l_pac
    v = []
    for r in range(2):
        regs = regs_pair[r]
        for i in range(regs.n_pri):
            p = regs[i]
            x = ((p.bss & 1) << 63) | (p.rid << 32) | (region_depos(idx, p) & 0xFFFFFFFF)
            y = (p.score << 32) | (i << 2) | ((1 if p.rb >= l_pac else 0) << 1) | r
            z_ = p.qe - p.qb
            v.append((x, y, z_))
    v.sort(key=lambda t: (t[0], t[1]))

    if trace.verbose >= 8:
        # mem_pair.c:171-180
        trace.out("sort by location and ascending score:\n")
        trace.out("There are %d primary for read 1 and %d for read 2.\n"
                  % (regs_pair[0].n_pri, regs_pair[1].n_pri))
        for (x, y, _z) in v:
            trace.out("read %u, %s:%u (str:%u)\n"
                      % ((y & 1) + 1, idx.anns[(x >> 32) & 0xFFFF].name,
                         x & 0xFFFFFFFF, (y >> 1) & 0x1))
        trace.out("\n")

    proper_pairs = []
    for i in range(len(v)):
        for k in range(i - 1, -1, -1):
            if v[i][0] >> 32 != v[k][0] >> 32:
                break
            if v[i][0] >> 63 != v[k][0] >> 63:
                break
            if (v[i][0] & 0xFFFFFFFF) - (v[k][0] & 0xFFFFFFFF) > max(pes.low, pes.high):
                break
            if (v[i][1] & 1) == (v[k][1] & 1):
                break
            is_ = infer_isize(v[k][0] & 0xFFFFFFFF, v[i][0] & 0xFFFFFFFF,
                              (v[k][1] >> 1) & 1, (v[i][1] >> 1) & 1,
                              v[k][2], v[i][2])
            if trace.verbose >= 8:
                # mem_pair.c:197-201 — the second parenthesised hit strand is
                # v[i]'s in the reference too (an upstream printf quirk)
                trace.out("%s, Hit %u (%u), paired with hit %u (%u)\n"
                          % (idx.anns[(v[i][0] >> 32) & 0xFFFF].name,
                             v[i][0] & 0xFFFFFFFF, (v[i][1] >> 1) & 1,
                             v[k][0] & 0xFFFFFFFF, (v[i][1] >> 1) & 1))
                trace.out("Insert size: %d (must be in [%d,%d]\n"
                          % (is_ if is_ is not None else 0, pes.low, pes.high))
            if is_ is not None and pes.low <= is_ <= pes.high:
                zscore = (is_ - pes.avg) / pes.std
                score_ = max(0, int((v[i][1] >> 32) + (v[k][1] >> 32)
                                    + 0.721 * math.log(2.0 * math.erfc(abs(zscore) * (1 / math.sqrt(2)))) * opt.a
                                    + 0.499))
                y = ((k << 32) | i) & U64
                x = ((score_ << 32) | (hash_64((y ^ ((pair_id << 8) & U64)) & U64) & 0xFFFFFFFF)) & U64
                proper_pairs.append((x, y))

    z = [-1, -1]
    if proper_pairs:
        proper_pairs.sort(key=lambda t: (t[0], t[1]))
        if trace.verbose >= 4:
            # mem_pair.c:223-235: u runs n-1..1 (u=0 is never printed)
            for u in range(len(proper_pairs) - 1, 0, -1):
                iu = proper_pairs[u][1] >> 32
                ku = proper_pairs[u][1] & 0xFFFFFFFF
                p1 = regs_pair[v[iu][1] & 1][(v[iu][1] & 0xFFFFFFFF) >> 2]
                p2 = regs_pair[v[ku][1] & 1][(v[ku][1] & 0xFFFFFFFF) >> 2]
                trace.out("[mem_pair] Found proper pairing: read %u: "
                          % ((v[iu][1] & 1) + 1))
                trace.print_region1(idx, p1)
                trace.out(" -- with read %u: " % ((v[ku][1] & 1) + 1))
                trace.print_region1(idx, p2)
                trace.out("\n")
        i = proper_pairs[-1][1] >> 32
        k = proper_pairs[-1][1] & 0xFFFFFFFF
        z[v[i][1] & 1] = (v[i][1] & 0xFFFFFFFF) >> 2
        z[v[k][1] & 1] = (v[k][1] & 0xFFFFFFFF) >> 2
        score = proper_pairs[-1][0] >> 32
        sub = proper_pairs[-2][0] >> 32 if len(proper_pairs) > 1 else 0
        tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
        n_sub = 0
        for j in range(len(proper_pairs) - 2, -1, -1):
            if sub - (proper_pairs[j][0] >> 32) <= tmp:
                n_sub += 1
        return score, sub, n_sub, z
    return 0, 0, 0, z
