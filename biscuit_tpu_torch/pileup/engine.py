"""Pileup engine: joint methylation + SNP calling to VCF.

Port of src/pileup.c: windowed pileup (100 kbp steps) with
per-base pileup_data records, per-site genotyping with bisulfite-aware
ambiguity redistribution, VCF emission, and the _meth_average.tsv side
statistics. Sequential window loop here (ordered by construction); the
genome-axis sharded device path plugs in per-window.

Copy of biscuit_tpu/pileup/engine.py with two engines for a non-verbose
window, picked by the `device` argument where the source reads
BISCUIT_TPU_PILEUP. `device` None is the `native` engine: the C++ window
engine (pileup/native.py over native/pileup_native.cpp) on raw BAM records
or on record objects, which uses no torch. A torch device is the `device`
engine: `_pileup_window_fast` takes the device and always calls
`_device_counts`, which makes the count matrices of a window in one call of
the fused window count (ops/pileup_count.pileup_window_counts: a CUDA
kernel on the card, its plain version on the CPU) over inputs staged in
reused host buffers; that is the source's BISCUIT_TPU_PILEUP=device path.
Over raw BAM records (the sources of pileup/native.py, which the CLI opens
for this engine as for `native`) a window of the `device` engine is one C++
walk instead (pileup/walk.py over pileup/walk_host.cpp): the records decoded
into the datum arrays `_pileup_window_fast` makes, counted by the same
`_device_counts`, the VCF text formatted from the counts.
A `Mesh` (parallel/mesh.py) is the `mesh` engine, the source's
BISCUIT_TPU_PILEUP=mesh: `_device_counts` counts this rank's contiguous
slice of the window's data with the same fused window count on the rank's
device and sums the counts over the ranks (all_reduce). The source's
`_mesh_counts` (K9's general entry twice, then sums and reshapes on the
host) and its power-of-two buckets are not ported. The numpy bincount
branch is left out. `run_windows` takes the windows of the
`device` engine on a CUDA device, and every window of the `mesh` engine
(whose ranks call their collectives in lockstep), in order in this process,
since a CUDA context does not survive a fork; native windows, and windows
of the `device` engine on the CPU, go to the source's fork pool. The rest
is the source's code; tests/test_torch_engine.py holds the copy to it.
"""
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import __version__
from ..io.sambam import (AlignmentFile, AlnRecord, FLAG_DUP, FLAG_PAIRED,
                         FLAG_PROPER, FLAG_QCFAIL, FLAG_READ2, FLAG_REVERSE,
                         FLAG_SECONDARY)
from . import stats
from .common import (BASE_A, BASE_C, BASE_G, BASE_N, BASE_R, BASE_T, BASE_Y,
                     BASECODE, BiscCommon, BiscThreads, CTXT_NA,
                     CYTOSINE_CONTEXT, CYTOSINE_CONTEXT_NOME, MethFilter,
                     METH_CONVERSION, METH_NA, METH_RETENTION, NCONTXTS,
                     NSTATUS_BASE, NSTATUS_METH, RefCache, aligned_bases_np,
                     char_to_int8, cnt_retention, cnt_retention_np,
                     fivenuc_context, get_bsstrand, get_bsstrand_np,
                     get_mate_length, iter_aligned_bases)

import numpy as np
import torch

from ..ops.pileup_count import CB, CM, DP, N_WORDS, pileup_window_counts
from ..parallel.mesh import Mesh, group_sum, shard_bounds

# seconds of the non-verbose windows in this process since reset_stages()
# (the windows a fork pool's workers compute are counted in the workers and
# never reach the parent: only the in-process path is covered): open (the
# CLI's opening of the BAMs and the reference), read decode (BAM fetch,
# filters, per-read base extraction, on raw records the C++ walk's,
# pileup/walk.py; and the data's staging), count (the staged data to the
# device, the fused window count, counts back), emit (emit mask and
# plp_format; on raw records the C++ walk's formatting), native (a window of the C++ engine,
# decode to VCF text); with the windows that held data (the C++ engine:
# every window it ran), those of them the device engine's C++ walk decoded
# and emitted (raw_windows), their data (device engine), the VCF lines and
# the chunks of data that the kernel counted in device memory for want of
# room in its shared memory (none on the plain route)
STAGES = {"open": 0.0, "decode": 0.0, "count": 0.0, "emit": 0.0,
          "native": 0.0, "windows": 0, "raw_windows": 0, "data": 0,
          "sites": 0, "wide_chunks": 0}
_COUNT_SPAN = None  # (entered, left) _device_counts in the current window


def reset_stages() -> None:
    for k in STAGES:
        STAGES[k] = type(STAGES[k])()


# 256-entry char -> int8 base-code table (vectorized char_to_int8)
_CHAR2INT8_TBL = np.full(256, BASE_N, dtype=np.int64)
for _c, _v in (("A", BASE_A), ("C", BASE_C), ("G", BASE_G), ("T", BASE_T),
               ("Y", BASE_Y), ("R", BASE_R)):
    _CHAR2INT8_TBL[ord(_c)] = _v


@dataclass
class PileupConf:
    comm: BiscCommon = field(default_factory=BiscCommon)
    bt: BiscThreads = field(default_factory=BiscThreads)
    filt: MethFilter = field(default_factory=MethFilter)
    ambi_redist: int = 1
    somatic: int = 0
    error: float = 0.001
    mu: float = 0.001
    mu_somatic: float = 0.001
    contam: float = 0.01
    prior1: float = 0.33333
    prior2: float = 0.33333

    @property
    def prior0(self) -> float:
        return 1.0 - self.prior1 - self.prior2


@dataclass
class PileupDatum:
    sid: int
    bsstrand: int
    qual: int
    strand: int
    qpos: int
    cnt_ret: int
    rlen: int
    qb: str
    stat: int


def pileup_genotype(cref: int, altsupp: int, conf: PileupConf):
    """pileup.c:389-413. Returns (gt, gl0, gl1, gl2, gq)."""
    gt = "./."
    gl0 = gl1 = gl2 = -1.0
    gq = -1.0
    if cref >= 0 or altsupp >= 0:
        gl0 = math.log(conf.prior0) + stats.genotype_lnlik(stats.HOMOREF, cref, altsupp, conf.error, conf.contam)
        gl1 = math.log(conf.prior1) + stats.genotype_lnlik(stats.HET, cref, altsupp, conf.error, conf.contam)
        gl2 = math.log(conf.prior2) + stats.genotype_lnlik(stats.HOMOVAR, cref, altsupp, conf.error, conf.contam)
        lsum = stats.ln_sum3(gl0, gl1, gl2)
        if gl0 > gl1:
            if gl0 > gl2:
                gq = stats.pval2qual(1 - math.exp(gl0 - lsum))
                gt = "0/0"
            else:
                gq = stats.pval2qual(1 - math.exp(gl2 - lsum))
                gt = "1/1"
        elif gl1 > gl2:
            gq = stats.pval2qual(1 - math.exp(gl1 - lsum))
            gt = "0/1"
        else:
            gq = stats.pval2qual(1 - math.exp(gl2 - lsum))
            gt = "1/1"
    return gt, gl0, gl1, gl2, gq


def _top_mutant(cnts_base1: List[int], rb_code: int) -> int:
    """pileup.c:312-333."""
    supp = []
    for i in range(NSTATUS_BASE):
        supp.append(((cnts_base1[i] << 4) | i) if i != BASE_N else 0)
    supp.sort(key=lambda v: -(v >> 4))
    for v in supp:
        base = v & 0xF
        if base == BASE_R and rb_code in (BASE_A, BASE_G):
            continue
        if base == BASE_Y and rb_code in (BASE_C, BASE_T):
            continue
        if base != BASE_N and base != rb_code and (v >> 4) > 0:
            return base
    return -1


def _redistribute_cnts(cnts_base: List[List[int]], rb_code: int) -> None:
    """pileup.c:339-370."""
    all_ = [0] * NSTATUS_BASE
    for row in cnts_base:
        for i in range(NSTATUS_BASE):
            all_[i] += row[i]
    for row in cnts_base:
        if (rb_code == BASE_T or all_[BASE_T]) and all_[BASE_C] == 0 and rb_code != BASE_C:
            row[BASE_T] += row[BASE_Y]
            row[BASE_Y] = 0
        if (rb_code == BASE_C or all_[BASE_C]) and all_[BASE_T] == 0 and rb_code != BASE_T:
            row[BASE_C] += row[BASE_Y]
            row[BASE_Y] = 0
        if (rb_code == BASE_A or all_[BASE_A]) and all_[BASE_G] == 0 and rb_code != BASE_G:
            row[BASE_A] += row[BASE_R]
            row[BASE_R] = 0
        if (rb_code == BASE_G or all_[BASE_G]) and all_[BASE_A] == 0 and rb_code != BASE_A:
            row[BASE_G] += row[BASE_R]
            row[BASE_R] = 0


def _plp_getcnts(dv: List[PileupDatum], conf: PileupConf, n_bams: int):
    cnts_meth = [[0] * NSTATUS_METH for _ in range(n_bams)]
    cnts_base = [[0] * NSTATUS_BASE for _ in range(n_bams)]
    for d in dv:
        if d.qual < conf.filt.min_base_qual:
            continue
        if d.qpos <= conf.filt.min_dist_end_5p or d.rlen < d.qpos + conf.filt.min_dist_end_3p:
            continue
        cnts_meth[d.sid][d.stat & 0xF] += 1
        cnts_base[d.sid][d.stat >> 4] += 1
    return cnts_meth, cnts_base


def _verbose_format(bsstrand: int, dv: List[PileupDatum], out: List[str], sid: int):
    """pileup.c:236-310."""
    sel = [d for d in dv if d.sid == sid and d.bsstrand == bsstrand]
    if not sel:
        return
    b = str(bsstrand)
    out.append(f";Bs{b}=" + "".join(d.qb for d in sel))
    out.append(f";Sta{b}=" + "".join(str(d.stat & 0xF) for d in sel))
    out.append(f";Bq{b}=" + "".join(chr(d.qual + 33) for d in sel))
    out.append(f";Str{b}=" + "".join("-" if d.strand else "+" for d in sel))
    out.append(f";Pos{b}=" + ",".join(str(d.qpos) for d in sel))
    out.append(f";Rret{b}=" + ",".join(str(d.cnt_ret) for d in sel))


def plp_format(rs: RefCache, chrm: str, rpos: int, dv: List[PileupDatum],
               conf: PileupConf, n_bams: int, betasum_context, cnt_context,
               pre=None) -> Optional[str]:
    """pileup.c:415-640. Returns the VCF line or None.

    When `pre` is given it is (cnts_meth, cnts_base, dp_per_sid) precomputed
    by the vectorized window path; dv is then only needed for verbose mode."""
    rb = rs.getbase_upcase(rpos)
    if rb == "N":
        return None
    rb_code = char_to_int8(rb)

    if pre is not None:
        cnts_meth, cnts_base, dp_per_sid = pre
    else:
        cnts_meth, cnts_base = _plp_getcnts(dv, conf, n_bams)
        dp_per_sid = None
    cnts_base_redist = [row[:] for row in cnts_base]
    if conf.ambi_redist:
        _redistribute_cnts(cnts_base_redist, rb_code)

    cnts_base_all = [0] * NSTATUS_BASE
    cnts_meth_all = [0] * NSTATUS_METH
    for sid in range(n_bams):
        for i in range(NSTATUS_METH):
            cnts_meth_all[i] += cnts_meth[sid][i]
        for i in range(NSTATUS_BASE):
            cnts_base_all[i] += cnts_base_redist[sid][i]

    cm1 = _top_mutant(cnts_base_all, rb_code)

    if (cm1 < 0 and not conf.comm.verbose
            and cnts_meth_all[METH_RETENTION] == 0
            and cnts_meth_all[METH_CONVERSION] == 0):
        return None

    gt = ["./."] * n_bams
    gl0 = [-1.0] * n_bams
    gl1 = [-1.0] * n_bams
    gl2 = [-1.0] * n_bams
    gq = [0.0] * n_bams
    methcallable = [0] * n_bams
    any_methcallable = 0
    lowest_gq = 0.0
    for sid in range(n_bams):
        cb1 = cnts_base_redist[sid]
        cm_1 = cnts_meth[sid]
        if cm_1[METH_RETENTION] + cm_1[METH_CONVERSION] > 0:
            if rb == "C":
                if cb1[BASE_T] == 0:
                    methcallable[sid] = 1
                elif cb1[BASE_C] > 0 and cb1[BASE_T] / cb1[BASE_C] < 0.05:
                    methcallable[sid] = 1
            if rb == "G":
                if cb1[BASE_A] == 0:
                    methcallable[sid] = 1
                elif cb1[BASE_G] > 0 and cb1[BASE_A] / cb1[BASE_G] < 0.05:
                    methcallable[sid] = 1
        nref = cb1[rb_code]
        nalt = cb1[cm1] if cm1 >= 0 else 0
        if nref + nalt > 0:
            gt[sid], gl0[sid], gl1[sid], gl2[sid], gq[sid] = \
                pileup_genotype(nref, nalt, conf)
        if gq[sid] < lowest_gq or sid == 0:
            lowest_gq = gq[sid]
        if methcallable[sid]:
            any_methcallable = 1

    squal = 0.0
    ss = 5
    if conf.somatic and cm1 >= 0:
        flat = [c for row in cnts_base_redist for c in row]
        cm1_t = _top_mutant(flat[:NSTATUS_BASE], rb_code) if False else None
        # reference calls top_mutant on the flattened 2-sample array, which
        # only inspects the first NSTATUS_BASE entries = the tumor sample
        cm1_t = _top_mutant(cnts_base_redist[0], rb_code)
        if cm1_t >= 0:
            altcnt_t = cnts_base_redist[0][cm1_t]
            altcnt_n = cnts_base_redist[1][cm1_t]
            cref_t = cnts_base_redist[0][rb_code]
            cref_n = cnts_base_redist[1][rb_code]
            squal = stats.pval2qual(stats.somatic_posterior(
                cref_t, altcnt_t, cref_n, altcnt_n, conf.error, conf.mu,
                conf.mu_somatic, conf.contam))
            if squal > 1:
                ss = 2
            elif gt[1][2] == "1":
                ss = 1
            else:
                ss = 0

    s: List[str] = []
    s.append(f"{chrm}\t{rpos}\t.\t{rb}\t")
    if cm1 >= 0:
        m = "N" if cm1 in (BASE_Y, BASE_R) else BASECODE[cm1]
        s.append(m)
    else:
        s.append(".")
    s.append(f"\t{int(lowest_gq)}")
    s.append("\tPASS\t" if lowest_gq > 5 else "\tLowQual\t")

    ctt = CTXT_NA
    s.append(f"NS={n_bams}")
    if rb in ("C", "G"):
        ctt, fivenuc = fivenuc_context(rs, rpos, rb)
        cx = CYTOSINE_CONTEXT_NOME[ctt] if conf.comm.is_nome else CYTOSINE_CONTEXT[ctt]
        s.append(f";CX={cx}")
        s.append(f";N5={fivenuc[:5]}")
    if conf.somatic and cm1 >= 0:
        s.append(f";SS={ss}")
        s.append(f";SC={int(squal)}")
    if cm1 >= 0 and cm1 in (BASE_Y, BASE_R):
        s.append(";AB=" + BASECODE[cm1])

    s.append("\tGT:GL1:GQ:DP")
    s.append(":SP")
    if cm1 >= 0:
        s.append(":AC:AF1")
    if any_methcallable:
        s.append(":CV:BT")

    for sid in range(n_bams):
        cb1 = cnts_base[sid]
        cb1r = cnts_base_redist[sid]
        cm_1 = cnts_meth[sid]
        dp = dp_per_sid[sid] if dp_per_sid is not None \
            else sum(1 for d in dv if d.sid == sid)
        if gq[sid] > 0 and dp:
            s.append("\t%s:%1.0f,%1.0f,%1.0f:%1.0f" % (
                gt[sid], max(-1000, gl0[sid]), max(-1000, gl1[sid]),
                max(-1000, gl2[sid]), gq[sid]))
        else:
            s.append("\t./.:.,.,.:0")
        s.append(f":{dp}" if dp else ":0")
        s.append(":")
        added = False
        parts = []
        if cb1[rb_code]:
            parts.append(f"{rb}{cb1[rb_code]}")
            added = True
        for i in range(NSTATUS_BASE):
            if i == BASE_N or i == rb_code or cb1[i] <= 0:
                continue
            parts.append(f"{BASECODE[i]}{cb1[i]}")
            added = True
        s.append("".join(parts) if added else ".")
        if cm1 >= 0:
            nref = cb1r[rb_code]
            nalt = cb1r[cm1]
            s.append(f":{nref + nalt}:")
            if nref + nalt:
                s.append("%1.2f" % (nalt / (nref + nalt)))
            else:
                s.append(".")
        if any_methcallable:
            if methcallable[sid]:
                beta = cm_1[METH_RETENTION] / (cm_1[METH_RETENTION] + cm_1[METH_CONVERSION])
                if ctt != CTXT_NA:
                    betasum_context[sid][ctt] += beta
                    cnt_context[sid][ctt] += 1
                s.append(":%d:%1.3f" % (cm_1[METH_RETENTION] + cm_1[METH_CONVERSION], beta))
            else:
                s.append(":0:.")
        if conf.comm.verbose:
            s.append("\tDIAGNOSE")
            s.append(f";RN={cm_1[METH_RETENTION]};CN={cm_1[METH_CONVERSION]}")
            _verbose_format(0, dv, s, sid)
            _verbose_format(1, dv, s, sid)

    s.append("\n")
    return "".join(s)


def pileup_window(bams: List[AlignmentFile], rs: RefCache, conf: PileupConf,
                  tid: int, chrm: str, beg: int, end: int,
                  betasum_context, cnt_context, device) -> str:
    """process one [beg, end) window (1-based beg, exclusive end) — the body
    of process_func (pileup.c:675-853). Dispatches to the C++ window engine
    when `device` is None (raw BAM records when `bams` are raw sources, else
    record objects); else, with the count matrices made on `device`, to the
    C++ walk of pileup/walk.py when `bams` are raw sources (which
    cli.main_pileup opens for the `native` and `device` engines only) or to
    the vectorized path; or to the per-datum path (verbose mode needs
    per-base diagnostic records)."""
    global _COUNT_SPAN
    if conf.comm.verbose:
        return _pileup_window_slow(bams, rs, conf, tid, chrm, beg, end,
                                   betasum_context, cnt_context)
    t0 = time.perf_counter()
    from .native import RawBamBase
    raw = bool(bams) and isinstance(bams[0], RawBamBase)
    if device is None:
        from .native import pileup_window_native, pileup_window_native_raw
        if raw:
            text = pileup_window_native_raw(bams, rs, conf, tid, chrm, beg,
                                            end, betasum_context, cnt_context)
        else:
            text = pileup_window_native(bams, rs, conf, tid, chrm, beg, end,
                                        betasum_context, cnt_context)
        STAGES["native"] += time.perf_counter() - t0
        STAGES["windows"] += 1
        STAGES["sites"] += text.count("\n")
        return text
    _COUNT_SPAN = None
    if raw:
        from .walk import pileup_window_walk
        text = pileup_window_walk(bams, rs, conf, tid, chrm, beg, end,
                                  betasum_context, cnt_context, device)
        STAGES["raw_windows"] += _COUNT_SPAN is not None
    else:
        text = _pileup_window_fast(bams, rs, conf, tid, chrm, beg, end,
                                   betasum_context, cnt_context, device)
    t1 = time.perf_counter()
    entered, left = _COUNT_SPAN or (t1, t1)
    STAGES["decode"] += entered - t0
    STAGES["count"] += left - entered
    STAGES["emit"] += t1 - left
    STAGES["windows"] += _COUNT_SPAN is not None
    STAGES["sites"] += text.count("\n")
    return text


def _read_passes_filters(b: AlnRecord, conf: PileupConf) -> bool:
    if b.mapq < conf.filt.min_mapq:
        return False
    if b.l_qseq < conf.filt.min_read_len:
        return False
    if b.flag > 0:
        if conf.filt.filter_secondary and (b.flag & FLAG_SECONDARY):
            return False
        if conf.filt.filter_duplicate and (b.flag & FLAG_DUP):
            return False
        if conf.filt.filter_ppair and (b.flag & FLAG_PAIRED) and not (b.flag & FLAG_PROPER):
            return False
        if conf.filt.filter_qcfail and (b.flag & FLAG_QCFAIL):
            return False
    nm = b.get_tag("NM")
    if nm is not None and nm > conf.filt.max_nm:
        return False
    as_ = b.get_tag("AS")
    if as_ is not None and as_ < conf.filt.min_score:
        return False
    return True


def _pileup_window_fast(bams: List[AlignmentFile], rs: RefCache, conf: PileupConf,
                        tid: int, chrm: str, beg: int, end: int,
                        betasum_context, cnt_context, device) -> str:
    """Vectorized window pileup: per-read numpy base extraction, count
    matrices over (pos, sample, status) made on `device`, and a vectorized
    emit mask — byte-identical output to the per-datum path."""
    n_bams = len(bams)
    rs.fetch(chrm, beg - 100 if beg > 100 else 1, end + 100)
    ref = rs.arr
    seqlen = rs.seqlen
    P = end - beg

    pos_l, sid_l, stat_l, pass_l = [], [], [], []
    f = conf.filt
    for sid, bam in enumerate(bams):
        for b in bam.fetch(tid, (beg - 1) if beg > 1 else 1, end):
            if not _read_passes_filters(b, conf):
                continue
            rp, qp = aligned_bases_np(b)
            if len(rp) == 0:
                continue
            qarr = np.frombuffer(b.seq.encode(), dtype=np.uint8)
            bsstrand = get_bsstrand_np(rs, b, conf.filt.min_base_qual, 0,
                                       rp, qp, qarr)
            cnt_ret = cnt_retention_np(rs, b, bsstrand, rp, qp, qarr)
            if cnt_ret > conf.filt.max_retention:
                continue
            keep = (rp >= beg) & (rp < end)
            if conf.filt.filter_doublecnt and (b.flag & FLAG_READ2):
                rpos0 = b.pos + 1
                rmpos = b.mpos + 1
                read_length = b.rlen()
                mc = b.get_tag("MC")
                mate_length = get_mate_length(mc) if mc is not None else read_length
                rend = rpos0 + read_length - 1
                rmend = rmpos + mate_length - 1
                keep &= ~((rp >= max(rpos0, rmpos)) & (rp <= min(rend, rmend)))
            if not keep.any():
                continue
            rpk = rp[keep]
            qpk = qp[keep]
            okq = qpk < len(qarr)
            qb = np.where(okq, qarr[np.minimum(qpk, len(qarr) - 1)], ord("N"))
            valid_r = (rpk >= 1) & (rpk <= seqlen)
            rb = np.where(valid_r, ref[np.minimum(rpk, seqlen) - 1], ord("N"))
            base = _CHAR2INT8_TBL[qb]
            if bsstrand:  # BSC
                meth = np.where(rb == ord("G"),
                                np.where(qb == ord("A"), METH_CONVERSION,
                                         np.where(qb == ord("G"), METH_RETENTION,
                                                  METH_NA)),
                                METH_NA)
                base = np.where(qb == ord("A"), BASE_R, base)
            else:  # BSW
                meth = np.where(rb == ord("C"),
                                np.where(qb == ord("T"), METH_CONVERSION,
                                         np.where(qb == ord("C"), METH_RETENTION,
                                                  METH_NA)),
                                METH_NA)
                base = np.where(qb == ord("T"), BASE_Y, base)
            stat = meth | (base << 4)
            if b.qual != "*":
                quals = np.frombuffer(b.qual.encode(), dtype=np.uint8)
                q = np.where(qpk < len(quals),
                             quals[np.minimum(qpk, len(quals) - 1)].astype(np.int64) - 33,
                             -33)
            else:
                q = np.zeros(len(rpk), np.int64)
            pos_l.append(rpk)
            sid_l.append(np.full(len(rpk), sid, np.int64))
            stat_l.append(stat)
            # datum-level filter (pileup.c plp_getcnts): base qual, distance
            # from the 5'/3' read ends
            pass_l.append((q >= f.min_base_qual) & (qpk + 1 > f.min_dist_end_5p)
                          & (b.l_qseq >= qpk + 1 + f.min_dist_end_3p))

    if not pos_l:
        return ""
    pos = np.concatenate(pos_l)
    sid = np.concatenate(sid_l)
    stat = np.concatenate(stat_l)
    passm = np.concatenate(pass_l)

    p = pos - beg  # 0..P-1
    # count matrices via the scatter-add kernel (ops/pileup_count.py)
    cm, cb, dp_arr = _device_counts(p, sid, stat, passm, P, n_bams, device)

    # vectorized emit mask: position must have data, non-N ref, and either
    # meth signal or a potential alt allele (see _top_mutant semantics: Y is
    # never an alt for C/T refs, R never for A/G refs; redistribution can only
    # move Y/R counts into already-occupied or ref categories when no other
    # non-ref base is present)
    covered = dp_arr.sum(axis=1) > 0
    rbw = np.full(P, ord("N"), np.int64)
    wpos = np.arange(beg, end)
    vr = (wpos >= 1) & (wpos <= seqlen)
    rbw[vr] = ref[np.minimum(wpos[vr], seqlen) - 1]
    rb_codew = _CHAR2INT8_TBL[np.minimum(rbw, 255)]
    meth_sig = (cm[:, :, METH_RETENTION].sum(axis=1)
                + cm[:, :, METH_CONVERSION].sum(axis=1)) > 0
    ball = cb.sum(axis=1)  # [P, NSTATUS_BASE]
    nonref = ball.sum(axis=1) - ball[np.arange(P), np.minimum(rb_codew, NSTATUS_BASE - 1)] \
        - ball[:, BASE_N]
    # subtract always-excluded ambiguity codes
    y_excl = np.isin(rb_codew, (BASE_C, BASE_T))
    r_excl = np.isin(rb_codew, (BASE_A, BASE_G))
    maybe_alt = nonref - np.where(y_excl, ball[:, BASE_Y], 0) \
        - np.where(r_excl, ball[:, BASE_R], 0) > 0
    emit = covered & (rbw != ord("N")) & (meth_sig | maybe_alt)

    out = []
    for pi in np.nonzero(emit)[0]:
        cnts_meth = cm[pi].tolist()
        cnts_base = cb[pi].tolist()
        dp_per_sid = dp_arr[pi].tolist()
        line = plp_format(rs, chrm, beg + int(pi), None, conf, n_bams,
                          betasum_context, cnt_context,
                          pre=(cnts_meth, cnts_base, dp_per_sid))
        if line:
            out.append(line)
    return "".join(out)


# device -> (host input, device input, host counts): buffers reused from
# window to window and grown as needed; pinned on a CUDA device
_STAGING: Dict[str, tuple] = {}
# a datum's stat (base << 4 | meth, below 0x70) to its code base * 3 + meth
_CODE_OF_STAT = np.array([(s >> 4) * NSTATUS_METH + (s & 0xF)
                          for s in range(256)], np.uint8)


def _staged(device, n_in: int, n_out: int):
    """The buffers of `device`: uint8 input of at least n_in bytes on the
    host and on the device (one tensor on the CPU), int32 counts of at least
    n_out words on the host."""
    key = str(device)
    bufs = _STAGING.get(key)
    if bufs is None or bufs[0].numel() < n_in or bufs[2].numel() < n_out:
        n_in = max(n_in * 5 // 4, bufs[0].numel() if bufs else 0)
        n_out = max(n_out, bufs[2].numel() if bufs else 0)
        cuda = torch.device(device).type == "cuda"
        host = torch.empty(n_in, dtype=torch.uint8, pin_memory=cuda)
        back = torch.empty(n_out, dtype=torch.int32, pin_memory=cuda)
        dev = torch.empty(n_in, dtype=torch.uint8, device=device) if cuda else host
        bufs = _STAGING[key] = (host, dev, back)
    return bufs


def _device_counts(p, sid, stat, passm, P: int, n_bams: int, device):
    """Count matrices on `device` in one call of the fused window count
    (ops/pileup_count.pileup_window_counts): the datum arrays go to the
    device once as 6 bytes a datum (int32 site * n_bams + sample, uint8
    base * 3 + meth, the pass flag), staged in one host buffer; cm, cb and
    the depth are summed there and come back as int64 numpy arrays
    cm [P, n_bams, 3], cb [P, n_bams, 7] and dp [P, n_bams]. Both walks of
    the `device` engine count here: _pileup_window_fast's arrays and those
    the C++ walk of pileup/walk.py decodes. The window's count span holds
    the copy, the count and the copy back. On a Mesh this rank stages and counts its
    contiguous slice of the window's data on its device, and the [window, N_WORDS] counts are summed over the ranks of
    the dp axis (all_reduce); the ranks call it in lockstep, window by
    window, and the integer sums give the one-rank counts."""
    global _COUNT_SPAN
    n_window, window = len(p), P * n_bams
    mesh = device if isinstance(device, Mesh) else None
    if mesh is not None:
        lo, hi = shard_bounds(n_window, mesh)
        p, sid, stat, passm = (a[lo:hi] for a in (p, sid, stat, passm))
        device = mesh.device
    n = len(p)
    host, dev, back = _staged(device, 6 * n, window * N_WORDS)
    h = host.numpy()
    sites = h[:4 * n].view(np.int32)
    if n_bams == 1:
        np.copyto(sites, p, casting="unsafe")
    else:
        np.multiply(p, n_bams, out=sites, casting="unsafe")
        np.add(sites, sid, out=sites, casting="unsafe")
    np.take(_CODE_OF_STAT, stat, out=h[4 * n:5 * n])  # a stat past 255 raises
    h[5 * n:6 * n] = passm
    entered = time.perf_counter()
    if dev is not host:
        dev[:6 * n].copy_(host[:6 * n], non_blocking=True)
    counts, n_wide = pileup_window_counts(
        dev[:4 * n].view(torch.int32), dev[4 * n:5 * n],
        dev[5 * n:6 * n].view(torch.bool), window)
    if mesh is not None:
        counts = group_sum(counts, mesh.group("dp"))
    if counts.device.type != "cpu":
        counts = back[:window * N_WORDS].view(window, N_WORDS).copy_(counts)
    _COUNT_SPAN = (entered, time.perf_counter())
    c = counts.numpy().reshape(P, n_bams, N_WORDS)
    cm = c[..., CM].astype(np.int64)
    cb = c[..., CB].astype(np.int64)
    dp_arr = c[..., DP].astype(np.int64)
    STAGES["data"] += n_window
    STAGES["wide_chunks"] += n_wide or 0
    return cm, cb, dp_arr


def _pileup_window_slow(bams: List[AlignmentFile], rs: RefCache, conf: PileupConf,
                        tid: int, chrm: str, beg: int, end: int,
                        betasum_context, cnt_context) -> str:
    n_bams = len(bams)
    plp: Dict[int, List[PileupDatum]] = {}
    rs.fetch(chrm, beg - 100 if beg > 100 else 1, end + 100)
    for sid, bam in enumerate(bams):
        for b in bam.fetch(tid, (beg - 1) if beg > 1 else 1, end):
            bsstrand = get_bsstrand(rs, b, conf.filt.min_base_qual, 0)
            if b.mapq < conf.filt.min_mapq:
                continue
            if b.l_qseq < conf.filt.min_read_len:
                continue
            if b.flag > 0:
                if conf.filt.filter_secondary and (b.flag & FLAG_SECONDARY):
                    continue
                if conf.filt.filter_duplicate and (b.flag & FLAG_DUP):
                    continue
                if conf.filt.filter_ppair and (b.flag & FLAG_PAIRED) and not (b.flag & FLAG_PROPER):
                    continue
                if conf.filt.filter_qcfail and (b.flag & FLAG_QCFAIL):
                    continue
            nm = b.get_tag("NM")
            if nm is not None and nm > conf.filt.max_nm:
                continue
            as_ = b.get_tag("AS")
            if as_ is not None and as_ < conf.filt.min_score:
                continue
            cnt_ret = cnt_retention(rs, b, bsstrand)
            if cnt_ret > conf.filt.max_retention:
                continue
            rpos0 = b.pos + 1
            rmpos = b.mpos + 1
            read_length = b.rlen()
            mc = b.get_tag("MC")
            mate_length = get_mate_length(mc) if mc is not None else read_length
            rend = rpos0 + read_length - 1
            rmend = rmpos + mate_length - 1
            seq, qual = b.seq, b.qual
            for rp, qp in iter_aligned_bases(b):
                if rp < beg or rp >= end:
                    continue
                rb = rs.getbase_upcase(rp)
                qb = seq[qp] if qp < len(seq) else "N"
                if (conf.filt.filter_doublecnt and (b.flag & FLAG_READ2)
                        and rp >= max(rpos0, rmpos) and rp <= min(rend, rmend)):
                    continue
                stat = 0
                if bsstrand:  # BSC
                    if rb == "G":
                        if qb == "A":
                            stat = METH_CONVERSION
                        elif qb == "G":
                            stat = METH_RETENTION
                        else:
                            stat = METH_NA
                    else:
                        stat = METH_NA
                    if qb == "A":
                        stat |= BASE_R << 4
                    else:
                        stat |= char_to_int8(qb) << 4
                else:  # BSW
                    if rb == "C":
                        if qb == "T":
                            stat = METH_CONVERSION
                        elif qb == "C":
                            stat = METH_RETENTION
                        else:
                            stat = METH_NA
                    else:
                        stat = METH_NA
                    if qb == "T":
                        stat |= BASE_Y << 4
                    else:
                        stat |= char_to_int8(qb) << 4
                plp.setdefault(rp, []).append(PileupDatum(
                    sid=sid,
                    bsstrand=bsstrand,
                    qual=(ord(qual[qp]) - 33) if qual != "*" else 0,
                    strand=1 if (b.flag & FLAG_REVERSE) else 0,
                    qpos=qp + 1,
                    cnt_ret=cnt_ret,
                    rlen=b.l_qseq,
                    qb=qb,
                    stat=stat))
    out = []
    for j in range(beg, end):
        dv = plp.get(j)
        if dv:
            line = plp_format(rs, chrm, j, dv, conf, n_bams,
                              betasum_context, cnt_context)
            if line:
                out.append(line)
    return "".join(out)


# ---- window execution (bisc_threads_t equivalent) -------------------------
# The reference runs windows on a thread pool (pileup.c process/wqueue,
# default 3 threads) and writes results back in window order. We fork
# worker processes sharing the parent's in-memory BAM/reference via
# copy-on-write and stream results back in submission order. A CUDA context
# does not survive a fork, so the windows of the device engine on a CUDA
# device run in order in the one process that owns the card; a window of the
# C++ engine (device None) uses no torch, so its workers fork from a process
# with a CUDA context as well. The output is the same either way.
_POOL_G = None


def _window1(bams, rs, conf, device, job):
    tid, name, wbeg, wend = job
    n_bams = len(bams)
    bs = [[0.0] * NCONTXTS for _ in range(n_bams)]
    cs = [[0] * NCONTXTS for _ in range(n_bams)]
    text = pileup_window(bams, rs, conf, tid, name, wbeg, wend, bs, cs, device)
    return text, bs, cs


def _pool_window1(job):
    return _window1(*_POOL_G, job)


def run_windows(bams, rs, conf, windows, n_procs, device):
    """Yield (window, text, bs, cs) for each (tid, name, beg, end) window, in
    order: computed by a fork pool of n_procs workers when n_procs > 1 and
    the windows run on the C++ engine (device None) or on the CPU, else (a
    CUDA device, a Mesh) one after the other in this process."""
    global _POOL_G
    if isinstance(device, Mesh) or n_procs <= 1 or (
            device is not None and device.type != "cpu"):
        for w in windows:
            yield (w, *_window1(bams, rs, conf, device, w))
        return
    _POOL_G = (bams, rs, conf, device)
    import multiprocessing as mp
    ctx = mp.get_context("fork")
    try:
        # a worker runs its torch ops on one thread: the pool is the
        # parallelism, and the intra-op threads of a parent that has used
        # them do not exist in a forked child
        with ctx.Pool(n_procs, initializer=torch.set_num_threads,
                      initargs=(1,)) as pool:
            for w, (text, bs, cs) in zip(windows,
                                         pool.imap(_pool_window1, windows,
                                                   chunksize=1)):
                yield w, text, bs, cs
    finally:
        _POOL_G = None


def vcf_header(reffn: str, targets, argv: List[str], conf: PileupConf,
               in_fns: List[str]) -> str:
    """print_vcf_header (pileup.c:874-942)."""
    h = []
    h.append("##fileformat=VCFv4.1\n")
    h.append(f"##reference={reffn}\n")
    h.append(f"##source=biscuit_tpuV{__version__}\n")
    for name, length in targets:
        h.append(f"##contig=<ID={name},length={length}>\n")
    h.append("##program=<cmd=biscuit_tpu")
    for a in argv:
        h.append(f" {a}")
    h.append(">\n")
    h.append('##FILTER=<ID=PASS,Description="All filters passed">\n')
    h.append('##FILTER=<ID=LowQual,Description="Genotype quality smaller than 5">\n')
    h.append('##INFO=<ID=NS,Number=1,Type=Integer,Description="Number of samples with data">\n')
    if conf.comm.is_nome:
        h.append('##INFO=<ID=CX,Number=1,Type=String,Description="Cytosine context (HCG, HCHG, HCHH, GCG, GCH)">\n')
    else:
        h.append('##INFO=<ID=CX,Number=1,Type=String,Description="Cytosine context (CG, CHH or CHG)">\n')
    h.append('##INFO=<ID=N5,Number=1,Type=String,Description="5-nucleotide context, centered around target cytosine">\n')
    h.append('##INFO=<ID=AB,Number=A,Type=String,Description="When true alt-allele is ambiguous, ALT field will be N and true alt-allele is stored here, following IUPAC code convention. This option does not appear when ALT != N.">\n')
    if conf.somatic:
        h.append('##INFO=<ID=SS,Number=1,Type=String,Description="Somatic status 0) WILDTYPE; 1) GERMLINE; 2) SOMATIC; 3) LOH; 4) POST_TRX_MOD; 5) UNKNOWN;">\n')
        h.append('##INFO=<ID=SC,Number=1,Type=Float,Description="Somatic score">\n')
        h.append('##INFO=<ID=AF1,Number=1,Type=Float,Description="Variant allele fraction">\n')
    h.append('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Raw read depth">\n')
    h.append('##FORMAT=<ID=SP,Number=.,Type=String,Description="Allele support (considering bisulfite conversion, with filtering)">\n')
    h.append('##FORMAT=<ID=AC,Number=.,Type=Integer,Description="Depth in calculating alternative allele frequency (after inference, with filtering)">\n')
    h.append('##FORMAT=<ID=AF1,Number=.,Type=Float,Description="Alternative allele frequency (after inference, with filtering)">\n')
    h.append('##FORMAT=<ID=CV,Number=1,Type=Integer,Description="Effective (strand-specific) coverage on cytosine">\n')
    h.append('##FORMAT=<ID=BT,Number=1,Type=Float,Description="Cytosine methylation fraction (aka beta value, with filtering)">\n')
    h.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype from normal">\n')
    h.append('##FORMAT=<ID=GL1,Number=3,Type=Float,Description="Genotype likelihoods for the first alternative allele">\n')
    h.append('##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality (phred-scaled)">\n')
    if conf.comm.verbose:
        h.append('##FORMAT=<ID=RN,Number=1,Type=Integer,Description="Retention count (with filtering)">\n')
        h.append('##FORMAT=<ID=CN,Number=1,Type=Integer,Description="Conversion count (with filtering)">\n')
        for pb, b in (("BSW", "0"), ("BSC", "1")):
            h.append(f'##FORMAT=<ID=Bs{b},Number=1,Type=String,Description="base identity, {pb}">\n')
            h.append(f'##FORMAT=<ID=Sta{b},Number=1,Type=String,Description="Status code, {pb} (0,1,2 for retention, conversion and NA)">\n')
            h.append(f'##FORMAT=<ID=Bq{b},Number=1,Type=String,Description="base quality, {pb}">\n')
            h.append(f'##FORMAT=<ID=Str{b},Number=1,Type=String;Description="strands, {pb}">\n')
            h.append(f'##FORMAT=<ID=Pos{b},Number=1,Type=String;Description="position in read, {pb}">\n')
            h.append(f'##FORMAT=<ID=Rret{b},Number=1,Type=String;Description="Number of retention in read, {pb}">\n')
    h.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
    for fn in in_fns:
        bname = os.path.basename(fn)
        if bname.endswith(".bam"):
            bname = bname[:-4]
        h.append("\t" + bname)
    h.append("\n")
    return "".join(h)


def meth_average_table(conf: PileupConf, sample: str, targets, betasum, cnt) -> List[str]:
    """print_meth_average1 equivalents (pileup.c:71-143). betasum/cnt are
    dicts tid -> [NCONTXTS] arrays."""
    lines = []
    gw_b = [0.0] * NCONTXTS
    gw_c = [0] * NCONTXTS

    def one_chrom(chrom, b, c):
        if conf.comm.is_nome:
            k_hcg, b_hcg = c[0], b[0]
            k_hchg, b_hchg = c[1], b[1]
            k_hchh, b_hchh = c[2], b[2]
            k_hch, b_hch = k_hchg + k_hchh, b_hchg + b_hchh
            k_gch = c[3] + c[4] + c[5]
            b_gch = b[3] + b[4] + b[5]
            if k_hcg > 0:
                lines.append("%s\t%s\t%d\t%1.3f%%\t%d\t%1.3f%%\t%d\t%1.3f%%\t%d\t%1.3f%%\t%d\t%1.3f%%\n" % (
                    sample, chrom,
                    k_hcg, (b_hcg / k_hcg * 100) if k_hcg else 0,
                    k_hchg, (b_hchg / k_hchg * 100) if k_hchg else 0,
                    k_hchh, (b_hchh / k_hchh * 100) if k_hchh else 0,
                    k_hch, (b_hch / k_hch * 100) if k_hch else 0,
                    k_gch, (b_gch / k_gch * 100) if k_gch else 0))
        else:
            k_cg, b_cg = c[3] + c[0], b[3] + b[0]
            k_chg, b_chg = c[4] + c[1], b[4] + b[1]
            k_chh, b_chh = c[5] + c[2], b[5] + b[2]
            k_ch, b_ch = k_chg + k_chh, b_chg + b_chh
            if k_cg > 0:
                lines.append("%s\t%s\t%d\t%1.3f%%\t%d\t%1.3f%%\t%d\t%1.3f%%\t%d\t%1.3f%%\n" % (
                    sample, chrom,
                    k_cg, (b_cg / k_cg * 100) if k_cg else 0,
                    k_chg, (b_chg / k_chg * 100) if k_chg else 0,
                    k_chh, (b_chh / k_chh * 100) if k_chh else 0,
                    k_ch, (b_ch / k_ch * 100) if k_ch else 0))

    for tid, (name, _len) in enumerate(targets):
        b = betasum.get(tid, [0.0] * NCONTXTS)
        c = cnt.get(tid, [0] * NCONTXTS)
        one_chrom(name, b, c)
        for k in range(NCONTXTS):
            gw_b[k] += b[k]
            gw_c[k] += c[k]
    one_chrom("WholeGenome", gw_b, gw_c)
    return lines
