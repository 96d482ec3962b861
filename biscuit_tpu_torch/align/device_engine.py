"""Device alignment engine (torch): SE and PE reads through the device kernels.

Port of DeviceAligner / prefill_setSAM / process_seqs_device of
biscuit_tpu/align/device_engine.py. The host logic (chaining, region
bookkeeping, SAM) is the same code, driven through the extension-request
generator protocol (region.chain2region_gen). Output is identical to the
host engine and to the JAX device engine (tests/test_torch_engine.py).

Batch flow per call:
  1. host: read clipping + in-silico conversion; (read, parent) lanes
  2. device: 3-pass SMEM seed collection (ops/seed_batch.collect_intv_flat,
     K3 with K5); lanes over its S-row capacity rerun smem.collect_intv
  3. device: batched SA walks for the first SA_PREFETCH_CAP occurrences of
     every seed: the seeder's rows, as they lie on the card, through K4's
     interval entry (ops/seed_batch.sa_batch_intervals); the rows of lanes
     the host seeded through its rank entry (sa_batch)
  4. device: the chain B-tree scan (chain.mem_chain_batch over
     ops/chain_batch.chain_scan_batch, K6); lanes over its caps, and every
     lane at -v4, run the host chain.mem_chain. Then host chain filtering
  5. device: banded extension (ops/sw_extend, K1), scheduled in rounds
     across lanes
  6. device: global alignment + traceback for every region SAM may print
     (a superset), one launch a chunk (ops/sw_global.sw_global_cigar, K2),
     into a cache that worker2's alnreg_setSAM calls read; lanes whose
     traceback overflows max_ops are realigned by the scalar sw.sw_global
  7. PE only, over the whole chunk: host insert-size statistics (pestat),
     then batched mate rescue (region.matesw_batch), every candidate's
     ksw_align2 in one forward and one reverse call of K7
     (ops/sw_local), replayed per pair on the host
  8. host: region merge, primary marking, pairing, SAM

Every op runs on `device`: CUDA launches the kernels, the CPU runs their
plain torch versions. The three DP kernels (K1, K7, K2) take a query of
any width the engine meets: past the widest compiled strip they run their
wide instance, on the card like the others.
"""
import copy
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import MemOpt, MEM_F_NO_RESCUE, MEM_F_PE
from ..ops import sw
from ..align.io_helpers import read_clipping

from ..ops.seed_batch import (FMPair, collect_intv_batch, sa_batch,
                              sa_batch_intervals)
from ..ops.sw_extend import sw_extend_batch
from ..ops.sw_global import decode_cigars, sw_global_cigar
from ..ops.sw_local import sw_align_batch
from . import sam as sammod
from . import trace
from .chain import (mem_chain, mem_chain_batch, mem_chain_flt,
                    mem_flt_chained_seeds)
from .pair import pestat
from .region import AlnRegs, chain2region_gen, matesw_batch, merge_regions
from .smem import collect_intv
from .pipeline import AlignerState, bsconvert, worker2_pe, worker2_se

# stage wall-clock accumulator: seconds per stage, read by stage_report()
_STAGE_T: Dict[str, float] = {}
# lane counts, read by stage_report(). The *_lanes past a device capacity
# contract are each redone exactly on the host (a capacity contract, not a
# fallback): seeding lanes over the seeder's S rows (smem.collect_intv),
# chaining lanes over the scan's KMAX, JMAX or NC (chain.mem_chain),
# global-alignment lanes whose traceback overflowed max_ops (sw.sw_global).
# rescue_lanes: the lanes sent to K7, forward and reverse passes together.
# cigar_late_lanes: global alignments that worker2 asked for and the CIGAR
# prefill had not computed, run then through K2 on the device.
# sa_rows, sa_jobs: seed rows and occurrences sent to K4's interval entry;
# sa_overflow_jobs: occurrences of host-seeded lanes sent to its rank entry.
_COUNTS = {"seed_overflow_lanes": 0, "chain_host_lanes": 0,
           "traceback_overflow_lanes": 0, "rescue_lanes": 0,
           "cigar_late_lanes": 0, "sa_rows": 0, "sa_jobs": 0,
           "sa_overflow_jobs": 0}
# stages whose work runs on the device, as the JAX engine counts them
_DEVICE_STAGES = ("seed", "sa", "chain_scan", "extend", "cigar", "rescue")


class _stage:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _STAGE_T[self.name] = (_STAGE_T.get(self.name, 0.0)
                               + time.perf_counter() - self.t0)


def stage_report() -> Dict[str, float]:
    """Per-stage seconds, the share of the device-dispatching stages, the
    counts of lanes redone on the host and of the lanes of mate rescue."""
    total = sum(_STAGE_T.values())
    dev = sum(_STAGE_T.get(k, 0.0) for k in _DEVICE_STAGES)
    rep = dict(_STAGE_T)
    rep["total_s"] = total
    rep["device_share"] = dev / total if total else 0.0
    rep.update(_COUNTS)
    return rep


def reset_stages() -> None:
    _STAGE_T.clear()
    for k in _COUNTS:
        _COUNTS[k] = 0


SA_PREFETCH_CAP = 64
# reads per device sweep (as in the JAX engine)
DEVICE_BATCH = int(os.environ.get("BISCUIT_TPU_DEVICE_BATCH", "16384"))


def pack_lanes(lanes):
    """The seeder's input for (seq, parent) lanes: each read converted for
    its strand, padded with 4. Returns (reads [B, L] int32, lens [B],
    parents [B]) as numpy."""
    B = len(lanes)
    q = np.full((B, max([s.l_seq for s, _p in lanes] + [1])), 4, np.int32)
    lens = np.zeros(B, np.int32)
    parents = np.zeros(B, np.int32)
    for i, (s, p) in enumerate(lanes):
        q[i, :s.l_seq] = bsconvert(s, p)
        lens[i] = s.l_seq
        parents[i] = p
    return q, lens, parents


def _sa_lookup(pos, off, kmax, r0, fm):
    """sa_lookup(seed_i, k, x0) of a lane whose seed rows start at row r0 of
    a K4 call: position pos[off[r] + k] for k below the row's kmax, the
    scalar walk of strand fm beyond."""
    def sa_lookup(seed_i, k, x0):
        r = r0 + seed_i
        if k < kmax[r]:
            return int(pos[off[r] + k])
        return fm.sa_s(x0 + k)  # beyond prefetch: scalar walk
    return sa_lookup


class DeviceAligner:
    def __init__(self, st: AlignerState, device):
        self.st = st
        self.device = torch.device(device)
        self.fmpair = FMPair.from_index(st.idx, self.device)
        self._mats_cache = None

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def sw_local_batch_fn(self, opt: MemOpt):
        """(reqs, xsubo) -> [KswResult]: exact ksw_align2 for mate rescue
        on the device (ops/sw_local, K7). reqs carry matsel as parent:
        mats[0] = ctmat, mats[1] = gamat (region._matesw_core), the reverse
        of the extension's order in `_mats`."""
        mats_np = np.stack([np.asarray(opt.ctmat, np.int64),
                            np.asarray(opt.gamat, np.int64)])

        def fn(reqs, xsubo):
            res, n_lanes = sw_align_batch(reqs, opt.o_del, opt.e_del,
                                          opt.o_ins, opt.e_ins, mats_np,
                                          xsubo, self.device)
            _COUNTS["rescue_lanes"] += n_lanes
            return res
        return fn

    # ------------------------------------------------------------------
    def _collect_seeds(self, opt: MemOpt, lanes: List[Tuple]):
        """lanes: list of (seq, parent). Returns per-lane seed lists and SA
        position lookups."""
        st = self.st
        fmp = self.fmpair
        with _stage("seed"):
            q, lens, parents = pack_lanes(lanes)
            parents = self._tensor(parents)
            seeds, overflow, lane_of, rows = collect_intv_batch(
                fmp, self._tensor(q), self._tensor(lens), parents, opt,
                on_device=True)
            # lanes over the seeder's S rows: the exact host seeder
            for i in np.nonzero(overflow)[0]:
                s, p = lanes[i]
                fm, fmc = st.fm_pair(p)
                seeds[i] = collect_intv(opt, fm, fmc, bsconvert(s, p))
            _COUNTS["seed_overflow_lanes"] += int(overflow.sum())

        with _stage("sa"):
            # the first SA_PREFETCH_CAP occurrences of every seed. The
            # seeder's rows go to K4's interval entry as they lie on the
            # card, in one call; the rows of host-seeded lanes go to its rank
            # entry, expanded here, in another
            sizes = np.fromiter((r[4] for i, lane in enumerate(seeds)
                                 if not overflow[i] for r in lane), np.int64)
            kmax = np.minimum(sizes, SA_PREFETCH_CAP)
            off = np.cumsum(kmax) - kmax
            kmax_row = rows[:, 4].clamp(max=SA_PREFETCH_CAP).long()
            pos = sa_batch_intervals(
                fmp, parents.index_select(0, lane_of), rows[:, 2], kmax_row,
                torch.cumsum(kmax_row, 0) - kmax_row, int(kmax.sum()))
            ov = [(lanes[i][1], r[2], min(r[4], SA_PREFETCH_CAP))
                  for i in np.nonzero(overflow)[0] for r in seeds[i]]
            ov_which, ov_x0, ov_kmax = (np.asarray([r[c] for r in ov], np.int64)
                                        for c in range(3))
            ov_off = np.cumsum(ov_kmax) - ov_kmax
            n_ov = int(ov_kmax.sum())
            pos_ov = np.zeros(0, np.int64)
            if n_ov:
                rdt = np.int64 if fmp.wide else np.int32
                ranks = (np.repeat(ov_x0 - ov_off, ov_kmax)
                         + np.arange(n_ov)).astype(rdt)
                pos_ov = sa_batch(fmp, self._tensor(np.repeat(
                    ov_which, ov_kmax).astype(np.int32)),
                    self._tensor(ranks)).cpu().numpy()
            pos = pos.cpu().numpy()
            _COUNTS["sa_rows"] += int(kmax.size)
            _COUNTS["sa_jobs"] += int(kmax.sum())
            _COUNTS["sa_overflow_jobs"] += n_ov

        lookups = []
        kmax, off, ov_kmax, ov_off = (a.tolist() for a in (kmax, off, ov_kmax,
                                                           ov_off))
        r_dev = r_ov = 0
        for i, ((_s, p), lane_seeds) in enumerate(zip(lanes, seeds)):
            if overflow[i]:
                lookups.append(_sa_lookup(pos_ov, ov_off, ov_kmax, r_ov,
                                          st.fm[p]))
                r_ov += len(lane_seeds)
            else:
                lookups.append(_sa_lookup(pos, off, kmax, r_dev, st.fm[p]))
                r_dev += len(lane_seeds)
        return seeds, lookups

    # ------------------------------------------------------------------
    def _extend_scheduled(self, opt: MemOpt, jobs: List):
        """jobs: generators yielding 6-tuples (qs, rs, aw, pen, h0, parent).
        Runs them all to completion with batched device SW rounds."""
        active: List[list] = []
        for gen in jobs:
            try:
                active.append([gen, next(gen)])
            except StopIteration:
                pass
        while active:
            B = len(active)
            Lq = max(max(len(e[1][0]), 1) for e in active)
            Lt = max(max(len(e[1][1]), 1) for e in active)
            q = np.zeros((B, Lq), np.int32)
            t = np.zeros((B, Lt), np.int32)
            qlens = np.ones(B, np.int32)
            tlens = np.ones(B, np.int32)
            ws = np.ones(B, np.int32)
            ebs = np.zeros(B, np.int32)
            h0s = np.ones(B, np.int32)
            msel = np.zeros(B, np.int32)
            for i, (_gen, (qs, rs, aw, pen, h0, parent)) in enumerate(active):
                q[i, :len(qs)] = qs
                qlens[i] = len(qs)
                t[i, :len(rs)] = rs
                tlens[i] = len(rs)
                ws[i] = aw
                ebs[i] = pen
                h0s[i] = h0
                msel[i] = parent
            T = self._tensor
            out = sw_extend_batch(T(q), T(qlens), T(t), T(tlens),
                                  self._mats(opt), T(msel),
                                  opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                                  T(ws), T(ebs), opt.zdrop, T(h0s))
            res = out.cpu().numpy()  # [6, B]: score,qle,tle,gtle,gscore,max_off
            nxt = []
            for i, entry in enumerate(active):
                r = tuple(int(x) for x in res[:, i])
                try:
                    entry[1] = entry[0].send(r)
                    nxt.append(entry)
                except StopIteration:
                    pass
            active = nxt

    def _mats(self, opt: MemOpt) -> torch.Tensor:
        if self._mats_cache is None:
            self._mats_cache = self._tensor(
                np.stack([opt.gamat, opt.ctmat]).astype(np.int32))
        return self._mats_cache

    # ------------------------------------------------------------------
    def sw_global_batch(self, opt: MemOpt, requests):
        """Batched ksw_global2 + CIGAR on the device (ops/sw_global).
        requests: list of (key, query, rseq, w, parent). Returns
        {key: (score, cigar)} identical to sw.sw_global. The lanes are swept
        in chunks that bound the direction tensor z to
        BISCUIT_TPU_GLOBAL_Z_MB (Lq*Lt bytes per lane)."""
        out = {}
        if not requests:
            return out
        Lq = max(len(r[1]) for r in requests)
        Lt = max(len(r[2]) for r in requests)
        z_budget = int(os.environ.get("BISCUIT_TPU_GLOBAL_Z_MB", "512")) << 20
        max_lanes = min(16384, max(128, z_budget // max(1, Lq * Lt)))
        for c0 in range(0, len(requests), max_lanes):
            out.update(self._sw_global_chunk(opt, requests[c0:c0 + max_lanes]))
        return out

    def _sw_global_chunk(self, opt: MemOpt, reqs):
        out = {}
        B = len(reqs)
        Lq = max(max(len(r[1]) for r in reqs), 1)
        Lt = max(max(len(r[2]) for r in reqs), 1)
        q = np.full((B, Lq), 4, np.int32)
        t = np.full((B, Lt), 4, np.int32)
        qlens = np.ones(B, np.int32)
        tlens = np.ones(B, np.int32)
        ws = np.ones(B, np.int32)
        msel = np.zeros(B, np.int32)
        for i, (_key, qq, rr, w, parent) in enumerate(reqs):
            q[i, :len(qq)] = qq
            qlens[i] = len(qq)
            t[i, :len(rr)] = rr
            tlens[i] = len(rr)
            ws[i] = w
            msel[i] = 1 if parent else 0
        T = self._tensor
        score, ops, n_ops, ov = sw_global_cigar(
            T(q), T(qlens), T(t), T(tlens), self._mats(opt), T(msel),
            opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, T(ws))
        scores = score.cpu().numpy()
        ovh = ov.cpu().numpy()
        # an overflowed lane's op buffer is incomplete (n_ops > max_ops):
        # decode nothing for it, it is realigned below
        cigars = decode_cigars(ops.cpu().numpy(),
                               np.where(ovh, 0, n_ops.cpu().numpy()))
        for i, (key, qq, rr, w, parent) in enumerate(reqs):
            if ovh[i]:
                _COUNTS["traceback_overflow_lanes"] += 1
                mat = (opt.ctmat if parent else opt.gamat)
                out[key] = sw.sw_global(
                    qq, rr, mat, opt.o_del, opt.e_del, opt.o_ins,
                    opt.e_ins, int(w))
            else:
                out[key] = (int(scores[i]), cigars[i])
        return out

    # ------------------------------------------------------------------
    def regs_for_batch(self, opt: MemOpt, seqs) -> List[AlnRegs]:
        """worker1 for a batch of reads (SE, or PE mates interleaved): one
        merged AlnRegs per read."""
        st = self.st
        idx = st.idx
        # lane policy (bwamem.c:311-375): order matters for emission parity
        lane_plan: List[Tuple[int, int]] = []  # (seq_idx, parent)
        pe = bool(opt.flag & MEM_F_PE)
        for i, _s in enumerate(seqs):
            if not pe:
                if not (opt.parent & 1) or (opt.parent >> 1):
                    lane_plan.append((i, 0))
                if not (opt.parent & 1) or not (opt.parent >> 1):
                    lane_plan.append((i, 1))
            else:
                # read 1 seeds the parent strand first, read 2 the daughter
                first = 1 if i % 2 == 0 else 0
                lane_plan.append((i, first))
                if not opt.parent:
                    lane_plan.append((i, 1 - first))
        lanes = [(seqs[i], p) for i, p in lane_plan]
        seeds, lookups = self._collect_seeds(opt, lanes)

        all_regs: List[AlnRegs] = [AlnRegs() for _ in seqs]
        gens = []
        # the chain scan on the device; the byte-exact -v4 trace mode takes
        # the host path, as in the JAX engine
        dev_chains = [None] * len(lane_plan)
        if trace.verbose < 4:
            with _stage("chain_scan"):
                jobs = [(seqs[si].l_seq, parent, seeds[li], lookups[li])
                        for li, (si, parent) in enumerate(lane_plan)]
                dev_chains = mem_chain_batch(opt, idx, jobs, self.device)
                _COUNTS["chain_host_lanes"] += sum(
                    c is None for c in dev_chains)
        with _stage("chain"):
            for li, (si, parent) in enumerate(lane_plan):
                s = seqs[si]
                chns = dev_chains[li]
                if chns is None:
                    fm, fmc = st.fm_pair(parent)
                    chns = mem_chain(opt, fm, fmc, idx, s.l_seq,
                                     bsconvert(s, parent), parent,
                                     seeds_intv=seeds[li],
                                     sa_lookup=lookups[li])
                chns = mem_chain_flt(opt, chns)
                mem_flt_chained_seeds(opt, idx, s.l_seq, s.seq, chns, parent)
                gens.append((chain2region_gen(opt, idx, s.l_seq, s.seq,
                                              parent, chns, all_regs[si]),
                             parent))
        # The reference runs a read's two strand passes sequentially
        # (bwamem.c:327-333): the second pass's containment checks must see
        # the first pass's regions, and chain2region_gen captures reg0 =
        # len(regs) when its body first runs. So lanes of the same read are
        # chained into one sequential generator; different reads run in
        # lockstep batches.
        by_read: Dict[int, List] = {}
        for gen_parent, (si, _p) in zip(gens, lane_plan):
            by_read.setdefault(si, []).append(gen_parent)
        with _stage("extend"):
            self._extend_scheduled(
                opt, [_chain_generators(lst) for lst in by_read.values()])

        with _stage("chain"):
            for si, s in enumerate(seqs):
                merge_regions(opt, idx, s.seq, s.l_seq, all_regs[si])
        return all_regs


class _PendingSW(Exception):
    """Raised by the recording global_fn: the request joined the batch."""


def prefill_setSAM(opt: MemOpt, idx, dev: DeviceAligner, items) -> Dict:
    """The global alignments (score, cigar) of every (seq, reg) in `items`,
    computed on the device before reg2sam runs: a cache keyed by (id of
    the region, band). The regions themselves are left as they are, so
    that reg2sam formats only what the host engine formats; its
    alnreg_setSAM calls read the cache through `cigar_fn`.

    The band-doubling retry loop of mem_alnreg_setSAM
    (mem_alnreg_format.c:56-70) is driven at batch level on shallow copies
    of the regions: each round re-enters alnreg_setSAM with a cache-backed
    global_fn; an uncached (region, w) records its request and raises,
    and the round's requests run as ONE device sweep. A cached one answers
    with its score and no CIGAR: the loop reads only the score, and
    gen_cigar then skips the MD and NM work that worker2 does once for the
    regions it formats."""
    cache: Dict = {}
    pending = [(s, copy.copy(r), id(r)) for s, r in items
               if r.n_cigar == 0 and _needs_global(opt, r)]
    while pending:
        requests = []
        seen = set()

        def make_fn(orig):
            def fn(reg, query, rseq, w):
                key = (orig, int(w))
                if key in cache:
                    return cache[key][0], None
                if key not in seen:
                    seen.add(key)
                    requests.append((key, query, rseq, int(w), reg.parent))
                raise _PendingSW
            return fn

        nxt = []
        for seq, shadow, orig in pending:
            try:
                sammod.alnreg_setSAM(opt, idx, seq, shadow,
                                     global_fn=make_fn(orig))
            except _PendingSW:
                nxt.append((seq, shadow, orig))
        if not requests:
            break
        cache.update(dev.sw_global_batch(opt, requests))
        pending = nxt
    return cache


def _needs_global(opt: MemOpt, reg) -> bool:
    """Whether alnreg_setSAM asks for a global alignment of `reg`: not when
    its first band is 0 and query and reference are of one length, where
    gen_cigar scores the ungapped alignment itself (and the band, doubled,
    stays 0). Its first lines, mem_alnreg_format.c:47-52."""
    lq, lr = reg.qe - reg.qb, reg.re - reg.rb
    w = max(sammod.infer_bw(lq, lr, reg.truesc, opt.a, opt.o_del, opt.e_del),
            sammod.infer_bw(lq, lr, reg.truesc, opt.a, opt.o_ins, opt.e_ins))
    return not (w == 0 and lq == lr)


def cigar_fn(opt: MemOpt, dev: DeviceAligner, cache: Dict):
    """The global_fn of worker2: (reg, query, rseq, w) -> (score, cigar)
    from the prefill's cache. A (region, band) the prefill did not compute
    runs then through K2 on the engine's device, counted in
    cigar_late_lanes (0 while the candidates over-approximate what reg2sam
    formats)."""
    def fn(reg, query, rseq, w):
        key = (id(reg), int(w))
        hit = cache.get(key)
        if hit is None:
            _COUNTS["cigar_late_lanes"] += 1
            hit = cache[key] = dev.sw_global_batch(
                opt, [(key, query, rseq, int(w), reg.parent)])[key]
        return hit
    return fn


def _setSAM_candidates(opt: MemOpt, seq, regs):
    """Over-approximate the regions reg2sam will format (score>=T or
    within the XA drop ratio of the best; unmapped rb/re excluded)."""
    best = max((r.score for r in regs), default=0)
    floor = min(opt.T, best * opt.XA_drop_ratio)
    return [(seq, r) for r in regs
            if r.rb >= 0 and r.re >= 0 and r.score >= floor]


def _chain_generators(gen_parent_list):
    """Run several (gen, parent) sequentially as one generator, tagging each
    yielded 5-tuple request with its lane's parent (for matrix selection)."""
    for gen, parent in gen_parent_list:
        try:
            req = next(gen)
        except StopIteration:
            continue
        while True:
            result = yield req + (parent,)
            try:
                req = gen.send(result)
            except StopIteration:
                break


def process_seqs_device(opt: MemOpt, st: AlignerState, seqs, n_processed: int,
                        pes0=None, rg_id: str = "",
                        engine: DeviceAligner = None, device=None) -> None:
    """mem_process_seqs with the device-backed worker1; PE when opt.flag
    has MEM_F_PE (mates interleaved in `seqs`). Pass an `engine` or the
    `device` to build one on."""
    if engine is None:
        if device is None:
            raise ValueError("process_seqs_device needs an engine or a device")
        engine = DeviceAligner(st, device)
    pe = bool(opt.flag & MEM_F_PE)
    if pe:
        for i in range(0, len(seqs), 2):
            s1, s2 = seqs[i], seqs[i + 1]
            if s1.name != s2.name and not (
                    s1.name[:-1] == s2.name[:-1] and s1.name[-1] == "1"
                    and s2.name[-1] == "2"):
                raise RuntimeError(
                    f'paired reads have different names: "{s1.name}", "{s2.name}"')
    for s in seqs:
        read_clipping(s, opt.adaptor1 if (not pe or s.id % 2 == 0)
                      else opt.adaptor2, opt)
    step = DEVICE_BATCH * 2 if pe else DEVICE_BATCH
    all_regs: List[AlnRegs] = []
    for lo in range(0, len(seqs), step):
        all_regs.extend(engine.regs_for_batch(opt, seqs[lo:lo + step]))
    # device-side CIGAR: batch-prefill alnreg_setSAM results before the
    # host worker2 loop (skipped at -v4: the byte-exact debug traces
    # interleave setSAM output in host order; PE then rescues on the host,
    # in worker2_pe)
    prefill = trace.verbose < 4
    global_fn = None
    if not pe:
        if prefill:
            with _stage("cigar"):
                global_fn = _prefill(opt, st, engine, seqs, all_regs)
        with _stage("worker2"):
            for i, s in enumerate(seqs):
                worker2_se(opt, st, s, all_regs[i], n_processed, i, rg_id,
                           global_fn=global_fn)
        return
    n_pairs = len(seqs) >> 1
    # the insert-size statistics span the whole chunk (bwamem.c:464-467)
    pes = pes0 if pes0 is not None else pestat(opt, st.idx, all_regs)
    pairs = [((seqs[i << 1], seqs[(i << 1) | 1]),
              (all_regs[i << 1], all_regs[(i << 1) | 1]))
             for i in range(n_pairs)]
    if prefill:
        # mate rescue mutates the region lists: run it for the whole chunk
        # first (every candidate's ksw_align2 in one K7 batch, replayed per
        # pair on the host), then prefill, then worker2 skips rescue
        if not (opt.flag & MEM_F_NO_RESCUE):
            with _stage("rescue"):
                matesw_batch(opt, st.idx, pes, pairs,
                             engine.sw_local_batch_fn(opt))
        with _stage("cigar"):
            global_fn = _prefill(opt, st, engine, seqs, all_regs)
    with _stage("worker2"):
        for i, (sq, rp) in enumerate(pairs):
            worker2_pe(opt, st, sq, rp, pes, n_processed, i, rg_id,
                       skip_rescue=prefill, global_fn=global_fn)


def _prefill(opt: MemOpt, st: AlignerState, engine: DeviceAligner, seqs,
             all_regs):
    """worker2's global_fn, over the global alignments of every candidate
    region computed on the device."""
    items = []
    for i, s in enumerate(seqs):
        items.extend(_setSAM_candidates(opt, s, all_regs[i]))
    return cigar_fn(opt, engine, prefill_setSAM(opt, st.idx, engine, items))
