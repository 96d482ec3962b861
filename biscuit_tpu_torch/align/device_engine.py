"""Device alignment engines (torch): SE and PE reads through the device kernels.

Two engines, ports of biscuit_tpu/align/device_engine.py:

- the hybrid engine (DeviceSeeder, process_seqs_hybrid; the CLI's
  `device`, its default): seeding (K3) and the SA walk of the first SA_CAP
  occurrences of every seed (K4's interval entry) on the device, injected
  into the native engine (align/native_engine.py, C++ threads), which
  chains, extends and writes SAM; a chunk the native engine's fused
  entries cannot take (-V, barcodes or UMIs, reads over its length gate)
  runs through the device engine;
- the device engine (DeviceAligner, prefill_setSAM, process_seqs_device;
  the CLI's `device-jax`), described below.

In the device engine the host logic (chaining, region bookkeeping, SAM) is
the host engine's code, driven through the extension-request
generator protocol (region.chain2region_gen). Output is identical to the
host engine and to the JAX device engine (tests/test_torch_engine.py).

Device engine, batch flow per call:
  1. host: read clipping + in-silico conversion; (read, parent) lanes
  2. device: 3-pass SMEM seed collection (ops/seed_batch.collect_intv_flat,
     K3 with K5); lanes over its S-row capacity rerun smem.collect_intv
  3. device: batched SA walks for the first SA_PREFETCH_CAP occurrences of
     every seed: the seeder's rows, as they lie on the card, and after them
     the rows of the lanes the host seeded, through one call of K4's
     interval entry (ops/seed_batch.sa_batch_intervals)
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
import contextlib
import copy
import ctypes
import functools
import math
import os
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import MemOpt, MEM_F_NO_RESCUE, MEM_F_PE, MEM_F_REF_HDR
from ..ops import sw
from ..align.io_helpers import read_clipping
from ..utils import spans
# the engines' stage report and its reset (utils/spans.py), re-exported for
# the benchmark, chip_smoke.py and the tests
from ..utils.spans import reset_stages, stage_report  # noqa: F401

from ..ops.seed_batch import (FMPair, collect_intv_batch, collect_intv_flat,
                              sa_batch_intervals, seed_lane_bytes)
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

# lane counts, in every stage_report(). The *_lanes past a device capacity
# contract are each redone exactly on the host (a capacity contract, not a
# fallback): seeding lanes over the seeder's S rows (smem.collect_intv),
# chaining lanes over the scan's KMAX, JMAX or NC (chain.mem_chain),
# global-alignment lanes whose traceback overflowed max_ops (sw.sw_global).
# rescue_lanes: the lanes sent to K7, forward and reverse passes together.
# cigar_late_lanes: global alignments that worker2 asked for and the CIGAR
# prefill had not computed, run then through K2 on the device.
# sa_rows, sa_jobs: the seeder's rows and their occurrences sent to K4's
# interval entry; sa_overflow_jobs: occurrences of host-seeded lanes sent to
# it in the same call.
LANE_COUNTS = ("seed_overflow_lanes", "chain_host_lanes",
               "traceback_overflow_lanes", "rescue_lanes", "cigar_late_lanes",
               "sa_rows", "sa_jobs", "sa_overflow_jobs")
spans.declare(*LANE_COUNTS)

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
    def __init__(self, st: AlignerState, device, mesh=None):
        """With a `mesh` (a make_mesh2 grid, BISCUIT_TPU_TORCH_INDEX_SHARD)
        the seed stage runs on this rank's shard of the tables over the
        grid (`seeder`: parallel.mesh.index_sharded_seeder of fmpair, in
        place of collect_intv_flat on fmpair); the SA walk stays on the
        whole tables, as in the JAX engine."""
        self.st = st
        self.device = torch.device(device)
        with spans.span("setup.seeder_tables"):
            self.fmpair = FMPair.from_index(st.idx, self.device)
        self.seeder = None
        if mesh is not None:
            from ..parallel.mesh import index_sharded_seeder
            self.seeder = index_sharded_seeder(mesh, self.fmpair)
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
            spans.count("rescue_lanes", n_lanes)
            return res
        return fn

    # ------------------------------------------------------------------
    def _collect_seeds(self, opt: MemOpt, lanes: List[Tuple]):
        """lanes: list of (seq, parent). Returns per-lane seed lists and SA
        position lookups."""
        st = self.st
        fmp = self.fmpair
        with spans.stage("seed"):
            q, lens, parents = pack_lanes(lanes)
            parents = self._tensor(parents)
            seeds, overflow, lane_of, rows = collect_intv_batch(
                fmp, self._tensor(q), self._tensor(lens), parents, opt,
                on_device=True, seeder=self.seeder)
            # lanes over the seeder's S rows: the exact host seeder
            for i in np.nonzero(overflow)[0]:
                s, p = lanes[i]
                fm, fmc = st.fm_pair(p)
                seeds[i] = collect_intv(opt, fm, fmc, bsconvert(s, p))
            spans.count("seed_overflow_lanes", int(overflow.sum()))

        with spans.stage("sa"):
            # the first SA_PREFETCH_CAP occurrences of every seed, in one call
            # of K4's interval entry: the seeder's rows as they lie on the
            # card, then the rows of the lanes the host seeded, each lane's
            # rows in order; one offset table serves both
            sizes = np.fromiter((r[4] for i, lane in enumerate(seeds)
                                 if not overflow[i] for r in lane), np.int64)
            ov = [(lanes[i][1], r[2], min(r[4], SA_PREFETCH_CAP))
                  for i in np.nonzero(overflow)[0] for r in seeds[i]]
            ov_which, ov_x0, ov_kmax = (np.asarray([r[c] for r in ov], np.int64)
                                        for c in range(3))
            kmax = np.concatenate([np.minimum(sizes, SA_PREFETCH_CAP), ov_kmax])
            off = np.cumsum(kmax) - kmax
            kmax_row = torch.cat([rows[:, 4].clamp(max=SA_PREFETCH_CAP).long(),
                                  self._tensor(ov_kmax)])
            pos = sa_batch_intervals(
                fmp, torch.cat([parents.index_select(0, lane_of).long(),
                                self._tensor(ov_which)]),
                torch.cat([rows[:, 2].long(), self._tensor(ov_x0)]), kmax_row,
                torch.cumsum(kmax_row, 0) - kmax_row, int(kmax.sum()))
            pos = pos.cpu().numpy()
            n_ov = int(ov_kmax.sum())
            spans.count("sa_rows", int(sizes.size))
            spans.count("sa_jobs", int(kmax.sum()) - n_ov)
            spans.count("sa_overflow_jobs", n_ov)

        lookups = []
        kmax, off = kmax.tolist(), off.tolist()
        r_dev, r_ov = 0, int(sizes.size)
        for i, ((_s, p), lane_seeds) in enumerate(zip(lanes, seeds)):
            if overflow[i]:
                lookups.append(_sa_lookup(pos, off, kmax, r_ov, st.fm[p]))
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
                spans.count("traceback_overflow_lanes")
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
            with spans.stage("chain_scan"):
                jobs = [(seqs[si].l_seq, parent, seeds[li], lookups[li])
                        for li, (si, parent) in enumerate(lane_plan)]
                dev_chains = mem_chain_batch(opt, idx, jobs, self.device)
                spans.count("chain_host_lanes",
                            sum(c is None for c in dev_chains))
        with spans.stage("chain"):
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
        with spans.stage("extend"):
            self._extend_scheduled(
                opt, [_chain_generators(lst) for lst in by_read.values()])

        with spans.stage("chain"):
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
            spans.count("cigar_late_lanes")
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
    spans.set_chunk(n_processed)
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
            with spans.stage("cigar"):
                global_fn = _prefill(opt, st, engine, seqs, all_regs)
        with spans.stage("worker2"):
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
            with spans.stage("rescue"):
                matesw_batch(opt, st.idx, pes, pairs,
                             engine.sw_local_batch_fn(opt))
        with spans.stage("cigar"):
            global_fn = _prefill(opt, st, engine, seqs, all_regs)
    with spans.stage("worker2"):
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


# ---------------------------------------------------------------------------
# The hybrid engine: seeds and SA positions from the device, injected into
# the native (C++) engine's chaining, extension and SAM
# ---------------------------------------------------------------------------

class DeviceSeeder:
    """Seed provider of the hybrid engine (port of the JAX package's
    DeviceSeeder, biscuit_tpu/align/device_engine.py).

    For every lane (read, strand) of a batch, mem_collect_intv runs on the
    device (K3, ops/seed_batch.collect_intv_flat), and K4's interval entry
    (ops/seed_batch.sa_batch_intervals) resolves the first SA_CAP
    occurrences of every seed on the seeder's rows as they lie there. Rows
    and positions come back to the host once each, as the zero-copy seed
    injection (native_engine.SeedInjC) that the C++ batch entries read:
    per lane key read * 2 + strand a flag and a row range, per row
    (start, end) and (x0, x1, size), per row an offset into the positions.

    A lane keeps has = 0 and seeds itself in C++ only where K3 flags it,
    more than S = SEED_CAP rows (the capacity contract, counted in
    seed_overflow_lanes); -e (MEM_F_SELF_OVLP) is injected like any other
    option, since the device seeder takes its start width. The output is
    the native engine's with or without the injection.

    On CUDA all of the seeder's device work runs on a stream of its own,
    `self.stream`, so that it may run in a thread of its own beside any work
    of the default stream.

    With a `mesh` (a make_mesh2 grid, BISCUIT_TPU_TORCH_INDEX_SHARD) the
    seeder runs on this rank's shard of the tables over the grid
    (parallel.mesh.index_sharded_seeder: lanes split over dp, rows routed
    over idx, kernels/fm_route.cu on the card), and K4's interval entry on
    the whole tables, as the JAX DeviceSeeder resolves SA positions on its
    whole fmpair. Every rank of the grid makes the same calls in the same
    order."""

    # occurrences a seed resolved on the device; the C++ engine walks the
    # rest. With an injection the C++ engine skips its own pre-resolution
    # of the first 8 occurrences of every seed (align_host.cpp,
    # chain_from_seeds), so at 0 every occurrence walks in C++. 8, what the
    # C++ engine resolves up front itself: in the SA_CAP sweeps of
    # chip_smoke.py on an H100 (PERF.md) 64 did not beat it beyond the
    # runs' spread, on a genome with repeats neither
    SA_CAP = 8
    # device memory one seeder call may take (seed_lane_bytes a lane)
    SWEEP_BYTES = 1 << 30

    def __init__(self, st: AlignerState, device, mesh=None):
        self.st = st
        self.device = torch.device(device)
        # the device engine shares its tables and seeder (aligner())
        self._aligner = DeviceAligner(st, device, mesh)
        self.fmpair, self.seeder = self._aligner.fmpair, self._aligner.seeder
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # the tables were copied on the default stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def lane_keys(self, opt: MemOpt, n: int, pe: bool):
        """Lane keys (read*2+parent) matching the C++ batch lane policy
        (bwamem.c:311-375; align_host.cpp bt_align_*_batch)."""
        pp = opt.parent
        keys = []
        for i in range(n):
            if not pe:
                if not (pp & 1) or (pp >> 1):
                    keys.append(i * 2)
                if not (pp & 1) or not (pp >> 1):
                    keys.append(i * 2 + 1)
            else:
                first = 1 if i % 2 == 0 else 0
                keys.append(i * 2 + first)
                if not pp:
                    keys.append(i * 2 + (1 - first))
        return np.asarray(keys, np.int64)

    def aligner(self) -> DeviceAligner:
        """The device engine on the seeder's device and tables, for the
        batches the native engine's fused entries cannot take (fused)."""
        return self._aligner

    def sweep_lanes(self, L: int) -> int:
        """Lanes of read length L that one seeder call takes."""
        return max(1, self.SWEEP_BYTES // seed_lane_bytes(
            L, self.fmpair.wide, self.device, routed=self.seeder is not None))

    def build_injection(self, opt: MemOpt, seqs, pe: bool):
        """(SeedInjC, keepalive) for clipped reads `seqs`, or None for no
        reads. keepalive starts with the host arrays the C++ engine reads,
        (has, lane_off, rows_se, rows_xs, sa_off, sa_pos), and must outlive
        its call."""
        if not seqs:
            return None
        stream = (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext())
        with spans.stage("inject"), stream:
            return self._inject(opt, seqs, pe)

    def _host(self, *tensors):
        """Copies of `tensors` on the host, complete on return: on CUDA
        into pinned buffers of their own, on the seeder's stream, waited
        for before the C++ engine reads them."""
        if self.stream is None:
            return tensors
        with spans.span("inject.pin"):
            out = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        .copy_(t, non_blocking=True) for t in tensors)
        with spans.span("inject.wait"):
            self.stream.synchronize()
        return out

    def _inject(self, opt: MemOpt, seqs, pe: bool):
        """The injection of build_injection, in the spans `inject.lanes`,
        `inject.to_card`, `inject.seed`, `inject.group`, `inject.sa`,
        `inject.pin`, `inject.wait` and `inject.arrays`."""
        from .native_engine import SeedInjC, _ptr
        fmp, dev = self.fmpair, self.device
        n = len(seqs)
        with spans.span("inject.lanes"):
            keys = self.lane_keys(opt, n, pe)
            B = len(keys)
            # the reads, padded with 4, go to the device once; each lane is
            # converted there as pipeline.bsconvert converts it (parent
            # strand C>T: 1 -> 3, daughter G>A: 2 -> 0)
            lens = np.fromiter((s.l_seq for s in seqs), np.int64, n)
            L = max(int(lens.max()), 1)
            reads = np.full((n, L), 4, np.uint8)
            reads[np.repeat(np.arange(n), lens),
                  np.arange(int(lens.sum()))
                  - np.repeat(np.cumsum(lens) - lens, lens)] = \
                np.concatenate([s.seq for s in seqs])
        with spans.span("inject.to_card"):
            if dev.type != "cpu":
                spans.count("inject.pageable_bytes",
                            reads.nbytes + lens.nbytes + keys.nbytes)
            T = lambda a: torch.from_numpy(a).to(dev)
            reads, lens, key = T(reads), T(lens).int(), T(keys)
        with spans.span("inject.seed"):
            step = self.sweep_lanes(L)
            seed = self.seeder or functools.partial(collect_intv_flat, fmp)
            lane_parts, row_parts, ov_parts = [], [], []
            for lo in range(0, B, step):
                k = key[lo:lo + step]
                q = reads[k >> 1].int()
                par = (k & 1).bool()[:, None]
                q = torch.where(par & (q == 1), 3,
                                torch.where(~par & (q == 2), 0, q))
                lane_of, rows, ov = seed(q, lens[k >> 1], (k & 1).int(), opt)
                lane_parts.append(lane_of.long() + lo)
                row_parts.append(rows)
                ov_parts.append(ov)
        with spans.span("inject.group"):
            # rows grouped by lane key, each lane's in the seeder's order: an
            # even PE read seeds its parent strand (key + 1) first
            key_row, order = torch.sort(key[torch.cat(lane_parts)],
                                        stable=True)
            rows = torch.cat(row_parts)[order]
            M = rows.shape[0]
            lane_off = torch.zeros(2 * n + 1, dtype=torch.int64, device=dev)
            lane_off[1:] = torch.bincount(key_row, minlength=2 * n).cumsum(0)
            has = torch.zeros(2 * n, dtype=torch.uint8, device=dev)
            has[key[~torch.cat(ov_parts)]] = 1
            # sa_off, the exclusive prefix sum of each row's min(size,
            # SA_CAP), gives both K4's offsets and its total
            kmax = rows[:, 4].long().clamp(max=self.SA_CAP)
            sa_off = torch.zeros(M + 1, dtype=torch.int64, device=dev)
            sa_off[1:] = kmax.cumsum(0)
        h_has, h_lane_off, h_se, h_xs, h_sa_off = self._host(
            has, lane_off, rows[:, :2].int().contiguous(),
            rows[:, 2:].long().contiguous(), sa_off)
        total = int(h_sa_off[-1])
        if total:
            with spans.span("inject.sa"):
                pos = sa_batch_intervals(fmp, key_row & 1, rows[:, 2], kmax,
                                         sa_off[:-1], total).long()
            h_pos, = self._host(pos)
            sa_pos = h_pos.numpy()
        else:
            sa_pos = np.zeros(1, np.int64)
        with spans.span("inject.arrays"):
            has_np, lane_off_np, sa_off_np = (
                t.numpy() for t in (h_has, h_lane_off, h_sa_off))
            rows_se = h_se.numpy() if M else np.zeros((1, 2), np.int32)
            rows_xs = h_xs.numpy() if M else np.zeros((1, 3), np.int64)
            spans.count("seed_overflow_lanes", B - int(has_np.sum()))
            spans.count("sa_rows", M)
            spans.count("sa_jobs", total)
            inj = SeedInjC()
            arrays = (has_np, lane_off_np, rows_se, rows_xs, sa_off_np, sa_pos)
            (inj.has, inj.lane_off, inj.rows_se, inj.rows_xs, inj.sa_off,
             inj.sa_pos) = (ctypes.cast(_ptr(a), ctypes.c_void_p)
                            for a in arrays)
        return inj, arrays + (h_has, h_lane_off, h_se, h_xs, h_sa_off)


def fused(opt: MemOpt, seqs) -> bool:
    """Whether the native engine's fused batch entries (align_host.cpp
    bt_align_se_batch / bt_align_pe_batch) align every read of `seqs` with
    an injection. They do not under -V (MEM_F_REF_HDR: the region path,
    whose C++ worker1 takes no injection), nor a read with a barcode or a
    UMI, nor one at the mem_flt_chained_seeds gate of align1_core (about
    725 bases at the defaults, fewer under -W), which they hand to Python
    to seed again on the host; in PE one such read sends the whole chunk
    there. Judged before clipping, which only shortens a read: a read that
    clipping would bring under the gate still counts as over it."""
    if opt.flag & MEM_F_REF_HDR:
        return False
    for s in seqs:
        if s.barcode or s.umi:
            return False
        n = s.l_seq
        if n >= opt.min_seed_len and not (
                (1.1 * opt.min_chain_weight if opt.min_chain_weight
                 else 5.5 * math.log(n)) > 0.05 * n):
            return False
    return True


def process_seqs_hybrid(opt: MemOpt, st: AlignerState, seqs, n_processed: int,
                        pes0=None, rg_id: str = "", engine=None,
                        seeder: DeviceSeeder = None, device=None,
                        seed_only: bool = False) -> None:
    """mem_process_seqs of the hybrid engine: the device seeds
    (DeviceSeeder) and the native engine (native_engine.process_seqs_native)
    chains, extends and writes SAM. Pass a `seeder` or the `device` to
    build one on.

    SE chunks of more than DEVICE_BATCH reads are pipelined: an injector
    thread clips sub-batch k+1 and builds its injection while the C++
    engine aligns sub-batch k (ctypes releases the GIL for the call), so
    up to three injections are alive at once, each in buffers of its own.
    Sub-batches pass their n_processed offsets through, and SE reads are
    independent, so the SAM is the serial run's. PE keeps the whole chunk
    (insert-size statistics span it, bwamem.c:464-467).
    BISCUIT_TPU_HYBRID_PIPELINE=0 runs serially. Stages: `inject` (the
    seeder, in whichever thread builds the injection) and `native` (the
    native engine); their sum over the wall shows the overlap. Spans (the
    registry of utils/spans.py, under the chunk's first read number):
    `clip` around each loop of read_clipping, `inject`'s parts
    (DeviceSeeder._inject) and `native`'s (`engine` runs through
    align/traced_native.traced's TracedAligner: the marshalling, the C++
    call and its phases, the SAM's decoding, the reads handed back).

    A chunk the fused C++ entries cannot take whole (fused) runs through
    the device engine (process_seqs_device) on the seeder's device and
    tables instead: there the C++ engine would seed on the host and drop
    the card's rows. The SAM is the same either way.

    seed_only: build every injection as above, in the same order and from
    the same threads, and skip the native engine (a rank other than 0 of
    an index-sharded run, whose seeding calls must meet rank 0's); a chunk
    for the device engine runs there whole all the same."""
    import queue
    from .native_engine import process_seqs_native
    from .traced_native import traced
    nat = traced(engine, st)
    if seeder is None:
        if device is None:
            raise ValueError("process_seqs_hybrid needs a seeder or a device")
        seeder = DeviceSeeder(st, device)
    pe = bool(opt.flag & MEM_F_PE)
    spans.set_chunk(n_processed)
    if not fused(opt, seqs):
        process_seqs_device(opt, st, seqs, n_processed, pes0, rg_id,
                            engine=seeder.aligner())
        return

    def native(sub, lo, inj):
        if seed_only:
            return
        with spans.stage("native"):
            process_seqs_native(opt, st, sub, n_processed + lo, pes0, rg_id,
                                engine=nat, inj_pre=inj, pre_clipped=True)

    if pe or len(seqs) <= DEVICE_BATCH or \
            os.environ.get("BISCUIT_TPU_HYBRID_PIPELINE", "1") == "0":
        with spans.span("clip"):
            for s in seqs:
                read_clipping(s, opt.adaptor1 if (not pe or s.id % 2 == 0)
                              else opt.adaptor2, opt)
        native(seqs, 0, seeder.build_injection(opt, seqs, pe))
        return
    subs = [seqs[lo:lo + DEVICE_BATCH]
            for lo in range(0, len(seqs), DEVICE_BATCH)]
    q: "queue.Queue" = queue.Queue(maxsize=1)

    def _injector():
        try:
            for sub in subs:
                with spans.span("clip"):
                    for s in sub:
                        read_clipping(s, opt.adaptor1, opt)
                q.put((sub, seeder.build_injection(opt, sub, False)))
        except BaseException as e:  # surface in the consumer
            q.put(e)

    th = threading.Thread(target=_injector, daemon=True)
    th.start()
    lo = 0
    for _ in subs:
        item = q.get()
        if isinstance(item, BaseException):
            raise item
        sub, inj = item
        native(sub, lo, inj)
        lo += len(sub)
    th.join()
