"""Alignment pipeline: read preprocessing, per-read alignment core, batch
processing, and the `align` subcommand driver.

Ports read_clipping / bseq_bsconvert / mem_align1_core / bis_worker1/2 /
mem_process_seqs (lib/aln/bwamem.c:161-476) and main_align
(align.c:319-598). This is the host orchestration path (exact semantics);
the batched TPU device path plugs in at the seeding/extension stages.

Copy of biscuit_tpu/align/pipeline.py. Its imports differ: FMNumpy comes
from biscuit_tpu_torch.ops.fm and every other module from this package,
so the port imports nothing of the JAX package. And worker2_se /
worker2_pe take a `global_fn` of the port's own, which they hand to
sam.reg2sam_se / reg2sam_pe (the device engine's cached global
alignments). tests/test_torch_engine.py holds the copy to its source,
that argument left out.
"""
import sys
from typing import List, Optional

import numpy as np

from ..config import MemOpt, MEM_F_PE, MEM_F_NOPAIRING, MEM_F_NO_RESCUE
from ..index.fmindex import BisIndex
from ..ops.fm import FMNumpy
from ..align import bns as bnsmod
from . import sam as sammod
from . import trace
from .chain import mem_chain, mem_chain_flt, mem_flt_chained_seeds
from .pair import PeStat, pestat
from .region import AlnRegs, mark_primary, matesw, merge_regions
from .smem import collect_intv
from . import region as regionmod
from ..align.io_helpers import read_clipping
from ..io.fastq import BSeq


class AlignerState:
    """Index + derived per-strand FM helpers, shared across batches."""

    def __init__(self, idx: BisIndex):
        self.idx = idx
        self.fm = {1: FMNumpy(idx.par), 0: FMNumpy(idx.dau)}

    def fm_pair(self, parent: int):
        return self.fm[parent], self.fm[1 - parent]


def bsconvert(seq: BSeq, parent: int) -> np.ndarray:
    """bseq_bsconvert (bwamem.c:161-178)."""
    if parent in seq.bisseq:
        return seq.bisseq[parent]
    q = seq.seq.copy()
    if parent:
        q[q == 1] = 3
    else:
        q[q == 2] = 0
    seq.bisseq[parent] = q
    return q


def align1_core(opt: MemOpt, st: AlignerState, seq: BSeq, regs: AlnRegs,
                parent: int) -> None:
    """mem_align1_core (bwamem.c:183-208)."""
    if trace.verbose >= 4:
        trace.out("[mem_align1_core] === Seeding %s against (parent: %u)\n"
                  % (seq.name, parent))
    bis = bsconvert(seq, parent)
    fm, fmc = st.fm_pair(parent)
    chns = mem_chain(opt, fm, fmc, st.idx, seq.l_seq, bis, parent)
    chns = mem_chain_flt(opt, chns)
    mem_flt_chained_seeds(opt, st.idx, seq.l_seq, seq.seq, chns, parent)
    regionmod.chain2region(opt, st.idx, seq.l_seq, seq.seq, parent, chns, regs)


def worker1_se(opt: MemOpt, st: AlignerState, seq: BSeq) -> AlnRegs:
    if trace.verbose >= 4:
        trace.out("\n=====> [bis_worker1] Processing read '%s' <=====\n" % seq.name)
    read_clipping(seq, opt.adaptor1, opt)
    regs = AlnRegs()
    if not (opt.parent & 1) or (opt.parent >> 1):
        align1_core(opt, st, seq, regs, 0)
    if not (opt.parent & 1) or not (opt.parent >> 1):
        align1_core(opt, st, seq, regs, 1)
    merge_regions(opt, st.idx, seq.seq, seq.l_seq, regs)
    return regs


def worker1_pe(opt: MemOpt, st: AlignerState, s1: BSeq, s2: BSeq):
    if s1.name != s2.name:
        if not (s1.name[:-1] == s2.name[:-1] and s1.name[-1] == "1" and s2.name[-1] == "2"):
            raise RuntimeError(f'paired reads have different names: "{s1.name}", "{s2.name}"')
    read_clipping(s1, opt.adaptor1, opt)
    read_clipping(s2, opt.adaptor2, opt)
    if trace.verbose >= 4:
        trace.out("\n=====> [bis_worker1] Processing read '%s'/1 <=====\n" % s1.name)
    regs1 = AlnRegs()
    align1_core(opt, st, s1, regs1, 1)
    if not opt.parent:
        align1_core(opt, st, s1, regs1, 0)
    merge_regions(opt, st.idx, s1.seq, s1.l_seq, regs1)
    if trace.verbose >= 4:
        trace.out("\n=====> [bis_worker1] Processing read '%s'/2 <=====\n" % s2.name)
    regs2 = AlnRegs()
    align1_core(opt, st, s2, regs2, 0)
    if not opt.parent:
        align1_core(opt, st, s2, regs2, 1)
    merge_regions(opt, st.idx, s2.seq, s2.l_seq, regs2)
    return regs1, regs2


def worker2_se(opt: MemOpt, st: AlignerState, seq: BSeq, regs: AlnRegs,
               n_processed: int, i: int, rg_id: str = "",
               global_fn=None) -> None:
    if trace.verbose >= 4:
        trace.out("\n=====> [bis_worker2] Finalizing SE read '%s' <=====\n" % seq.name)
    mark_primary(opt, regs, n_processed + i)
    for r in regs:
        r.flag = 0
    seq.sam = sammod.reg2sam_se(opt, st.idx, seq, regs, rg_id,
                                global_fn=global_fn)


def worker2_pe(opt: MemOpt, st: AlignerState, seqs, regs_pair, pes: PeStat,
               n_processed: int, i: int, rg_id: str = "",
               skip_rescue: bool = False, global_fn=None) -> None:
    """skip_rescue: the device engine runs matesw itself for the whole
    batch before prefilling cigars on device; rescue must run once."""
    if trace.verbose >= 4:
        trace.out("\n=====> [bis_worker2] Finalizing PE read '%s' <=====\n"
                  % seqs[0].name)
    if not (opt.flag & MEM_F_NO_RESCUE) and not skip_rescue:
        matesw(opt, st.idx, pes, seqs, regs_pair)
    if trace.verbose >= 4:
        trace.out("\n\n====== [bis_worker2] Primary-marking read 1\n")
    mark_primary(opt, regs_pair[0], (i << 1) | 0)
    if trace.verbose >= 4:
        trace.out("\n\n====== [bis_worker2] Primary-marking read 2\n")
    mark_primary(opt, regs_pair[1], (i << 1) | 1)
    for rp in regs_pair:
        for r in rp:
            r.flag = 0
    s1, s2 = sammod.reg2sam_pe(opt, st.idx, (n_processed >> 1) + i, seqs,
                               regs_pair, pes, rg_id, global_fn=global_fn)
    seqs[0].sam = s1
    seqs[1].sam = s2


_POOL_STATE = {}


def _pool_init(opt, st):
    _POOL_STATE["opt"] = opt
    _POOL_STATE["st"] = st


def _pool_worker1_se(s):
    regs = worker1_se(_POOL_STATE["opt"], _POOL_STATE["st"], s)
    return s, regs


def _pool_worker1_pe(pair):
    s1, s2 = pair
    r1, r2 = worker1_pe(_POOL_STATE["opt"], _POOL_STATE["st"], s1, s2)
    return s1, s2, r1, r2


def process_seqs(opt: MemOpt, st: AlignerState, seqs: List[BSeq],
                 n_processed: int, pes0: Optional[PeStat] = None,
                 rg_id: str = "") -> None:
    """mem_process_seqs (bwamem.c:432-476). The reference data-parallelizes
    worker1 over pthreads (kt_for); we use fork()ed worker processes over the
    read batch — worker2 (pairing/SAM) stays in the parent so the PE
    insert-size statistics cover the whole chunk, exactly like the reference.
    """
    n_workers = max(1, opt.n_threads)
    pool = None
    if n_workers > 1 and len(seqs) >= 64:
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        pool = ctx.Pool(n_workers, initializer=_pool_init, initargs=(opt, st))
    try:
        if not (opt.flag & MEM_F_PE):
            if pool is not None:
                out = pool.map(_pool_worker1_se, seqs, chunksize=32)
                seqs[:] = [o[0] for o in out]
                all_regs = [o[1] for o in out]
            else:
                all_regs = [worker1_se(opt, st, s) for s in seqs]
            for i, s in enumerate(seqs):
                worker2_se(opt, st, s, all_regs[i], n_processed, i, rg_id)
        else:
            n_pairs = len(seqs) >> 1
            all_regs = []
            if pool is not None:
                pairs = [(seqs[i << 1], seqs[(i << 1) | 1]) for i in range(n_pairs)]
                out = pool.map(_pool_worker1_pe, pairs, chunksize=16)
                for i, (s1, s2, r1, r2) in enumerate(out):
                    seqs[i << 1] = s1
                    seqs[(i << 1) | 1] = s2
                    all_regs.extend([r1, r2])
            else:
                for i in range(n_pairs):
                    r1, r2 = worker1_pe(opt, st, seqs[i << 1], seqs[(i << 1) | 1])
                    all_regs.extend([r1, r2])
            pes = pes0 if pes0 is not None else pestat(opt, st.idx, all_regs)
            for i in range(n_pairs):
                worker2_pe(opt, st, (seqs[i << 1], seqs[(i << 1) | 1]),
                           (all_regs[i << 1], all_regs[(i << 1) | 1]), pes,
                           n_processed, i, rg_id)
    finally:
        if pool is not None:
            pool.close()
            pool.join()


def sam_header(idx: BisIndex, hdr_line: Optional[str], pg_line: Optional[str]) -> str:
    """bwa_print_sam_hdr (bwa.c:653-684): @SQ sorted by name."""
    out = []
    n_sq = 0
    if hdr_line:
        for ln in hdr_line.split("\n"):
            if ln.startswith("@SQ\t"):
                n_sq += 1
    if n_sq == 0:
        for a in sorted(idx.anns, key=lambda a: a.name):
            out.append(f"@SQ\tSN:{a.name}\tLN:{a.length}\n")
    if hdr_line:
        out.append(hdr_line + "\n")
    if pg_line:
        out.append(pg_line + "\n")
    return "".join(out)
