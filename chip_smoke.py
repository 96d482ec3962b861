#!/usr/bin/env python3
"""Bring-up check of the torch port (biscuit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (more for the kernel table):
  1. the card: nvidia-smi name and power limit, compute capability
  2. build the six CUDA sources of the align slice with nvcc, in parallel
  3. each kernel against its plain torch version on the card, on
     numpy-seeded inputs or the phase-4 reads at the shapes of the align
     path: exact equality (torch.equal), and both times from CUDA events;
     the seeder and the SA walk also on a 50 Mbp index (tables twice the L2)
  4. the SE align slice end to end: a 5 Mbp genome and 4096 150 bp WGBS
     reads (tools/make_testdata.py, plus SNPs and small indels so that
     global alignment has work), the index built in-process, then the
     port's `align` CLI on cuda; its first 512 reads' SAM must equal the
     port's host engine's byte for byte, and at most 1% of the seeding
     lanes and 10% of the chaining lanes may be redone on the host
  4b. the PE align slice end to end: 2048 pairs of 150 bp on the same
     genome, every third mate 2 damaged so that only mate rescue can place
     it, through the CLI with two FASTQs; the SAM of the whole chunk must
     equal the port's host engine's byte for byte, K7 (mate rescue) must
     have run, and more damaged mates must be mapped than in a run with
     rescue off (-S). Then K7's row of the kernel table: its calls caught
     on this path, and numpy-seeded i16, saturating u8 and odd-qlen lanes,
     against its plain version
  5. no jax module was imported
Then a JSON line with the kernel table and, last, the result line. Any
failure raises and exits nonzero; nothing falls back to the CPU.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 7
GENOME, N_READS, READ_LEN = 5_000_000, 4096, 150
N_PAIRS, DAMAGE_EVERY = 2048, 3  # phase 4b: pairs; every 3rd mate 2 damaged
BIG_GENOME, BIG_CHECK = 50_000_000, 1024  # 50 Mbp: lanes held to plain
N_CHECK = 512            # reads whose SAM is held to the host engine


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() from CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def lanes_of(fq, n_reads):
    """The seeder's input for the first n_reads of fq, each read converted
    both ways as the engine plans SE lanes: (reads [2n, L] int32, lens,
    parents) as numpy."""
    from biscuit_tpu.io.fastq import fastq_iter, read_batch
    from biscuit_tpu_torch.align.device_engine import pack_lanes
    seqs = read_batch(fastq_iter(fq), None, 1 << 60)[:n_reads]
    return pack_lanes([(s, p) for s in seqs for p in (0, 1)])


def compare(name, got, want):
    """Exact equality of two tensors (or tuples of them) on the card;
    returns the max absolute difference (0 when equal)."""
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel != plain (max |d| {err})")
    return err


# ---------------------------------------------------------------------------
# phase 3 inputs (numpy-seeded, the shapes the align path gives each kernel)
# ---------------------------------------------------------------------------

def ext_case(rng, B, Lq, Lt, w_val=None):
    """K1 lanes as test_pallas_sw builds them: half extend a planted match
    with a few edits; w_val set: the narrowing-adversarial mix."""
    import numpy as np
    from biscuit_tpu.config import MemOpt
    opt = MemOpt()
    q = rng.integers(0, 4, (B, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int32)
    L = min(Lq, Lt)
    for b in range(B):
        k = b % 4 if w_val is not None else (0 if b % 2 == 0 else 3)
        if k == 0:
            n = L - int(rng.integers(0, 5))
            t[b, :n] = q[b, :n]
            for _ in range(int(rng.integers(0, 4))):
                t[b, int(rng.integers(0, n))] = rng.integers(0, 4)
        elif k == 1:
            t[b, :L // 3] = q[b, :L // 3]
        elif k == 2:
            t[b, L // 2:L] = q[b, :L - L // 2]
    qlens = rng.integers(Lq // 2 if w_val is None else 8, Lq + 1, B)
    tlens = rng.integers(Lt // 2, Lt + 1, B)
    w = np.full(B, opt.w if w_val is None else w_val, np.int32)
    bonus = np.where(rng.random(B) < 0.5, opt.pen_clip5, 0)
    h0 = rng.integers(1, 60, B)
    msel = rng.integers(0, 2, B)
    mats = np.stack([opt.gamat, opt.ctmat])
    return opt, [a.astype(np.int32) for a in
                 (q, qlens, t, tlens, mats, msel, w, bonus, h0)]


def glob_case(rng, B, Lq, Lt):
    """K2 lanes: query ~150, target a mutated copy (SNPs and indels) ~160,
    band at least |tlen - qlen| + 3 as gen_cigar guarantees."""
    import numpy as np
    q = np.full((B, Lq), 4, np.int32)
    t = np.full((B, Lt), 4, np.int32)
    qlens = rng.integers(Lq - 10, Lq + 1, B).astype(np.int32)
    tlens = np.zeros(B, np.int32)
    for b in range(B):
        qq = rng.integers(0, 4, qlens[b])
        tt = qq.copy()
        for _ in range(int(rng.integers(1, 12))):
            p, r = int(rng.integers(0, len(tt))), rng.random()
            if r < 0.6:
                tt[p] = rng.integers(0, 4)
            elif r < 0.8:
                tt = np.delete(tt, p)
            else:
                tt = np.insert(tt, p, rng.integers(0, 4))
        tt = tt[:Lt]
        q[b, :len(qq)], t[b, :len(tt)] = qq, tt
        tlens[b] = len(tt)
    w = np.maximum(rng.integers(3, 40, B), np.abs(tlens - qlens) + 3)
    msel = rng.integers(0, 2, B).astype(np.int32)
    return q, qlens, t, tlens, msel, w.astype(np.int32)


def local_case(rng, B, Lq, Lt):
    """K7 lanes beside the path's: i16 and u8 lanes mixed, qlens that are
    not multiples of 16, a third of the targets repeating their query under
    a third matrix that scores 4 a match (u8 lanes saturate), and early
    endsc breaks. Returns the wrapper's inputs as numpy, the matrices
    [3, 5, 5] (gamat, ctmat, a=4/b=2)."""
    import numpy as np
    from biscuit_tpu.config import MemOpt
    opt = MemOpt()
    q = np.full((B, Lq), 4, np.int32)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int32)
    qlens = rng.integers(Lq // 3, Lq - 2, B).astype(np.int32)
    qlens[qlens % 16 == 0] += 1
    tlens = rng.integers(Lt // 2, Lt + 1, B).astype(np.int32)
    msel = rng.integers(0, 2, B).astype(np.int32)
    for b in range(B):
        qq = rng.integers(0, 4, qlens[b])
        q[b, :qlens[b]] = qq
        off = int(rng.integers(0, tlens[b] - qlens[b]))
        reps = 1 if b % 3 else (tlens[b] - off) // qlens[b]
        for k in range(reps):
            t[b, off + k * qlens[b]:off + (k + 1) * qlens[b]] = qq
        if b % 3 == 0:
            msel[b] = 2
        nm = int(rng.integers(0, 1 + qlens[b] // 6))
        t[b, rng.integers(0, tlens[b], nm)] = rng.integers(0, 4, nm)
    strong = np.where(np.eye(5, dtype=bool), 4, -2)
    strong[4, :] = strong[:, 4] = -1
    mats = np.stack([opt.gamat, opt.ctmat, strong]).astype(np.int32)
    u8 = rng.integers(0, 2, B).astype(np.int32)
    minsc = np.full(B, opt.min_seed_len * opt.a, np.int32)
    endsc = np.where(rng.random(B) < 0.2, rng.integers(20, 120, B),
                     0x10000).astype(np.int32)
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    return (q, qlens, t, tlens, mats, msel), sc, (minsc, endsc, u8)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "biscuit_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]  # + the data helper
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        return smoke(work)


def smoke(work: str) -> int:
    import numpy as np
    import torch

    # 1. the card
    card = card_line()
    dev = torch.device("cuda", 0)
    say(f"[1] card: {card}; capability {torch.cuda.get_device_capability(0)}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build, one nvcc for each source, all started together
    from biscuit_tpu_torch import kernels
    from biscuit_tpu_torch.ops import (chain_batch, seed_batch, sw_extend,
                                       sw_global, sw_local)
    t0 = time.perf_counter()
    libs = (sw_extend._lib, sw_global._lib, seed_batch._lib,
            seed_batch._seed_lib, chain_batch._lib, sw_local._lib)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib) for lib in libs]:
            f.result()
    say(f"[2] built {sorted(kernels.BUILD_SECONDS) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s; per source "
        f"{json.dumps({k: round(v, 2) for k, v in kernels.BUILD_SECONDS.items()})}")

    # the phase-4 data come first: K4 walks the phase-4 index. The generator
    # makes no indels and few mismatches, which would leave global alignment
    # (K2) without work: SNPs at a human density and an indel in every 16th
    # read give it some, as real reads do.
    from torch_testdata import make_dataset
    t0 = time.perf_counter()
    fa, fq, idx = make_dataset(work, genome_size=GENOME, n_reads=N_READS,
                               read_len=READ_LEN, seed=SEED, snp_rate=0.001,
                               indel_every=16)
    say(f"[3] data: {GENOME} bp genome, {N_READS} x {READ_LEN} bp reads, index "
        f"built in {time.perf_counter() - t0:.1f} s")

    # 3. each kernel against its plain version on the card
    rng = np.random.default_rng(SEED)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    table = []

    def row(name, source, replaces, err, ms, plain_ms, shape):
        table.append({"name": name, "route": "cuda",
                      "source": f"biscuit_tpu_torch/kernels/{source}",
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": err, "ms": round(ms, 4),
                      "plain_ms": round(plain_ms, 4)})
        say(f"[3] {name} {shape}: kernel == plain (max |d| {err}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")

    # K1 at the engine's shapes, then the adversarial band widths
    err, ms, pms = 0, 0.0, 0.0
    for w_val in (None, 1, 2, 5, 17):
        opt, a = ext_case(rng, 4096, 150, 300, w_val)
        q, ql, t, tl, mats, msel, w, bonus, h0 = (T(x) for x in a)
        sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
        mat_b = mats[msel.long()].reshape(-1, 25)
        wc = sw_extend.band_clamp(ql, w, bonus, mats, *sc)
        for zdrop in ((opt.zdrop,) if w_val is None else (0, 10, opt.zdrop)):
            k = lambda: sw_extend.sw_extend_batch(q, ql, t, tl, mats, msel, *sc,
                                                  w, bonus, zdrop, h0)
            p = lambda: sw_extend.sw_extend_batch_plain(q, ql, t, tl, mat_b, wc,
                                                        h0, *sc, zdrop)
            err = max(err, compare(f"sw_extend w={w_val} zdrop={zdrop}", k(), p()))
            if w_val is None:
                ms, pms = cuda_ms(k, 20), cuda_ms(p, 3)
    row("sw_extend", "sw_extend.cu", "biscuit_tpu/ops/pallas_sw.py:58",
        err, ms, pms, "B=4096 Lq=150 Lt<=300, w in {100,1,2,5,17}")

    # K2: DP and traceback
    q, ql, t, tl, msel, w = (T(x) for x in glob_case(rng, 2048, 150, 160))
    mats = T(np.stack([opt.gamat, opt.ctmat]).astype(np.int32))
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    mat_b = mats[msel.long()].reshape(-1, 25)
    tl1, w1 = tl.clamp(min=1), w.clamp(min=1)
    kd = lambda: sw_global.sw_global_batch(q, ql, t, tl, mats, msel, *sc, w)
    pd = lambda: sw_global.sw_global_batch_plain(q, ql, t, tl1, mat_b, w1, *sc)
    (ks, kz), (ps, pz) = kd(), pd()
    err = compare("sw_global", (ks, kz), (ps, pz))
    row("sw_global", "sw_global.cu", "biscuit_tpu/ops/pallas_global.py:133",
        err, cuda_ms(kd, 20), cuda_ms(pd, 3), "B=2048 Lq=150 Lt=160")
    kt = lambda: sw_global.global_traceback(kz, ql, tl, w)
    pt = lambda: sw_global.global_traceback_plain(kz, ql, tl, w)
    err = compare("global_traceback", kt(), pt())
    # and lanes past max_ops: unrelated sequences under cheap gaps and dear
    # mismatches need ~75 runs; the flags and truncated buffers must match
    B2 = 256
    q2 = T(rng.integers(0, 4, (B2, 120)).astype(np.int32))
    t2 = T(rng.integers(0, 4, (B2, 120)).astype(np.int32))
    l2, w2 = T(np.full(B2, 120, np.int32)), T(np.full(B2, 40, np.int32))
    m2 = T(np.where(np.eye(5, dtype=bool), 1, -20)[None].astype(np.int32))
    z0 = T(np.zeros(B2, np.int32))
    _s2, z2 = sw_global.sw_global_batch(q2, l2, t2, l2, m2, z0, 1, 1, 1, 1, w2)
    got2 = sw_global.global_traceback(z2, l2, l2, w2)
    err = max(err, compare("global_traceback overflow", got2,
                           sw_global.global_traceback_plain(z2, l2, l2, w2)))
    n_ov = int(got2[2].sum())
    if n_ov == 0:
        raise AssertionError("the overflow case did not overflow")
    row("global_traceback", "sw_global.cu",
        "biscuit_tpu/ops/pallas_global.py:242", err, cuda_ms(kt, 20),
        cuda_ms(pt, 3), f"B=2048 (+{n_ov} overflow lanes of {B2} checked)")

    # K4: 2^20 random ranks on the phase-4 index
    fm = seed_batch.FMPair.from_index(idx, dev)
    n = 1 << 20
    ranks = T(rng.integers(0, fm.seq_len + 1, n).astype(
        np.int64 if fm.wide else np.int32))
    which = T(rng.integers(0, 2, n).astype(np.int32))
    ks = lambda: seed_batch.sa_batch(fm, which, ranks)
    ps = lambda: seed_batch.sa_batch_plain(fm, which, ranks)
    err = compare("sa_walk", ks(), ps())
    # the other instance of the kernel: the same genome in the wide layout
    # (int64 ranks, 12-column rows), which strands of 2^31 bases and more use
    from biscuit_tpu.index.build import build_index
    os.environ["BISCUIT_TPU_WIDE_INDEX"] = "1"
    try:
        fmw = seed_batch.FMPair.from_index(build_index(fa), dev)
    finally:
        del os.environ["BISCUIT_TPU_WIDE_INDEX"]
    if not fmw.wide or fm.wide:
        raise AssertionError("expected a narrow and a wide index")
    ranks_w = ranks.long()
    err = max(err, compare("sa_walk wide",
                           seed_batch.sa_batch(fmw, which, ranks_w),
                           seed_batch.sa_batch_plain(fmw, which, ranks_w)))
    row("sa_walk", "sa_walk.cu", "biscuit_tpu/ops/seed_batch.py:1983", err,
        cuda_ms(ks, 10), cuda_ms(ps, 2),
        "2^20 ranks, narrow index (times), wide index (equality)")
    # the port's scalar walk agrees on a sample
    from biscuit_tpu_torch.ops.fm import FMNumpy
    fms = {0: FMNumpy(idx.dau), 1: FMNumpy(idx.par)}
    got = ks()[:2000].tolist()
    for wh, r, g in zip(which[:2000].tolist(), ranks[:2000].tolist(), got):
        if g != fms[wh].sa_s(r):
            raise AssertionError(f"sa_walk rank {r}: {g} != {fms[wh].sa_s(r)}")

    # K3 (K5 inside it): the phase-4 reads converted both ways, as the
    # engine seeds them, on the narrow index and on its wide twin
    from biscuit_tpu.config import MemOpt, MEM_F_NO_MULTI
    from biscuit_tpu_torch.align.smem import collect_intv
    opt = MemOpt()
    opt.flag |= MEM_F_NO_MULTI
    lq, ll, lp = (T(a) for a in lanes_of(fq, N_READS))

    def seed_fns(f, lanes, n_lanes):
        a = (f, *(x[:n_lanes] for x in lanes), opt)
        return (lambda: seed_batch.collect_intv_flat(*a),
                lambda: seed_batch.collect_intv_flat_plain(*a))

    def seed_check(name, f, lanes, n_lanes):
        kf, pf = seed_fns(f, lanes, n_lanes)
        got, want = kf(), pf()
        n = [torch.bincount(x[0].long(), minlength=n_lanes) for x in (got, want)]
        err = compare(name, (*got, n[0]), (*want, n[1]))
        if int(got[2].sum()) > n_lanes // 100 or got[1].shape[0] < n_lanes:
            raise AssertionError(f"{name}: {int(got[2].sum())} lanes flagged, "
                                 f"{got[1].shape[0]} rows for {n_lanes} lanes")
        return err, kf, pf, got

    B = lq.shape[0]
    err, ks, ps, got = seed_check("smem_seed", fm, (lq, ll, lp), B)
    # the first lanes against the host's exact smem.collect_intv
    lane_of, rows, _ov = (x.cpu() for x in got)
    for b in range(64):
        p = int(lp[b])
        want = collect_intv(opt, fms[p], fms[1 - p], lq[b, :int(ll[b])].cpu().numpy())
        mine = [tuple(r) for r in rows[lane_of == b].tolist()]
        if mine != want:
            raise AssertionError(f"smem_seed lane {b} differs from collect_intv")
    err = max(err, seed_check("smem_seed wide", fmw, (lq, ll, lp), B)[0])
    row("smem_seed", "smem_seed.cu", "biscuit_tpu/ops/seed_batch.py:1847", err,
        cuda_ms(ks, 10), cuda_ms(ps, 1),
        f"B={B} lanes, L={lq.shape[1]}, narrow index (times), wide (equality), "
        f"{rows.shape[0]} rows")

    # K6: the occurrence streams mem_chain_batch builds for those lanes and
    # for chimeras of thirds of three reads (lanes of three chains), caught
    # at the scan's entry; then NC=2, where lanes overflow
    from biscuit_tpu.io.fastq import BSeq, fastq_iter, read_batch
    from biscuit_tpu_torch.align.chain import CHAIN_NC, mem_chain_batch
    from biscuit_tpu_torch.align.device_engine import DeviceAligner
    from biscuit_tpu_torch.align.pipeline import AlignerState
    seqs = read_batch(fastq_iter(fq), None, 1 << 60)[:N_READS]
    n3 = READ_LEN // 3
    chim = [np.concatenate([seqs[i].seq[:n3], seqs[i + 1].seq[n3:2 * n3],
                            seqs[i + 2].seq[2 * n3:3 * n3]])
            for i in range(0, 3 * (N_READS // 8), 3)]
    seqs += [BSeq(name=f"chimera{i}", seq=c, l_seq=len(c))
             for i, c in enumerate(chim)]
    plan = [(s, p) for s in seqs for p in (0, 1)]
    engine = DeviceAligner(AlignerState(idx), dev)
    seeds, lookups = engine._collect_seeds(opt, plan)
    jobs = [(s.l_seq, p, seeds[i], lookups[i]) for i, (s, p) in enumerate(plan)]
    caught = []
    real_scan = chain_batch.chain_scan_batch
    chain_batch.chain_scan_batch = lambda *a, **k: caught.append(a) or real_scan(*a, **k)
    try:
        mem_chain_batch(opt, idx, jobs, dev)
    finally:
        chain_batch.chain_scan_batch = real_scan
    sa = caught[0]
    kc = lambda nc=CHAIN_NC: chain_batch.chain_scan_batch(*sa, NC=nc)
    pc = lambda nc=CHAIN_NC: chain_batch.chain_scan_batch_plain(*sa, NC=nc)
    err = compare("chain_scan", kc(), pc())
    got2 = kc(2)
    err = max(err, compare("chain_scan NC=2", got2, pc(2)))
    n_ov2 = int(got2[1].sum())
    if n_ov2 == 0:
        raise AssertionError("chain_scan NC=2 flagged no lane")
    row("chain_scan", "chain_scan.cu", "biscuit_tpu/ops/chain_batch.py:44",
        err, cuda_ms(kc, 20), cuda_ms(pc, 1),
        f"J={sa[0].shape[0]} B={sa[0].shape[1]} NC={CHAIN_NC} "
        f"(+NC=2: {n_ov2} lanes flagged, equal)")

    # the seeder and the SA walk on a 50 Mbp index, whose tables (about
    # 100 MB each strand pair) are twice the L2; the plain versions on
    # BIG_CHECK lanes and 2^16 ranks bound their time
    t0 = time.perf_counter()
    bfa, bfq, bidx = make_dataset(os.path.join(work, "big"), genome_size=BIG_GENOME,
                                  n_reads=N_READS, read_len=READ_LEN, seed=SEED)
    fmb = seed_batch.FMPair.from_index(bidx, dev)
    say(f"[3] 50 Mbp data and index in {time.perf_counter() - t0:.1f} s "
        f"(fused tables {fmb.tab.numel() * 4 / 1e6:.0f} MB)")
    big = tuple(T(a) for a in lanes_of(bfq, N_READS))
    kb, _pb = seed_fns(fmb, big, B)
    _err, _kb, pb, _got = seed_check("smem_seed 50 Mbp", fmb, big, BIG_CHECK)
    say(f"[3] smem_seed 50 Mbp: kernel {cuda_ms(kb, 5):.4f} ms for {B} lanes, "
        f"plain {cuda_ms(pb, 1):.4f} ms for {BIG_CHECK} lanes, equal on "
        f"{BIG_CHECK} [{card}]")
    rb = T(rng.integers(0, fmb.seq_len + 1, n).astype(np.int32))
    kw = lambda: seed_batch.sa_batch(fmb, which, rb)
    pw = lambda: seed_batch.sa_batch_plain(fmb, which[:1 << 16], rb[:1 << 16])
    compare("sa_walk 50 Mbp", kw()[:1 << 16], pw())
    say(f"[3] sa_walk 50 Mbp: kernel {cuda_ms(kw, 10):.4f} ms for 2^20 ranks, "
        f"plain {cuda_ms(pw, 1):.4f} ms for 2^16, equal on 2^16 [{card}]")
    del fmb, bidx

    # 4. the SE align slice end to end, through the CLI entry point
    from biscuit_tpu_torch import cli
    from biscuit_tpu_torch.align import device_engine
    from biscuit_tpu.config import MemOpt, MEM_F_NO_MULTI, MEM_F_PE
    from biscuit_tpu.index.fmindex import BisIndex
    from biscuit_tpu_torch.align.pipeline import AlignerState, process_seqs
    from torch_testdata import damage_mates, load_pairs
    os.environ["BISCUIT_TPU_TORCH_DEVICE"] = "cuda"

    def align(argv):
        """The CLI on the card, every count set to 0 just before it and read
        just after: (SAM records, wall s, launches, stage report)."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        device_engine.reset_stages()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["align", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        rep = device_engine.stage_report()
        if rc != 0:
            raise AssertionError(f"align {argv} exited {rc}")
        body = [ln for ln in buf.getvalue().splitlines()
                if not ln.startswith("@")]
        return body, wall, launches, rep

    def primaries(body, n):
        """One primary record a read, each mapped one with a position and
        a CIGAR."""
        prim = [ln.split("\t") for ln in body
                if not int(ln.split("\t")[1]) & 0x900]
        if len(prim) != n or any(len(f) < 11 for f in prim):
            raise AssertionError(f"{len(prim)} primary records for {n} reads")
        for f in prim:
            if not int(f[1]) & 4 and (int(f[3]) < 1 or f[5] == "*"):
                raise AssertionError(f"bad mapped record {f[:6]}")
        return prim

    def host_sam(seqs, flag, n_threads=1):
        """The port's host engine on seqs: (SAM, seconds)."""
        opt = MemOpt()
        opt.flag |= MEM_F_NO_MULTI | flag
        opt.n_threads = n_threads
        for s in seqs:
            s.comment = None
        t1 = time.perf_counter()
        process_seqs(opt, AlignerState(BisIndex.load(fa)), seqs, 0)
        return "".join(s.sam for s in seqs), time.perf_counter() - t1

    def check_lanes(rep, n_lanes, tag):
        say(f"[{tag}] lanes redone on host: seeding {rep['seed_overflow_lanes']}, "
            f"chaining {rep['chain_host_lanes']} of {n_lanes}; traceback "
            f"overflow {rep['traceback_overflow_lanes']}")
        # a kernel that flagged every lane must not pass behind the host rerun
        if rep["seed_overflow_lanes"] > n_lanes // 100:
            raise AssertionError("over 1% of the seeding lanes ran on the host")
        if rep["chain_host_lanes"] > n_lanes // 10:
            raise AssertionError("over 10% of the chaining lanes ran on the host")

    body, wall, launches, rep = align([fa, fq])
    prim = primaries(body, N_READS)
    mapped = sum(1 for f in prim if not int(f[1]) & 4)
    if mapped < 0.9 * N_READS:
        raise AssertionError(f"only {mapped} of {N_READS} reads mapped")
    # the first N_CHECK reads through the port's host engine
    want, host_s = host_sam(read_batch(fastq_iter(fq), None, 1 << 60)[:N_CHECK], 0)
    if not "".join(ln + "\n" for ln in body).startswith(want):
        raise AssertionError("device SAM differs from the host engine's "
                             f"in the first {N_CHECK} reads")
    n_ind = sum(1 for f in prim if "I" in f[5] or "D" in f[5])
    say(f"[4] align: {N_READS} reads, {mapped} mapped, {n_ind} with I/D, "
        f"first {N_CHECK} SAM byte-identical to the host engine "
        f"({host_s:.1f} s on host)")
    say(f"[4] stages (s): {json.dumps({k: round(v, 3) for k, v in rep.items()})}")
    check_lanes(rep, 2 * N_READS, "4")
    say(f"[4] launches: {json.dumps(launches)}")
    say(f"[4] align wall {wall:.2f} s = {N_READS / wall:.1f} reads/s "
        f"(engine stages {rep['total_s']:.2f} s) [{card}]")
    for r in table:
        if launches.get(r["name"], 0) < 1:
            raise AssertionError(f"{r['name']} never launched on the SE path")

    # 4b. the PE align slice end to end. The generator draws the genome
    # first, so the same seed and size write the same genome.fa, and the
    # phase-4 index serves. Every third mate 2 is damaged at every 9th base
    # (no exact 19-mer left): only mate rescue can place it.
    t0 = time.perf_counter()
    pfa, (fq1, fq2), _ = make_dataset(
        os.path.join(work, "pe"), genome_size=GENOME, n_reads=N_PAIRS,
        read_len=READ_LEN, seed=SEED, snp_rate=0.001, pe=True, index=False)
    with open(fa, "rb") as f1, open(pfa, "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("the PE data's genome differs from phase 4's")
    damage_mates(fq2, DAMAGE_EVERY)
    say(f"[4b] data: {N_PAIRS} pairs of {READ_LEN} bp, every "
        f"{DAMAGE_EVERY}rd mate 2 damaged, in {time.perf_counter() - t0:.1f} s")
    caught = []  # K7's calls on the path, for its row of the kernel table
    real_local = sw_local.sw_local_batch
    sw_local.sw_local_batch = lambda *a: caught.append(a) or real_local(*a)
    try:
        pbody, pwall, plaunch, prep = align([fa, fq1, fq2])
    finally:
        sw_local.sw_local_batch = real_local
    pprim = primaries(pbody, 2 * N_PAIRS)
    pmapped = sum(1 for f in pprim if not int(f[1]) & 4)

    def damaged_mapped(prim):
        damaged = [prim[2 * p + 1] for p in range(0, N_PAIRS, DAMAGE_EVERY)]
        return sum(1 for f in damaged if not int(f[1]) & 4), len(damaged)

    dmapped, n_damaged = damaged_mapped(pprim)
    # the same reads with rescue off: the damaged mates it placed go unmapped
    sbody, swall, slaunch, srep = align(["-S", fa, fq1, fq2])
    smapped, _n = damaged_mapped(primaries(sbody, 2 * N_PAIRS))
    # the whole chunk through the port's host engine: the insert-size
    # statistics span the chunk; its worker1 runs in a fork pool
    want, host_s = host_sam(load_pairs(fq1, fq2), MEM_F_PE, os.cpu_count() or 1)
    if "".join(ln + "\n" for ln in pbody) != want:
        raise AssertionError("PE device SAM differs from the host engine's")
    say(f"[4b] align: {2 * N_PAIRS} reads, {pmapped} mapped, damaged mates "
        f"{dmapped} of {n_damaged} mapped ({smapped} with rescue off, -S, "
        f"{swall:.2f} s); SAM of the whole chunk byte-identical to the host "
        f"engine ({host_s:.1f} s on host)")
    say(f"[4b] stages (s): {json.dumps({k: round(v, 3) for k, v in prep.items()})}")
    check_lanes(prep, 2 * 2 * N_PAIRS, "4b")
    say(f"[4b] launches: {json.dumps(plaunch)}; rescue lanes "
        f"{prep['rescue_lanes']} in {len(caught)} K7 calls")
    say(f"[4b] PE align wall {pwall:.2f} s = {2 * N_PAIRS / pwall:.1f} reads/s "
        f"(engine stages {prep['total_s']:.2f} s, rescue "
        f"{prep.get('rescue', 0.0):.3f} s) [{card}]")
    if plaunch.get("sw_local", 0) < 2 or prep["rescue_lanes"] < 1:
        raise AssertionError("mate rescue did not run K7 on the PE path")
    if slaunch.get("sw_local", 0) or srep["rescue_lanes"]:
        raise AssertionError("K7 ran under -S")
    if dmapped <= smapped:
        raise AssertionError(f"rescue placed no damaged mate ({dmapped} "
                             f"mapped with it, {smapped} without)")

    # K7 against its plain version: each call caught on the PE path, then
    # numpy-seeded lanes (i16 and u8, saturating, odd qlens, endsc breaks)
    keys = ("gmax", "te", "qe", "shift", "sat", "imax_rows")

    def local_fns(a):
        q, ql, t, tl, mats, msel, o_del, e_del, o_ins, e_ins, mn, en, u8 = a
        mat_b = mats.to(torch.int32)[msel.long()].reshape(-1, 25)
        k = lambda: sw_local.sw_local_batch(*a)
        p = lambda: sw_local.sw_local_batch_plain(
            q, ql, t, tl, mat_b, mn, en, u8, o_del, e_del, o_ins, e_ins)
        return k, p

    def local_check(name, a):
        kf, pf = local_fns(a)
        got, want = kf(), pf()
        return compare(name, tuple(got[k] for k in keys),
                       tuple(want[k] for k in keys)), got

    err = 0
    for i, a in enumerate(caught):
        err = max(err, local_check(f"sw_local path call {i}", a)[0])
    n_seeded = 4096
    first, sc, last = local_case(rng, n_seeded, 160, 450)
    seeded = (*(T(x) for x in first), *sc, *(T(x) for x in last))
    e2, got = local_check("sw_local seeded lanes", seeded)
    n_sat, n_u8 = int(got["sat"].sum()), int(seeded[-1].sum())
    if n_sat == 0 or n_u8 in (0, n_seeded):
        raise AssertionError(f"seeded K7 lanes: {n_sat} saturated, {n_u8} u8")
    fwd = caught[0]  # the forward pass: every candidate of the chunk
    kf, pf = local_fns(fwd)
    ms = cuda_ms(kf, 20)
    # cells each lane computed: its striped width times the rows it ran.
    # One thread walks a lane, so the longest lane bounds the kernel.
    width = torch.where(fwd[-1] > 0, 16, 8)
    cells = ((fwd[1] + width - 1) // width * width
             * (kf()["imax_rows"] != sw_local.NEGB).sum(0))
    row("sw_local", "sw_local.cu", "biscuit_tpu/ops/sw_local.py:41",
        max(err, e2), ms, cuda_ms(pf, 1),
        f"path: {len(caught)} calls, forward B={fwd[0].shape[0]} "
        f"Lq={fwd[0].shape[1]} Lt={fwd[2].shape[1]}, {int(cells.sum())} "
        f"cells, longest lane {int(cells.max())} "
        f"({ms * 1e6 / max(int(cells.max()), 1):.1f} ns a cell); "
        f"+ {n_seeded} seeded lanes ({n_u8} u8, {n_sat} saturated)")
    for r in table:
        n_se, n_pe = launches.get(r["name"], 0), plaunch.get(r["name"], 0)
        r["launches"] = n_se + n_pe
        if n_pe < 1:
            raise AssertionError(f"{r['name']} never launched on the PE path")

    # 5. jax stayed out
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    say("[5] 'jax' not in sys.modules")

    say(json.dumps({"kernels": table}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
