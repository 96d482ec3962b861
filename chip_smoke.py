#!/usr/bin/env python3
"""Bring-up check of the torch port (biscuit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab OTHER_TREE   (no check: `align` (the
        device-jax engine) and `pileup` (the device engine) of this tree
        and of another checkout
        side by side on the data of phases 4, 4b and 6, and K6's and K4's
        launches of both trees on the same inputs)

Phases, one line each (more for the kernel table):
  1. the card: nvidia-smi name and power limit, compute capability
  2. build the seven CUDA sources of the align and pileup slices with nvcc,
     and the native library (g++: align_host.cpp, sais.cpp, bwt_merge.cpp,
     pileup_native.cpp, streams_native.cpp), in parallel; registers,
     spills and shared memory of each kernel from
     ptxas, warps resident an SM from the occupancy calculator
  3. each kernel against its plain torch version on the card, on
     numpy-seeded inputs or the phase-4 reads at the shapes of its path:
     exact equality (torch.equal), both times from CUDA events, the least
     time the card could take for the same work (bound_ms: the larger of
     bytes over the memory rate and integer operations over the integer
     rate; a DP kernel's operations are those of the cells its lanes really
     fill, early breaks taken off) and, for the count scatter-add, the time
     of the one PyTorch call
     that computes it; the seeder and the SA walk also on a 50 Mbp index
     (tables twice the L2). The SA walk (K4) runs both entries, ranks and
     seed intervals, on 2^20 random ranks (and rows of about as many jobs)
     at sa_intv 4, 16 (the wide twin) and 32 (a view of the sampled
     array) on 5 and 50 Mbp, with its walk-step bound (the rows its walks
     read, counted by the plain walk) beside the one-sample floor, on the
     edge rows of tests/torch_testdata.py, a skewed list (one 31-step walk
     among sampled ranks), job lists longer than the grid's walk slots,
     and the engine's own call. The three DP kernels that give a warp a lane
     (K1 sw_extend, K7 sw_local, K2 sw_global) also run the edge lanes of
     tests/torch_testdata.py at query widths that launch every compiled
     strip width, on uint8 and int32 codes, under e_ins of 0, 1 and 3, and
     at widths past the widest strip, which launch the wide instance with
     its strips in shared memory and, at 16,000 columns, in device memory;
     their rows give the launch alone beside the wrapper, K1's also at a late round's 256
     lanes, K2's the DP, the traceback, and the two in one launch (the
     engine's call), each held to the others; the wide instance's bound
     at every wide shape and, at 2048 lanes of 640 x 660, its launch alone
     and its plain version. The seeder (K3) also runs
     seeded edge lanes (N everywhere, reads of no and one base, tandem
     repeats) under -e and under S of 3 and 1, which flag lanes, held to its
     plain version and to the host's collect_intv. The chain scan (K6) also
     runs the edge lanes of tests/test_torch_chain.py (1024 occurrences,
     exactly NC chains and one more, a seed across l_pac, int64 ranks
     around an l_pac >= 2^31) at NC 64 and 2, and its launch alone with 16
     and with 32 threads a lane. K9's fused entry (cm, cb and the depth of
     a window in one launch, the pileup path's call) runs a window of phase
     6's size in coordinate order, two samples, shuffled (every chunk on its
     device-memory path), on one site, empty and with codes in [21, 32);
     its general entry (mesh.py's contract) keeps its own cases
  Phases 4 to 4c and 6 run `align` with the device-jax engine
  (BISCUIT_TPU_TORCH_ENGINE=device-jax), whose kernels they hold; 4d runs
  the CLI's default engine, `device` (the hybrid), and `native`.
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
     against its plain version. Then the same PE align once more under
     torch.profiler: the card's busy time and idle share, device time by name
  4c. queries wider than the widest compiled strip: 128 reads of 640 bp,
     and 64 pairs of a 640 bp mate 1 (every third damaged as in 4b) and a
     150 bp mate 2, through the CLI on the card: K1, K2 and (PE) K7 run
     their wide instance, no lane is redone on the host for its width, and
     the SAM, SA:Z tags included, must equal the port's host engine's byte
     for byte. In 4, 4b and 4c no global alignment may be left for worker2
     (cigar_late_lanes 0)
  4d. the engines: the hybrid (K3 and K4 on the card into the native C++
     engine) at SA_CAP 0, 8, 16 and 64, once each, and the native engine
     at -@ 1 and at -@ os.cpu_count(), on the reads of phases 4 and
     4b; every SAM must equal device-jax's of phases 4 and 4b byte for byte,
     K3 must launch in every hybrid run and K4's interval entry in every one
     with SA_CAP above 0; reads/s of each engine with the host's core count,
     the hybrid's inject and native seconds; the same sweep on 8192 reads
     of a genome with repeats (torch_testdata.repeat_dataset) at -@ 1 and
     at -@ os.cpu_count(), once each, SAM equal to the native engine's,
     which equals device-jax's on the first 1024; the per-call set-up
     (index load, NativeAligner, DeviceSeeder) timed on its own; -V -@ 2
     through the native engine (its fork pool) once after CUDA init and
     K3's launches, no launch in it, and through the default engine (the
     chunk on the device engine), both SAM equal to device-jax's; a warm
     hybrid PE run under torch.profiler. In phase 6, the hybrid at the
     default SA_CAP and at 64 (pipelined sub-batches of DEVICE_BATCH reads)
     and the native engine on its 40,000 reads at -@ 1, both at -@
     os.cpu_count(), each beside its set-up; SAM equal to device-jax's
  6. the pileup slice end to end: a 200 kbp genome at 30x (40,000 directional
     WGBS reads of 150 bp of a diploid sample: half from a haplotype with
     SNPs, half from the reference), aligned by the port's `align` on the
     card, sorted to BAM by its `sort`, then its `pileup` through the CLI on
     the card under the device engine (BISCUIT_TPU_TORCH_PILEUP=device) with
     the default 100,000 bp window step, so that full-size
     windows of about 3 x 10^6 data reach K9; the VCF must equal, without
     its ##program line, the VCF of the same CLI in a process of its own on
     the CPU (plain counts), K9's fused entry must have launched once a
     window that held data (its general entry never), and the VCF must hold
     methylation lines and ALT alleles. Then
     the same pileup once more under the CLI's default engine (the switch
     unset), which must be the device engine with the same launches and
     VCF, and once under torch.profiler: stage seconds
     of each run, the card's busy time and idle share, device time by name
  6b. the native pileup engine (the C++ window engine) on phase 6's BAM in
     this process, after K9's launches: with a .bai (RawBamStream) and
     without (RawBam) at -@ 1 and -@ os.cpu_count() (its fork pool), twice
     each, so in 20 windows of 10 kbp (-s 10000), those with the .bai
     again in a process of its own (no CUDA context) and there also in 100
     windows (-s 2000), on the SAM (record
     objects), and on a -g region across a window boundary beside the
     device engine on it; each VCF (without ##program)
     and _meth_average.tsv must equal the device engine's byte for byte,
     and no kernel may launch in a native run; sites/s and bp/s of each run
     with its stage seconds; what a fork pool costs here and in a process
     of its own; the rule of PERF.md (is native faster than the device
     engine by more than the spread, in 20 windows at -@ os.cpu_count()?)
     applied and its answer printed beside the default, `device`
  6c. the subcommands downstream of pileup on phase 6's outputs: vcf2bed
     (-t cg, c, snp; hcg, gch on a -N VCF) and mergecg on the C++ line
     filters and on the Python walk (BISCUIT_TPU_TORCH_STREAMS=python);
     epiread (epiBED, -B with the SNP bed, -P, -O; on chr1) on the C++
     raw-BAM engine and the Python walk at -@ 1 and -@ os.cpu_count(): the two paths' and
     both thread counts' outputs must be the same bytes, no kernel may
     launch; the raw engine again in a process of its own, on chr1 and on
     the whole BAM in 20 and 100 windows, at both thread counts;
     rectangle on chr1's -O epireads and asm on the -P epireads
     must give well-formed rows; lines/s of each run
  6d. the QC family and the companion scripts (host code, as in the JAX
     package) on phase 6's genome, FASTQ, BAM and VCF: bsstrand -c -y to a
     BAM, bsconv -p -m 2, cinread -t cg and -t ch on chr1's first QC_SPAN
     bp, tview -d, bc, QC.py -v (with qc -s inside it) on the assets of
     scripts/build_qc_assets.py, flip_pbat_strands, pybiscuit to_methylKit;
     qc with insert sizes, bc on two FASTQs and pybiscuit to_mr on phase
     4b's pairs; each in this process with no kernel launched, its outputs
     equal to the same command's in a process of its own with no card
     (CUDA_VISIBLE_DEVICES=); a BAM flipped twice holds the input's
     records; cinread_func's vectorized counts equal its walk's; the wall
     and reads/s or lines/s of each run
  7. K10, multi-device over torch.distributed, and the port's driver entry,
     on phase 6's data: entry()'s batched K3 step on the card equal to its
     plain version (torch.equal); dryrun_multichip(2), whose two spawned
     ranks share the card under gloo (NCCL only where each rank has a card
     of its own: it cannot run on one card) and hold each of its eight
     stages to its one-rank run, with each stage's seconds, and K1, K6, K7,
     K9's general entry and stage 8's index-sharded walks
     (kernels/fm_route.cu: smem_route_step, sa_route_step, route_gather)
     launched by the ranks' sharded calls (the counts each rank reports,
     added to the kernel table); the ranks also hold stage 8's kernels to
     their plain versions on their shards, with each walk's steps
     (route_gather's row of the table); `align` under
     BISCUIT_TPU_TORCH_INDEX_SHARD=2 as 2 ranks sharing the card (gloo) on
     phase 4's 4096 reads and phase 4b's 2048 pairs: rank 0's SAM body equal
     to phase 4d's one process, rank 1 no SAM, each rank seeding by
     smem_route_step on its shard (K3 never) and walking SA by K4's interval
     entry on the whole tables, with the routed seeder's steps a call, ms a
     step and rows (the ranks' stderr); both step kernels at those shapes
     (8192 lanes, 20,000 SA walks) on the same 2 shards under gloo, each
     held to K3's / K4's output on the whole tables and to its plain version
     on its shard, with its launches alone beside its whole call
     (biscuit_tpu_torch/tools/route_bench.py --ranks 2 --plain: the kernel
     table's rows), then under nccl in a group of one rank at several k
     (steps enqueued between host reads), each held to K3's / K4's output;
     then, each in processes of its own on the card: shard_align -n 2 on
     phase 6's 40,000 reads under the default engine, its SAM body equal
     to phase 4d's one-process SAM, each worker launching K3 and K4's
     interval entry (the launches the CLI reports on stderr);
     shard_pileup -n 2 and `pileup` under the mesh engine on 2 ranks
     started with torchrun's variables, each equal to phase 6's VCF
     (without ##program) and _meth_average.tsv, each mesh rank launching
     K9's fused entry once a window; dist_run --ns 1,2 on 8192 of phase
     6's reads, with its hashes equal across n and each n's wall
  5. (last) neither jax nor any module of the JAX package was imported
Then a JSON line with the kernel table and, last, the result line. Any
failure raises and exits nonzero; nothing falls back to the CPU.
"""
import contextlib
import gc
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()  # the script's start, for the phases' [t] lines
SEED = 7
GENOME, N_READS, READ_LEN = 5_000_000, 4096, 150
N_PAIRS, DAMAGE_EVERY = 2048, 3  # phase 4b: pairs; every 3rd mate 2 damaged
BIG_GENOME, BIG_CHECK = 50_000_000, 1024  # 50 Mbp: lanes held to plain
# phase 3: lanes of 54 x 150 = 8100 bases for the seeder, up to 1024 rows each
LONG_JOIN, LONG_S = 54, 1024
# phase 6: 2 chromosomes of 100 kbp at 30x, so two full 100 kbp windows
PLP_GENOME, PLP_READS = 200_000, 40_000
PLP_WINDOW, PLP_DATA = 100_000, 3_000_000   # K9's shape on that path
# phase 6c: rectangle and asm on the epireads of chr1's first 10 kbp
RECT_SPAN = 10_000
# phase 6d: cinread's per-site rows on chr1's first QC_SPAN bp, and tview's
# dump of a TVIEW_WIDTH bp window at TVIEW_AT
QC_SPAN, TVIEW_AT, TVIEW_WIDTH = 20_000, "chr1:50000", 120
# phase 4c: reads wider than the DP kernels' widest strip (512 columns), SE
# and as mate 1
WIDE_LEN, N_WIDE, N_WIDE_PAIRS = 640, 128, 64
# (B, Lq, Lt) past the widest strip: the wide instance of K1, K7 and K2 with
# its strips in shared memory and, the last, in device memory
WIDE_SHAPES = ((17, 530, 200), (6, 656, 120), (3, 16000, 40))

# The card's published peaks (NVIDIA H100 SXM data sheet): 3.35 TB/s of
# device memory, and 67 TFLOP/s of float32 outside the tensor cores. The
# kernels here do int32 arithmetic, for which the data sheet gives no rate:
# an FMA counts two operations and an SM has half as many int32 lanes as
# float32 lanes, so the integer rate is taken as a quarter of that figure.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 4
# integer operations a DP cell costs (adds, maxima and compares of the
# affine-gap recurrence; the global kernel also packs direction bits)
CELL_OPS = {"sw_extend": 12, "sw_global": 14, "sw_local": 14}
N_CHECK = 512            # reads whose SAM is held to the host engine
# phase 4d: the hybrid engine's SA_CAP sweep (occurrences a seed resolved
# by K4 on the card; the native engine walks the rest)
SA_CAPS = (0, 8, 16, 64)
N_REP, N_REP_CHECK = 8192, 1024  # phase 4d: reads on the genome with repeats


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of fn() from CUDA events, after one warm-up (none
    with warm=False, for a slow plain version that has just run)."""
    import torch
    if warm:
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time the card could take to move
    n_bytes once and to do n_ops integer operations, and which is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _nothing(_):
    return None


def fork_pool_cost(n: int):
    """(seconds, resident bytes): a fork pool of n workers started, given one
    empty task each and joined, in this process, and this process's
    resident set size when it forked."""
    import multiprocessing
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    t = time.perf_counter()
    with multiprocessing.get_context("fork").Pool(n) as pool:
        pool.map(_nothing, range(n), chunksize=1)
    return time.perf_counter() - t, rss


def band_cells(qlens, tlens, w):
    """DP cells inside the band |i - j| <= w of every lane, rows i < tlen,
    columns j < qlen: what global alignment fills. An extension that ends
    early (z-drop, a narrowed band) fills fewer, so for K1 this is only the
    upper figure beside the count of the cells its lanes really fill."""
    import torch
    i = torch.arange(int(tlens.max()), device=qlens.device)[None, :]
    lo = (i - w[:, None]).clamp(min=0)
    hi = torch.minimum(qlens[:, None], i + w[:, None] + 1)
    return int(((hi - lo).clamp(min=0) * (i < tlens[:, None])).sum())


def count_case(rng, window, n_bams, n, p_invalid):
    """K9's inputs as the pileup engine makes them for a window of
    `window` sites and n_bams samples: reads of 150 bases in coordinate
    order, each base one datum at position site * n_bams + sample with a
    code base * 3 + meth in [0, 21): (positions, codes, valid) as int64 /
    bool numpy arrays of n data."""
    import numpy as np
    n_reads = n // 150
    start = np.sort(rng.integers(0, window - 150, n_reads))
    site = (start[:, None] + np.arange(150)[None, :]).reshape(-1)
    sample = np.repeat(rng.integers(0, n_bams, n_reads), 150)
    codes = rng.integers(0, 7, site.size) * 3 + rng.integers(0, 3, site.size)
    valid = rng.random(site.size) >= p_invalid
    return site * n_bams + sample, codes, valid


def chain_scan_inputs(opt, idx, fq, dev):
    """K6's arguments as mem_chain_batch gives them for the first N_READS
    reads of fq, both strands, and for chimeras of thirds of three reads
    (lanes of three chains), caught at the scan's entry: (qbeg, len, rbeg,
    valid, rid, k, n_occ, l_pac, w, max_gap, max_occ)."""
    import numpy as np
    from biscuit_tpu_torch.io.fastq import BSeq, fastq_iter, read_batch
    from biscuit_tpu_torch.align.chain import mem_chain_batch
    from biscuit_tpu_torch.align.device_engine import DeviceAligner
    from biscuit_tpu_torch.align.pipeline import AlignerState
    from biscuit_tpu_torch.ops import chain_batch
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
    return caught[0]


def sa_engine_inputs(idx, fq, dev):
    """K4's interval entry as the engine calls it for the first N_READS
    reads of fq, both strands, caught at the entry: (fm, which_row, x0_row,
    kmax_row, off_row, total)."""
    from biscuit_tpu_torch.config import MemOpt, MEM_F_NO_MULTI
    from biscuit_tpu_torch.io.fastq import fastq_iter, read_batch
    from biscuit_tpu_torch.align import device_engine
    from biscuit_tpu_torch.align.pipeline import AlignerState
    opt = MemOpt()
    opt.flag |= MEM_F_NO_MULTI
    seqs = read_batch(fastq_iter(fq), None, 1 << 60)[:N_READS]
    engine = device_engine.DeviceAligner(AlignerState(idx), dev)
    caught = []
    real = device_engine.sa_batch_intervals
    device_engine.sa_batch_intervals = lambda *a: caught.append(a) or real(*a)
    try:
        engine._collect_seeds(opt, [(s, p) for s in seqs for p in (0, 1)])
    finally:
        device_engine.sa_batch_intervals = real
    return caught[0]


def lanes_of(fq, n_reads):
    """The seeder's input for the first n_reads of fq, each read converted
    both ways as the engine plans SE lanes: (reads [2n, L] int32, lens,
    parents) as numpy."""
    from biscuit_tpu_torch.io.fastq import fastq_iter, read_batch
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
    from biscuit_tpu_torch.config import MemOpt
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
    from biscuit_tpu_torch.config import MemOpt
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
        if sys.argv[1:2] == ["--ab"]:
            return align_ab(work, *sys.argv[2:])
        return smoke(work)


def k4_ab_inputs(work, fa, idx):
    """K4's inputs for `--ab`, in files both trees read: the phase-4 tables
    (sa_intv 4), their wide twin (sa_intv 16), their sa_intv-32 view, a 50
    Mbp index and its view, each with 2^20 random ranks. Returns {tag:
    (path, walk-step bound ms, one-sample floor ms)}, the bounds from this
    tree's plain walk on the card (the same whatever implements K4)."""
    import numpy as np
    import torch
    from torch_testdata import make_dataset, sa_intv_view
    from biscuit_tpu_torch.index.build import build_index
    from biscuit_tpu_torch.ops import seed_batch
    dev = torch.device("cuda", 0)
    os.environ["BISCUIT_TPU_WIDE_INDEX"] = "1"
    try:
        wide = build_index(fa)
    finally:
        del os.environ["BISCUIT_TPU_WIDE_INDEX"]
    _bfa, _bfq, big = make_dataset(os.path.join(work, "big"),
                                   genome_size=BIG_GENOME, n_reads=16,
                                   seed=SEED)
    rng = np.random.default_rng(SEED + 4)
    shapes = {}
    for tag, base, view in (("5 Mbp sa_intv 4", idx, 0),
                            ("5 Mbp wide sa_intv 16", wide, 0),
                            ("5 Mbp sa_intv 32 view", idx, 32),
                            ("50 Mbp sa_intv 4", big, 0),
                            ("50 Mbp sa_intv 32 view", big, 32)):
        fm = seed_batch.FMPair.from_index(base, dev)
        if view:
            fm = sa_intv_view(fm, view)
        n = 1 << 20
        ranks = rng.integers(0, fm.seq_len + 1, n).astype(
            np.int64 if fm.wide else np.int32)
        which = rng.integers(0, 2, n).astype(np.int32)
        steps = torch.zeros(n, dtype=torch.int64, device=dev)
        seed_batch.sa_batch_plain(fm, torch.from_numpy(which).to(dev),
                                  torch.from_numpy(ranks).to(dev), steps)
        rb = fm.sa_samples.element_size()
        path = os.path.join(work, f"k4_{len(shapes)}.npz")
        np.savez(path, tab=fm.tab.cpu().numpy().view(np.uint32),
                 L2=fm.L2.cpu().numpy(), primary=fm.primary.cpu().numpy(),
                 sa=fm.sa_samples.cpu().numpy(), seq_len=fm.seq_len,
                 wide=fm.wide, intv=fm.sa_intv, ranks=ranks, which=which)
        shapes[tag] = (path, bound(int(steps.sum()) * fm.tab.shape[-1] * 4
                                   + n * (3 * rb + 4), 0)[0],
                       bound(n * (3 * rb + 4), 0)[0])
    return shapes


def align_ab(work: str, other: str) -> int:
    """`align` and `pileup` of this tree against the tree `other` (another
    checkout that holds a `biscuit_tpu_torch/`) on the data of phases 4, 4b
    and 6, in four processes one after the other: other, this, this,
    other. Each aligns PE (cold: it builds the kernels), SE, PE, SE, PE
    through the CLI's `main`, then piles up phase 6's BAM (aligned and
    sorted by this tree beforehand) twice, then times K6 on phase 3's
    chain scan inputs (made by this tree): the wrapper, and the launch
    alone through the C interface both trees share. The seconds are those
    of the CLI's own `[M::mem_process_seqs] Processed ... real sec` line
    and of each pileup call. It checks only that the two K6 calls agree."""
    import re
    from torch_testdata import damage_mates, diploid_dataset, make_dataset
    other = os.path.abspath(other)
    if not os.path.isdir(os.path.join(other, "biscuit_tpu_torch")):
        print(f"chip_smoke: no biscuit_tpu_torch in {other}", file=sys.stderr)
        return 2
    fa, fq, idx = make_dataset(work, genome_size=GENOME, n_reads=N_READS,
                               read_len=READ_LEN, seed=SEED, snp_rate=0.001,
                               indel_every=16)
    import torch
    from biscuit_tpu_torch.config import MemOpt
    k6 = os.path.join(work, "k6.pt")
    torch.save([x.cpu() if torch.is_tensor(x) else x for x in chain_scan_inputs(
        MemOpt(), idx, fq, torch.device("cuda", 0))], k6)
    _fa, (fq1, fq2), _ = make_dataset(
        os.path.join(work, "pe"), genome_size=GENOME, n_reads=N_PAIRS,
        read_len=READ_LEN, seed=SEED, snp_rate=0.001, pe=True, index=False)
    damage_mates(fq2, DAMAGE_EVERY)
    k4_shapes = k4_ab_inputs(work, fa, idx)
    pdir = os.path.join(work, "plp")
    gfa, gfq, _ = diploid_dataset(pdir, n_reads=PLP_READS, snp_rate=0.005,
                                  genome_size=PLP_GENOME, read_len=READ_LEN,
                                  seed=SEED + 1)
    gsam, gbam = os.path.join(pdir, "aln.sam"), os.path.join(pdir, "aln.bam")
    from biscuit_tpu_torch import cli
    os.environ["BISCUIT_TPU_TORCH_DEVICE"] = "cuda"
    # the pileup engine both trees have (a tree before the switch ignores it)
    os.environ["BISCUIT_TPU_TORCH_PILEUP"] = "device"
    # the engine both trees have (a tree before the engine switch ignores it)
    os.environ["BISCUIT_TPU_TORCH_ENGINE"] = "device-jax"
    with open(gsam, "w") as f, contextlib.redirect_stdout(f):
        if cli.main(["align", gfa, gfq]) != 0:
            return 1
    if cli.main(["sort", "-o", gbam, gsam]) != 0:
        return 1
    vcf = os.path.join(pdir, "ab.vcf")
    card = card_line()
    pe, se = [fa, fq1, fq2], [fa, fq]
    sa_shape = torch.load(k6)[0].shape
    code = ("import contextlib, io, sys, time\n"
            "from biscuit_tpu_torch import cli\n"
            f"for argv in {[pe, se, pe, se, pe]!r}:\n"
            "    with contextlib.redirect_stdout(io.StringIO()):\n"
            "        cli.main(['align', *argv])\n"
            "for _ in range(2):\n"
            "    t = time.perf_counter()\n"
            f"    assert cli.main(['pileup', '-o', {vcf!r}, {gfa!r}, {gbam!r}]) == 0\n"
            "    print(f'[ab pileup] {time.perf_counter() - t:.3f}', file=sys.stderr)\n"
            "import torch\n"
            "from biscuit_tpu_torch import kernels\n"
            "from biscuit_tpu_torch.ops import chain_batch as cb\n"
            f"sa = [x.cuda() if torch.is_tensor(x) else x for x in torch.load({k6!r})]\n"
            "p = [x.int().contiguous() for x in sa[:7]]\n"
            "p[2] = sa[2].contiguous()\n"
            "J, B = p[2].shape\n"
            "log = torch.empty((J, B), dtype=torch.int32, device=p[2].device)\n"
            "ov = torch.empty(B, dtype=torch.bool, device=p[2].device)\n"
            "fn = 'chain_scan_wide' if p[2].dtype == torch.int64 else 'chain_scan_narrow'\n"
            "go = lambda: kernels.launch(cb._lib(), fn, 'chain_scan', p[2].device, "
            "*map(kernels.ptr, p), J, B, *map(int, sa[7:11]), 64, kernels.ptr(log), "
            "kernels.ptr(ov))\n"
            "wrap = lambda: cb.chain_scan_batch(*sa)\n"
            "go()\n"
            "assert torch.equal(wrap()[0], log)\n"
            "def ms(fn, reps=50):\n"
            "    fn()\n"
            "    torch.cuda.synchronize()\n"
            "    a, b = (torch.cuda.Event(enable_timing=True) for _ in '..')\n"
            "    a.record()\n"
            "    for _ in range(reps):\n"
            "        fn()\n"
            "    b.record()\n"
            "    torch.cuda.synchronize()\n"
            "    return a.elapsed_time(b) / reps\n"
            "print(f'[ab k6] {ms(wrap):.4f} {ms(go):.4f}', file=sys.stderr)\n"
            "import hashlib\n"
            "import numpy as np\n"
            "from biscuit_tpu_torch.ops import seed_batch as sb\n"
            "dev = torch.device('cuda', 0)\n"
            f"for tag, path in {[(t, x[0]) for t, x in k4_shapes.items()]!r}:\n"
            "    z = np.load(path)\n"
            "    fm = sb.FMPair.from_numpy(z['tab'], z['L2'], z['primary'], "
            "int(z['seq_len']), z['sa'], bool(z['wide']), int(z['intv']), dev)\n"
            "    which = torch.from_numpy(z['which']).to(dev)\n"
            "    ranks = torch.from_numpy(z['ranks']).to(dev)\n"
            "    out = torch.empty_like(ranks)\n"
            "    if hasattr(sb, '_launch_sa'):\n"
            "        ctr = torch.zeros(2, dtype=torch.int32, device=dev)\n"
            "        go = lambda: sb._launch_sa(fm, which, ranks, None, None, out, ctr)\n"
            "    else:\n"
            "        fn = 'sa_walk_wide' if fm.wide else 'sa_walk_narrow'\n"
            "        go = lambda: kernels.launch(sb._lib(), fn, 'sa_walk', dev, "
            "*map(kernels.ptr, (fm.tab, fm.L2, fm.primary, fm.sa_samples, which, "
            "ranks)), fm.tab.shape[1], fm.sa_samples.shape[1], "
            "fm.sa_intv.bit_length() - 1, kernels.ptr(out), ranks.numel())\n"
            "    wrap = lambda: sb.sa_batch(fm, which, ranks)\n"
            "    go()\n"
            "    assert torch.equal(wrap(), out)\n"
            "    h = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:12]\n"
            "    print(f'[ab k4] {tag}|{ms(wrap, 10):.4f}|{ms(go, 20):.4f}|{h}', "
            "file=sys.stderr)\n")
    k4_digest = {}
    for tag, tree in (("other", other), ("this", REPO), ("this", REPO),
                      ("other", other)):
        r = subprocess.run(
            [sys.executable, "-c", code], cwd=tree, capture_output=True,
            text=True, env=dict(os.environ, PYTHONPATH=tree,
                                BISCUIT_TPU_TORCH_DEVICE="cuda"))
        if r.returncode != 0:
            print(tag, "failed:", r.stderr[-1500:], flush=True)
            return 1
        real = re.findall(r"Processed \d+ reads in [\d.]+ CPU sec, "
                          r"([\d.]+) real sec", r.stderr)
        plp = re.findall(r"\[ab pileup\] ([\d.]+)", r.stderr)
        k6_ms = re.findall(r"\[ab k6\] ([\d.]+) ([\d.]+)", r.stderr)[0]
        k4_got = re.findall(r"\[ab k4\] ([^|]+)\|([\d.]+)\|([\d.]+)\|(\w+)",
                            r.stderr)
        for t, wrap_ms, alone_ms, digest in k4_got:
            if k4_digest.setdefault(t, digest) != digest:
                raise AssertionError(f"K4 {t}: the two trees' positions differ")
        with open(vcf) as f:
            n_sites = sum(1 for ln in f if ln[0] != "#")
        say(f"[ab] {tag}: real s of PE (cold), SE, PE, SE, PE: "
            + " ".join(real) + "; pileup s: " + " ".join(plp)
            + f" ({n_sites} sites: "
            + " ".join(f"{n_sites / float(x):.1f}" for x in plp)
            + f" sites/s); K6 on phase 3's inputs ([J, B] = {list(sa_shape)}): the "
            f"wrapper {k6_ms[0]} ms, the launch alone {k6_ms[1]} ms [{card}]")
        say(f"[ab] {tag}: K4's rank entry on 2^20 random ranks, the wrapper / "
            f"the launch alone (ms): " + "; ".join(
                f"{t}: {w} / {a} (walk-step bound {k4_shapes[t][1]:.6f}, "
                f"floor {k4_shapes[t][2]:.6f})" for t, w, a, _d in k4_got)
            + f" [{card}]")
    return 0


def phase_6b(work, card, pileup, vcf_lines, gfa, gsam, gbam, vcf_gpu,
             n_sites, dev_walls):
    """6b. the native pileup engine (the C++ window engine) on phase 6's BAM,
    in the process that has launched K9: without and with a .bai (RawBam,
    RawBamStream), at -@ 1 and -@ os.cpu_count(), twice each, and so in 20
    windows of 10 kbp (-s 10000) with the .bai, then those with the .bai
    again in a process of its own (no CUDA context); on the SAM (the object
    path); on a -g region across a window boundary beside the device
    engine on the same region. Every VCF (without ##program) and
    _meth_average.tsv must be the device engine's of phase 6 (the SAM's with
    its sample named after the SAM), no kernel may launch in a native run,
    and the -@ os.cpu_count() runs must fork their pool. Then the rule that
    picks the default engine, and 6c on the outputs."""
    from biscuit_tpu_torch import cli
    t_phase = time.perf_counter()
    ncpu = os.cpu_count()
    want = vcf_lines(vcf_gpu)
    with open(vcf_gpu + "_meth_average.tsv") as f:
        want_tsv = f.read()
    out = os.path.join(os.path.dirname(gbam), "native.vcf")

    def check(tag, wall, launches, st, pools, raws, threads, kind,
              vcf=None, tsv=None):
        got = vcf_lines(out)
        with open(out + "_meth_average.tsv") as f:
            got_tsv = f.read()
        if got != (vcf or want) or got_tsv != (tsv or want_tsv):
            raise AssertionError(f"6b {tag}: the native VCF or tsv differs "
                                 f"from the device engine's")
        if any(launches.values()):
            raise AssertionError(f"6b {tag}: a native run launched {launches}")
        if pools != (["fork"] if threads > 1 else []) or raws != kind:
            raise AssertionError(f"6b {tag}: pools {pools}, sources {raws}")
        if threads == 1 and (st["windows"] < 1 or st["native"] <= 0
                             or st["sites"] != len(got) - sum(
                                 ln[0] == "#" for ln in got)):
            raise AssertionError(f"6b {tag}: stages {st}")
        stages = {k: round(v, 3) for k, v in st.items()
                  if k in ("open", "native") or (k in ("windows", "sites")
                                                 and threads == 1)}
        say(f"[6b] native, {tag}: {wall:.3f} s, {n_sites / wall:.1f} sites/s, "
            f"{PLP_GENOME / wall:.1f} bp/s; stages {json.dumps(stages)}; "
            f"VCF and tsv == the device engine's, no launch [{card}]")
        return wall

    walls = {}
    if cli.main(["bamindex", gbam]) != 0:
        raise AssertionError("bamindex failed")
    for bai in (True, False):
        if not bai:   # the same path (the tsv names it), no .bai beside it
            os.rename(gbam + ".bai", gbam + ".bai.off")
        kind = "RawBamStream" if bai else "RawBam"
        for threads in (1, ncpu):
            for _ in range(2):
                walls.setdefault((bai, threads), []).append(check(
                    f"{'with' if bai else 'without'} a .bai ({kind}), -@ "
                    f"{threads}",
                    *pileup("native", ["-@", str(threads)], out=out),
                    threads, [kind]))
    os.rename(gbam + ".bai.off", gbam + ".bai")
    # 20 windows of 10 kbp: the fork pool with work to share (2 windows of
    # 100 kbp leave it 2 workers); the same VCF and tsv
    for threads in (1, ncpu):
        for _ in range(2):
            walls.setdefault(("s10000", threads), []).append(check(
                f"-s 10000 (20 windows), with a .bai, -@ {threads}",
                *pileup("native", ["-s", "10000", "-@", str(threads)],
                        out=out), threads, ["RawBamStream"]))
    # the same runs in a process of its own, as a user runs the CLI: no CUDA
    # context and none of this process's memory to copy into each fork
    alone = [(*o, "-@", str(t)) for o in ((), ("-s", "10000"), ("-s", "2000"))
             for t in (1, ncpu) for _ in range(2)]
    code = ("import json, time, torch\n"
            "from chip_smoke import fork_pool_cost\n"
            "from biscuit_tpu_torch import cli\n"
            "walls = []\n"
            f"for k, opts in enumerate({alone!r}):\n"
            "    t = time.perf_counter()\n"
            f"    assert cli.main(['pileup', *opts, '-o', {out!r} + str(k), "
            f"{gfa!r}, {gbam!r}]) == 0\n"
            "    walls.append(time.perf_counter() - t)\n"
            f"print(json.dumps([walls, torch.cuda.is_initialized(), "
            f"fork_pool_cost({ncpu})]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, BISCUIT_TPU_TORCH_PILEUP="native"),
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise AssertionError(f"6b in a process of its own: {r.stderr[-2000:]}")
    alone_walls, cuda_init, fork_alone = json.loads(r.stdout.splitlines()[-1])
    for k in range(len(alone)):
        with open(out + str(k) + "_meth_average.tsv") as f:
            if vcf_lines(out + str(k)) != want or f.read() != want_tsv:
                raise AssertionError(f"6b {alone[k]} in a process of its "
                                     f"own: the VCF or tsv differs")
    if cuda_init:
        raise AssertionError("6b: the native CLI made a CUDA context")
    say("[6b] native in a process of its own (cli.main timed inside it, no "
        "CUDA context), VCF and tsv == the device engine's: " + "; ".join(
            f"{' '.join(o)}: {w:.3f} s, {n_sites / w:.1f} sites/s"
            for o, w in zip(alone, alone_walls)) + f" [{card}]")
    # what a fork pool of -@ os.cpu_count() workers costs before any window:
    # here (the card's context, the earlier phases' data) and there
    fork_here = fork_pool_cost(ncpu)
    say(f"[6b] a fork pool of {ncpu} workers, started, given one empty task "
        f"each and joined: {fork_here[0]:.3f} s in this process (RSS "
        f"{fork_here[1] / 2**20:.0f} MiB), {fork_alone[0]:.3f} s in a process "
        f"of its own (RSS {fork_alone[1] / 2**20:.0f} MiB) [{card}]")
    # the SAM: record objects through pileup_window_native; the VCF names
    # its sample after the file, the tsv by its path
    sam_vcf = [ln.replace("\taln\n", "\taln.sam\n") if ln[:6] == "#CHROM"
               else ln for ln in want]
    check("the SAM (record objects), -@ 1",
          *pileup("native", ["-@", "1"], [gsam], out), 1, [],
          sam_vcf, want_tsv.replace(gbam + "\t", gsam + "\t"))
    # a region across a window boundary, beside the device engine on it
    region = ["-g", "chr1:40000-60000", "-s", "10000", "-@", "1"]
    rvcf = os.path.join(os.path.dirname(gbam), "region.vcf")
    _w, rl, rst, _p, _r = pileup("device", region, out=rvcf)
    if rl.get("pileup_window_counts", 0) != 2 or rst["windows"] != 2:
        raise AssertionError(f"6b region: device launches {rl}, stages {rst}")
    with open(rvcf + "_meth_average.tsv") as f:
        rtsv = f.read()
    check("-g chr1:40000-60000 -s 10000 (2 windows), -@ 1",
          *pileup("native", region, out=out), 1, ["RawBamStream"],
          vcf_lines(rvcf), rtsv)
    say(f"[6b] the device engine on that region: {len(vcf_lines(rvcf))} VCF "
        f"lines, 2 launches of K9's fused entry")

    # the rule written before the run (PERF.md section 6): is `native`
    # faster, its sites/s at -@ os.cpu_count() (with a .bai, what
    # raw_bam_open takes where one lies; in 20 windows, so that the pool has
    # work to share) above the device engine's in each of two runs by more
    # than the two runs' spread? It measures the device engine's gap; the
    # default stays `device`, the engine that runs on the card (phase 6
    # holds that the switch unset launches K9 once a window)
    nat = [n_sites / w for w in walls["s10000", ncpu]]
    dev = [n_sites / w for w in dev_walls]
    spread = max(abs(nat[0] - nat[1]), abs(dev[0] - dev[1]))
    faster = "native" if min(nat) - max(dev) > spread else "neither"
    say(f"[6b] the rule: native, 20 windows at -@ {ncpu}, "
        f"{', '.join(f'{x:.1f}' for x in nat)} sites/s against the device "
        f"engine's {', '.join(f'{x:.1f}' for x in dev)} (phase 6's first two "
        f"runs), spread {spread:.1f}: faster by more than the spread: "
        f"{faster}; the CLI's default: {cli.PILEUP_DEFAULT} [{card}]")
    say(f"[6b] {time.perf_counter() - t_phase:.1f} s")
    phase_6c(work, card, pileup, gfa, gbam, vcf_gpu)


def phase_6c(work, card, pileup, gfa, gbam, vcf):
    """6c. the subcommands downstream of pileup on phase 6's outputs, each
    through the CLI in this process: vcf2bed (-t cg, c, snp, and hcg, gch
    on a -N VCF) and mergecg on its C++ line filters and on its Python walk
    (BISCUIT_TPU_TORCH_STREAMS=python); epiread (epiBED, -B with the SNP
    bed, -P -B, -O; -g chr1, half the BAM, in four windows: the Python walk
    takes about 7 s a run there at -@ 1) on the C++ raw-BAM engine and on
    the Python walk, at -@ 1 and -@ os.cpu_count(); rectangle on the -O epireads of chr1's first
    RECT_SPAN bp, and asm on the -P epireads whose SNP lies there, sorted by
    SNP and CpG as asm asks (both are Python whose time grows with the
    span: rectangle pads every row to the span's CpG columns). The outputs
    of the two paths must be the same bytes, no kernel may launch, and
    rectangle's and asm's rows must be well formed."""
    from biscuit_tpu_torch import cli, kernels
    t_phase = time.perf_counter()
    ncpu = os.cpu_count()
    d = os.path.join(work, "down")
    os.makedirs(d, exist_ok=True)
    nome = os.path.join(d, "nome.vcf")
    pileup("native", ["-N"], out=nome)

    def sub(tag, argv, out, **env):
        """argv through the CLI, stdout into `out`, under `env`: its text."""
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            with open(out, "w") as f, contextlib.redirect_stdout(f):
                rc = cli.main(argv)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        wall = time.perf_counter() - t0
        if rc != 0 or any(kernels.LAUNCHES.values()):
            raise AssertionError(f"6c {tag}: exit {rc}, launches "
                                 f"{dict(kernels.LAUNCHES)}")
        with open(out) as f:
            text = f.read()
        n = text.count("\n")
        say(f"[6c] {tag}: {n} lines in {wall:.3f} s, {n / wall:.1f} lines/s "
            f"[{card}]")
        return text

    def both(tag, argv, name, switch, paths):
        """argv on each of the two paths (values of `switch`): their output,
        which must be the same bytes and not empty."""
        texts = [sub(f"{tag}, {path}", argv, os.path.join(d, f"{name}.{path}"),
                     **{switch: value}) for path, value in paths]
        if texts[0] != texts[1] or not texts[0]:
            raise AssertionError(f"6c {tag}: the two paths differ or are empty")
        with open(os.path.join(d, name), "w") as f:
            f.write(texts[0])
        return texts[0]

    streams = (("C++", "native"), ("Python", "python"))
    for t, src in (("cg", vcf), ("c", vcf), ("snp", vcf), ("hcg", nome),
                   ("gch", nome)):
        both(f"vcf2bed -t {t}", ["vcf2bed", "-t", t, src], f"{t}.bed",
             "BISCUIT_TPU_TORCH_STREAMS", streams)
    merged = both("mergecg", ["mergecg", gfa, os.path.join(d, "cg.bed")],
                  "cg.merged.bed", "BISCUIT_TPU_TORCH_STREAMS", streams)
    if not any(ln.split("\t")[2] == str(int(ln.split("\t")[1]) + 2)
               for ln in merged.splitlines()):
        raise AssertionError("6c mergecg merged no CpG")
    snp = os.path.join(d, "snp.bed")
    paths = (("C++ raw", "native"), ("Python", "device"))
    for name, opts in (("epibed", []), ("snp", ["-B", snp]),
                       ("pairwise", ["-P", "-B", snp]), ("old", ["-O"])):
        texts = {threads: both(f"epiread {' '.join(opts)} -@ {threads}",
                               ["epiread", *opts, "-g", "chr1", "-s", "25000",
                                "-@", str(threads), gfa, gbam],
                               f"{name}.{threads}.epiread",
                               "BISCUIT_TPU_TORCH_PILEUP", paths)
                 for threads in (1, ncpu)}
        if texts[1] != texts[ncpu]:
            raise AssertionError(f"6c epiread {name}: -@ 1 and -@ {ncpu} "
                                 f"differ")
    # epiread's raw engine and its fork pool in a process of its own, as a
    # user runs it (no CUDA context): chr1 in 4 windows as above, and the
    # whole BAM in 20 and in 100 windows, at -@ 1 and -@ os.cpu_count(),
    # twice each; each output that of -@ 1 (and on chr1 the one above)
    alone = [(o, t) for o in (("-g", "chr1", "-s", "25000"), ("-s", "10000"),
                              ("-s", "2000"))
             for t in (1, ncpu) for _ in range(2)]
    code = ("import contextlib, json, sys, time\n"
            "from biscuit_tpu_torch import cli\n"
            "walls = []\n"
            f"for k, (opts, t) in enumerate({alone!r}):\n"
            f"    with open({d!r} + f'/alone.{{k}}.epiread', 'w') as f, "
            "contextlib.redirect_stdout(f):\n"
            "        w = time.perf_counter()\n"
            "        assert cli.main(['epiread', *opts, '-@', str(t), "
            f"{gfa!r}, {gbam!r}]) == 0\n"
            "        walls.append(time.perf_counter() - w)\n"
            "print(json.dumps([walls, 'torch' in sys.modules]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, BISCUIT_TPU_TORCH_PILEUP="native"),
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise AssertionError(f"6c epiread alone: {r.stderr[-2000:]}")
    walls, torch_in = json.loads(r.stdout.splitlines()[-1])
    outs = []
    for k in range(len(alone)):
        with open(os.path.join(d, f"alone.{k}.epiread")) as f:
            outs.append(f.read())
    with open(os.path.join(d, "epibed.1.epiread")) as f:
        chr1 = f.read()
    for k, (opts, _t) in enumerate(alone):
        if outs[k] != (chr1 if k < 4 else outs[4 * (k // 4)]) or \
                not outs[k] or torch_in:
            raise AssertionError(f"6c epiread {opts} alone: the output "
                                 f"differs, or torch was imported")
    say("[6c] epiread (C++ raw) in a process of its own, outputs == -@ 1's: "
        + "; ".join(f"{' '.join(o)} -@ {t}: {w:.3f} s, "
                    f"{outs[k].count(chr(10)) / w:.1f} lines/s"
                    for k, ((o, t), w) in enumerate(zip(alone, walls)))
        + f" [{card}]")
    def first_span(name, col, sort=False):
        """The epireads of `name` on chr1 whose column `col` lies in the
        first RECT_SPAN bp, in their order or sorted by that column and the
        next."""
        with open(os.path.join(d, name)) as f:
            rows = [ln.split("\t") for ln in f]
        rows = [r for r in rows if r[0] == "chr1" and int(r[col]) < RECT_SPAN]
        if sort:
            rows.sort(key=lambda r: (int(r[col]), int(r[col + 1])))
        path = os.path.join(d, name + ".span")
        with open(path, "w") as g:
            g.writelines("\t".join(r) for r in rows)
        return path

    rect = sub(f"rectangle on the -O epireads of chr1:1-{RECT_SPAN}",
               ["rectangle", gfa, first_span("old.1.epiread", 4)],
               os.path.join(d, "rect.txt"))
    rows = [ln.split("\t") for ln in rect.splitlines()]
    if len(rows) < 1000 or {r[0] for r in rows} != {"chr1"} or \
            len({len(r[-1]) for r in rows}) != 1:
        raise AssertionError(f"6c rectangle: {len(rows)} rows, not one "
                             f"matrix of chr1")
    asm = sub(f"asm on the -P epireads of SNPs in chr1:1-{RECT_SPAN}",
              ["asm", first_span("pairwise.1.epiread", 1, sort=True)],
              os.path.join(d, "asm.txt"))
    rows = [ln.split("\t") for ln in asm.splitlines()]
    if len(rows) < 10 or any(len(r) != 11 or not 0 <= float(r[9]) <= 1
                             for r in rows):
        raise AssertionError(f"6c asm: {len(rows)} rows, or one malformed")
    say(f"[6c] {time.perf_counter() - t_phase:.1f} s")


def script_main(name, argv):
    """The port's companion script `name` (biscuit_tpu_torch/scripts/) on
    argv in this process: its exit code."""
    import importlib
    mod = importlib.import_module(f"biscuit_tpu_torch.scripts.{name}")
    saved = sys.argv
    sys.argv = [mod.__file__, *argv]
    try:
        return mod.main()
    finally:
        sys.argv = saved


def phase_6d(work, card, gfa, gfq, gbam, vcf, fa, fq1, fq2):
    """6d. the QC family and the companion scripts, host code in the port as
    in the JAX package, on phase 6's genome, FASTQ, BAM (with the .bai of
    6b) and VCF, each through its entry point in this process: bsstrand -c
    -y to a BAM (and its report), bsconv -p -m 2, cinread (-t cg and -t ch,
    cut to chr1's first QC_SPAN bp: a Python walk a site), tview -d (a
    TVIEW_WIDTH bp window at TVIEW_AT, -c t), bc (SE into a .fq.gz), QC.py
    -v (which runs qc -s) on the assets of scripts/build_qc_assets.py,
    flip_pbat_strands, pybiscuit to_methylKit (on vcf2bed -e's CpG beta and
    coverage); and what needs pairs on phase 4b's 2048 pairs (`fa`, `fq1`,
    `fq2`, aligned by the native engine and sorted here): qc with insert
    sizes, bc on two FASTQs, pybiscuit to_mr. Each must exit 0 with no
    kernel launched, and write the stdout, stderr (without its [main]
    lines) and files of the same command run in a process of its own with
    CUDA_VISIBLE_DEVICES= (no card); the flipped BAM flipped again must
    hold the input's records; cinread_func's vectorized counts (qc's path)
    must equal its per-site walk's for every target on the cut."""
    import numpy as np
    from biscuit_tpu_torch import cli, kernels
    from biscuit_tpu_torch.io.sambam import AlignmentFile
    from biscuit_tpu_torch.pileup.common import RefCache
    from biscuit_tpu_torch.subcmds.cinread import (TGT_NAMES, CinreadConf,
                                                   CinreadData, cinread_func)
    from torch_testdata import tree_files
    t_phase = time.perf_counter()
    d = os.path.join(work, "qc")
    os.makedirs(d)
    # set-up: the PE BAM, the CpG table of to_methylKit, the QC assets
    t0 = time.perf_counter()
    psam, pbam = os.path.join(d, "pe.sam"), os.path.join(d, "pe.bam")
    saved = os.environ.get("BISCUIT_TPU_TORCH_ENGINE")
    os.environ["BISCUIT_TPU_TORCH_ENGINE"] = "native"
    try:
        with open(psam, "w") as f, contextlib.redirect_stdout(f):
            rc = cli.main(["align", fa, fq1, fq2])
    finally:
        os.environ.pop("BISCUIT_TPU_TORCH_ENGINE")
        if saved is not None:
            os.environ["BISCUIT_TPU_TORCH_ENGINE"] = saved
    if rc != 0 or cli.main(["sort", "-o", pbam, psam]) != 0:
        raise AssertionError("6d: the PE align or sort failed")
    cg_bed, cg_table = os.path.join(d, "cg.bed"), os.path.join(d, "cg.txt")
    with open(cg_bed, "w") as f, contextlib.redirect_stdout(f):
        if cli.main(["vcf2bed", "-t", "cg", "-e", vcf]) != 0:
            raise AssertionError("6d: vcf2bed -e failed")
    with open(cg_bed) as f, open(cg_table, "w") as g:
        # chrom, beg, end, beta, coverage, the cytosine's base
        g.writelines("\t".join(r[:3] + r[7:9] + r[3:4]) + "\n"
                     for r in (ln.rstrip("\n").split("\t") for ln in f))
    assets = os.path.join(d, "assets")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "build_qc_assets.py"),
                    "-r", gfa, "-o", assets, "-i"], check=True,
                   capture_output=True)
    say(f"[6d] set-up: phase 4b's {N_PAIRS} pairs aligned (native engine) and "
        f"sorted, vcf2bed -e's CpG table, QC assets, in "
        f"{time.perf_counter() - t0:.1f} s; cinread cut to chr1:1-{QC_SPAN}, "
        f"tview to {TVIEW_WIDTH} bp at {TVIEW_AT}")

    region = f"chr1:1-{QC_SPAN}"
    n_pe = 2 * N_PAIRS
    # tag -> (script or None for the CLI, argv with {out} its own directory,
    # reads it takes or None: lines it writes)
    runs = {
        "bsstrand -c -y": (None, ["bsstrand", "-c", "-y", gfa, gbam,
                                  "{out}/c.bam"], PLP_READS),
        "bsconv -p -m 2": (None, ["bsconv", "-p", "-m", "2", gfa, gbam],
                           PLP_READS),
        "cinread -t cg": (None, ["cinread", "-t", "cg", "-g", region, gfa,
                                 gbam], None),
        "cinread -t ch": (None, ["cinread", "-t", "ch", "-g", region, gfa,
                                 gbam], None),
        "qc (PE)": (None, ["qc", fa, pbam, "{out}/p"], n_pe),
        "tview -d": (None, ["tview", "-d", "-g", TVIEW_AT, "-w",
                            str(TVIEW_WIDTH), "-c", "t", gbam, gfa], None),
        "bc": (None, ["bc", "-o", "{out}/bc", gfq], PLP_READS),
        "bc (PE)": (None, ["bc", "-o", "{out}/bc", fq1, fq2], n_pe),
        "QC.py -v": ("QC", ["-v", vcf, "-o", "{out}/qc", assets, gfa, "s",
                            gbam], PLP_READS),
        "flip_pbat_strands": ("flip_pbat_strands", [gbam, "{out}/f.bam"],
                              PLP_READS),
        "pybiscuit to_mr": ("pybiscuit", ["to_mr", "-i", pbam, "-o",
                                          "{out}/x.mr"], n_pe),
        "pybiscuit to_methylKit": ("pybiscuit", ["to_methylKit", "-i",
                                                 cg_table, "-o",
                                                 "{out}/x.txt"], None),
    }

    def outputs(stdout, stderr, out):
        """(stdout, stderr without its [main] lines and with `out` read as
        {out}, the files under `out`)."""
        stderr = "".join(ln for ln in stderr.splitlines(True)
                         if not ln.startswith("[main] "))
        return stdout, stderr.replace(out, "{out}"), tree_files(out)

    got = {}
    err = os.path.join(d, "stderr")
    for k, (tag, (script, argv, n_reads)) in enumerate(runs.items()):
        out = os.path.join(d, "card", str(k))
        os.makedirs(out)
        argv = [a.format(out=out) for a in argv]
        gc.collect()
        kernels.reset_launches()
        buf = io.StringIO()
        sys.stderr.flush()
        fd = os.dup(2)   # the family writes reports to the stderr of import
        with open(err, "w") as e:
            os.dup2(e.fileno(), 2)
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = (cli.main(argv) if script is None
                          else script_main(script, argv))
            finally:
                wall = time.perf_counter() - t0
                sys.stderr.flush()
                os.dup2(fd, 2)
                os.close(fd)
        gc.collect()   # closes the files a script's argparse opened
        with open(err) as e:
            got[tag] = outputs(buf.getvalue(), e.read(), out)
        if rc not in (0, None) or any(kernels.LAUNCHES.values()):
            raise AssertionError(f"6d {tag}: exit {rc}, launches "
                                 f"{dict(kernels.LAUNCHES)}: {got[tag][1]}")
        n_lines = sum(v.count(b"\n") for v in got[tag][2].values()) + \
            got[tag][0].count("\n")
        if not n_lines:
            raise AssertionError(f"6d {tag}: no output")
        rate = (f"{n_reads / wall:.1f} reads/s ({n_reads} reads)" if n_reads
                else f"{n_lines / wall:.1f} lines/s ({n_lines} lines)")
        say(f"[6d] {tag}: {wall:.3f} s, {rate}; no launch [{card}]")

    # the same commands, each in a process of its own with no card, all at
    # once, and the flipped BAM flipped back; meanwhile, in this process,
    # cinread_func's vectorized count path (qc's) against its per-site walk
    t0 = time.perf_counter()
    no_card = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    flip = "biscuit_tpu_torch.scripts.flip_pbat_strands"
    back = os.path.join(d, "back.bam")

    def on_cpu(k, tag):
        script, argv, _n = runs[tag]
        out = os.path.join(d, "cpu", str(k))
        os.makedirs(out)
        mod = ("biscuit_tpu_torch.cli" if script is None
               else f"biscuit_tpu_torch.scripts.{script}")
        r = subprocess.run([sys.executable, "-m", mod,
                            *(a.format(out=out) for a in argv)], cwd=REPO,
                           env=no_card, capture_output=True, text=True)
        return r.returncode, outputs(r.stdout, r.stderr, out)

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        jobs = {tag: pool.submit(on_cpu, k, tag)
                for k, tag in enumerate(runs)}
        flipped = os.path.join(d, "card", str(list(runs).index(
            "flip_pbat_strands")), "f.bam")
        back_job = pool.submit(subprocess.run, [
            sys.executable, "-m", flip, flipped, back], cwd=REPO,
            env=no_card, capture_output=True, text=True)
        t1 = time.perf_counter()
        bam, rs = AlignmentFile(gbam), RefCache(gfa)
        recs = list(bam.fetch(0, 0, QC_SPAN))
        for tgt in range(len(TGT_NAMES)):
            walk = CinreadConf(tgt=tgt, skip_printing=0)
            vec = CinreadConf(tgt=tgt, skip_printing=1)
            dw, dv = CinreadData(), CinreadData()
            for b in recs:
                cinread_func(b, rs, walk, dw, bam.header.names, io.StringIO())
                cinread_func(b, rs, vec, dv, bam.header.names, io.StringIO())
            if not np.array_equal(dw.counts, dv.counts) or \
                    not dv.counts.sum():
                raise AssertionError(f"6d cinread -t {TGT_NAMES[tgt]}: the "
                                     f"vectorized counts differ from the "
                                     f"walk's")
        t_cin = time.perf_counter() - t1
        cpu = {tag: job.result() for tag, job in jobs.items()}
        back_rc = back_job.result().returncode
    for tag, (rc, outs) in cpu.items():
        if rc != 0 or outs != got[tag]:
            raise AssertionError(f"6d {tag}: the run with no card exited {rc} "
                                 f"or wrote other outputs: {outs[1][-2000:]}")
    key = lambda r: (r.qname, r.flag, r.tid, r.pos, r.cigar, r.seq, r.qual,
                     r.tags)
    if back_rc != 0 or [key(r) for r in AlignmentFile(back)] != \
            [key(r) for r in AlignmentFile(gbam)]:
        raise AssertionError("6d: a BAM flipped twice differs from its input")
    theirs = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                            "biscuit_tpu")]
    if theirs:
        raise AssertionError(f"6d imported {theirs}")
    say(f"[6d] each command again in a process of its own with "
        f"CUDA_VISIBLE_DEVICES= ({os.cpu_count()} at once, "
        f"{time.perf_counter() - t0:.1f} s): stdout, stderr and files the "
        f"same; the flipped BAM flipped back == the input's records; "
        f"meanwhile cinread_func's vectorized counts == its walk's for "
        f"{', '.join(TGT_NAMES)} on chr1:1-{QC_SPAN}'s {len(recs)} reads "
        f"({t_cin:.1f} s); no jax, no biscuit_tpu")
    say(f"[6d] {time.perf_counter() - t_phase:.1f} s")


# phase 7: the kernels whose launches the dry run's ranks must show (the
# last three: the index-sharded walks of stage 8, kernels/fm_route.cu), and
# the reads of phase 6 that dist_run seeds
K10_KERNELS = ("sw_extend", "chain_scan", "sw_local", "pileup_count",
               "smem_route_step", "sa_route_step", "route_gather")
ROUTED = {"smem_route_step": "the routed seeder",
          "sa_route_step": "the routed SA walk",
          "route_gather": "the SA samples' gather at a walk's end"}
DIST_READS = 8192
# route_bench's k: steps of a routed walk enqueued between host reads
ROUTE_KS = (1, 4, 8, 16, 32)


def cli_launches(text, who):
    """The launches a CLI process reported on stderr ({} if none)."""
    tag = f"[{who}] kernel launches: "
    found = [json.loads(ln[len(tag):]) for ln in text.splitlines()
             if ln.startswith(tag)]
    return found[-1] if found else {}


def shard_align(card, table, tag, argv, want, n_reads):
    """`align <argv>` under BISCUIT_TPU_TORCH_INDEX_SHARD=2 as 2 ranks
    started with torchrun's variables, sharing the card (gloo): rank 0's SAM
    body must be `want` (phase 4d's one process), rank 1 must print no SAM,
    each rank must seed by smem_route_step on its shard (K3 never) and
    resolve SA positions by K4's interval entry on the whole tables. Adds
    the ranks' launches to the table and prints the routed walks' steps,
    rows and times."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BISCUIT_TPU_TORCH_")}
    env.update(PYTHONPATH=REPO, BISCUIT_TPU_TORCH_INDEX_SHARD="2",
               WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "biscuit_tpu_torch.cli", "align", *argv],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(env, RANK=str(k), LOCAL_RANK=str(k))) for k in range(2)]
    try:  # a rank out of lockstep leaves the other waiting in a collective
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for k, (p, (_so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{tag}: index-sharded rank {k} exited "
                                 f"{p.returncode}: {se[-3000:]}")
    body = [ln for ln in outs[0][0].splitlines() if not ln.startswith("@")]
    if body != want or outs[1][0]:
        raise AssertionError(f"{tag}: rank 0's SAM differs from phase 4d's "
                             f"one process, or rank 1 printed SAM")
    tag_w = "[main_align] routed walks: "
    launches, walks = [], []
    for _so, se in outs:
        launches.append(cli_launches(se, "main_align"))
        found = [json.loads(ln[len(tag_w):]) for ln in se.splitlines()
                 if ln.startswith(tag_w)]
        walks.append(found[-1]["smem_route_step"] if found else {})
    for k, lk in enumerate(launches):
        if lk.get("smem_route_step", 0) < 1 or lk.get("smem_seed", 0) or \
                lk.get("sa_walk_intervals", 0) < 1:
            raise AssertionError(f"{tag}: rank {k} launched {lk}")
    for r in table:
        r["launches"] += sum(lk.get(r["name"], 0) for lk in launches)
    w = walks[0]
    say(f"[7] align {tag} under BISCUIT_TPU_TORCH_INDEX_SHARD=2, 2 ranks "
        f"sharing the card (gloo): {n_reads} reads, rank 0's SAM body == "
        f"phase 4d's one process, rank 1 no SAM; wall {wall:.2f} s with both "
        f"ranks' start; the ranks' launches {json.dumps(launches)} [{card}]")
    say(f"[7] {tag} routed seeder on rank 0: {w['calls']} calls, "
        f"{w['steps']} steps = {w['steps'] / w['calls']:.1f} a call, "
        f"{w['rows']} rows asked; the whole call {w['call_ms'] / w['calls']:.4f}"
        f" ms = {w['call_ms'] / w['steps']:.4f} ms a step; rank 1: "
        f"{json.dumps(walks[1])} [{card}]")


def phase_7(work, card, table, gfa, gfq, gbam, vcf, gwant, n_windows,
            shard):
    """7. K10 and the driver entry (see the module's docstring). table: the
    kernel rows, whose launches the phase adds to; gwant: phase 6's SAM
    body, which phase 4d's one-process runs equal; n_windows: phase 6's
    windows, each of which every rank of the mesh must count on the card;
    shard: (fa, fq, fq1, fq2, body, pbody) of phases 4 and 4b, the reads and
    one-process SAM bodies of the index-sharded `align`."""
    import socket

    import torch

    from biscuit_tpu_torch import kernels
    from biscuit_tpu_torch.config import MemOpt
    from biscuit_tpu_torch.graft_entry import dryrun_multichip, entry
    from biscuit_tpu_torch.ops.seed_batch import (ROUTE_SYNC_EVERY,
                                                  collect_intv_flat_plain)
    t_phase = time.perf_counter()

    # entry(): one batched K3 step on the card, against its plain version
    step, args = entry()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = step(*args)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    n_k3 = kernels.LAUNCHES.get("smem_seed", 0)
    err = compare("entry() step", got, collect_intv_flat_plain(
        args[0], *args[1:], MemOpt()))
    if n_k3 != 1 or got[2].any():
        raise AssertionError(f"entry() launched K3 {n_k3} times, or flagged "
                             f"{int(got[2].sum())} lanes")
    say(f"[7] entry(): {tuple(args[1].shape)} reads on {args[1].device}, "
        f"{got[1].shape[0]} seed rows, K3 launched once == plain (max |d| "
        f"{err}), {t_step * 1e3:.3f} ms with its compaction [{card}]")

    # the dry run: 2 ranks spawned here, sharing the card
    res = dryrun_multichip(2)
    why = (f"the ranks share {res['device']}" if not res["nccl"]
           else "a card a rank")
    say(f"[7] dryrun_multichip(2): backend {res['backend']} ({why}; "
        f"torch.cuda.device_count() {torch.cuda.device_count()}); NCCL "
        f"{'ran' if res['nccl'] else 'did not run'}; each stage == its "
        f"one-rank run in both ranks; wall {res['wall']:.1f} s with the "
        f"spawn [{card}]")
    say("[7] dryrun stage seconds (the slower rank): " + json.dumps(
        {k: round(v, 4) for k, v in res["seconds"].items()}))
    say(f"[7] dryrun launches of the ranks' sharded calls: "
        f"{json.dumps(res['launches'])}")
    for name in K10_KERNELS:
        if res["launches"].get(name, 0) < 1:
            raise AssertionError(f"{name} never launched in the dry run's "
                                 f"ranks: {res['launches']}")
    for r in table:
        if r["name"] in K10_KERNELS:
            r["launches"] += res["launches"][r["name"]]
        if r["name"] == "smem_seed":
            r["launches"] += n_k3 + res["launches"].get("smem_seed", 0)
    # stage 8's kernels, held to their plain versions in the ranks on each
    # rank's shard (rank 0's numbers): the walks' times are whole calls,
    # every step's launch and collective in them; the step kernels' rows
    # are replaced below by their times at the main path's shapes
    for name, what in ROUTED.items():
        err, ms, plain_ms, n_bytes, n_ops, steps = res["routed"][name]
        bound_ms, bound_by = bound(n_bytes, n_ops)
        table.append({"name": name, "route": "cuda",
                      "source": "biscuit_tpu_torch/kernels/fm_route.cu",
                      "replaces": "biscuit_tpu/ops/seed_batch.py:2097 (and "
                                  "the routed gather of _tab_row, :265-289)",
                      "launches": res["launches"][name], "max_abs_err": err,
                      "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                      "bound_ms": round(bound_ms, 6), "bound_by": bound_by,
                      "library_ms": None, "paths": ["7"]})
        alone = f"{steps} steps, " if steps else ""
        say(f"[7] {name} ({what}, stage 8 on rank 0's shard): kernel == "
            f"plain (max |d| {err}); kernel {ms:.4f} ms ({alone}the whole "
            f"call), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms by "
            f"{bound_by} ({n_bytes} bytes, {n_ops} operations) [{card}]")

    # align on the index sharded over 2 ranks, at the full width of phases
    # 4 and 4b
    fa, fq, fq1, fq2, body, pbody = shard
    shard_align(card, table, "SE", [fa, fq], body, N_READS)
    shard_align(card, table, "PE", [fa, fq1, fq2], pbody, 2 * N_PAIRS)

    # the step kernels at the main path's shapes (phase 4's 8192 lanes, and
    # 20,000 SA walks), each held to K3's / K4's output on the whole tables:
    # on the `align` above's 2 shards, the ranks sharing the card (gloo),
    # and to its plain version on its shard (the kernel table's rows); then
    # under nccl in a group of one rank (a shard of the whole tables), at
    # each k steps enqueued between host reads
    def route_bench(ranks, ks, *more):
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m", "biscuit_tpu_torch.tools.route_bench",
             "--data", os.path.dirname(fa), "--reads", str(N_READS),
             "--ranks", str(ranks), "--ks", ",".join(map(str, ks)), *more],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        try:  # a rank out of lockstep leaves the others waiting
            so, se = p.communicate(timeout=600)
        finally:  # the ranks it spawned with it
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
        if p.returncode != 0:
            raise AssertionError(f"route_bench --ranks {ranks} exited "
                                 f"{p.returncode}: {se[-2000:]}")
        return json.loads(so.strip().splitlines()[-1]), \
            time.perf_counter() - t0

    k = ROUTE_SYNC_EVERY
    rb, secs = route_bench(2, (k,), "--plain")
    for name, part in (("smem_route_step", rb["seed"][0]),
                       ("sa_route_step", rb["sa"])):
        n_bytes = part["rows"] * rb["row_bytes"] + rb["io_bytes"][name]
        # an occ4 from a row: about 16 popcounts and 48 shifts, masks, adds
        bound_ms, bound_by = bound(n_bytes, 64 * part["rows"])
        row = next(r for r in table if r["name"] == name)
        row.update(ms=round(part["call_ms"], 4),
                   plain_ms=round(part["plain_ms"], 4),
                   bound_ms=round(bound_ms, 6), bound_by=bound_by)
        say(f"[7] {name} at the main path's shapes (route_bench, "
            f"{rb['ranks']} ranks under {rb['backend']} sharing the card, "
            f"{rb['lanes']} lanes / {rb['sa_jobs']} SA walks): kernel == "
            f"plain on rank 0's shard == the whole tables' kernel; the whole "
            f"call {part['call_ms']:.4f} ms, {part['steps']:.0f} steps "
            f"({part['ms_a_step']:.4f} ms a step), the launches alone "
            f"{part['launch_ms']:.4f} ms "
            f"({part['launch_ms'] / part['steps']:.4f} ms a step, CUDA "
            f"events), {part['rows']:.0f} rows asked; plain "
            f"{part['plain_ms']:.4f} ms; bound {bound_ms:.6f} ms by "
            f"{bound_by} ({n_bytes:.0f} bytes); {secs:.1f} s with the spawn "
            f"[{card}]")
    rb, secs = route_bench(1, ROUTE_KS)
    say(f"[7] route_bench, {rb['ranks']} rank under {rb['backend']} (a "
        f"shard of the whole tables): {rb['lanes']} lanes of "
        f"{rb['read_len']} bp, seeds == K3's at every k of steps enqueued "
        f"between host reads: " + "; ".join(
            f"k={t['k']} {t['call_ms']:.3f} ms a call, {t['steps']:.0f} steps,"
            f" {t['ms_a_step']:.4f} ms a step, launches alone "
            f"{t['launch_ms']:.3f} ms" for t in rb["seed"])
        + f"; the SA walk at k={k} {rb['sa']['call_ms']:.3f} ms, "
        f"{rb['sa']['steps']:.0f} steps; {secs:.1f} s [{card}]")

    # the drivers, each in processes of its own on the card, under the
    # default engines
    env = {k: v for k, v in os.environ.items()
           if k not in ("BISCUIT_TPU_TORCH_ENGINE", "BISCUIT_TPU_TORCH_PILEUP")}
    env["PYTHONPATH"] = REPO
    logs = os.path.join(work, "shard_logs")
    os.makedirs(logs, exist_ok=True)

    def run(argv, **more):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", *argv], cwd=REPO,
                           env=dict(env, **more), capture_output=True,
                           text=True)
        if r.returncode != 0:
            tails = "".join(open(os.path.join(logs, f)).read()[-1500:]
                            for f in sorted(os.listdir(logs)))
            raise AssertionError(f"{argv[:2]} exited {r.returncode}: "
                                 f"{r.stderr[-2000:]} {tails}")
        return r, time.perf_counter() - t0

    r, wall = run(["biscuit_tpu_torch.tools.shard_align", "-n", "2", gfa, gfq],
                  BT_SHARD_WORKER_LOGS=logs)
    body = [ln for ln in r.stdout.splitlines() if not ln.startswith("@")]
    if body != gwant:
        raise AssertionError("shard_align -n 2: SAM differs from one process's")
    # each worker's launches, from its log: K3 and K4's interval entry
    workers = []
    for i in range(2):
        with open(os.path.join(logs, f"worker.{i}.log")) as f:
            workers.append(cli_launches(f.read(), "main_align"))
        for name in ("smem_seed", "sa_walk_intervals"):
            if workers[i].get(name, 0) < 1:
                raise AssertionError(f"shard_align worker {i} launched no "
                                     f"{name}: {workers[i]}")
    for r in table:
        r["launches"] += sum(w.get(r["name"], 0) for w in workers)
    say(f"[7] shard_align -n 2 (default engine, 2 workers on the card): "
        f"{PLP_READS} reads, SAM body == phase 4d's one process; wall "
        f"{wall:.2f} s = {PLP_READS / wall:.1f} reads/s with both workers' "
        f"start; the workers' launches {json.dumps(workers)} [{card}]")

    def vcf_lines(path):
        with open(path) as f:
            return [ln for ln in f if not ln.startswith("##program")]

    def same_vcf(path, what):
        with open(path + "_meth_average.tsv") as f, \
                open(vcf + "_meth_average.tsv") as g:
            if vcf_lines(path) != vcf_lines(vcf) or f.read() != g.read():
                raise AssertionError(f"{what}: VCF or _meth_average.tsv "
                                     "differs from phase 6's")

    svcf = os.path.join(work, "shard.vcf")
    _r, wall = run(["biscuit_tpu_torch.tools.shard_pileup", "-n", "2", "-o",
                    svcf, gfa, gbam])
    same_vcf(svcf, "shard_pileup -n 2")
    say(f"[7] shard_pileup -n 2 (a chromosome a worker, device engine): VCF "
        f"and _meth_average.tsv == phase 6's; wall {wall:.2f} s [{card}]")

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mvcf = os.path.join(work, "mesh.vcf")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "biscuit_tpu_torch.cli", "pileup", "-o", mvcf,
         gfa, gbam], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(env, BISCUIT_TPU_TORCH_PILEUP="mesh",
                            WORLD_SIZE="2", RANK=str(k), LOCAL_RANK=str(k),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
        for k in range(2)]
    try:  # a rank that fails leaves the other waiting in a collective
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    joined, ranks = [], []
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0 or so:
            raise AssertionError(f"pileup mesh rank exited {p.returncode}: "
                                 f"{se[-2000:]}")
        joined += [ln for ln in se.splitlines() if "[main_pileup] mesh" in ln]
        ranks.append(cli_launches(se, "main_pileup"))
    same_vcf(mvcf, "pileup under mesh on 2 ranks")
    # each rank counts its slice of every window with K9's fused entry
    if any(k.get("pileup_window_counts", 0) != n_windows for k in ranks):
        raise AssertionError(f"a mesh rank did not count each of the "
                             f"{n_windows} windows on the card: {ranks}")
    for r in table:
        r["launches"] += sum(k.get(r["name"], 0) for k in ranks)
    say(f"[7] pileup under mesh, 2 ranks as torchrun starts them: "
        f"{'; '.join(joined)}; rank 0's VCF and _meth_average.tsv == phase "
        f"6's; the ranks' launches {json.dumps(ranks)}; wall {wall:.2f} s "
        f"[{card}]")

    out = os.path.join(work, "dist_scaling.json")
    r, wall = run(["biscuit_tpu_torch.tools.dist_run", "--ns", "1,2",
                   "--reads", str(DIST_READS), "--reps", "3", "--data",
                   os.path.dirname(gfa), "--out", out])
    with open(out) as f:
        dist = json.load(f)
    if [t["n_procs"] for t in dist["table"]] != [1, 2] or any(
            t["launches"].get("smem_seed", 0) < 1 for t in dist["table"]):
        raise AssertionError(f"dist_run: {dist}")
    say(f"[7] dist_run --ns 1,2 ({dist['workload']}; {dist['parity']}): "
        + "; ".join(f"n={t['n_procs']} {t['backend']} on {t['device']}: "
                    f"{t['t_per_rep_s']:.4f} s a step, wall {t['wall_s']:.1f}"
                    f" s, efficiency {t['efficiency']:.3f}"
                    for t in dist["table"])
        + f"; {wall:.1f} s in all [{card}]")
    say(f"[7] {time.perf_counter() - t_phase:.1f} s")


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
    from biscuit_tpu_torch.ops import (chain_batch, pileup_count, seed_batch,
                                       sw_extend, sw_global, sw_local)
    from biscuit_tpu_torch import native
    t0 = time.perf_counter()
    libs = (sw_extend._lib, sw_global._lib, seed_batch._lib,
            seed_batch._seed_lib, seed_batch._route_lib, chain_batch._lib,
            sw_local._lib, pileup_count._lib)

    def native_lib():
        """g++ of the native library beside the nvcc builds: seconds."""
        t1 = time.perf_counter()
        native.lib()
        return time.perf_counter() - t1
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        native_job = pool.submit(native_lib)
        for f in [pool.submit(lib) for lib in libs]:
            f.result()
        native_build_s = native_job.result()
    say(f"[2] built {sorted(kernels.BUILD_SECONDS) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s; per source "
        f"{json.dumps({k: round(v, 2) for k, v in kernels.BUILD_SECONDS.items()})}")
    say(f"[2] native library (g++, align_host.cpp with sais.cpp, "
        f"bwt_merge.cpp, pileup_native.cpp and streams_native.cpp): "
        f"{native_build_s:.1f} s (0: cached)")

    for src in sorted(kernels.BUILD_RESOURCES):
        for kern, regs, st, ld, smem in kernels.BUILD_RESOURCES[src]:
            say(f"[2] ptxas {src}.cu {kern}: {regs} registers, spills "
                f"{st} + {ld} bytes, {smem} bytes of static shared memory")
    from biscuit_tpu_torch.ops import strip_scan
    say("[2] warps resident an SM (CUDA occupancy calculator), by strip width "
        "C (wide: the wide instance at " + f"{WIDE_LEN} columns): "
        + json.dumps({name: {**{C: op.resident_warps(C)
                                for C in strip_scan.STRIP_WIDTHS},
                             "wide": op.resident_warps(strip_scan.WIDE,
                                                       WIDE_LEN)}
                            for name, op in (("sw_extend", sw_extend),
                                             ("sw_local", sw_local),
                                             ("sw_global", sw_global))}))
    for wide in (False, True):
        warps, lane_bytes = seed_batch.seed_resident_warps(READ_LEN + 2, wide)
        say(f"[2] smem_seed {'wide' if wide else 'narrow'} at L={READ_LEN + 2}: "
            f"{lane_bytes} bytes of shared memory a lane (its interval lists), "
            f"{warps} warps resident an SM")

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

    say(f"[t] phase 3 starts at {time.perf_counter() - T0:.1f} s")
    # 3. each kernel against its plain version on the card
    rng = np.random.default_rng(SEED)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    table = []

    def row(name, source, replaces, err, ms, plain_ms, shape, n_bytes, n_ops,
            library_ms=None, paths=("4", "4b")):
        """One kernel of the table. n_bytes: every input read once and every
        output written once; n_ops: the integer operations these inputs
        need; paths: the phases whose run must launch it."""
        bound_ms, bound_by = bound(n_bytes, n_ops)
        table.append({"name": name, "route": "cuda",
                      "source": f"biscuit_tpu_torch/kernels/{source}",
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": err, "ms": round(ms, 4),
                      "plain_ms": round(plain_ms, 4),
                      "bound_ms": round(bound_ms, 6), "bound_by": bound_by,
                      "library_ms": (None if library_ms is None
                                     else round(library_ms, 4)),
                      "paths": list(paths)})
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        say(f"[3] {name} {shape}: kernel == plain (max |d| {err}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms by {bound_by} ({n_bytes} bytes, {n_ops} "
            f"operations), library call {lib} [{card}]")

    # K1 at the engine's shapes, then the adversarial band widths
    from torch_testdata import (DP_EDGE_SHAPES, extend_edge_case,
                                local_edge_case)

    def wide_memory(scratch_words):
        """The wide shapes cover both places a wide lane's strips lie:
        shared memory (no device scratch) and, the last shape, device
        memory."""
        words = [int(scratch_words(x[1])) for x in WIDE_SHAPES]
        if any(words[:-1]) or words[-1] <= 0:
            raise AssertionError(f"scratch words of the wide shapes: {words}")

    def launched(name, fn, n=1):
        """fn() must launch kernel `name` exactly n times: a CUDA tensor
        never reaches a plain version."""
        n0 = kernels.LAUNCHES.get(name, 0)
        got = fn()
        if kernels.LAUNCHES.get(name, 0) - n0 != n:
            raise AssertionError(f"{name} launched "
                                 f"{kernels.LAUNCHES.get(name, 0) - n0} times, "
                                 f"expected {n}")
        return got

    err, ms, pms = 0, 0.0, 0.0
    for w_val in (None, 1, 2, 5, 17):
        opt, a = ext_case(rng, 4096, 150, 300, w_val)
        q, ql, t, tl, mats, msel, w, bonus, h0 = (T(x) for x in a)
        sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
        mat_b = mats[msel.long()].reshape(-1, 25).contiguous()
        wc = sw_extend.band_clamp(ql, w, bonus, mats, *sc)
        for zdrop in ((opt.zdrop,) if w_val is None else (0, 10, opt.zdrop)):
            k = lambda: sw_extend.sw_extend_batch(q, ql, t, tl, mats, msel, *sc,
                                                  w, bonus, zdrop, h0)
            p = lambda: sw_extend.sw_extend_batch_plain(q, ql, t, tl, mat_b, wc,
                                                        h0, *sc, zdrop)
            err = max(err, compare(f"sw_extend w={w_val} zdrop={zdrop}",
                                   launched("sw_extend", k), p()))
            if w_val is None:
                ms, pms = cuda_ms(k, 20), cuda_ms(p, 3)
                # the launch alone (no gather of the matrices, no band clamp
                # with its sync), and a late round's 256 lanes both ways
                raw = lambda n=4096: sw_extend._launch(
                    q[:n], ql[:n], t[:n], tl[:n], mat_b[:n], wc[:n], h0[:n],
                    *sc, zdrop)
                late = lambda: sw_extend.sw_extend_batch(
                    q[:256], ql[:256], t[:256], tl[:256], mats, msel[:256],
                    *sc, w[:256], bonus[:256], zdrop, h0[:256])
                k1_alone = cuda_ms(raw, 50)
                k1_late = (cuda_ms(late, 20), cuda_ms(lambda: raw(256), 50))
                # the cells these lanes fill before they break, counted by
                # the plain version as it runs (its result was held to the
                # kernel's just above); the whole band is the upper figure
                filled = torch.zeros(q.shape[0], dtype=torch.int64, device=dev)
                sw_extend.sw_extend_batch_plain(q, ql, t, tl, mat_b, wc, h0,
                                                *sc, zdrop, filled=filled)
                cells, band = int(filled.sum()), band_cells(ql, tl, wc)
                if not 0 < cells <= band:
                    raise AssertionError(f"sw_extend: {cells} cells filled "
                                         f"of a band of {band}")
                moved = nbytes(q, ql, t, tl, mats, msel, w, bonus, h0, k())
    # the edge lanes at every strip width: the wrapper on int32 and on uint8
    # codes under the default scores with three band widths and z-drops,
    # e_ins = 3 through the wrapper, and e_ins = 0 (which the band clamp
    # divides by) through the launch alone with the band as given
    k1_widths, n_edge = set(), 0
    for shape in DP_EDGE_SHAPES + WIDE_SHAPES:
        k1_widths.add(strip_scan.strip_width(shape[1]))
        for w_val, zdrops, scores, codes in (
                (100, (0, 10, opt.zdrop), sc, torch.int32),
                (2, (0, 10, opt.zdrop), sc, torch.int32),
                (5, (opt.zdrop,), sc, torch.uint8),
                (100, (opt.zdrop,), (5, 2, 3, 3), torch.int32),
                (100, (opt.zdrop,), (6, 1, 6, 0), torch.uint8)):
            a = extend_edge_case(42 + shape[1], *shape, w_val)
            q, ql, t, tl, mats, msel, w, bonus, h0 = (T(x) for x in a)
            qc, tc = q.to(codes), t.to(codes)
            mat_b = mats[msel.long()].reshape(-1, 25).contiguous()
            clamp = scores[3] > 0
            wc = sw_extend.band_clamp(ql, w, bonus, mats, *scores) if clamp else w
            for zdrop in zdrops:
                if clamp:
                    k = lambda: sw_extend.sw_extend_batch(
                        qc, ql, tc, tl, mats, msel, *scores, w, bonus, zdrop, h0)
                else:
                    k = lambda: sw_extend._launch(qc, ql, tc, tl, mat_b, wc, h0,
                                                  *scores, zdrop)
                want = sw_extend.sw_extend_batch_plain(
                    q, ql, t, tl, mat_b, wc, h0, *scores, zdrop)
                err = max(err, compare(
                    f"sw_extend edge {shape} w={w_val} zdrop={zdrop} "
                    f"scores={scores} {codes}", launched("sw_extend", k), want))
                n_edge += 1
    all_widths = {strip_scan.WIDE, *strip_scan.STRIP_WIDTHS}
    wide_memory(sw_extend._lib().sw_extend_scratch_words)
    if k1_widths != all_widths:
        raise AssertionError(f"sw_extend: strip widths {sorted(k1_widths)} "
                             f"launched of {sorted(all_widths)}")
    say(f"[3] sw_extend at a late round's shape, B=256 of those lanes: wrapper "
        f"{k1_late[0]:.4f} ms, launch alone {k1_late[1]:.4f} ms [{card}]")
    row("sw_extend", "sw_extend.cu", "biscuit_tpu/ops/pallas_sw.py:58",
        err, ms, pms, f"B=4096 Lq=150 Lt<=300, w in {{100,1,2,5,17}}, {cells} "
        f"cells filled at w=100 (the whole band: {band}), longest lane "
        f"{int(filled.max())}; the wrapper {ms:.4f} ms, the launch alone "
        f"{k1_alone:.4f} ms; + {n_edge} edge cases at strip widths "
        f"{sorted(k1_widths)} (0: the wide instance, Lq "
        f"{[x[1] for x in WIDE_SHAPES]}), uint8 and int32 codes, e_ins "
        f"0/1/3: equal", moved, cells * CELL_OPS["sw_extend"])

    # K2: the DP, the traceback, and the two in one launch (what the engine
    # calls). z comes back as a permuted view of lane-major memory.
    q, ql, t, tl, msel, w = (T(x) for x in glob_case(rng, 2048, 150, 160))
    mats = T(np.stack([opt.gamat, opt.ctmat]).astype(np.int32))
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    mat_b = mats[msel.long()].reshape(-1, 25).contiguous()
    tl1, w1 = tl.clamp(min=1), w.clamp(min=1)
    kd = lambda: sw_global.sw_global_batch(q, ql, t, tl, mats, msel, *sc, w)
    pd = lambda: sw_global.sw_global_batch_plain(q, ql, t, tl1, mat_b, w1, *sc)
    kc = lambda: sw_global.sw_global_cigar(q, ql, t, tl, mats, msel, *sc, w)
    (ks, kz), (ps, pz) = launched("sw_global", kd), pd()
    err = compare("sw_global", (ks, kz), (ps, pz))
    if kz.is_contiguous() or not kz.permute(2, 0, 1).is_contiguous():
        raise AssertionError("z is not a view of lane-major memory")
    kt = lambda: sw_global.global_traceback(kz, ql, tl, w)
    pt = lambda: sw_global.global_traceback_plain(kz, ql, tl, w)
    want_tb = pt()
    err_tb = compare("global_traceback", launched("global_traceback", kt),
                     want_tb)
    # the fused entry: one launch, equal to the two steps and to the plain
    # composition; and the traceback over a contiguous copy of z
    fused = launched("sw_global", kc)
    err = max(err, compare("sw_global_cigar", fused, (ps, *want_tb)),
              compare("sw_global_cigar plain", fused,
                      sw_global.sw_global_cigar_plain(q, ql, t, tl, mat_b, w, *sc)))
    err_tb = max(err_tb, compare(
        "global_traceback contiguous z",
        sw_global.global_traceback(kz.contiguous(), ql, tl, w), want_tb))
    # the launches alone: no gather of the matrices, no casts of the lengths
    k2_dp = cuda_ms(lambda: sw_global._launch(q, ql, t, tl, mat_b, w, *sc), 50)
    k2_fused = (cuda_ms(kc, 20), cuda_ms(lambda: sw_global._launch(
        q, ql, t, tl, mat_b, w, *sc, sw_global.MAX_OPS), 50))
    # the edge lanes at every strip width, on int32 and uint8 codes, e_ins of
    # 0, 1 and 3, five band widths; max_ops = 3 flags most lanes
    from torch_testdata import global_edge_case
    k2_widths, n_edge = set(), 0
    for shape in DP_EDGE_SHAPES + WIDE_SHAPES:
        k2_widths.add(strip_scan.strip_width(shape[1]))
        for scores, w_val, codes in (((6, 1, 6, 1), 100, torch.int32),
                                     ((6, 1, 5, 2), 5, torch.uint8),
                                     ((5, 2, 3, 3), 2, torch.int32),
                                     ((6, 1, 6, 0), 17, torch.uint8),
                                     ((6, 1, 6, 1), 1, torch.int32)):
            eq, eql, et, etl, emats, emsel, ew = (
                T(x) for x in global_edge_case(42 + shape[1], *shape, w_val))
            emat_b = emats[emsel.long()].reshape(-1, 25)
            qc, tc = eq.to(codes), et.to(codes)
            tag = f"edge {shape} w={w_val} scores={scores} {codes}"
            gs, gz = launched("sw_global", lambda: sw_global.sw_global_batch(
                qc, eql, tc, etl, emats, emsel, *scores, ew))
            es, ez = sw_global.sw_global_batch_plain(
                eq, eql, et, etl.clamp(min=1), emat_b, ew.clamp(min=1), *scores)
            err = max(err, compare(f"sw_global {tag}", (gs, gz), (es, ez)))
            # a traceback starts inside z; the DP stops at row Lt either way
            etc = etl.clamp(max=shape[2])
            for max_ops in (sw_global.MAX_OPS, 3):
                want = (es, *sw_global.global_traceback_plain(
                    ez, eql, etc, ew, max_ops))
                got = launched("sw_global", lambda: sw_global.sw_global_cigar(
                    qc, eql, tc, etc, emats, emsel, *scores, ew, max_ops))
                err = max(err, compare(f"sw_global_cigar {tag} max_ops="
                                       f"{max_ops}", got, want))
                err_tb = max(err_tb, compare(
                    f"global_traceback {tag} max_ops={max_ops}",
                    launched("global_traceback",
                             lambda: sw_global.global_traceback(
                                 gz, eql, etc, ew, max_ops)), want[1:]))
            n_edge += 1
    wide_memory(sw_global._lib().sw_global_scratch_words)
    if k2_widths != all_widths:
        raise AssertionError(f"sw_global: strip widths {sorted(k2_widths)} "
                             f"launched of {sorted(all_widths)}")
    cells = band_cells(ql, tl1, w1)
    ms = cuda_ms(kd, 20)
    # the row's times are those of the call the align path makes: the DP with
    # the traceback behind it in one launch, against the plain composition.
    # The bound is the DP's as before (z, which the fused launch writes too,
    # is nearly all of its bytes)
    row("sw_global", "sw_global.cu", "biscuit_tpu/ops/pallas_global.py:133",
        err, k2_fused[0], cuda_ms(lambda: sw_global.sw_global_cigar_plain(
            q, ql, t, tl, mat_b, w, *sc), 2),
        f"B=2048 Lq=150 Lt=160, {cells} band cells; the DP with the "
        f"traceback behind it in one launch (sw_global_cigar, the engine's "
        f"call, this row's ms): the wrapper {k2_fused[0]:.4f} ms, the launch "
        f"alone {k2_fused[1]:.4f} ms; the DP alone: the wrapper {ms:.4f} ms, "
        f"the launch alone {k2_dp:.4f} ms, plain {cuda_ms(pd, 3):.4f} ms; + "
        f"{n_edge} edge cases at strip widths {sorted(k2_widths)} (0: the "
        f"wide instance, Lq {[x[1] for x in WIDE_SHAPES]}), uint8 and int32 "
        f"codes, e_ins 0/1/3, w in {{1,2,5,17,100}}: equal",
        nbytes(q, ql, t, tl, mats, msel, w, ks, kz),
        cells * CELL_OPS["sw_global"])
    # and lanes past max_ops: unrelated sequences under cheap gaps and dear
    # mismatches need ~75 runs; the flags and truncated buffers must match
    B2 = 256
    q2 = T(rng.integers(0, 4, (B2, 120)).astype(np.int32))
    t2 = T(rng.integers(0, 4, (B2, 120)).astype(np.int32))
    l2, w2 = T(np.full(B2, 120, np.int32)), T(np.full(B2, 40, np.int32))
    m2 = T(np.where(np.eye(5, dtype=bool), 1, -20)[None].astype(np.int32))
    z0 = T(np.zeros(B2, np.int32))
    s2, z2 = sw_global.sw_global_batch(q2, l2, t2, l2, m2, z0, 1, 1, 1, 1, w2)
    got2 = sw_global.global_traceback(z2, l2, l2, w2)
    want2 = sw_global.global_traceback_plain(z2, l2, l2, w2)
    err_tb = max(err_tb, compare("global_traceback overflow", got2, want2),
                 compare("sw_global_cigar overflow", sw_global.sw_global_cigar(
                     q2, l2, t2, l2, m2, z0, 1, 1, 1, 1, w2), (s2, *want2)))
    n_ov = int(got2[2].sum())
    if n_ov == 0:
        raise AssertionError("the overflow case did not overflow")
    row("global_traceback", "sw_global.cu",
        "biscuit_tpu/ops/pallas_global.py:242", err_tb, cuda_ms(kt, 20),
        cuda_ms(pt, 3), f"B=2048, as a kernel of its own over the lane-major "
        f"z: no path launches it (on the align path the walk runs behind the "
        f"DP inside sw_global's launch) (+{n_ov} overflow lanes of {B2}, the "
        f"edge cases at max_ops 64 and 3, a contiguous z: equal)",
        # the walk reads one direction byte a step, at most qlen + tlen steps
        int((ql + tl).sum()) + nbytes(ql, tl, w, *kt()), 4 * int((ql + tl).sum()),
        paths=())

    # K4, the SA walk: both entries on 2^20 random ranks (the interval entry
    # on seed-interval rows of about as many ranks) at three step lengths:
    # the phase-4 index (sa_intv 4), its wide twin (int64 ranks, 12-column
    # rows, sa_intv 16) and an sa_intv-32 view of it (the reference
    # format's sampling); then the edge rows, a skewed list, job lists
    # longer than the grid's walk slots, and the engine's own call. The
    # 50 Mbp index follows with phase 3's 50 Mbp block.
    from torch_testdata import SA_ROW_CASES, sa_intv_view, sa_rows
    fm = seed_batch.FMPair.from_index(idx, dev)
    n = 1 << 20
    ranks = T(rng.integers(0, fm.seq_len + 1, n).astype(
        np.int64 if fm.wide else np.int32))
    which = T(rng.integers(0, 2, n).astype(np.int32))
    from biscuit_tpu_torch.index.build import build_index
    os.environ["BISCUIT_TPU_WIDE_INDEX"] = "1"
    try:
        fmw = seed_batch.FMPair.from_index(build_index(fa), dev)
    finally:
        del os.environ["BISCUIT_TPU_WIDE_INDEX"]
    if not fmw.wide or fm.wide or fmw.sa_intv != 16:
        raise AssertionError("expected a narrow and a wide (sa_intv 16) index")
    krng = np.random.default_rng(SEED + 4)
    k4_err = {"sa_walk": 0, "sa_walk_intervals": 0}

    def k4_rows(f, case, n_rows=1 << 17):
        """sa_rows of one case as the interval entry takes them."""
        w, x0, km = sa_rows(case, f.seq_len, f.host_consts[8:], f.sa_intv,
                            n=n_rows, seed=int(krng.integers(1 << 30)))
        return (T(w.astype(np.int32)), T(x0).to(f.rdt),
                T(km.astype(np.int32)), T(np.cumsum(km) - km), int(km.sum()))

    def k4_check(tag, f, which, ranks, rows):
        """Both entries against their plain twins (exactly), each launching
        once; returns the plain walk's step counts of the ranks and of the
        rows' jobs."""
        steps = torch.zeros(ranks.numel(), dtype=torch.int64, device=dev)
        isteps = torch.zeros(rows[4], dtype=torch.int64, device=dev)
        k4_err["sa_walk"] = max(k4_err["sa_walk"], compare(
            f"sa_walk {tag}", launched("sa_walk", lambda: seed_batch.sa_batch(
                f, which, ranks), 1 if ranks.numel() else 0),
            seed_batch.sa_batch_plain(f, which, ranks, steps)))
        k4_err["sa_walk_intervals"] = max(k4_err["sa_walk_intervals"], compare(
            f"sa_walk_intervals {tag}", launched(
                "sa_walk_intervals",
                lambda: seed_batch.sa_batch_intervals(f, *rows),
                1 if rows[4] else 0),
            seed_batch.sa_batch_intervals_plain(f, *rows, steps=isteps)))
        return steps, isteps

    def k4_bounds(f, steps, isteps, rows):
        """(walk-step bound of the ranks, of the rows, the one-sample floor)
        in bytes: every step reads its row once, every job its sample once
        and writes its position; the ranks' inputs (rank and strand) or the
        rows' (strand, x0, kmax, off) are read once. The floor counts no
        row."""
        rb, tb = f.sa_samples.element_size(), f.tab.shape[-1] * 4
        n_r, n_j = steps.numel(), isteps.numel()
        return (int(steps.sum()) * tb + n_r * (rb + 4 + rb + rb),
                int(isteps.sum()) * tb + nbytes(*rows[:4]) + n_j * 2 * rb,
                n_r * (rb + 4 + rb + rb))

    def k4_times(tag, f, which, ranks, rows, plain_reps=1):
        """Both entries equal to their plain twins, their wrappers and
        launches alone, the plain versions' times, the walk-step bounds and
        the floor; printed, and returned as a dict."""
        steps, isteps = k4_check(tag, f, which, ranks, rows)
        out = torch.empty_like(ranks)
        iout = torch.empty(rows[4], dtype=f.rdt, device=dev)
        ctr = torch.zeros(2, dtype=torch.int32, device=dev)
        alone = lambda: seed_batch._launch_sa(f, which, ranks, None, None,
                                              out, ctr)
        ialone = lambda: seed_batch._launch_sa(f, *rows[:4], iout, ctr)
        wrap = lambda: seed_batch.sa_batch(f, which, ranks)
        iwrap = lambda: seed_batch.sa_batch_intervals(f, *rows)
        alone()
        ialone()
        compare(f"sa_walk {tag}, the launch alone", out, wrap())
        compare(f"sa_walk_intervals {tag}, the launch alone", iout, iwrap())
        t = {"wrapper": cuda_ms(wrap, 10), "alone": cuda_ms(alone, 20),
             "plain": cuda_ms(lambda: seed_batch.sa_batch_plain(
                 f, which, ranks), plain_reps, warm=False),
             "i_wrapper": cuda_ms(iwrap, 10), "i_alone": cuda_ms(ialone, 20),
             "i_plain": cuda_ms(lambda: seed_batch.sa_batch_intervals_plain(
                 f, *rows), plain_reps, warm=False)}
        walk, iwalk, floor = k4_bounds(f, steps, isteps, rows)
        t.update(bytes=walk, i_bytes=iwalk, steps=int(steps.sum()),
                 i_steps=int(isteps.sum()), bound=bound(walk, 0)[0],
                 i_bound=bound(iwalk, 0)[0], floor=bound(floor, 0)[0])
        say(f"[3] sa_walk {tag}: {ranks.numel()} ranks, {t['steps']} steps "
            f"(mean {t['steps'] / max(ranks.numel(), 1):.3f}, longest "
            f"{int(steps.max())}): the wrapper {t['wrapper']:.4f} ms, the "
            f"launch alone {t['alone']:.4f} ms, plain {t['plain']:.4f} ms, "
            f"walk-step bound {t['bound']:.6f} ms ({walk} bytes), one-sample "
            f"floor {t['floor']:.6f} ms; intervals: {rows[0].numel()} rows, "
            f"{rows[4]} jobs, {t['i_steps']} steps: the wrapper "
            f"{t['i_wrapper']:.4f} ms, the launch alone {t['i_alone']:.4f} "
            f"ms, plain {t['i_plain']:.4f} ms, walk-step bound "
            f"{t['i_bound']:.6f} ms ({iwalk} bytes) [{card}]")
        return t, steps

    f32 = sa_intv_view(fm, 32)
    k4_shapes = {"5 Mbp sa_intv 4": (fm, ranks),
                 "5 Mbp wide sa_intv 16": (fmw, ranks.long()),
                 "5 Mbp sa_intv 32 view": (f32, ranks)}
    k4, k4_rows_of = {}, {}
    for tag, (f, rk) in k4_shapes.items():
        k4_rows_of[tag] = k4_rows(f, "random")
        k4[tag], steps = k4_times(tag, f, which, rk, k4_rows_of[tag])
    steps32 = steps  # the sa_intv-32 view's
    occ = {(w, i): seed_batch.sa_occupancy(w, i) for w in (0, 1)
           for i in (0, 1)}
    say(f"[3] sa_walk resident warps an SM and walks in flight an SM "
        f"(occupancy calculator): " + json.dumps(
            {f"{'wide' if w else 'narrow'} {'intervals' if i else 'ranks'}":
             v for (w, i), v in occ.items()}))
    # the edge rows of torch_testdata.sa_rows on every layout, through both
    # entries (the rank entry on each row's ranks)
    n_edge = 0
    for tag, (f, _rk) in k4_shapes.items():
        for case in SA_ROW_CASES:
            rows = k4_rows(f, case, n_rows=300)
            row_of = torch.repeat_interleave(
                torch.arange(rows[0].numel(), device=dev), rows[2].long())
            within = (torch.arange(row_of.numel(), device=dev)
                      - rows[3][row_of])
            k4_check(f"{tag} edge rows {case}", f, rows[0][row_of],
                     (rows[1].long()[row_of] + within).to(f.rdt), rows)
            n_edge += 1
    # skew: one walk of 31 steps among 2^20 sampled ranks (0 steps each) on
    # the sa_intv-32 view; the long walk holds one slot, so the list takes
    # about one walk's latency more than without it, not a warp's share
    pick = torch.nonzero(steps32 == 31).flatten()
    if pick.numel() == 0:
        raise AssertionError("no 31-step walk among the random ranks")
    sampled = T((32 * krng.integers(0, f32.seq_len // 32, n)).astype(np.int32))
    skewed = sampled.clone()
    at = int(krng.integers(0, n))
    skewed[at] = ranks[pick[0]]
    swhich = which.clone()
    swhich[at] = which[pick[0]]
    sk_steps = torch.zeros(n, dtype=torch.int64, device=dev)
    compare("sa_walk skewed", seed_batch.sa_batch(f32, swhich, skewed),
            seed_batch.sa_batch_plain(f32, swhich, skewed, sk_steps))
    if int(sk_steps.sum()) != 31:
        raise AssertionError(f"skewed list: {int(sk_steps.sum())} steps")
    sk_out = torch.empty_like(skewed)
    sk_ctr = torch.zeros(2, dtype=torch.int32, device=dev)
    sk_ms = {name: cuda_ms(lambda: seed_batch._launch_sa(
        f32, swhich, r, None, None, sk_out, sk_ctr), 20)
        for name, r in (("sampled", sampled), ("skewed", skewed))}
    props = torch.cuda.get_device_properties(dev)
    grid_slots = {i: props.multi_processor_count * occ[0, i][1]
                  for i in (0, 1)}
    # job lists longer than the grid's walk slots, so that slots take jobs
    # as others finish
    n_long = 2 * max(grid_slots.values()) + 12345
    long_rows = k4_rows(fm, "random", n_rows=n_long // 6)
    k4_check("long lists", fm, T(krng.integers(0, 2, n_long).astype(np.int32)),
             T(krng.integers(0, fm.seq_len + 1, n_long).astype(np.int32)),
             long_rows)
    if long_rows[4] <= max(grid_slots.values()):
        raise AssertionError(f"{long_rows[4]} jobs, grid slots {grid_slots}")
    say(f"[3] sa_walk skew, the launch alone on the sa_intv-32 view: 2^20 "
        f"sampled ranks {sk_ms['sampled']:.4f} ms, the same with one 31-step "
        f"walk among them {sk_ms['skewed']:.4f} ms; the grid's walk slots "
        f"(SMs x blocks x threads x walks a thread) {grid_slots[0]} (ranks) "
        f"/ {grid_slots[1]} (intervals), job lists of {n_long} ranks and "
        f"{long_rows[4]} jobs equal; {n_edge} edge-row cases equal through "
        f"both entries [{card}]")
    k4_base = k4["5 Mbp sa_intv 4"]
    row("sa_walk", "sa_walk.cu", "biscuit_tpu/ops/seed_batch.py:1983",
        k4_err["sa_walk"], k4_base["wrapper"], k4_base["plain"],
        f"the rank entry, 2^20 random ranks on the phase-4 index (sa_intv 4, "
        f"{k4_base['steps']} steps): the wrapper {k4_base['wrapper']:.4f} ms, "
        f"the launch alone {k4_base['alone']:.4f} ms; the one-sample floor "
        f"{k4_base['floor']:.6f} ms; the engine calls it only for lanes the "
        f"host seeded; + the wide twin, the sa_intv-32 view, {n_edge} edge-row "
        f"cases, the skewed list and the long lists: equal",
        k4_base["bytes"], 0, paths=())
    # the engine's own call: the seeder's rows of the phase-4 reads, both
    # strands, as _collect_seeds hands them to the interval entry
    ea = sa_engine_inputs(idx, fq, dev)
    e_steps = torch.zeros(ea[5], dtype=torch.int64, device=dev)
    e_want = seed_batch.sa_batch_intervals_plain(*ea, steps=e_steps)
    k4_err["sa_walk_intervals"] = max(k4_err["sa_walk_intervals"], compare(
        "sa_walk_intervals, the engine's call", launched(
            "sa_walk_intervals", lambda: seed_batch.sa_batch_intervals(*ea)),
        e_want))
    e_rows = (ea[1].int().contiguous(), ea[2].to(fm.rdt).contiguous(),
              ea[3].int().contiguous(), ea[4].contiguous())
    e_out = torch.empty(ea[5], dtype=fm.rdt, device=dev)
    e_ctr = torch.zeros(2, dtype=torch.int32, device=dev)
    e_alone = lambda: seed_batch._launch_sa(fm, *e_rows, e_out, e_ctr)
    e_alone()
    compare("sa_walk_intervals, the engine's call, the launch alone", e_out,
            e_want)
    e_ms = cuda_ms(lambda: seed_batch.sa_batch_intervals(*ea), 20)
    e_alone_ms = cuda_ms(e_alone, 20)
    _w, e_bytes, _f = k4_bounds(fm, e_steps[:0], e_steps, e_rows)
    row("sa_walk_intervals", "sa_walk.cu", "biscuit_tpu/ops/seed_batch.py:1983",
        k4_err["sa_walk_intervals"], e_ms, cuda_ms(
            lambda: seed_batch.sa_batch_intervals_plain(*ea), 2),
        f"the interval entry at the engine's call on phase 4's reads, both "
        f"strands: {ea[1].numel()} seed rows, {ea[5]} jobs, "
        f"{int(e_steps.sum())} steps: the wrapper {e_ms:.4f} ms, the launch "
        f"alone {e_alone_ms:.4f} ms; 2^20 jobs at sa_intv 4 / 16 / 32: the "
        f"launch alone " + " / ".join(f"{k4[t]['i_alone']:.4f}" for t in k4)
        + " ms; + the edge rows, skew and long lists above: equal",
        e_bytes, 0, paths=("4", "4b"))
    # the port's scalar walk agrees on a sample
    from biscuit_tpu_torch.ops.fm import FMNumpy
    fms = {0: FMNumpy(idx.dau), 1: FMNumpy(idx.par)}
    got = seed_batch.sa_batch(fm, which, ranks)[:2000].tolist()
    for wh, r, g in zip(which[:2000].tolist(), ranks[:2000].tolist(), got):
        if g != fms[wh].sa_s(r):
            raise AssertionError(f"sa_walk rank {r}: {g} != {fms[wh].sa_s(r)}")

    # K3 (K5 inside it): the phase-4 reads converted both ways, as the
    # engine seeds them, on the narrow index and on its wide twin
    from biscuit_tpu_torch.config import MemOpt, MEM_F_NO_MULTI
    from biscuit_tpu_torch.align.smem import collect_intv
    opt = MemOpt()
    opt.flag |= MEM_F_NO_MULTI
    lq, ll, lp = (T(a) for a in lanes_of(fq, N_READS))

    def seed_fns(f, lanes, n_lanes):
        a = (f, *(x[:n_lanes] for x in lanes), opt)
        return (lambda: seed_batch.collect_intv_flat(*a),
                lambda: seed_batch.collect_intv_flat_plain(*a))

    def seed_check(name, f, lanes, n_lanes):
        """(max |d|, kernel fn, got, the plain version's ms on this run)"""
        kf, pf = seed_fns(f, lanes, n_lanes)
        got = kf()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pf()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        n = [torch.bincount(x[0].long(), minlength=n_lanes) for x in (got, want)]
        err = compare(name, (*got, n[0]), (*want, n[1]))
        if int(got[2].sum()) > n_lanes // 100 or got[1].shape[0] < n_lanes:
            raise AssertionError(f"{name}: {int(got[2].sum())} lanes flagged, "
                                 f"{got[1].shape[0]} rows for {n_lanes} lanes")
        return err, kf, got, plain_ms

    def host_rows(lanes, n_lanes, o):
        q_, l_, p_ = (x.cpu().numpy() for x in lanes)
        return [collect_intv(o, fms[int(p_[b])], fms[1 - int(p_[b])],
                             q_[b, :l_[b]]) for b in range(n_lanes)]

    def rows_of(got, n_lanes):
        lane_of, rows = got[0].cpu(), got[1].cpu()
        return [[tuple(r) for r in rows[lane_of == b].tolist()]
                for b in range(n_lanes)]

    B = lq.shape[0]
    err, ks, got, k3_plain_ms = seed_check("smem_seed", fm, (lq, ll, lp), B)
    # the first lanes against the host's exact smem.collect_intv
    if rows_of(got, 64) != host_rows((lq, ll, lp), 64, opt):
        raise AssertionError("smem_seed differs from collect_intv")
    n_rows = got[1].shape[0]
    err = max(err, seed_check("smem_seed wide", fmw, (lq, ll, lp), B)[0])
    # the launch alone: no casts, no range check with its sync, no row mask
    params = seed_batch.seed_params(opt)
    k3 = (cuda_ms(ks, 10), cuda_ms(lambda: seed_batch._launch_seed(
        fm, lq, ll, lp, params, seed_batch.SEED_CAP), 20))
    k3_wide = cuda_ms(lambda: seed_batch._launch_seed(
        fmw, lq, ll, lp, params, seed_batch.SEED_CAP), 20)
    # the launch alone by batch size: at 128 lanes, under one a SM, a lane's
    # own chain of extensions is all there is; at 8192 the card is full
    by_b = {n: round(cuda_ms(lambda: seed_batch._launch_seed(
        fm, lq[:n], ll[:n], lp[:n], params, seed_batch.SEED_CAP), 20), 4)
        for n in (128, 1024, B)}
    say(f"[3] smem_seed, the launch alone by lanes a call (ms): "
        f"{json.dumps(by_b)} [{card}]")
    # reads so long that a lane's interval lists do not fit an SM's shared
    # memory and lie in device memory: LONG_JOIN path reads joined end to end,
    # under S = LONG_S rows so that no lane overflows, held to the host's
    # collect_intv (the plain version makes a step a base of the longest
    # lane: a quarter of an hour on these)
    n_long = 8
    hq, hl, hp = (x.cpu().numpy() for x in (lq, ll, lp))
    joined = [np.concatenate([hq[r, :hl[r]] for r in range(
        i % 2 + 2 * LONG_JOIN * i, i % 2 + 2 * LONG_JOIN * (i + 1), 2)])
        for i in range(n_long)]  # lane i: LONG_JOIN reads of one conversion
    long_len = np.asarray([len(x) for x in joined], np.int32)
    longq = np.full((n_long, long_len.max()), 4, np.int32)
    for i, x in enumerate(joined):
        longq[i, :len(x)] = x
    long_lanes = (T(longq), T(long_len), T(hp[np.arange(n_long) % 2]))
    per_lane = int(seed_batch._seed_lib().smem_seed_scratch_bytes(
        longq.shape[1], LONG_S, 0))
    if per_lane <= 0:
        raise AssertionError(f"L={longq.shape[1]}: the lists fit shared memory")
    g = launched("smem_seed", lambda: seed_batch.collect_intv_flat(
        fm, *long_lanes, opt, S=LONG_S))
    host = host_rows(long_lanes, n_long, opt)
    if any(g[2].tolist()) or rows_of(g, n_long) != host:
        raise AssertionError("smem_seed long reads differ from collect_intv")
    say(f"[3] smem_seed, {n_long} reads of {longq.shape[1]} bases, S={LONG_S}: "
        f"the lists in device memory ({per_lane} bytes a lane), "
        f"{g[1].shape[0]} rows, {min(len(h) for h in host)} to "
        f"{max(len(h) for h in host)} a lane: kernel == collect_intv")
    # the edge lanes (N at every kind of place, reads of no and one base,
    # tandem repeats, joined reads, a homopolymer that overflows S = 128)
    # beside the first 96 lanes of the path: under the default options,
    # under -e (start_width = 2), and under S of 3 and 1, which flag more; two of the cases on the wide index too;
    # equal to the plain version in rows, counts and flags, and to the host
    from biscuit_tpu_torch.config import MEM_F_SELF_OVLP
    from biscuit_tpu_torch.io.fastq import fastq_iter, read_batch
    from torch_testdata import lanes_both_ways, seed_edge_reads
    genuine = [s.seq for s in read_batch(fastq_iter(fq), None, 1 << 60)[:6]]
    eq, el, ep = (T(a) for a in lanes_both_ways(seed_edge_reads(genuine)))
    pad = lq.shape[1] - eq.shape[1]
    eq = torch.nn.functional.pad(eq, (0, pad), value=4)
    edge = tuple(torch.cat([a, b[:96]]) for a, b in
                 ((eq, lq), (el, ll), (ep, lp)))
    nE, n_flagged, n_cases = edge[0].shape[0], {}, 0
    for flag in (0, MEM_F_SELF_OVLP):
        o = MemOpt()
        o.flag |= MEM_F_NO_MULTI | flag
        host = host_rows(edge, nE, o)
        for S in (seed_batch.SEED_CAP, 1 if flag else 3):
            for f in ((fmw, fm) if S == seed_batch.SEED_CAP and not flag
                      else (fmw,) if flag and S == 1 else (fm,)):
                g = launched("smem_seed", lambda: seed_batch.collect_intv_flat(
                    f, *edge, o, S=S))
                p_ = seed_batch.collect_intv_flat_plain(f, *edge, o, S)
                err = max(err, compare(f"smem_seed edge lanes flag={flag} S={S} "
                                       f"wide={f.wide}", g, p_))
                n_cases += 1
            # a lane is flagged iff the host gives it more than S rows, and
            # then has none; the others have the host's rows
            flags = g[2].tolist()
            if flags != [len(h) > S for h in host] or rows_of(g, nE) != [
                    [] if fl else h for fl, h in zip(flags, host)]:
                raise AssertionError(f"smem_seed edge lanes flag={flag} S={S} "
                                     "differ from collect_intv")
            if not 0 < sum(flags) < nE:
                raise AssertionError(f"S={S} flagged {sum(flags)} lanes")
            n_flagged[S] = n_flagged.get(S, 0) + sum(flags)
    ms = k3[0]
    row("smem_seed", "smem_seed.cu", "biscuit_tpu/ops/seed_batch.py:1847", err,
        ms, k3_plain_ms,
        f"B={B} lanes, L={lq.shape[1]}, narrow index (times), wide (equality), "
        f"{n_rows} rows; the wrapper {k3[0]:.4f} ms, the launch alone "
        f"{k3[1]:.4f} ms (wide index: {k3_wide:.4f} ms); + {n_cases} cases of "
        f"{nE} edge and path lanes (-e; lanes flagged by S: "
        f"{json.dumps(n_flagged)}; two on the wide index): equal, and equal to "
        f"the host's collect_intv",
        # a floor: every base of a lane is extended over at least once, and
        # an extension gathers two rows of the fused table
        nbytes(lq, ll, lp, *got) + 2 * int(ll.sum()) * fm.tab.shape[-1]
        * fm.tab.element_size(), 40 * int(ll.sum()))

    # K6: the occurrence streams mem_chain_batch builds for those lanes and
    # for chimeras of thirds of three reads (lanes of three chains), caught
    # at the scan's entry; then NC=2, where lanes overflow
    from biscuit_tpu_torch.align.chain import CHAIN_JMAX, CHAIN_NC
    sa = chain_scan_inputs(opt, idx, fq, dev)
    kc = lambda nc=CHAIN_NC: chain_batch.chain_scan_batch(*sa, NC=nc)
    pc = lambda nc=CHAIN_NC: chain_batch.chain_scan_batch_plain(*sa, NC=nc)
    err = compare("chain_scan", launched("chain_scan", kc), pc())
    got2 = kc(2)
    err = max(err, compare("chain_scan NC=2", got2, pc(2)))
    n_ov2 = int(got2[1].sum())
    if n_ov2 == 0:
        raise AssertionError("chain_scan NC=2 flagged no lane")
    # the edge lanes of tests/test_torch_chain.py (CHAIN_JMAX occurrences,
    # exactly NC chains and one more, a seed across l_pac) at NC 64 and 2,
    # on int32 ranks around this index's l_pac and on int64 ranks around an
    # l_pac >= 2^31; J = 1024 streams through the kernel's staging chunks
    from torch_testdata import chain_edge_lanes, chain_planes
    n_edge = 0
    for nc in (CHAIN_NC, 2):
        for l_pac, rdt in ((int(idx.l_pac), np.int32),
                           ((1 << 31) + 12345, np.int64)):
            planes, n_occ = chain_planes(chain_edge_lanes(nc, l_pac), rdt)
            ea = (*(T(x) for x in planes), T(n_occ), l_pac, *sa[8:11])
            if ea[0].shape[0] <= chain_batch.JC:
                raise AssertionError("the edge lanes fit one staging chunk")
            err = max(err, compare(
                f"chain_scan edge lanes NC={nc} l_pac={l_pac}",
                launched("chain_scan",
                         lambda: chain_batch.chain_scan_batch(*ea, NC=nc)),
                chain_batch.chain_scan_batch_plain(*ea, NC=nc)))
            n_edge += 1

    # the launch alone, without the wrapper's casts and its range check of
    # n_occ with its sync; its result held to the plain version's too
    log = torch.empty_like(sa[0], dtype=torch.int32)
    ov = torch.empty(sa[0].shape[1], dtype=torch.bool, device=dev)
    args = [x.int().contiguous() for x in sa[:7]]
    args[2] = sa[2].contiguous()
    k6_go = lambda: chain_batch._launch(*args, *sa[7:11], CHAIN_NC, log, ov)
    k6_go()
    compare("chain_scan, the launch alone", (log, ov), pc())
    k6_alone = cuda_ms(k6_go, 50)
    ms = cuda_ms(kc, 20)
    row("chain_scan", "chain_scan.cu", "biscuit_tpu/ops/chain_batch.py:44",
        err, ms, cuda_ms(pc, 1),
        f"J={sa[0].shape[0]} B={sa[0].shape[1]} NC={CHAIN_NC} (+NC=2: "
        f"{n_ov2} lanes flagged, equal; + {n_edge} cases of edge lanes, J="
        f"{CHAIN_JMAX} over staging chunks of {chain_batch.JC}, int32 and "
        f"int64 ranks: equal); the wrapper {ms:.4f} ms, the launch alone "
        f"{k6_alone:.4f} ms",
        nbytes(*sa[:7], *kc()), 30 * int(sa[6].sum()))

    # K9: the window count scatter-add at the shapes phase 6 gives it, a
    # window of 100,000 sites with 3 x 10^6 data (30x of 150 bp reads in
    # coordinate order): 32 codes with a tenth of the data invalid (the
    # filtered counts) and 1 code over all data (the depth), for one sample
    # and for two (somatic mode), int64 indices (as the engine's numpy arrays
    # come) and int32. Integer counts: equal exactly, tolerance 0.
    err = 0
    for n_bams in (1, 2):
        window = PLP_WINDOW * n_bams
        for n_codes, p_invalid in ((32, 0.1), (1, 0.0)):
            pos, code, valid = count_case(rng, PLP_WINDOW, n_bams, PLP_DATA,
                                          p_invalid)
            if n_codes == 1:
                code = np.zeros_like(code)
            for dt in (np.int64, np.int32):
                a = (T(pos.astype(dt)), T(code.astype(dt)), T(valid))
                kf = lambda: pileup_count.pileup_count_window(*a, window, n_codes)
                pf = lambda: pileup_count.pileup_count_window_plain(
                    *a, window, n_codes)
                got = kf()
                err = max(err, compare(f"pileup_count W={window} C={n_codes} "
                                       f"{np.dtype(dt).name}", got, pf()))
                if int(got.sum()) != int(valid.sum()):
                    raise AssertionError("pileup_count lost data")
                tag = (f"W={window} C={n_codes} {np.dtype(dt).name} "
                       f"N={pos.size}")
                # the one PyTorch call that computes the same counts, on the
                # flat index made beforehand (the spill bin at the end)
                flat = torch.where(a[2], a[0].long() * n_codes + a[1].long(),
                                   window * n_codes)
                lf = lambda: torch.bincount(flat, minlength=window * n_codes + 1)
                if not torch.equal(lf()[:-1].reshape(window, n_codes).int(), got):
                    raise AssertionError(f"{tag}: bincount != kernel")
                # without the wrapper's read of the refused-data word
                raw = lambda: pileup_count._launch(*a, window, n_codes)
                times = (cuda_ms(kf, 20), cuda_ms(raw, 20), cuda_ms(pf, 5),
                         cuda_ms(lf, 5))
                if (n_bams, n_codes, dt) == (1, 32, np.int64):
                    k9 = (times, tag, nbytes(*a) + 2 * window * n_codes * 4,
                          3 * pos.size)
                say(f"[3] pileup_count {tag}: kernel == plain == bincount; "
                    f"wrapper {times[0]:.4f} ms, launch alone {times[1]:.4f} "
                    f"ms, plain {times[2]:.4f} ms, bincount {times[3]:.4f} ms "
                    f"[{card}]")
    # an index out of range raises (never a silent clamp or drop) ...
    for bad_pos, bad_code in ((PLP_WINDOW, 0), (-1, 0), (5, 32), (5, -1)):
        b = (T(np.array([3, bad_pos, 7])), T(np.array([1, bad_code, 2])),
             T(np.ones(3, bool)))
        try:
            pileup_count.pileup_count_window(*b, PLP_WINDOW, 32)
        except ValueError:
            pass
        else:
            raise AssertionError(f"pileup_count took position {bad_pos}, "
                                 f"code {bad_code}")
    # ... unless its `valid` is false; and no data give zero counts
    b = (b[0], b[1], T(np.array([True, False, True])))
    if int(pileup_count.pileup_count_window(*b, PLP_WINDOW, 32).sum()) != 2:
        raise AssertionError("pileup_count counted an invalid datum")
    e = (T(np.zeros(0, np.int64)), T(np.zeros(0, np.int64)), T(np.zeros(0, bool)))
    if int(pileup_count.pileup_count_window(*e, PLP_WINDOW, 32).sum()) != 0:
        raise AssertionError("pileup_count of no data is not zero")
    (ms, raw_ms, pms, lms), tag, moved, ops = k9
    row("pileup_count", "pileup_count.cu", "biscuit_tpu/parallel/mesh.py:118",
        err, ms, pms, tag + f" (+ 2 samples, 1 code, int32, refusals: equal); "
        f"the general entry, whose path is K10's count merge (phase 7: the "
        f"dry run's stage 3): the wrapper {ms:.4f} ms, the launch alone "
        f"{raw_ms:.4f} ms",
        moved, ops, library_ms=lms, paths=("7",))

    # K9's fused entry, the pileup path's call: cm, cb and the depth of a
    # window in one launch, on the inputs the engine stages (int32 site,
    # uint8 code, bool pass: 6 bytes a datum), at phase 6's size: reads in
    # coordinate order (the path's case, timed), two samples one after the
    # other, the same data shuffled (every chunk on the device-memory path),
    # every datum on one site, no data, passing codes in [21, 32). Integer
    # counts: equal exactly.
    from torch_testdata import (WINDOW_KINDS, window_count_case,
                                window_count_inputs)
    err, wide_by_kind = 0, {}
    for kind in WINDOW_KINDS:
        # two samples at phase 6's depth each
        case = window_count_case(kind, seed=SEED, P=PLP_WINDOW, n=PLP_DATA * (
            2 if kind == "two_samples" else 1))
        (sites, codes, ok), window = window_count_inputs(*case)
        a = (T(sites), T(codes), T(ok))
        kf = lambda: pileup_count.pileup_window_counts(*a, window)
        pf = lambda: pileup_count.pileup_window_counts_plain(*a, window)
        got, n_wide = launched("pileup_window_counts", kf,
                               1 if sites.size else 0)
        err = max(err, compare(f"pileup_window_counts {kind}", got, pf()))
        if int(got[:, pileup_count.DP].sum()) != sites.size:
            raise AssertionError(f"pileup_window_counts {kind} lost data")
        n_chunks = -(-sites.size // pileup_count.FUSED_CHUNK)
        wide_by_kind[kind] = f"{n_wide} of {n_chunks}"
        if kind == "shuffled" and n_wide != n_chunks:
            raise AssertionError(f"shuffled: {n_wide} of {n_chunks} chunks "
                                 "on the device-memory path")
        if kind == "sorted":
            k9f = (cuda_ms(kf, 20), cuda_ms(lambda: pileup_count._launch_fused(
                *a, window), 20), cuda_ms(pf, 5))
            k9f_moved = nbytes(*a) + window * pileup_count.N_WORDS * 4
            k9f_tag = f"W={window} N={sites.size}"
    for bad in ("site", "code"):
        sites, codes, ok = (x[:4].clone() for x in a)
        if bad == "site":
            sites[2], ok[2] = window, False   # counts in the depth all the same
        else:
            codes[2], ok[2] = 32, True
        try:
            pileup_count.pileup_window_counts(sites, codes, ok, window)
        except ValueError:
            pass
        else:
            raise AssertionError(f"pileup_window_counts took a bad {bad}")
    say(f"[3] pileup_window_counts: chunks on the device-memory path by kind: "
        f"{json.dumps(wide_by_kind)}")
    row("pileup_window_counts", "pileup_count.cu",
        "biscuit_tpu/pileup/engine.py:526 (two calls of parallel/mesh.py:118)",
        err, k9f[0], k9f[2],
        f"{k9f_tag}, reads in coordinate order: the wrapper {k9f[0]:.4f} ms, "
        f"the launch alone {k9f[1]:.4f} ms; + kinds {list(WINDOW_KINDS)}, "
        "refusals: equal", k9f_moved, 3 * PLP_DATA, paths=("6",))

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
    _err, _kb, _got, big_plain_ms = seed_check("smem_seed 50 Mbp", fmb, big,
                                               BIG_CHECK)
    big_alone = cuda_ms(lambda: seed_batch._launch_seed(
        fmb, *big, params, seed_batch.SEED_CAP), 10)
    say(f"[3] smem_seed 50 Mbp: kernel {cuda_ms(kb, 5):.4f} ms for {B} lanes "
        f"(the launch alone {big_alone:.4f} ms), "
        f"plain {big_plain_ms:.4f} ms for {BIG_CHECK} lanes, equal on "
        f"{BIG_CHECK} [{card}]")
    # K4 on the 50 Mbp tables at sa_intv 4 and on their sa_intv-32 view
    rb = T(rng.integers(0, fmb.seq_len + 1, n).astype(np.int32))
    for tag, f in (("50 Mbp sa_intv 4", fmb),
                   ("50 Mbp sa_intv 32 view", sa_intv_view(fmb, 32))):
        k4[tag] = k4_times(tag, f, which, rb, k4_rows(f, "random"))[0]
    del fmb, bidx, f

    from torch.profiler import ProfilerActivity, profile

    def say_busy(tag, prof, wall, *must_have):
        """Device time by name from a profile over `wall` seconds: events of
        the card itself (kernels and copies); the host-side ops that
        launched them carry the same device time a second time."""
        on_card = torch.autograd.DeviceType.CUDA
        by_name = sorted(((e.self_device_time_total, e.count, e.key)
                          for e in prof.key_averages()
                          if e.device_type == on_card
                          and e.self_device_time_total > 0), reverse=True)
        busy_ms = sum(us for us, _n, _k in by_name) / 1e3
        for name in must_have:
            if not any(name in key for _us, _n, key in by_name):
                raise AssertionError(f"torch.profiler saw no {name} kernel")
        say(f"[{tag}] device busy {busy_ms:.3f} ms of {wall * 1e3:.1f} ms "
            f"wall: idle share {1 - busy_ms / (wall * 1e3):.5f} (kernels and "
            f"copies of one stream, summed) [{card}]")
        for us, n_ev, key in by_name[:8]:
            say(f"[{tag}]   {us / 1e3:10.3f} ms  {n_ev:5d} x  {key[:90]}")

    say(f"[t] phase 4 starts at {time.perf_counter() - T0:.1f} s")
    # 4. the SE align slice end to end, through the CLI entry point
    from biscuit_tpu_torch import cli
    from biscuit_tpu_torch.align import device_engine
    from biscuit_tpu_torch.config import MemOpt, MEM_F_NO_MULTI, MEM_F_PE
    from biscuit_tpu_torch.index.fmindex import BisIndex
    from biscuit_tpu_torch.align.pipeline import AlignerState, process_seqs
    from torch_testdata import damage_mates, load_pairs, trim_fastq
    os.environ["BISCUIT_TPU_TORCH_DEVICE"] = "cuda"
    # phases 4 to 4c and 6 drive the device engine, whose kernels they hold;
    # phase 4d the CLI's default, the hybrid, and the native engine
    os.environ["BISCUIT_TPU_TORCH_ENGINE"] = "device-jax"

    def align(argv):
        """The CLI on the card, every count set to 0 just before it and read
        just after: (SAM records, wall s, launches, stage report). The
        garbage of earlier phases is collected before the clock starts."""
        gc.collect()
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
            f"overflow {rep['traceback_overflow_lanes']}; global alignments "
            f"left for worker2 (cigar_late_lanes) {rep['cigar_late_lanes']}")
        # the prefill's candidates over-approximate what reg2sam formats
        if rep["cigar_late_lanes"]:
            raise AssertionError("worker2 asked for a global alignment the "
                                 "CIGAR prefill did not compute")
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
    want, host_se_s = host_sam(read_batch(fastq_iter(fq), None, 1 << 60)[:N_CHECK], 0,
                               os.cpu_count() or 1)
    if not "".join(ln + "\n" for ln in body).startswith(want):
        raise AssertionError("device SAM differs from the host engine's "
                             f"in the first {N_CHECK} reads")
    n_ind = sum(1 for f in prim if "I" in f[5] or "D" in f[5])
    say(f"[4] align: {N_READS} reads, {mapped} mapped, {n_ind} with I/D, "
        f"first {N_CHECK} SAM byte-identical to the host engine "
        f"({host_se_s:.1f} s on host)")
    say(f"[4] stages (s): {json.dumps({k: round(v, 3) for k, v in rep.items()})}")
    check_lanes(rep, 2 * N_READS, "4")
    say(f"[4] launches: {json.dumps(launches)}")
    say(f"[4] align wall {wall:.2f} s = {N_READS / wall:.1f} reads/s "
        f"(engine stages {rep['total_s']:.2f} s) [{card}]")
    for r in table:
        if "4" in r["paths"] and launches.get(r["name"], 0) < 1:
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
    want, host_pe_s = host_sam(load_pairs(fq1, fq2), MEM_F_PE,
                               os.cpu_count() or 1)
    if "".join(ln + "\n" for ln in pbody) != want:
        raise AssertionError("PE device SAM differs from the host engine's")
    say(f"[4b] align: {2 * N_PAIRS} reads, {pmapped} mapped, damaged mates "
        f"{dmapped} of {n_damaged} mapped ({smapped} with rescue off, -S, "
        f"{swall:.2f} s); SAM of the whole chunk byte-identical to the host "
        f"engine ({host_pe_s:.1f} s on host)")
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

    # where the card's time goes on that path: the same PE align once more,
    # warm, under torch.profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _body, wwall, _launches, wrep = align([fa, fq1, fq2])
    say(f"[4b] profiled warm run: wall {wwall:.2f} s = "
        f"{2 * N_PAIRS / wwall:.1f} reads/s; stages (s): "
        f"{json.dumps({k: round(v, 3) for k, v in wrep.items()})} [{card}]")
    say_busy("4b", prof, wwall, "sw_extend_kernel", "sw_local_kernel")

    # K7 against its plain version: each call caught on the PE path, then
    # numpy-seeded lanes (i16 and u8, saturating, odd qlens, endsc breaks)
    keys = ("gmax", "te", "qe", "shift", "sat", "imax_rows")

    def local_fns(a):
        q, ql, t, tl, mats, msel, o_del, e_del, o_ins, e_ins, mn, en, u8 = a
        mat_b = mats.to(torch.int32)[msel.long()].reshape(-1, 25)
        k = lambda: sw_local.sw_local_batch(*a)
        p = lambda: sw_local.sw_local_batch_plain(
            q.to(torch.int32), ql, t.to(torch.int32), tl, mat_b, mn, en, u8,
            o_del, e_del, o_ins, e_ins)
        return k, p

    def local_check(name, a):
        kf, pf = local_fns(a)
        got, want = launched("sw_local", kf), pf()
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
    # the edge lanes at every strip width, on int32 and on uint8 codes, under
    # the default scores, e_ins = 0 (the scan's decay vanishes), e_ins = 3
    # and scores that saturate the u8 lanes
    k7_widths, n_edge = set(), 0
    for B, Lq, Lt in DP_EDGE_SHAPES + WIDE_SHAPES:
        Lq = -(-Lq // 16) * 16
        k7_widths.add(strip_scan.strip_width(Lq))
        for (ma, mb, *scores), codes in (((1, 2, 6, 1, 6, 1), torch.int32),
                                         ((1, 2, 6, 1, 6, 1), torch.uint8),
                                         ((1, 2, 6, 1, 6, 0), torch.int32),
                                         ((2, 3, 5, 2, 3, 3), torch.uint8),
                                         ((4, 2, 6, 1, 6, 1), torch.int32)):
            first, last = local_edge_case(7 + Lq, B, Lq, Lt, ma, mb)
            q, ql, t, tl, mats, msel = (T(x) for x in first)
            a = (q.to(codes), ql, t.to(codes), tl, mats, msel, *scores,
                 *(T(x) for x in last))
            err = max(err, local_check(
                f"sw_local edge {(B, Lq, Lt)} a={ma} b={mb} scores={scores} "
                f"{codes}", a)[0])
            n_edge += 1
    wide_memory(sw_local._lib().sw_local_scratch_words)
    if k7_widths != all_widths:
        raise AssertionError(f"sw_local: strip widths {sorted(k7_widths)} "
                             f"launched of {sorted(all_widths)}")
    fwd = caught[0]  # the forward pass: every candidate of the chunk
    kf, pf = local_fns(fwd)
    ms = cuda_ms(kf, 20)
    # the launch alone: without the gather of the matrices and the range
    # check of the lengths with its sync
    q, ql, t, tl, mats, msel, o_del, e_del, o_ins, e_ins, _mn, en, u8 = fwd
    mat_b = mats.to(torch.int32)[msel.long()].reshape(-1, 25).contiguous()
    qk, tk = strip_scan.kernel_codes(q, t)
    k7_alone = cuda_ms(lambda: sw_local._launch(
        qk, ql.int(), tk, tl.int(), mat_b, en.int(), u8.int(), o_del, e_del,
        o_ins, e_ins), 50)
    # cells each lane computed: its striped width times the rows it ran.
    # A warp walks a lane, so the longest lane bounds the kernel from below.
    width = torch.where(fwd[-1] > 0, 16, 8)
    cells = ((fwd[1] + width - 1) // width * width
             * (kf()["imax_rows"] != sw_local.NEGB).sum(0))
    row("sw_local", "sw_local.cu", "biscuit_tpu/ops/sw_local.py:41",
        max(err, e2), ms, cuda_ms(pf, 1),
        f"path: {len(caught)} calls, forward B={fwd[0].shape[0]} "
        f"Lq={fwd[0].shape[1]} Lt={fwd[2].shape[1]}, {int(cells.sum())} "
        f"cells, longest lane {int(cells.max())}; the wrapper {ms:.4f} ms, "
        f"the launch alone {k7_alone:.4f} ms "
        f"({k7_alone * 1e6 / max(int(cells.max()), 1):.1f} ns a cell of the "
        f"longest lane); + {n_seeded} seeded lanes ({n_u8} u8, {n_sat} "
        f"saturated), {n_edge} edge cases at strip widths "
        f"{sorted(k7_widths)} (0: the wide instance), uint8 and int32 "
        f"codes, e_ins 0/1/3: equal",
        nbytes(*(x for x in fwd if torch.is_tensor(x)), *kf().values()),
        int(cells.sum()) * CELL_OPS["sw_local"], paths=("4b",))
    def wide_times():
        """What the wide instance costs: the three wrappers on 2048 edge
        lanes at the widest compiled strip and at phase 4c's width, there
        also the launches alone and the plain versions; and each kernel's
        bound (band cells x CELL_OPS, inputs read and outputs written once;
        K2's z counted a byte a band cell, K7 fills its whole rectangle)
        there and at every WIDE_SHAPES shape."""
        sc = (6, 1, 6, 1)
        for B, Lq, Lt in ((2048, 512, 530), (2048, WIDE_LEN, WIDE_LEN + 20),
                          *WIDE_SHAPES):
            timed = B == 2048
            q, ql, t, tl, mats, msel, w, bonus, h0 = (
                T(x) for x in extend_edge_case(3, B, Lq, Lt))
            k = lambda: sw_extend.sw_extend_batch(
                q, ql, t, tl, mats, msel, *sc, w, bonus, 100, h0)
            mat_b = mats[msel.long()].reshape(-1, 25).contiguous()
            wc = sw_extend.band_clamp(ql, w, bonus, mats, *sc)
            k1 = (bound(nbytes(q, ql, t, tl, mats, msel, w, bonus, h0, k()),
                        band_cells(ql, tl, wc) * CELL_OPS["sw_extend"]),)
            if timed:
                k1 += (cuda_ms(k, 10), cuda_ms(lambda: sw_extend._launch(
                    q, ql, t, tl, mat_b, wc, h0, *sc, 100), 10))
            if Lq == WIDE_LEN:
                k1 += (cuda_ms(lambda: sw_extend.sw_extend_batch_plain(
                    q, ql, t, tl, mat_b, wc, h0, *sc, 100), 1),)
            q, ql, t, tl, mats, msel, w = (T(x) for x in global_edge_case(3, B, Lq, Lt))
            tl = tl.clamp(max=Lt)
            mat_b = mats[msel.long()].reshape(-1, 25).contiguous()
            k = lambda: sw_global.sw_global_cigar(q, ql, t, tl, mats, msel, *sc, w)
            # z, a direction byte a cell, written and read back in the launch:
            # only the band's cells, those the operations count
            cells = band_cells(ql, tl.clamp(min=1), w.clamp(min=1))
            k2 = (bound(nbytes(q, ql, t, tl, mats, msel, w, *k()) + cells,
                        cells * CELL_OPS["sw_global"]),)
            if timed:
                k2 += (cuda_ms(k, 10), cuda_ms(lambda: sw_global._launch(
                    q, ql, t, tl, mat_b, w, *sc, sw_global.MAX_OPS), 10))
            if Lq == WIDE_LEN:
                k2 += (cuda_ms(lambda: sw_global.sw_global_cigar_plain(
                    q, ql, t, tl, mat_b, w, *sc), 1),)
            Lq16 = -(-Lq // 16) * 16
            first, last = local_edge_case(3, B, Lq16, Lt)
            a = (*(T(x) for x in first), *sc, *(T(x) for x in last))
            q, ql, t, tl, mats, msel = a[:6]
            mn, en, u8 = a[10:]
            mat_b = mats.to(torch.int32)[msel.long()].reshape(-1, 25).contiguous()
            k = lambda: sw_local.sw_local_batch(*a)
            k7 = (bound(nbytes(*(x for x in a if torch.is_tensor(x)),
                               *k().values()),
                        int((ql.long() * tl.long()).sum()) * CELL_OPS["sw_local"]),)
            if timed:
                qk, tk = strip_scan.kernel_codes(q, t)
                k7 += (cuda_ms(k, 10), cuda_ms(lambda: sw_local._launch(
                    qk, ql.int(), tk, tl.int(), mat_b, en.int(), u8.int(),
                    *sc), 10))
            if Lq == WIDE_LEN:
                k7 += (cuda_ms(lambda: sw_local.sw_local_batch_plain(
                    q.int(), ql, t.int(), tl, mat_b, mn, en, u8, *sc), 1),)
            parts = []
            for name, v in (("sw_extend", k1), ("sw_global_cigar", k2),
                            ("sw_local", k7)):
                txt = f"{name}: bound {v[0][0]:.6f} ms by {v[0][1]}"
                if timed:
                    txt += f", the wrapper {v[1]:.4f} ms, the launch alone {v[2]:.4f} ms"
                if len(v) > 3:
                    txt += f", plain {v[3]:.4f} ms"
                parts.append(txt)
            say(f"[3] edge lanes B={B} Lq={Lq} Lt={Lt}, instance C="
                f"{strip_scan.strip_width(Lq)} (0: wide): " + "; ".join(parts)
                + f" [{card}]")
    wide_times()
    for r in table:
        n_se, n_pe = launches.get(r["name"], 0), plaunch.get(r["name"], 0)
        if "4b" in r["paths"]:
            r["launches"] = n_se + n_pe
            if n_pe < 1:
                raise AssertionError(f"{r['name']} never launched on the PE path")

    # 4c. reads of WIDE_LEN bases, wider than the widest compiled strip of
    # K1, K7 and K2, through the CLI on the card. Their extension, rescue
    # and global-alignment lanes run the kernels' wide instance; the SAM
    # must be the host engine's. SE, then pairs of a long mate 1 (which
    # rescue aligns as a long query from its mate's place) and a 150 bp mate
    # 2, every DAMAGE_EVERY-th long mate damaged as in phase 4b: such a read
    # has no seed of its own, collects chance 19-mers of the three-letter
    # genome as weak regions, and its best region may score below T; the
    # CIGAR prefill computes those regions too, and the SAM must still list
    # in SA:Z only what the host engine formats.
    t0 = time.perf_counter()
    wfa, wfq, _ = make_dataset(
        os.path.join(work, "wide"), genome_size=GENOME, n_reads=N_WIDE,
        read_len=WIDE_LEN, seed=SEED, snp_rate=0.001, indel_every=16,
        index=False)
    wpfa, (wfq1, wfq2), _ = make_dataset(
        os.path.join(work, "widepe"), genome_size=GENOME, n_reads=N_WIDE_PAIRS,
        read_len=WIDE_LEN, seed=SEED, snp_rate=0.001, indel_every=8, pe=True,
        index=False)
    for other in (wfa, wpfa):
        with open(fa, "rb") as f1, open(other, "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError("the long reads' genome differs from "
                                     "phase 4's")
    trim_fastq(wfq2, READ_LEN)
    damage_mates(wfq1, DAMAGE_EVERY)
    say(f"[4c] data: {N_WIDE} reads and {N_WIDE_PAIRS} mates 1 of {WIDE_LEN} "
        f"bp (the widest compiled strip: {32 * max(strip_scan.STRIP_WIDTHS)} "
        f"columns), every {DAMAGE_EVERY}rd mate 1 damaged, mates 2 of "
        f"{READ_LEN} bp, in {time.perf_counter() - t0:.1f} s")
    for tag, argv, seqs, flag, need in (
            ("SE", [fa, wfq], read_batch(fastq_iter(wfq), None, 1 << 60), 0,
             ("sw_extend", "sw_global")),
            ("PE", [fa, wfq1, wfq2], load_pairs(wfq1, wfq2), MEM_F_PE,
             ("sw_extend", "sw_global", "sw_local"))):
        # the widths the DP wrappers pick their instance for, on this run
        seen, real_width = [], strip_scan.strip_width
        strip_scan.strip_width = lambda Lq: seen.append(Lq) or real_width(Lq)
        try:
            wbody, wwall, wl, wrep = align(argv)
        finally:
            strip_scan.strip_width = real_width
        n_wide = sum(real_width(Lq) == strip_scan.WIDE for Lq in seen)
        wprim = primaries(wbody, len(seqs))
        wmapped = sum(1 for f in wprim if not int(f[1]) & 4)
        want, host_s = host_sam(seqs, flag, os.cpu_count() or 1)
        if "".join(ln + "\n" for ln in wbody) != want:
            raise AssertionError(f"{tag} SAM of the long reads differs from "
                                 "the host engine's")
        counts = {k: wl.get(k, 0) for k in need}
        if (any(n < 1 for n in counts.values()) or n_wide < 1
                or wmapped < 0.6 * len(seqs)):
            raise AssertionError(f"{tag} long reads: {wmapped} of {len(seqs)} "
                                 f"mapped, launches {counts}, {n_wide} of the "
                                 f"wide instance")
        if wrep["cigar_late_lanes"]:
            raise AssertionError(f"{tag} long reads: worker2 asked for a "
                                 "global alignment the CIGAR prefill did not "
                                 "compute")
        redone = {k: wrep[k] for k in ("seed_overflow_lanes", "chain_host_lanes",
                                       "traceback_overflow_lanes",
                                       "cigar_late_lanes")}
        say(f"[4c] {tag}: {len(seqs)} reads, {wmapped} mapped, SAM "
            f"byte-identical to the host engine ({host_s:.1f} s on host); "
            f"launches of the DP kernels: {json.dumps(counts)}, {n_wide} of "
            f"them of the wide instance (widest query {max(seen)} columns); "
            f"lanes redone on the host by the other "
            f"capacities: {json.dumps(redone)}; {len(seqs) / wwall:.1f} reads/s, wall "
            f"{wwall:.2f} s [{card}]")

    say(f"[t] phase 4d starts at {time.perf_counter() - T0:.1f} s")
    # 4d. the engines: the hybrid (`device`, the CLI's default: K3 and K4 on
    # the card, chaining, extension and SAM in the native C++ engine), the
    # native engine alone and `device-jax` (phases 4 and 4b) on the same
    # reads. Their SAM must be device-jax's, which phases 4 and 4b held to
    # the host engine, byte for byte, at every SA_CAP of the sweep.
    ncpu = os.cpu_count()
    say(f"[4d] native library (align_host.cpp, sais.cpp, bwt_merge.cpp) "
        f"built in {native_build_s:.1f} s by g++ -std=c++20; host "
        f"os.cpu_count() = {ncpu}")
    cap0 = device_engine.DeviceSeeder.SA_CAP

    def engine_run(engine, argv, sa_cap=cap0, threads=1):
        """align through the CLI with BISCUIT_TPU_TORCH_ENGINE=engine, the
        hybrid's SA_CAP and -@ threads."""
        os.environ["BISCUIT_TPU_TORCH_ENGINE"] = engine
        device_engine.DeviceSeeder.SA_CAP = sa_cap
        try:
            return align(["-@", str(threads), *argv])
        finally:
            os.environ["BISCUIT_TPU_TORCH_ENGINE"] = "device-jax"
            device_engine.DeviceSeeder.SA_CAP = cap0

    def rps(n, wall):
        return f"{n / wall:.1f} reads/s ({wall:.3f} s, os.cpu_count() {ncpu})"

    def setup_s(fasta, what):
        """The per-call set-up inside a CLI wall, timed on its own: the
        index load and the native engine's tables (both engines), the
        seeder's tables on the card (the hybrid). {engine: seconds}."""
        from biscuit_tpu_torch.align.native_engine import NativeAligner
        t0 = time.perf_counter()
        st_ = AlignerState(BisIndex.load(fasta))
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        NativeAligner(st_)
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        device_engine.DeviceSeeder(st_, "cuda")
        torch.cuda.synchronize()
        t_sdr = time.perf_counter() - t0
        say(f"[4d] set-up a CLI call on {what}: index load {t_load:.3f} s, "
            f"NativeAligner {t_nat:.3f} s, DeviceSeeder {t_sdr:.3f} s [{card}]")
        return {"device": t_load + t_nat + t_sdr, "native": t_load + t_nat}

    def past(engine, n, wall, setup):
        return (f"; past the set-up of {setup[engine]:.3f} s "
                f"{1e6 * (wall - setup[engine]) / n:.2f} us a read")

    setup4 = setup_s(fa, "phase 4's genome")
    k34 = ("smem_seed", "sa_walk_intervals")
    hyb_launch = {k: 0 for k in k34}
    sweep = {}
    for tag, argv, want, n in (("SE", [fa, fq], body, N_READS),
                               ("PE", [fa, fq1, fq2], pbody, 2 * N_PAIRS)):
        for cap in SA_CAPS:
            hbody, hwall, hl, hrep = engine_run("device", argv, cap)
            if hbody != want:
                raise AssertionError(f"{tag} hybrid SAM at SA_CAP {cap} "
                                     "differs from device-jax's")
            if hl.get("smem_seed", 0) < 1 or (
                    (hl.get("sa_walk_intervals", 0) > 0) != (cap > 0)):
                raise AssertionError(f"{tag} hybrid at SA_CAP {cap}: "
                                     f"launches {hl}")
            if cap in (cap0, 64):
                for k in k34:
                    hyb_launch[k] += hl.get(k, 0)
            sweep.setdefault((tag, cap), []).append(hwall)
            say(f"[4d] {tag} hybrid SA_CAP {cap}: {rps(n, hwall)}; inject "
                f"{hrep.get('inject', 0):.3f} s, native "
                f"{hrep.get('native', 0):.3f} s; seed_overflow_lanes "
                f"{hrep['seed_overflow_lanes']}, sa_rows {hrep['sa_rows']}, "
                f"sa_jobs {hrep['sa_jobs']}; launches "
                f"{json.dumps({k: hl.get(k, 0) for k in k34})}; SAM == "
                f"device-jax's [{card}]")
        for threads in (1, ncpu):
            nbody, nwall, nl, _nrep = engine_run("native", argv, threads=threads)
            if nbody != want or any(nl.values()):
                raise AssertionError(f"{tag} native SAM differs from "
                                     f"device-jax's, or it launched {nl}")
            say(f"[4d] {tag} native -@ {threads}: {rps(n, nwall)}"
                f"{past('native', n, nwall, setup4)}; SAM == device-jax's "
                f"[{card}]")
        hbody, hwall, _hl, hrep = engine_run("device", argv, threads=ncpu)
        if hbody != want:
            raise AssertionError(f"{tag} hybrid SAM at -@ {ncpu} differs")
        say(f"[4d] {tag} hybrid -@ {ncpu} SA_CAP {cap0}: {rps(n, hwall)}"
            f"{past('device', n, hwall, setup4)}; inject "
            f"{hrep.get('inject', 0):.3f} s, native "
            f"{hrep.get('native', 0):.3f} s [{card}]")
    for tag in ("SE", "PE"):
        say(f"[4d] {tag} SA_CAP sweep, reads/s: " + "; ".join(
            f"{cap}: " + ", ".join(f"{(N_READS if tag == 'SE' else 2 * N_PAIRS) / w:.1f}"
                                   for w in sweep[tag, cap]) for cap in SA_CAPS)
            + f" (default {cap0}; os.cpu_count() {ncpu}) [{card}]")
    say(f"[4d] engines, reads/s at -@ 1 (SE 4096 reads / PE 2048 pairs): "
        f"device-jax {N_READS / wall:.1f} / {2 * N_PAIRS / pwall:.1f}; device "
        f"(hybrid, SA_CAP {cap0}) {N_READS / min(sweep['SE', cap0]):.1f} / "
        f"{2 * N_PAIRS / min(sweep['PE', cap0]):.1f} (the faster of two); host: "
        f"{N_CHECK / host_se_s:.1f} on phase 4's first {N_CHECK} reads at -@ 1, "
        f"{2 * N_PAIRS / host_pe_s:.1f} on phase 4b's chunk at -@ {ncpu} "
        f"(the runs that held the SAM); os.cpu_count() {ncpu} [{card}]")
    # the SA_CAP sweep on a genome with repeats
    # (torch_testdata.repeat_dataset: 80 copies of a 150 bp unit between
    # random flanks of 20 kbp, half the reads from the repeat, whose seeds
    # have about 80 occurrences), where 8 and 64 differ in the walks K4
    # takes from the C++ engine; at -@ 1 twice and at -@ os.cpu_count()
    # device-jax takes about 80 s for all the reads here (its host
    # Python over 80 occurrences a seed), so it holds the native engine on
    # the first N_REP_CHECK reads, and the native engine holds the hybrid
    # on all of them
    from torch_testdata import repeat_dataset
    rfa, rfq, _ridx = repeat_dataset(os.path.join(work, "rep"), n_reads=N_REP)
    del _ridx
    rfq_c = os.path.join(work, "rep", "check.fq")
    with open(rfq) as f, open(rfq_c, "w") as g:
        g.writelines(f.readlines()[:4 * N_REP_CHECK])
    cwant, cwall, _l, _r = engine_run("device-jax", [rfa, rfq_c])
    cbody, _w, _l, _r = engine_run("native", [rfa, rfq_c])
    rwant, rwall, _l, _r = engine_run("native", [rfa, rfq])
    if cbody != cwant or rwant[:len(cbody)] != cbody:
        raise AssertionError("repeats: native SAM differs from device-jax's")
    say(f"[4d] repeats: {N_REP} reads of 100 bp; native -@ 1 "
        f"{rps(N_REP, rwall)}; its SAM == device-jax's on the first "
        f"{N_REP_CHECK} (device-jax {rps(N_REP_CHECK, cwall)}) [{card}]")
    rsweep = {}
    for threads in (1, ncpu):
        for cap in SA_CAPS:
            hbody, hwall, hl, hrep = engine_run("device", [rfa, rfq], cap,
                                                threads)
            if hbody != rwant or hl.get("smem_seed", 0) < 1 or (
                    (hl.get("sa_walk_intervals", 0) > 0) != (cap > 0)):
                raise AssertionError(f"repeats: the hybrid at SA_CAP {cap} "
                                     f"-@ {threads}: SAM differs from "
                                     f"native's, or launched {hl}")
            rsweep.setdefault((threads, cap), []).append(hwall)
            say(f"[4d] repeats, hybrid -@ {threads} SA_CAP {cap}: "
                f"{rps(N_REP, hwall)}; inject {hrep.get('inject', 0):.3f} s, "
                f"native {hrep.get('native', 0):.3f} s; sa_rows "
                f"{hrep['sa_rows']}, sa_jobs {hrep['sa_jobs']} [{card}]")
    for threads in (1, ncpu):
        say(f"[4d] repeats SA_CAP sweep at -@ {threads}, reads/s: " + "; ".join(
            f"{cap}: " + ", ".join(f"{N_REP / w:.1f}" for w in
                                   rsweep[threads, cap]) for cap in SA_CAPS)
            + f" (default {cap0}; os.cpu_count() {ncpu}) [{card}]")
    if min(hyb_launch.values()) < 1:
        raise AssertionError(f"the hybrid launched {hyb_launch}")
    for r in table:
        if r["name"] in k34:
            r["launches"] += hyb_launch[r["name"]]
    # -V: the native engine's region-marshalling path, which forks a worker
    # pool (-@ 2, at least 256 reads), serves it when `native` is named: in
    # this process, after CUDA init and K3's launches, its children must run
    # C++ and Python only, and it launches nothing. The default engine hands
    # a -V chunk to the device engine (its fused C++ entries take no -V), on
    # the seeder's tables: K3 launches, no injection is built
    import multiprocessing
    vfq = os.path.join(work, "v512.fq")
    with open(fq) as f, open(vfq, "w") as g:
        g.writelines(f.readlines()[:4 * N_CHECK])
    vwant, _w, _l, _r = engine_run("device-jax", ["-V", fa, vfq])
    pools, get_context = [], multiprocessing.get_context
    multiprocessing.get_context = lambda m=None: pools.append(m) or \
        get_context(m)
    try:
        nbody, nwall, nl, _r = engine_run("native", ["-V", fa, vfq], threads=2)
    finally:
        multiprocessing.get_context = get_context
    if nbody != vwant or pools != ["fork"] or any(nl.values()):
        raise AssertionError(f"-V -@ 2 native: SAM differs from device-jax's, "
                             f"pools {pools}, or launched {nl}")
    say(f"[4d] -V -@ 2, native (its fork pool, after CUDA init and "
        f"{hyb_launch['smem_seed']} K3 launches): {N_CHECK} reads, SAM == "
        f"device-jax's -V, no launch, {rps(N_CHECK, nwall)} [{card}]")
    vbody, vwall, vl, vrep = engine_run("device", ["-V", fa, vfq], threads=2)
    if vbody != vwant or vl.get("smem_seed", 0) < 1 or "inject" in vrep or \
            "native" in vrep:
        raise AssertionError(f"-V -@ 2 device: SAM differs from device-jax's, "
                             f"launched {vl}, or stages {sorted(vrep)}")
    say(f"[4d] -V -@ 2, device (the chunk on the device engine): SAM == "
        f"device-jax's -V, launches {json.dumps(vl)}, {rps(N_CHECK, vwall)} "
        f"[{card}]")
    # where the card's time goes in the hybrid: a warm PE run under
    # torch.profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _b, hwall, _l, hrep = engine_run("device", [fa, fq1, fq2])
    say(f"[4d] profiled warm hybrid PE run: {rps(2 * N_PAIRS, hwall)}; "
        f"inject {hrep.get('inject', 0):.3f} s, native "
        f"{hrep.get('native', 0):.3f} s [{card}]")
    say_busy("4d", prof, hwall, "smem_seed_kernel")

    say(f"[t] phase 6 starts at {time.perf_counter() - T0:.1f} s")
    # 6. the pileup slice end to end: align on the card, sort, pileup on the
    # card through the CLI, against the same CLI on the CPU
    from biscuit_tpu_torch.pileup import engine as plp_engine
    t0 = time.perf_counter()
    pdir = os.path.join(work, "plp")
    from torch_testdata import diploid_dataset
    gfa, gfq, _ = diploid_dataset(pdir, n_reads=PLP_READS, snp_rate=0.005,
                                  genome_size=PLP_GENOME, read_len=READ_LEN,
                                  seed=SEED + 1)
    say(f"[6] data: {PLP_GENOME} bp genome, {PLP_READS} x {READ_LEN} bp reads "
        f"({PLP_READS * READ_LEN / PLP_GENOME:.0f}x) of a diploid sample (half "
        f"from a haplotype with SNPs at 0.5%, half from the reference), index "
        f"built in {time.perf_counter() - t0:.1f} s")
    gsam, gbam = os.path.join(pdir, "aln.sam"), os.path.join(pdir, "aln.bam")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with open(gsam, "w") as f, contextlib.redirect_stdout(f):
        rc = cli.main(["align", gfa, gfq])
    torch.cuda.synchronize()
    t_align = time.perf_counter() - t0
    alaunch = dict(kernels.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"align exited {rc}")
    if alaunch.get("sa_walk_intervals", 0) < 1:
        raise AssertionError(f"phase 6's align launched {alaunch}")
    say(f"[6] align launches: {json.dumps(alaunch)}")
    t0 = time.perf_counter()
    if cli.main(["sort", "-o", gbam, gsam]) != 0:
        raise AssertionError("sort failed")
    say(f"[6] align {t_align:.1f} s = {PLP_READS / t_align:.1f} reads/s on the "
        f"card; sort to BAM {time.perf_counter() - t0:.1f} s [{card}]")
    # 4d on phase 6's reads: the hybrid pipelines its sub-batches of
    # DEVICE_BATCH reads (the injection of the next beside the native
    # engine's align of this one); its SAM and the native engine's must be
    # device-jax's
    with open(gsam) as f:
        gwant = [ln.rstrip("\n") for ln in f if not ln.startswith("@")]
    n_sub = -(-PLP_READS // device_engine.DEVICE_BATCH)
    setup6 = setup_s(gfa, "phase 6's genome")
    for engine, cap, threads in [("device", c, 1) for c in sorted({cap0, 64})] + [
            ("native", cap0, 1), ("device", cap0, ncpu), ("native", cap0, ncpu)]:
        gb, gwall, gl, grep = engine_run(engine, [gfa, gfq], cap, threads)
        if gb != gwant:
            raise AssertionError(f"phase 6's reads: {engine} SAM at SA_CAP "
                                 f"{cap} differs from device-jax's")
        if engine == "device" and (gl.get("smem_seed", 0) != n_sub or (
                gl.get("sa_walk_intervals", 0) != (n_sub if cap else 0))):
            raise AssertionError(f"phase 6's reads: the hybrid launched {gl} "
                                 f"for {n_sub} sub-batches")
        split = (f"; inject {grep.get('inject', 0):.3f} s, native "
                 f"{grep.get('native', 0):.3f} s, their sum over the wall "
                 f"{(grep.get('inject', 0) + grep.get('native', 0)) / gwall:.3f}"
                 f", {n_sub} sub-batches" if engine == "device" else "")
        say(f"[4d] phase 6's {PLP_READS} reads, {engine} -@ {threads}"
            + (f" SA_CAP {cap}" if engine == "device" else "")
            + f": {PLP_READS / gwall:.1f} reads/s ({gwall:.3f} s, "
            f"os.cpu_count() {ncpu}){past(engine, PLP_READS, gwall, setup6)}"
            f"{split}; SAM == device-jax's [{card}]")

    vcf_gpu, vcf_cpu = (os.path.join(pdir, n) for n in ("gpu.vcf", "cpu.vcf"))
    import multiprocessing
    from biscuit_tpu_torch.pileup import native as plp_native

    def pileup(engine="device", opts=(), inputs=(gbam,), out=vcf_gpu):
        """The CLI's pileup under BISCUIT_TPU_TORCH_PILEUP=engine (None: the
        switch unset, the CLI's default), every count set to 0 just before
        it and read just after: (wall s, launches, stages, the fork pools it
        made, the raw BAM sources it opened)."""
        gc.collect()
        torch.cuda.synchronize()
        kernels.reset_launches()
        plp_engine.reset_stages()
        pools, raws = [], []
        get_context, raw_open = multiprocessing.get_context, \
            plp_native.raw_bam_open
        multiprocessing.get_context = lambda m=None: pools.append(m) or \
            get_context(m)
        plp_native.raw_bam_open = lambda fn: raws.append(raw_open(fn)) or \
            raws[-1]
        saved = os.environ.pop("BISCUIT_TPU_TORCH_PILEUP", None)
        if engine is not None:
            os.environ["BISCUIT_TPU_TORCH_PILEUP"] = engine
        t0 = time.perf_counter()
        try:
            rc = cli.main(["pileup", *opts, "-o", out, gfa, *inputs])
            torch.cuda.synchronize()
        finally:
            multiprocessing.get_context = get_context
            plp_native.raw_bam_open = raw_open
            os.environ.pop("BISCUIT_TPU_TORCH_PILEUP", None)
            if saved is not None:
                os.environ["BISCUIT_TPU_TORCH_PILEUP"] = saved
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"pileup {engine} {opts} exited {rc}")
        return (wall, dict(kernels.LAUNCHES), dict(plp_engine.STAGES), pools,
                [type(r).__name__ for r in raws])

    t_plp, klaunch, st, _p, _r = pileup()
    # the same CLI in a process of its own on the CPU: the plain counts
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "biscuit_tpu_torch.cli", "pileup",
                        "-o", vcf_cpu, gfa, gbam], cwd=REPO,
                       env=dict(os.environ, BISCUIT_TPU_TORCH_DEVICE="cpu",
                                BISCUIT_TPU_TORCH_PILEUP="device"),
                       capture_output=True, text=True)
    t_cpu = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"pileup on the CPU exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")

    def vcf_lines(path):
        with open(path) as f:
            return [ln for ln in f if not ln.startswith("##program")]

    got, want = vcf_lines(vcf_gpu), vcf_lines(vcf_cpu)
    if got != want:
        raise AssertionError("the card's VCF differs from the CPU's")
    with open(vcf_gpu + "_meth_average.tsv") as f, \
            open(vcf_cpu + "_meth_average.tsv") as g:
        if f.read() != g.read():
            raise AssertionError("_meth_average.tsv differs")
    sites = [ln.split("\t") for ln in got if not ln.startswith("#")]
    n_meth = sum(1 for f in sites if "CV:BT" in f[8])
    n_alt = sum(1 for f in sites if f[4] != ".")
    if any(len(f) != 10 or not f[1].isdigit() for f in sites):
        raise AssertionError("malformed VCF record")
    if st["sites"] != len(sites) or n_meth < PLP_GENOME // 10 or n_alt < 100:
        raise AssertionError(f"{len(sites)} VCF records ({st['sites']} "
                             f"counted), {n_meth} with CV:BT, {n_alt} with ALT")
    # two chromosomes of PLP_GENOME / 2, windows [1 + k * step, ...) below
    # the chromosome's length
    n_windows = 2 * -(-(PLP_GENOME // 2 - 1) // PLP_WINDOW)
    if st["windows"] != n_windows or klaunch.get("pileup_count", 0) or \
            klaunch.get("pileup_window_counts", 0) != st["windows"]:
        raise AssertionError(f"{st['windows']} windows with data (expected "
                             f"{n_windows}), launches {klaunch}")
    if st["data"] < 0.8 * PLP_READS * READ_LEN:
        raise AssertionError(f"only {st['data']} data reached K9")
    say(f"[6] pileup: {len(sites)} VCF records ({n_meth} with CV:BT, {n_alt} "
        f"with an ALT allele), byte-identical without ##program to the CPU "
        f"run's ({t_cpu:.1f} s in its own process, 3 window workers); "
        f"_meth_average.tsv identical")
    say(f"[6] stages (s): open {st['open']:.3f}, read decode "
        f"{st['decode']:.3f}, K9 with its copies "
        f"{st['count']:.3f}, emit {st['emit']:.3f}; {st['windows']} windows, "
        f"{st['data']} data = {st['data'] // st['windows']} a window; chunks "
        f"of data K9 counted in device memory for want of room in shared "
        f"memory: {st['wide_chunks']}")
    say(f"[6] launches: {json.dumps(klaunch)}")
    say(f"[6] pileup wall {t_plp:.2f} s = {len(sites) / t_plp:.1f} sites/s, "
        f"{PLP_GENOME / t_plp:.1f} bp/s [{card}]")
    for r in table:
        if "6" in r["paths"]:
            r["launches"] = klaunch.get(r["name"], 0)
            if r["launches"] < 1:
                raise AssertionError(f"{r['name']} never launched on the "
                                     "pileup path")
    # where that time goes on the card: the same run once more, then under
    # torch.profiler for the device time of every kernel and copy

    def say_run(tag, wall, st):
        st = {k: round(v, 3) if isinstance(v, float) else v
              for k, v in st.items()}
        say(f"[6] {tag}: wall {wall:.3f} s, {st['sites'] / wall:.1f} sites/s; "
            f"stages {json.dumps(st)} [{card}]")

    # the second run under the CLI's default engine, which must be the
    # device engine: K9's fused entry once a window, the same VCF
    t_plp2, launches2, st2, _p, _r = pileup(None)
    if cli.PILEUP_DEFAULT != "device" or vcf_lines(vcf_gpu) != want or \
            st2["windows"] != n_windows or \
            launches2.get("pileup_window_counts", 0) != n_windows:
        raise AssertionError(f"the default pileup engine "
                             f"{cli.PILEUP_DEFAULT}: launches {launches2}, "
                             f"stages {st2}, or its VCF differs")
    say_run("second run, the default engine (switch unset)", t_plp2, st2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _launches, st2, _p, _r = pileup()
    say_run("profiled run", wall, st2)
    say_busy("6", prof, wall, "pileup_count")
    phase_6b(work, card, pileup, vcf_lines, gfa, gsam, gbam, vcf_gpu,
             len(sites), [t_plp, t_plp2])
    phase_6d(work, card, gfa, gfq, gbam, vcf_gpu, fa, fq1, fq2)
    phase_7(work, card, table, gfa, gfq, gbam, vcf_gpu, gwant, n_windows,
            (fa, fq, fq1, fq2, body, pbody))

    say(f"[t] phase 5 starts at {time.perf_counter() - T0:.1f} s")
    # 5. neither jax nor the JAX package was imported
    theirs = [m for m in sys.modules if m in ("jax", "biscuit_tpu")
              or m.startswith(("jax.", "biscuit_tpu."))]
    if theirs:
        raise AssertionError(f"imported: {theirs}")
    say("[5] no module of jax or biscuit_tpu in sys.modules")
    for r in table:
        del r["paths"]

    say(json.dumps({"kernels": table}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
