"""The two loops of the benchmark's cells, chosen by a traffic mix's
`kind`: `align` runs the chunk loop of `biscuit_tpu_torch.cli.main_align`
(the FASTQ batch reader in a thread of its own, the hybrid engine built once,
SAM text out), and `pileup` runs whole `cli.main(["pileup", ...])` calls.

Each loop makes the run's inputs from the seed (timed apart), sets the
program up (index load, engines, one warm chunk or call: `setup_s`), measures
whole chunks or calls until the first that ends after `seconds`, reads the
card's peak memory, frees the program's state and holds what the window
wrote to the plain reference under `ref/`. Given `time_limits` (the command
gives WARM_LIMIT_S and CHUNK_LIMIT_S), a warm chunk or call, or one of the
window, that runs past its limit stops the process (time_limit).
"""
import contextlib
import faulthandler
import gc
import json
import os
import queue
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from .gen import genome as gmod
from .gen import reads as rmod
from . import trace as tmod

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# The time limits of a run of the command (run.main alone arms them; the
# tests' calls of run.run_cell give none). WARM_LIMIT_S covers the warm chunk
# or call, which in a fresh checkout also builds the kernels and the native
# libraries; CHUNK_LIMIT_S each chunk or call of the window, an align chunk
# from asking the reader's queue for its batch to the card's sync, so that a
# stalled reader is caught too. Input generation, the index build and the
# reference check after the window have none. CHUNK_LIMIT_S: the longest
# window chunk recorded is 5.11 s (a traced wgbs-pe150.align run on an H100
# host with 8 cores), and a WGBS chunk of 66,668 reads on the device-jax
# path needs 70 s even at that path's best rate recorded, 957 reads/s on a
# 5 Mbp genome. WARM_LIMIT_S: at most 300 s, and at least three times the
# longest warm chunk that runs cold, with nothing built (PERF.md section 2
# gives what has been measured of it).
WARM_LIMIT_S = 240
CHUNK_LIMIT_S = 60


@contextlib.contextmanager
def time_limit(limit_s, name: str, t_proc: float):
    """Stop the process if the block runs past `limit_s` seconds (none where
    `limit_s` is None). The block's `name` (the cell and its chunk or call)
    and the limit go to stderr as it starts; the stop prints every thread's
    stack and exits 1, with no result line. The stop is faulthandler's
    watchdog, a C thread that needs no GIL, so it also ends a C call that
    holds the GIL."""
    if limit_s is None:
        yield
        return
    log(f"[limit] {name}: {limit_s} s from {time.perf_counter() - t_proc:.1f}"
        f" s into the run")
    faulthandler.dump_traceback_later(limit_s, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def _limits_file(cell: dict) -> dict:
    with open(os.path.join(BENCH_DIR, "limits", cell["name"] + ".json")) as f:
        return json.load(f)


def limits(cell: dict) -> dict:
    """The limit of each number the cell's check compares."""
    return _limits_file(cell)["limits"]


def control_of(cell: dict):
    """The cell's control: align options, or `float32` for the pileup
    reference's genotyping in the program's place."""
    return _limits_file(cell)["control"]


def judge(numbers: dict, lim: dict):
    """(correct, checks): every number within its limit."""
    checks = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    return all(v <= lim[k] for k, v in numbers.items()), checks


def memory_peak(device) -> int:
    import torch
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scratch():
    return tempfile.mkdtemp(prefix="biscuit-bench-")


# the `align` options that a configuration (its "align_options") or a
# control (limits/<cell>.json "control") may give: each to the MemOpt field
# that cli.main_align sets for it, and whether it takes a value (else the
# field is set to 1)
ALIGN_OPTIONS = {"-b": ("parent", True), "-k": ("min_seed_len", True),
                 "-w": ("w", True), "-9": ("has_bc", False)}


def align_options(args) -> list:
    """[(MemOpt field, value)] of a list of align options; an option that
    is not in ALIGN_OPTIONS, or that lacks its value, is refused."""
    out, args = [], list(args)
    while args:
        o = args.pop(0)
        if o not in ALIGN_OPTIONS:
            raise ValueError(f"align option {o!r} is not one the benchmark "
                             f"can set (loops.ALIGN_OPTIONS: "
                             f"{', '.join(ALIGN_OPTIONS)})")
        field, takes = ALIGN_OPTIONS[o]
        if takes and not args:
            raise ValueError(f"align option {o!r} needs a value")
        out.append((field, int(args.pop(0)) if takes else 1))
    return out


# ---------------------------------------------------------------------------
# align
# ---------------------------------------------------------------------------

def align(cell, cfg, mix, seed, seconds, trace, device, t_proc, control,
          time_limits=None):
    warm_limit, chunk_limit = time_limits or (None, None)
    t_in = time.perf_counter()
    g, t_index = gmod.load_genome(cfg, log)
    t_gen = time.perf_counter() - t_in - t_index
    pe = cfg["layout"] == "pe"
    chunks = rmod.make_chunks(g, cfg, seed, mix["pool_chunks"],
                              cfg["chunk_bases"])
    tmp = _scratch()
    files = []
    for k, ch in enumerate(chunks):
        paths = [os.path.join(tmp, f"c{k}_{m}.fq") for m in
                 ((1, 2) if pe else (1,))]
        rmod.write_fastq(ch, paths)
        files.append(paths)
    gc.freeze()  # the inputs' objects out of the collector's way
    t_inputs = time.perf_counter() - t_in - t_index
    log(f"[benchmark] inputs made in {t_inputs:.3f} s (genome {t_gen:.3f} s,"
        f" {len(chunks)} chunks of {chunks[0].bases} bases; the index built "
        f"in {t_index:.3f} s, counted in setup_s)")

    from biscuit_tpu_torch.config import (MemOpt, MEM_F_NO_MULTI, MEM_F_PE)
    from biscuit_tpu_torch.index.fmindex import BisIndex
    from biscuit_tpu_torch.align import bns as bnsmod, trace as ptrace
    from biscuit_tpu_torch.align.pipeline import AlignerState
    from biscuit_tpu_torch.align import device_engine as de
    from biscuit_tpu_torch.align.native_engine import NativeAligner
    from biscuit_tpu_torch.io.fastq import fastq_iter, read_batch
    from biscuit_tpu_torch import cli

    threads = os.cpu_count() if mix["threads"] == "cpu_count" else \
        int(mix["threads"])
    opt = MemOpt()
    opt.flag |= MEM_F_NO_MULTI
    opt.n_threads = threads
    for field, v in align_options(cfg.get("align_options", [])
                                  + (control or [])):
        setattr(opt, field, v)
    opt.__post_init__()
    if pe:
        opt.flag |= MEM_F_PE
    ptrace.set_verbose(3)
    idx = BisIndex.load(g.fasta)
    bnsmod.infer_alt_chromosomes(idx)
    st = AlignerState(idx)
    nat, sdr = NativeAligner(st), de.DeviceSeeder(st, device, None)
    n_done = [0]

    def batch(k):
        its = [fastq_iter(p) for p in files[k % len(files)]]
        return read_batch(its[0], its[1] if pe else None, cfg["chunk_bases"],
                          bool(opt.has_bc))

    def align_chunk(seqs):
        for s in seqs:
            s.comment = None
        de.process_seqs_hybrid(opt, st, seqs, n_done[0], None, "",
                               engine=nat, seeder=sdr)
        n_done[0] += len(seqs)

    # one warm chunk: every kernel and shape of the window built and run
    with time_limit(warm_limit, f"{cell['name']} warm chunk", t_proc):
        tw = time.perf_counter()
        warm = batch(0)
        align_chunk(warm)
        warm = "".join(s.sam for s in warm if s.sam)
        sync(device)
        t_warm = time.perf_counter() - tw
    de.reset_stages()
    if device.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(device)

    # the window: cli.main_align's loop, its reader thread prefetching the
    # next batch while the current one aligns
    bq = queue.Queue(maxsize=1)
    stop = threading.Event()
    spans = {"read": 0.0, "write": 0.0}

    def reader():
        k = 1
        try:
            while not stop.is_set():
                t = time.perf_counter()
                b = (k % len(files), batch(k))
                spans["read"] += time.perf_counter() - t
                while not stop.is_set():
                    try:
                        bq.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        pass
                k += 1
        except BaseException as e:  # surfaced in the window's thread
            bq.put(e)

    outputs, chunk_s = [], []
    tracer = tmod.Tracer(device) if trace else contextlib.nullcontext()
    rt = threading.Thread(target=reader, daemon=True)
    t_setup = time.perf_counter() - t_proc - t_inputs
    with tracer:
        t0 = time.perf_counter()
        rt.start()
        with tmod.span("benchmark.window"):
            while True:
                with time_limit(chunk_limit, f"{cell['name']} window chunk "
                                f"{len(chunk_s)}", t_proc):
                    item = bq.get()
                    if isinstance(item, BaseException):
                        raise item
                    k, seqs = item
                    tc = time.perf_counter()
                    with tmod.span("benchmark.align_chunk"):
                        align_chunk(seqs)
                    with tmod.span("benchmark.write_sam"):
                        tw = time.perf_counter()
                        outputs.append((k, "".join(s.sam for s in seqs
                                                   if s.sam)))
                        spans["write"] += time.perf_counter() - tw
                    sync(device)
                t1 = time.perf_counter()
                chunk_s.append(t1 - tc)
                if t1 - t0 >= seconds:
                    break
        wall = time.perf_counter() - t0
    stop.set()
    rt.join()
    cli.report_launches("benchmark")
    stages = de.stage_report()
    peak = memory_peak(device)
    n_reads = sum(len(chunks[k].names) for k, _ in outputs)
    lane_bases = 2 * sum(chunks[k].bases for k, _ in outputs)
    del nat, sdr, st, idx
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)

    from .ref.align_check import check_window
    t = time.perf_counter()
    rng = np.random.default_rng([seed, 11])
    per = max(1, mix["check_reads"] // len(outputs))
    sel = [np.sort(rng.choice(len(chunks[k].names), min(per, len(
        chunks[k].names)), replace=False)) for k, _ in outputs]
    numbers, attempted, failed, notes = check_window(
        chunks, outputs, g.codes, g.starts, g.names, sel, pe)
    log(f"[benchmark] reference check {time.perf_counter() - t:.3f} s, "
        f"{sum(len(s) for s in sel)} reads in detail; disagreements: "
        f"{json.dumps(notes)}")
    correct, checks = judge(numbers, limits(cell))
    log(f"[benchmark] window {wall:.3f} s, {len(outputs)} chunks, {n_reads} "
        f"reads; setup {t_setup:.3f} s, its warm chunk {t_warm:.3f} s; "
        f"chunks (s): "
        f"{' '.join(f'{c:.3f}' for c in chunk_s)}")
    ctx = {"kind": "align", "wall": wall, "spans": spans, "chunk_s": chunk_s,
           "stages": stages, "lane_bases": lane_bases,
           "row_bytes": 4 * (12 if cfg["wide_index"] else 8),
           "trace": tracer.summary() if trace else None, "cfg": cfg}
    res = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": {"align_reads_per_s": {"value": n_reads / wall,
                                             "unit": "reads/s"},
                       "setup_s": {"value": t_setup, "unit": "s"}},
           "memory_peak_bytes": peak, "checks": checks, "ctx": ctx,
           "numbers": numbers, "outputs": {"warm": warm,
                                           "window": outputs}}
    if trace:
        res["device"] = {"busy_s": ctx["trace"]["busy_s"],
                         "window_s": ctx["trace"]["window_s"]}
        res["breakdown"] = ctx["trace"]["breakdown"]
    return res


# ---------------------------------------------------------------------------
# pileup
# ---------------------------------------------------------------------------

def pileup(cell, cfg, mix, seed, seconds, trace, device, t_proc, control,
           time_limits=None):
    warm_limit, call_limit = time_limits or (None, None)
    from .gen import bam as bmod
    from .ref import pileup_ref
    t_in = time.perf_counter()
    g, t_index = gmod.load_genome(cfg, log)
    tid = mix["region_chrom"]
    region = (mix["region_start"], mix["region_start"] + cfg[
        "pileup_region_bp"])
    names, lengths = g.names, np.diff(g.starts).tolist()
    tmp = _scratch()
    samples = []
    for k in range(mix["pool_bams"]):
        recs = rmod.pileup_records(g, cfg, (tid,) + region, mix["depth"],
                                   seed + k, f"s{seed % 100000}b{k}")
        path = os.path.join(tmp, f"sample{k}.bam")
        bmod.write_bam(path, names, lengths, recs)
        samples.append((path, recs))
    gc.freeze()  # the inputs' objects out of the collector's way
    t_inputs = time.perf_counter() - t_in - t_index
    log(f"[benchmark] inputs made in {t_inputs:.3f} s ({len(samples)} BAMs "
        f"of {len(samples[0][1])} reads; the index built in {t_index:.3f} "
        f"s, counted in setup_s)")

    from biscuit_tpu_torch import cli
    from biscuit_tpu_torch.pileup import engine as pe
    threads = os.cpu_count() if mix["threads"] == "cpu_count" else \
        int(mix["threads"])
    reg = f"{names[tid]}:{region[0]}-{region[1]}"

    def call(k, out):
        rc = cli.main(["pileup", "-@", str(threads), "-g", reg, "-o", out,
                       g.fasta, samples[k % len(samples)][0]])
        if rc != 0:
            raise RuntimeError(f"pileup exited {rc}")

    with time_limit(warm_limit, f"{cell['name']} warm call", t_proc):
        tw = time.perf_counter()
        call(0, os.path.join(tmp, "warm.vcf"))  # every kernel built and run
        sync(device)
        t_warm = time.perf_counter() - tw
    pe.reset_stages()
    if device.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(device)
    outputs, call_s = [], []
    tracer = tmod.Tracer(device) if trace else contextlib.nullcontext()
    t_setup = time.perf_counter() - t_proc - t_inputs
    with tracer:
        t0 = time.perf_counter()
        with tmod.span("benchmark.window"):
            k = 1
            while True:
                out = os.path.join(tmp, f"call{k}.vcf")
                with time_limit(call_limit, f"{cell['name']} window call "
                                f"{len(call_s)}", t_proc):
                    tc = time.perf_counter()
                    with tmod.span("benchmark.pileup_call"):
                        call(k, out)
                    sync(device)
                t1 = time.perf_counter()
                call_s.append(t1 - tc)
                outputs.append((k % len(samples), out))
                k += 1
                if t1 - t0 >= seconds:
                    break
        wall = time.perf_counter() - t0
    stages = dict(pe.STAGES)
    peak = memory_peak(device)
    gc.unfreeze()
    cli.report_launches("benchmark")
    n_sites = 0
    got = []
    for k, out in outputs:
        with open(out) as f:
            vcf = [ln for ln in f if not ln.startswith("#")]
        with open(out + "_meth_average.tsv") as f:
            tsv = f.readlines()
        n_sites += len(vcf)
        got.append((k, vcf, tsv))
    shutil.rmtree(tmp, ignore_errors=True)

    t = time.perf_counter()
    want, ctl = {}, {}
    ref = g.codes[g.starts[tid]:g.starts[tid + 1]]
    numbers = {"vcf_records_differ": 0, "tsv_lines_differ": 0}
    failed = 0
    for k, vcf, tsv in got:
        if k not in want:
            want[k] = pileup_ref.pileup(samples[k][1], names, lengths, tid,
                                        ref, region, samples[k][0])
            if control == "float32":  # the control in the program's place
                ctl[k] = pileup_ref.pileup(samples[k][1], names, lengths, tid,
                                           ref, region, samples[k][0],
                                           np.float32)
        if control == "float32":
            vcf, tsv = ctl[k]
        d = (pileup_ref.differ(vcf, want[k][0]),
             pileup_ref.differ(tsv, want[k][1]))
        numbers["vcf_records_differ"] += d[0]
        numbers["tsv_lines_differ"] += d[1]
        failed += any(d)
    log(f"[benchmark] reference {time.perf_counter() - t:.3f} s for "
        f"{len(want)} samples")
    correct, checks = judge(numbers, limits(cell))
    log(f"[benchmark] window {wall:.3f} s, {len(outputs)} calls, {n_sites} "
        f"sites; setup {t_setup:.3f} s, its warm call {t_warm:.3f} s; "
        f"calls (s): "
        f"{' '.join(f'{c:.3f}' for c in call_s)}")
    ctx = {"kind": "pileup", "wall": wall, "call_s": call_s, "stages": stages,
           "positions": len(outputs) * (min(region[1], lengths[tid])
                                        - region[0] - 1),
           "trace": tracer.summary() if trace else None, "cfg": cfg}
    res = {"correct": correct, "attempted": len(outputs), "failed": failed,
           "metrics": {"pileup_sites_per_s": {"value": n_sites / wall,
                                              "unit": "sites/s"},
                       "setup_s": {"value": t_setup, "unit": "s"}},
           "memory_peak_bytes": peak, "checks": checks, "ctx": ctx,
           "numbers": numbers, "outputs": got}
    if trace:
        res["device"] = {"busy_s": ctx["trace"]["busy_s"],
                         "window_s": ctx["trace"]["window_s"]}
        res["breakdown"] = ctx["trace"]["breakdown"]
    return res


LOOPS = {"align": align, "pileup": pileup}
