#!/usr/bin/env python3
"""The routed walks of an FM index sharded over ranks (kernels/fm_route.cu:
smem_route_step, sa_route_step), timed on the card at a real size.

It starts --ranks processes, one rank each, joined in a process group (a
file store in a temporary directory; nccl where every rank has a card of
its own, else gloo with the ranks sharing the card, as
parallel/mesh.backend_for decides). Each rank holds its shard of the FM
tables (ops/seed_batch.fm_shard) and, in lockstep with the others:

  * seeds the lanes of --reads reads of --data, each read both ways as the
    hybrid engine's seeder converts it, through collect_intv_flat on its
    shard (the routed seeder, one step kernel launch and one collective a
    step), for each k of --ks (ops/seed_batch.ROUTE_SYNC_EVERY, the steps
    enqueued between host reads under nccl); the seeds must equal K3's on
    the whole tables;
  * walks --sa random ranks through sa_batch on its shard (the routed SA
    walk, at the tree's own k); the positions must equal K4's on the
    whole tables;
  * with --plain, runs each walk's plain version once on the same shard
    (collect_intv_flat_plain, sa_batch_plain: every row read routed through
    seed_batch._tab_row, one collective each), which the kernels' output
    must equal.

For each walk rank 0 prints the mean wall of a call over --reps calls, its
steps (the step kernel's launches), the rows they asked for
(seed_batch.ROUTED_ROWS), the step kernel's launches alone and
route_gather's (launches and time) by CUDA events, taken around each launch
by a wrapper of kernels.launch, so that the same measurement runs on
another tree of this repository (--tree DIR: its biscuit_tpu_torch is
imported instead), for an A/B on one card; with --plain the plain
version's wall. One JSON line on stdout.

Usage (from the repository's root, on a card):
    python -m biscuit_tpu_torch.tools.route_bench --data DIR [--reads 4096]
        [--ranks 2] [--ks 8] [--sa 20000] [--reps 2] [--plain]
    python biscuit_tpu_torch/tools/route_bench.py --tree OTHER ...
DIR holds genome.fa with the port's index and reads.fq. With --tree run the
file by its path: under -m the spawned ranks import this checkout's
package before the tree's.
"""
import argparse
import json
import os
import sys
import tempfile
import time

WALKS = ("smem_route_step", "sa_route_step")


def _rank(rank, args, store, out):
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch
    import torch.distributed as dist

    from biscuit_tpu_torch import kernels
    from biscuit_tpu_torch.align.pipeline import bsconvert
    from biscuit_tpu_torch.config import MemOpt
    from biscuit_tpu_torch.index.fmindex import BisIndex
    from biscuit_tpu_torch.io.fastq import fastq_iter, read_batch
    from biscuit_tpu_torch.ops import seed_batch as sb
    from biscuit_tpu_torch.parallel.mesh import init_group

    torch.set_num_threads(1)
    backend, dev = init_group(rank, args.ranks, "file://" + store, "cuda")
    events = {k: [] for k in WALKS + ("route_gather",)}
    real_launch = kernels.launch

    def launch(lib, fn, kernel, device, *a):
        if kernel not in events:
            return real_launch(lib, fn, kernel, device, *a)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        real_launch(lib, fn, kernel, device, *a)
        ev[1].record()
        events[kernel].append(ev)
    kernels.launch = launch

    idx = BisIndex.load(os.path.join(args.data, "genome.fa"))
    fm = sb.FMPair.from_index(idx, dev)
    shard = sb.fm_shard(fm, args.ranks, rank, dist.group.WORLD)
    seqs = read_batch(fastq_iter(os.path.join(args.data, "reads.fq")), None,
                      1 << 60)[:args.reads]
    L = max(s.l_seq for s in seqs)
    q = np.full((2 * len(seqs), L), 4, np.int32)
    lens = np.zeros(2 * len(seqs), np.int32)
    for i, s in enumerate(seqs):
        for p in (0, 1):
            q[2 * i + p, :s.l_seq] = bsconvert(s, p)
            lens[2 * i + p] = s.l_seq
    par = np.arange(2 * len(seqs), dtype=np.int32) % 2
    q, lens, par = (torch.from_numpy(a).to(dev) for a in (q, lens, par))
    rng = np.random.default_rng(7)
    which = torch.from_numpy(rng.integers(0, 2, args.sa).astype(np.int32))
    ranks = torch.from_numpy(rng.integers(1, fm.seq_len, args.sa)).to(fm.rdt)
    which, ranks = which.to(dev), ranks.to(dev)
    opt = MemOpt()

    def same(got, want):
        got = got if isinstance(got, tuple) else (got,)
        return all(torch.equal(a, b) for a, b in zip(got, want))

    def timed(name, fn, want, plain=None):
        if not same(fn(), want):  # a warm-up, held to the whole tables'
            raise AssertionError(f"{name} differs from the whole tables'")
        for v in events.values():
            v.clear()
        sb.ROUTED_ROWS[name] = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3 / args.reps
        steps = len(events[name]) / args.reps
        alone = {k: sum(a.elapsed_time(b) for a, b in v) / args.reps
                 for k, v in events.items()}
        out = {"call_ms": wall, "steps": steps, "launch_ms": alone[name],
               "rows": sb.ROUTED_ROWS[name] / args.reps,
               "gather_ms": alone["route_gather"],
               "gathers": len(events["route_gather"]) / args.reps,
               "ms_a_step": wall / steps}
        if plain is not None:
            t0 = time.perf_counter()
            got = plain()
            torch.cuda.synchronize(dev)
            out["plain_ms"] = (time.perf_counter() - t0) * 1e3
            if not same(got, want):
                raise AssertionError(f"{name}'s plain version differs")
        return out

    want = sb.collect_intv_flat(fm, q, lens, par, opt)
    k0 = getattr(sb, "ROUTE_SYNC_EVERY", None)  # the tree's own k
    seed = []
    for i, k in enumerate(int(x) for x in args.ks.split(",")):
        sb.ROUTE_SYNC_EVERY = k
        seed.append(dict(k=k, **timed(
            "smem_route_step",
            lambda: sb.collect_intv_flat(shard, q, lens, par, opt), want,
            (lambda: sb.collect_intv_flat_plain(shard, q, lens, par, opt))
            if args.plain and i == 0 else None)))
    sb.ROUTE_SYNC_EVERY = k0
    sa = timed("sa_route_step", lambda: sb.sa_batch(shard, which, ranks),
               (sb.sa_batch(fm, which, ranks),),
               (lambda: sb.sa_batch_plain(shard, which, ranks))
               if args.plain else None)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"ranks": args.ranks, "backend": backend,
                       "lanes": int(q.shape[0]), "read_len": L,
                       "row_bytes": int(fm.tab.shape[-1]) * 4,
                       "io_bytes": {"smem_route_step": sum(
                           t.numel() * t.element_size()
                           for t in (q, lens, par, *want)),
                           "sa_route_step": 2 * ranks.numel()
                           * ranks.element_size() + which.numel() * 4},
                       "sa_jobs": args.sa, "tree": args.tree or ".",
                       "device": torch.cuda.get_device_name(dev),
                       "seed": seed, "sa": sa}, f)
    dist.barrier()
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--ks", default="8")
    ap.add_argument("--sa", type=int, default=20000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--tree", default="")
    args = ap.parse_args()
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="route_bench_") as td:
        out = os.path.join(td, "out.json")
        mp.start_processes(_rank, args=(args, os.path.join(td, "store"), out),
                           nprocs=args.ranks, join=True, start_method="spawn")
        with open(out) as f:
            print(json.dumps(json.load(f)), flush=True)


if __name__ == "__main__":
    main()
