#!/usr/bin/env python3
"""Multi-process execution over torch.distributed, its parity and its
scaling.

Counterpart of tools/dist_run.py over the port. It launches n OS processes,
one rank each, joined in one process group (a file store in a temporary
directory; nccl where every rank has a card of its own, else gloo, as
parallel/mesh.backend_for decides: ranks that share one card share it
under gloo). Each rank pins itself to one core and runs, across the process
boundaries:

  * the production seeder, K3 (ops/seed_batch.collect_intv_flat), over its
    contiguous slice of a read pool with the index replicated in every rank
    (parallel/mesh.sharded_log_seed_fn: the source's pool seeder is not
    ported);
  * the pileup count merge: K9's general entry on each rank's slice and an
    all_reduce (sharded_pileup_counts_fn);
  * the PE insert-size exchange over the process group
    (parallel/exchange.TorchProcessAllgather).

Parity: the seed rows with their global read ids and the merged counts are
hashed; every n must give the hashes of the first n of --ns. Scaling:
efficiency = T1 / (n * Tn) of the seeding step. The table goes to --out
only (a JSON file, by default under the repository's gitignored build/).

The ranks run on BISCUIT_TPU_TORCH_DEVICE (default `cuda`; `cpu` runs the
plain versions under gloo).

Usage (from the repository's root):
    python -m biscuit_tpu_torch.tools.dist_run [--ns 1,2,4] [--reads 8192]
        [--genome 2000000] [--reps 3] [--out FILE]
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ----------------------------------------------------------------- child
def child(args):
    rank, n = args.rank, args.nprocs
    try:  # one pinned core per process => honest per-process scaling
        os.sched_setaffinity(0, {rank % os.cpu_count()})
    except OSError:
        pass
    import numpy as np
    import torch

    from biscuit_tpu_torch import kernels
    from biscuit_tpu_torch.align.pipeline import bsconvert
    from biscuit_tpu_torch.config import MemOpt
    from biscuit_tpu_torch.device import resolve
    from biscuit_tpu_torch.index.fmindex import BisIndex
    from biscuit_tpu_torch.io.fastq import fastq_iter, read_batch
    from biscuit_tpu_torch.ops.seed_batch import FMPair
    from biscuit_tpu_torch.parallel.exchange import TorchProcessAllgather
    from biscuit_tpu_torch.parallel.mesh import (init_group, make_mesh,
                                                 shard_bounds,
                                                 sharded_log_seed_fn,
                                                 sharded_pileup_counts_fn)

    torch.set_num_threads(1)
    backend, dev = init_group(rank, n, "file://" + args.store, resolve())
    mesh = make_mesh(n, dev)
    idx = BisIndex.load(os.path.join(args.data, "genome.fa"))
    fm = FMPair.from_index(idx, dev)
    opt = MemOpt()

    # deterministic read pool, identical in every process; each process
    # feeds only its shard rows
    seqs = read_batch(fastq_iter(os.path.join(args.data, "reads.fq")),
                      None, 1 << 60)[:args.reads]
    # N must be IDENTICAL across every n (the parity hash compares runs),
    # so truncate to a multiple of 48 = lcm of n*4 for n in {1,2,3,4}
    N = len(seqs) - len(seqs) % 48 or 48
    L = max((max(s.l_seq for s in seqs) + 31) // 32 * 32, 32)
    pool = np.full((N, L + 2), 4, np.int32)
    for i, s in enumerate(seqs[:N]):
        p = i & 1
        pool[i, :s.l_seq] = bsconvert(s, p)
        pool[i, L] = s.l_seq
        pool[i, L + 1] = p
    lo, hi = shard_bounds(N, mesh)
    lpool = torch.from_numpy(pool[lo:hi]).to(dev)

    fn = sharded_log_seed_fn(mesh, fm, opt)
    kernels.reset_launches()
    rows, rid, n_rows, ov = fn(lpool)
    # a flagged read is reseeded on the host by the aligner; this driver
    # has no such rerun, so a flag would change the rows with the partition
    # and fail the parity for a reason of its own: refuse it here
    assert not bool(ov.any()), "a read overflowed the seeder's S rows"
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        rows, rid, n_rows, ov = fn(lpool)  # the gather syncs the ranks
    dt = (time.perf_counter() - t0) / args.reps
    launches = dict(kernels.LAUNCHES)

    # parity hash: (rows, global read id) of every shard, sorted by read id
    # (each shard's stream is already in read order; the stable sort keeps
    # a read's rows in theirs)
    per = -(-N // n)
    shard = torch.repeat_interleave(torch.arange(n), n_rows)
    merged = torch.cat([rows.long().cpu(),
                        (rid.long().cpu() + shard * per)[:, None]], 1).numpy()
    order = np.argsort(merged[:, 5], kind="stable")
    seed_hash = hashlib.sha256(
        np.ascontiguousarray(merged[order]).tobytes()).hexdigest()

    # ---- pileup count merge across processes ----
    W = 1024
    rngp = np.random.default_rng(7)
    P_TOT = 1 << 16
    positions = rngp.integers(0, W, P_TOT).astype(np.int32)
    stat = rngp.integers(0, 30, P_TOT).astype(np.int32)
    valid = (rngp.random(P_TOT) < 0.9)
    plo, phi = shard_bounds(P_TOT, mesh)
    cnts = sharded_pileup_counts_fn(mesh, W)(
        *(torch.from_numpy(a[plo:phi]).to(dev)
          for a in (positions, stat, valid)))
    counts_hash = hashlib.sha256(cnts.cpu().numpy().tobytes()).hexdigest()

    # ---- pes exchange over the process group ----
    ex = TorchProcessAllgather()
    my_isizes = list(range(rank * 10, rank * 10 + 3 + rank))
    pooled = ex(my_isizes)
    want = []
    for r in range(n):
        want.extend(range(r * 10, r * 10 + 3 + r))
    assert pooled == want, (pooled, want)

    out = {"n": n, "rank": rank, "t_per_rep_s": dt, "seed_hash": seed_hash,
           "counts_hash": counts_hash, "N": int(N), "rows": int(len(merged)),
           "backend": backend, "device": str(dev), "launches": launches}
    with open(os.path.join(args.data, f"result_n{n}_r{rank}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# ----------------------------------------------------------------- parent
def parent(args):
    from biscuit_tpu_torch.device import resolve
    resolve()  # no card: fail here, not in every rank
    if args.data:
        return _parent(args, args.data)
    with tempfile.TemporaryDirectory(prefix="bt_dist_data") as data:
        return _parent(args, data)


def _parent(args, data):
    env = dict(os.environ, PYTHONPATH=REPO)
    if not os.path.exists(os.path.join(data, "genome.fa")):
        os.makedirs(data, exist_ok=True)
        subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "make_testdata.py"),
             data, "--genome-size", str(args.genome),
             "--n-reads", str(args.reads)],
            check=True, capture_output=True)
        # build the index once; children load the saved files
        subprocess.run(
            [sys.executable, "-m", "biscuit_tpu_torch.cli", "index",
             os.path.join(data, "genome.fa")],
            check=True, capture_output=True, cwd=REPO, env=env)

    results = {}
    for n in [int(x) for x in args.ns.split(",")]:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="bt_dist_store") as td:
            procs = [subprocess.Popen(
                [sys.executable, "-m", "biscuit_tpu_torch.tools.dist_run",
                 "--child", "--rank", str(r), "--nprocs", str(n),
                 "--store", os.path.join(td, "store"), "--data", data,
                 "--reads", str(args.reads), "--reps", str(args.reps)],
                cwd=REPO, env=env)
                for r in range(n)]
            rcs = [p.wait() for p in procs]
        assert all(rc == 0 for rc in rcs), f"n={n} ranks failed: {rcs}"
        ranks = []
        for r in range(n):
            with open(os.path.join(data, f"result_n{n}_r{r}.json")) as f:
                ranks.append(json.load(f))
        res = dict(ranks[0])
        res["wall_s"] = time.perf_counter() - t0
        res["t_per_rep_s"] = max(x["t_per_rep_s"] for x in ranks)
        res["launches"] = {}
        for x in ranks:
            assert (x["seed_hash"], x["counts_hash"]) == \
                (res["seed_hash"], res["counts_hash"]), "ranks disagree"
            for k, v in x["launches"].items():
                res["launches"][k] = res["launches"].get(k, 0) + v
        results[n] = res
        print(f"[dist] n={n}: {json.dumps(res)}", flush=True)

    ns = list(results)
    base = results[ns[0]]
    table = []
    for n in ns:
        r = results[n]
        assert r["seed_hash"] == base["seed_hash"], "seed parity broke"
        assert r["counts_hash"] == base["counts_hash"], "count parity broke"
        eff = base["t_per_rep_s"] * ns[0] / (n * r["t_per_rep_s"])
        table.append({"n_procs": n, "t_per_rep_s": r["t_per_rep_s"],
                      "wall_s": r["wall_s"],
                      "speedup": base["t_per_rep_s"] / r["t_per_rep_s"],
                      "efficiency": eff, "backend": r["backend"],
                      "device": r["device"], "launches": r["launches"]})
    out = {"workload": f"K3 seeder, N={base['N']} reads "
                       f"({base['rows']} seed rows), 1 core/proc",
           "parity": "seed + all_reduce count hashes identical across n",
           "table": table}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--nprocs", type=int, default=1)
    ap.add_argument("--store", default="")
    ap.add_argument("--data", default="",
                    help="data directory (default: a new temporary one)")
    ap.add_argument("--reads", type=int, default=8192)
    ap.add_argument("--genome", type=int, default=2_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ns", default="1,2,4")
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "dist_scaling.json"))
    args = ap.parse_args()
    if args.child:
        child(args)
    else:
        parent(args)


if __name__ == "__main__":
    main()
