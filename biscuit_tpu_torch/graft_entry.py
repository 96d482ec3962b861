"""Driver entry points of the port: one batched seeding step, and the
multi-device dry run over torch.distributed.

Counterpart of the repository's __graft_entry__.py. entry() returns one
batched seeding step: K3 (ops/seed_batch.collect_intv_flat) in place of the
JAX forward_extend_all of ops/seed_parallel.py, on the same tiny 20 kbp
genome and 64 reads of 96 bp, made with the same numpy seeds.

dryrun_multichip(n) spawns n ranks joined in a process group (a file store
in a temporary directory) and runs the eight stages of the source's dry run
over them, each held to its one-rank run in every rank:
  1. K3 seeding with the reads sharded (sharded_seed_fn);
  2. K1 extension with the lanes sharded (sharded_extend_fn);
  3. K9's count merge on CIGAR-expanded data (sharded_pileup_counts_fn):
     the merged total must be the number of data;
  4. the per-read seed sets from the sharded pool, with the source's
     per_read bookkeeping and shard offsets (the source runs its pool
     seeder; the port K3 through sharded_log_seed_fn);
  5. each shard's rows equal K3 on that slice of the pool;
  6. K6 with the lanes of the [J, B] planes sharded (sharded_chain_fn);
  7. K7 with the lanes sharded (sharded_rescue_fn);
  8. the index sharded over an (n_dp, n_idx) grid (n_dp 2 from 4 ranks on,
     else 1): the seeds and the SA walk equal those of the replicated
     tables (sharded_index_seed_fn, sharded_index_sa_fn). On a card they
     run the step kernels of kernels/fm_route.cu, which each rank then
     holds to the plain machines on its shard (_routed_checks), with the
     steps each walk took and its launches alone.
Every entry point runs on the card unless the caller names another device;
with no card it raises. Ranks on one card share it under gloo; nccl only
where each rank has a card of its own (parallel/mesh.backend_for).

    python -m biscuit_tpu_torch.graft_entry [n]
"""
import json
import os
import sys
import tempfile
import time

import numpy as np

L_SEED, L_POOL = 96, 64  # read lengths of entry() and of the dry run


def _tiny_index():
    from .index.build import build_index
    rng = np.random.default_rng(0)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    with tempfile.TemporaryDirectory(prefix="graft_") as td:
        path = os.path.join(td, "tiny.fa")
        with open(path, "w") as f:
            f.write(">chr1\n")
            f.write(seq + "\n")
        return build_index(path)


def _reads(idx, B, L, seed=1):
    """Simulated bisulfite reads drawn from the tiny genome."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, L), np.int32)
    for b in range(B):
        p = int(rng.integers(0, idx.l_pac - L))
        frag = idx.pac[p:p + L].astype(np.int32)
        conv = np.where(frag == 1, 3, frag)  # C->T (parent strand read)
        q[b] = conv
    lens = np.full(B, L, np.int32)
    parents = np.ones(B, np.int32)
    return q, lens, parents


def entry(device=None):
    """(step, args): one batched seeding step on tensors on `device` (the
    card unless the caller names another)."""
    import torch

    from .config import MemOpt
    from .device import resolve
    from .ops.seed_batch import FMPair, collect_intv_flat

    dev = resolve(device)
    idx = _tiny_index()
    fm = FMPair.from_index(idx, dev)
    opt = MemOpt()  # min_seed_len 19, max_mem_intv 20: the source's step
    q, lens, parents = _reads(idx, 64, L_SEED)

    def step(fm, q, lens, parents):
        return collect_intv_flat(fm, q, lens, parents, opt)

    T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return step, (fm, T(q), T(lens), T(parents))


def stage_inputs(idx, n_devices: int) -> dict:
    """The numpy inputs of the dry run's stages at n ranks, made as the
    source makes them: {stage: arrays}."""
    from .config import MemOpt
    from .pileup.common import (BASE_A, BASE_C, BASE_G, BASE_T,
                                METH_CONVERSION, METH_NA, METH_RETENTION,
                                NSTATUS_METH)
    opt = MemOpt()
    B, L = 8 * n_devices, L_POOL
    q, lens, parents = _reads(idx, B, L)
    t = np.zeros((B, 2 * L), np.int32)
    for b in range(B):
        t[b, :2 * L] = np.resize(q[b], 2 * L)
    out = {"seed": (q, lens, parents),
           "extend": (q, lens, t, np.full(B, 2 * L, np.int32), parents,
                      np.full(B, opt.w, np.int32),
                      np.full(B, opt.pen_clip5, np.int32),
                      np.full(B, 19, np.int32))}

    W = 128
    rng = np.random.default_rng(3)
    pos_l, stat_l = [], []
    code_map = np.array([BASE_A, BASE_C, BASE_G, BASE_T], np.int32)
    for _ in range(8 * n_devices):
        rp = int(rng.integers(0, W - L))
        frag = idx.pac[rp:rp + L].astype(np.int32)
        keep = rng.random(L) < 0.3
        read = np.where((frag == 1) & ~keep, 3, frag)
        meth = np.where(frag == 1,
                        np.where(read == 1, METH_RETENTION, METH_CONVERSION),
                        METH_NA)
        pos_l.append(np.arange(rp, rp + L, dtype=np.int32))
        stat_l.append((meth | (code_map[read] << 4)).astype(np.int32))
    pos = np.concatenate(pos_l)
    stat = np.concatenate(stat_l)
    # the engine's code of a stat, base * 3 + meth (pileup/engine.py
    # _mesh_counts): K9 refuses a code past n_codes, which the source's
    # scatter-add lets spill into the next site's bins
    code = (stat >> 4) * NSTATUS_METH + (stat & 0xF)
    out["pileup"] = (pos, code.astype(np.int32), np.ones(len(pos), bool), W)

    Np = 8 * n_devices
    qp, lensp, parsp = _reads(idx, Np, L, seed=4)
    pool = np.full((Np, L + 2), 4, np.int32)
    pool[:, :L] = qp
    pool[:, L] = lensp
    pool[:, L + 1] = parsp
    out["pool"] = pool

    rngc = np.random.default_rng(7)
    J, Bc = 32, 8 * n_devices
    l_pac = int(idx.l_pac)
    out["chain"] = ((
        rngc.integers(0, 60, (J, Bc)).astype(np.int32),
        rngc.integers(19, 40, (J, Bc)).astype(np.int32),
        rngc.integers(0, 2 * l_pac - 64, (J, Bc)).astype(np.int32),
        (rngc.random((J, Bc)) < 0.9).astype(np.int32),
        np.zeros((J, Bc), np.int32),
        np.tile((np.arange(J) % 4).astype(np.int32)[:, None], (1, Bc)),
        rngc.integers(0, J + 1, Bc).astype(np.int32)),
        l_pac, int(opt.w), int(opt.max_chain_gap), 500, 16)

    rngr = np.random.default_rng(8)
    Br, Lq, Lt = 8 * n_devices, 48, 96
    qr = rngr.integers(0, 4, (Br, Lq)).astype(np.int32)
    out["rescue"] = (
        qr, np.full(Br, Lq, np.int32),
        rngr.integers(0, 4, (Br, Lt)).astype(np.int32),
        np.full(Br, Lt, np.int32),
        np.stack([opt.gamat, opt.ctmat]).astype(np.int32),
        rngr.integers(0, 2, Br).astype(np.int32),
        np.full(Br, 20, np.int32), np.full(Br, 0xFFFF, np.int32),
        rngr.integers(0, 2, Br).astype(np.int32))

    n_dp = 2 if n_devices >= 4 else 1
    rngs = np.random.default_rng(9)
    wide = idx.dau.sa_samples.dtype.itemsize == 8
    ranks = rngs.integers(1, int(idx.dau.seq_len), 8 * n_dp).astype(
        np.int64 if wide else np.int32)
    whichs = rngs.integers(0, 2, 8 * n_dp).astype(np.int32)
    out["grid"] = (n_dp, n_devices // n_dp)
    out["sa"] = (whichs, ranks)
    return out


def _per_read(rows, rid, off):
    """{global read id: [row, ...]} of a seeder's rows (the source's
    per_read, the shard's offset added)."""
    d = {}
    for row, r in zip(rows.tolist(), rid.tolist()):
        d.setdefault(int(r) + off, []).append(tuple(row))
    return d


def _shards(n_rows):
    """[lo, hi) of each shard's rows in a gathered seeder output."""
    ends = np.cumsum([int(m) for m in n_rows])
    return list(zip(ends - np.asarray([int(m) for m in n_rows]), ends))


def _same(name, got, want):
    """Exact equality of tensors (or tuples or dicts of them)."""
    import torch
    if isinstance(want, dict):
        got, want = [got[k] for k in want], list(want.values())
    elif not isinstance(want, (tuple, list)):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"sharded {name} diverged from one rank")


def _stages(n, dev):
    """The eight stages in this rank: (summary of the source's line, seconds
    a stage, kernel launches of the sharded calls)."""
    import torch

    from . import kernels
    from .config import MemOpt
    from .ops.chain_batch import chain_scan_batch
    from .ops.pileup_count import pileup_count_window
    from .ops.seed_batch import FMPair, collect_intv_flat, sa_batch
    from .ops.sw_extend import sw_extend_batch
    from .ops.sw_local import sw_local_batch
    from .parallel.mesh import (local_slice, make_mesh, make_mesh2,
                                sharded_chain_fn, sharded_extend_fn,
                                sharded_index_sa_fn, sharded_index_seed_fn,
                                sharded_log_seed_fn, sharded_pileup_counts_fn,
                                sharded_rescue_fn, sharded_seed_fn)

    idx = _tiny_index()
    fm = FMPair.from_index(idx, dev)
    opt = MemOpt()
    mesh = make_mesh(n, dev)
    inp = stage_inputs(idx, n)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    loc = lambda a, m=mesh, axis="dp", dim=0: local_slice(  # noqa: E731
        T(a), m, axis, dim)
    seconds, launches, summary = {}, {}, {}

    def sharded(stage, fn):
        """fn() timed, and its kernel launches counted, as the stage's
        sharded run."""
        before = dict(kernels.LAUNCHES)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[stage] = time.perf_counter() - t0
        for k, v in kernels.LAUNCHES.items():
            if v - before.get(k, 0):
                launches[k] = launches.get(k, 0) + v - before.get(k, 0)
        return out

    # 1. seeding, reads sharded
    q, lens, parents = inp["seed"]
    got = sharded("1 seed", lambda: sharded_seed_fn(mesh, fm, L_POOL, 19, 20)(
        loc(q), loc(lens), loc(parents)))
    _same("seeding", got, collect_intv_flat(fm, T(q), T(lens), T(parents), opt))
    summary["max_end"] = int(got[1][:, 1].max())

    # 2. banded extension, lanes sharded
    mats = T(np.stack([opt.gamat, opt.ctmat]).astype(np.int32))
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    ext = inp["extend"]
    got = sharded("2 extend", lambda: sharded_extend_fn(
        mesh, mats, *sc, opt.zdrop)(*(loc(a) for a in ext)))
    qe, le, te, tle, msel, w, eb, h0 = (T(a) for a in ext)
    _same("extension", got, sw_extend_batch(qe, le, te, tle, mats, msel, *sc,
                                            w, eb, opt.zdrop, h0))
    summary["scores"] = got[0, :4].tolist()

    # 3. pileup counts of CIGAR-expanded data, merged across ranks
    pos, stat, valid, W = inp["pileup"]
    got = sharded("3 pileup counts", lambda: sharded_pileup_counts_fn(
        mesh, W)(loc(pos), loc(stat), loc(valid)))
    _same("pileup counts", got, pileup_count_window(T(pos), T(stat),
                                                    T(valid), W))
    summary["total"] = int(got.sum())
    if summary["total"] != len(pos):
        raise AssertionError(f"the count merge lost data: {summary['total']} "
                             f"!= {len(pos)}")

    # 4. per-read seed sets from the sharded pool
    pool = inp["pool"]
    Np, L = pool.shape[0], pool.shape[1] - 2
    N_l = -(-Np // n)
    lfn = sharded_log_seed_fn(mesh, fm, opt)
    rows, rid, n_rows, _ov = sharded("4 pool seeds", lambda: lfn(loc(pool)))
    got = {}
    for s, (lo, hi) in enumerate(_shards(n_rows)):
        got.update(_per_read(rows[lo:hi], rid[lo:hi], s * N_l))
    lane, rows, _ = collect_intv_flat(fm, T(pool[:, :L]), T(pool[:, L]),
                                      T(pool[:, L + 1]), opt)
    want = _per_read(rows, lane, 0)
    if got != want:
        raise AssertionError("sharded pool seeding diverged from one rank")
    summary["pool_reads"] = len(want)

    # 5. each shard's rows equal K3 on its slice of the pool
    def shard_rows(out, pool_of, n_sh, what):
        rows, rid, n_rows, _ov = out
        per = -(-pool_of.shape[0] // n_sh)
        for s, (lo, hi) in enumerate(_shards(n_rows)):
            sl = pool_of[s * per:(s + 1) * per]
            lane, want, _ = collect_intv_flat(fm, T(sl[:, :L]), T(sl[:, L]),
                                              T(sl[:, L + 1]), opt)
            if not (torch.equal(rid[lo:hi], lane)
                    and torch.equal(rows[lo:hi], want)):
                raise AssertionError(f"{what} diverged from one rank")

    out = sharded("5 log seeds", lambda: lfn(loc(pool)))
    shard_rows(out, pool, n, "sharded log seeding")
    summary["log_rows"] = int(out[0].shape[0])

    # 6. chaining, lanes of the [J, B] planes sharded
    planes, l_pac, cw, gap, max_occ, NC = inp["chain"]
    got = sharded("6 chain", lambda: sharded_chain_fn(
        mesh, cw, gap, max_occ, NC=NC)(
        *(loc(a, dim=1) for a in planes[:6]), loc(planes[6]), l_pac))
    _same("chaining", got, chain_scan_batch(*(T(a) for a in planes), l_pac,
                                            cw, gap, max_occ, NC=NC))
    summary["chain_lanes"] = planes[0].shape[1]

    # 7. mate rescue, lanes sharded
    ra = inp["rescue"]
    got = sharded("7 rescue", lambda: sharded_rescue_fn(mesh, *sc)(
        *(T(a) if i == 4 else loc(a) for i, a in enumerate(ra))))
    _same("rescue", got, sw_local_batch(*(T(a) for a in ra[:6]), *sc,
                                        *(T(a) for a in ra[6:])))
    summary["rescue_lanes"] = ra[0].shape[0]

    # 8. the index sharded over idx, the pool over dp
    n_dp, n_idx = inp["grid"]
    mesh2 = make_mesh2(n_dp, n_idx, dev)
    loc2 = lambda a: loc(a, mesh2)  # noqa: E731
    out = sharded("8 index-sharded seeds", lambda: (
        sharded_index_seed_fn(mesh2, fm, opt)(loc2(pool))))
    shard_rows(out, pool, n_dp, "sharded-index seeding")
    whichs, ranks = inp["sa"]
    got = sharded("8 index-sharded SA walk", lambda: sharded_index_sa_fn(
        mesh2, fm)(loc2(whichs), loc2(ranks)))
    _same("index SA walk", got, sa_batch(fm, T(whichs), T(ranks)))
    summary["grid"] = [n_dp, n_idx]
    routed = _routed_checks(mesh2, fm, loc2(pool), loc2(whichs), loc2(ranks),
                            opt) if dev.type == "cuda" and n_idx > 1 else {}
    return summary, seconds, launches, routed


def _wall_ms(fn, dev, reps=1):
    """Milliseconds a call of fn, the card synchronized around reps calls."""
    import torch
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / reps, out


def _routed_checks(mesh2, fm, pool, whichs, ranks, opt):
    """Stage 8's kernels (kernels/fm_route.cu) on this rank's shard and
    inputs, held to their plain versions on the same device: {kernel:
    (max |d|, ms, plain ms, bytes, operations, steps)}, ms the walk's whole
    call, the bytes those of the rows the walk asked for (a row read once a
    step), its inputs and outputs (steps None for route_gather, whose ms is
    its launch). Every rank of the idx group runs them in lockstep.
    Launches here are no stage's."""
    import torch

    from .ops import seed_batch as sb
    from .parallel.mesh import _local_fm

    dev = pool.device
    fml = _local_fm(mesh2, fm)
    L = pool.shape[1] - 2
    a = (pool[:, :L], pool[:, L], pool[:, L + 1])
    row_bytes = fml.tab.shape[-1] * 4
    out = {}

    def held(name, kern, plain, io_bytes):
        sb.reset_routed()
        ms, got = _wall_ms(kern, dev)
        rows, steps = sb.ROUTED_ROWS[name], sb.ROUTED_STEPS[name]
        plain_ms, want = _wall_ms(plain, dev)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        _same(f"{name} against its plain machine", got, want)
        n_bytes = rows * row_bytes + io_bytes(got)
        # an occ4 from a row: about 16 popcounts and 48 shifts, masks, adds
        out[name] = (0, ms, plain_ms, n_bytes, 64 * rows, steps)

    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    held("smem_route_step",
         lambda: sb.collect_intv_flat(fml, *a, opt),
         lambda: sb.collect_intv_flat_plain(fml, *a, opt),
         lambda got: nb(*a, *got))
    held("sa_route_step", lambda: sb.sa_batch(fml, whichs, ranks),
         lambda: sb.sa_batch_plain(fml, whichs, ranks),
         lambda got: nb(whichs, ranks, *got))
    # route_gather, the SA samples' gather at the end of a walk, at the
    # seeder's shape
    g = torch.from_numpy(np.random.default_rng(11).integers(
        -1, 2 * fml.n64_global, 2 * pool.shape[0])).to(dev)
    lo = fml.shard_index * fml.tab.shape[0]
    ms, got = _wall_ms(lambda: sb.route_gather(fml.tab, lo, g), dev, 20)
    plain_ms, want = _wall_ms(lambda: sb.route_gather_plain(fml.tab, lo, g),
                              dev, 20)
    _same("route_gather against its plain version", got, want)
    out["route_gather"] = (0, ms, plain_ms, nb(g) + 2 * nb(got), 2 * g.numel(),
                           None)
    return out


def _rank(rank, n, store, device, out_dir):
    """One rank of the dry run: join the group, run the stages, write its
    report to <out_dir>/rank<r>.json."""
    import torch
    import torch.distributed as dist

    from . import kernels
    from .parallel.mesh import init_group

    torch.set_num_threads(1)
    backend, dev = init_group(rank, n, "file://" + store, device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary, seconds, launches, routed = _stages(n, dev)
    report = {"rank": rank, "backend": backend, "device": str(dev),
              "summary": summary, "seconds": seconds, "launches": launches,
              "routed": routed,
              "wall": time.perf_counter() - t0,
              "foreign": [m for m in sys.modules
                          if m.split(".")[0] in ("jax", "biscuit_tpu")]}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The eight sharded stages over n ranks spawned here, each equal to its
    one-rank run in every rank (or an exception). Prints the source's
    closing line and returns {"line", "backend", "nccl", "device", "seconds"
    (a stage's slowest rank), "launches" (the kernels the ranks' sharded
    calls launched, summed over ranks), "routed" (on a card, with the index
    sharded: rank 0's _routed_checks), "wall" (spawn included)}."""
    import torch.multiprocessing as mp

    from .device import resolve

    dev = resolve(device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as td:
        mp.start_processes(_rank, args=(n_devices, os.path.join(td, "store"),
                                        str(dev), td),
                           nprocs=n_devices, join=True, start_method="spawn")
        reports = []
        for r in range(n_devices):
            with open(os.path.join(td, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    wall = time.perf_counter() - t0
    foreign = sorted({m for r in reports for m in r["foreign"]})
    if foreign:
        raise AssertionError(f"a rank imported {foreign}")
    s = reports[0]["summary"]
    n_dp, n_idx = s["grid"]
    line = (f"dryrun_multichip n={n_devices}: seeds max_end={s['max_end']}, "
            f"extend scores[:4]={s['scores']}, pileup counts merged="
            f"{s['total']}, pool-seeder reads={s['pool_reads']}, log-seeder "
            f"rows={s['log_rows']}, chain+rescue lanes={s['chain_lanes']}+"
            f"{s['rescue_lanes']}, sharded-index mesh=({n_dp},{n_idx})"
            f" (all sharded == single-device)")
    print(line, flush=True)
    launches = {}
    for r in reports:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    backend = reports[0]["backend"]
    return {"line": line, "backend": backend, "nccl": backend == "nccl",
            "device": reports[0]["device"],
            "seconds": {k: max(r["seconds"][k] for r in reports)
                        for k in reports[0]["seconds"]},
            "launches": launches, "routed": reports[0]["routed"],
            "wall": wall}


if __name__ == "__main__":
    fn, args = entry()
    lane_of, rows, ov = fn(*args)
    print("entry ok:", tuple(rows.shape), "rows of", int(ov.numel()), "lanes")
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else
                     int(os.environ.get("NDEV", "2")))
