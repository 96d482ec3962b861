"""Multi-device execution over torch.distributed: read-shard data
parallelism, pileup counts merged across ranks, and the FM index sharded
over ranks.

Port of biscuit_tpu/parallel/mesh.py. JAX runs one process over an
n-device Mesh through shard_map; PyTorch runs one process a device, joined
in a process group (what torchrun sets up). So a `Mesh` here is this
rank's place in a grid of ranks: for each axis (`dp`, and `idx` on the grid
of make_mesh2) its size, this rank's coordinate and the process group of
the ranks along it. The JAX constructs map so:

    in_specs=P("dp")       each rank passes its own contiguous slice
                           (shard_bounds / local_slice)
    out_specs=P("dp")      all_gather into rank order, so every rank holds
                           the global array the JAX function returns
    psum                   all_reduce(SUM)

A mesh of one rank makes no collective call. Slices may differ in size by
one row: every gather exchanges the sizes first.

Each sharded function runs the port's op on this rank's slice: K3
(ops/seed_batch.collect_intv_flat) in place of the source's
forward_extend_all and pool seeders (ops/seed_parallel.py and the archive
seeders are not ported), K1 sw_extend_batch, K9's general entry
pileup_count_window, K6 chain_scan_batch and K7 sw_local_batch; each op
launches its kernel on a CUDA device and runs its plain version on the CPU.
On an index sharded over `idx` the seeder and the SA walk go by steps, a
kernel cannot call a collective in the middle of a walk: on a CUDA device
each step is one launch (kernels/fm_route.cu) and one sum of the rows it
asked for over the group; on the CPU the plain machines do the same sum at
each row read (seed_batch._tab_row).

`align` runs on an index sharded over ranks under
BISCUIT_TPU_TORCH_INDEX_SHARD=n (index_shard_mesh, index_sharded_seeder):
WORLD_SIZE ranks started with torchrun's variables, a make_mesh2 grid of
WORLD_SIZE // n by n.

Backends (`backend_for`): nccl where every rank has a card of its own
(torch.cuda.device_count() >= world size), else gloo: on the CPU, and for
ranks that share one card, whose tensors then cross the collectives through
host copies. The choice follows from the device count alone; nothing runs a
failed collective again on another backend.
"""
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..config import MemOpt
from ..ops.chain_batch import chain_scan_batch
from ..ops.pileup_count import pileup_count_window  # K9's general entry
from ..ops.seed_batch import FMPair, collect_intv_flat, fm_shard, sa_batch
from ..ops.sw_extend import sw_extend_batch
from ..ops.sw_local import sw_local_batch


def backend_for(device, world_size: int) -> str:
    """nccl where every rank can have a card of its own, else gloo (the CPU,
    or ranks that share a card: NCCL refuses two ranks on one GPU)."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_group(rank: int, world_size: int, init_method: str, device,
               local_rank: int = None):
    """Join the process group as `rank` of world_size under the backend of
    backend_for. Returns (backend, this rank's device): cuda:local_rank
    under nccl, the shared cuda:0 under gloo, else `device`."""
    device = torch.device(device)
    backend = backend_for(device, world_size)
    if device.type == "cuda":
        device = torch.device(
            "cuda", (rank if local_rank is None else local_rank)
            if backend == "nccl" else 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend, device


def init_from_env(device):
    """Join the group that torchrun's variables (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) describe, when WORLD_SIZE is
    above 1. Returns (world size, rank, backend or None, device)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 1, 0, None, torch.device(device)
    rank = int(os.environ["RANK"])
    backend, device = init_group(rank, world, "env://", device,
                                 int(os.environ.get("LOCAL_RANK", rank)))
    return world, rank, backend, device


# align's switch: the FM index sharded over n ranks of the group that
# torchrun's variables describe (the source's BISCUIT_TPU_INDEX_SHARD)
INDEX_SHARD_ENV = "BISCUIT_TPU_TORCH_INDEX_SHARD"


def index_shard_mesh(device):
    """The grid of BISCUIT_TPU_TORCH_INDEX_SHARD=n: None when the variable
    is unset or at most 1; else, when WORLD_SIZE is a multiple of n above
    1, this rank joins the group (init_from_env) and gets its place in the
    make_mesh2(WORLD_SIZE // n, n) grid, the source's n_dp = ndev // n_idx.
    Any other WORLD_SIZE raises ValueError before any group is joined, as
    the source asserts that n_idx needs that many devices."""
    raw = os.environ.get(INDEX_SHARD_ENV, "")
    try:
        n = int(raw or 0)
    except ValueError:
        raise ValueError(f"{INDEX_SHARD_ENV}={raw} is not a number of shards")
    if n <= 1:
        return None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or world % n:
        raise ValueError(f"{INDEX_SHARD_ENV}={n} needs a WORLD_SIZE that is "
                         f"a multiple of {n} (have WORLD_SIZE={world})")
    world, _rank, _backend, device = init_from_env(device)
    return make_mesh2(world // n, n, device)


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a grid of ranks: for each axis its size, this
    rank's coordinate and the process group of the ranks along it (None
    where the axis holds this rank alone); the rank's device."""
    axes: tuple
    shape: tuple
    coords: tuple
    groups: tuple
    device: torch.device

    def size(self, axis: str = "dp") -> int:
        return self.shape[self.axes.index(axis)]

    def coord(self, axis: str = "dp") -> int:
        return self.coords[self.axes.index(axis)]

    def group(self, axis: str = "dp"):
        return self.groups[self.axes.index(axis)]


def _world(n: int) -> int:
    """This rank, where the process group holds n ranks."""
    if n == 1:
        return 0
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise ValueError(f"a mesh of {n} ranks needs a process group of "
                         f"{n} (have "
                         f"{dist.get_world_size() if dist.is_initialized() else 'none'})")
    return dist.get_rank()


def make_mesh(n_devices: int = None, device="cpu") -> Mesh:
    """1-D `dp` mesh over the n ranks of the process group (all of them
    when n_devices is None; 1: this rank alone, no collective)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    rank = _world(n_devices)
    group = dist.group.WORLD if n_devices > 1 else None
    return Mesh(("dp",), (n_devices,), (rank,), (group,),
                torch.device(device))


def make_mesh2(n_dp: int, n_idx: int, device="cpu") -> Mesh:
    """2-D mesh: reads data-parallel over `dp`, FM index sharded over `idx`;
    rank = dp * n_idx + idx (the source's devices reshaped to (n_dp,
    n_idx)). Every rank creates every subgroup, in the same order, as
    torch.distributed requires."""
    rank = _world(n_dp * n_idx)
    d, i = divmod(rank, n_idx)
    lines = {"dp": [[e * n_idx + j for e in range(n_dp)] for j in range(n_idx)],
             "idx": [[e * n_idx + j for j in range(n_idx)] for e in range(n_dp)]}
    groups = {}
    for axis, ranks_of in lines.items():
        for ranks in ranks_of:
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                groups[axis] = g
    return Mesh(("dp", "idx"), (n_dp, n_idx), (d, i),
                (groups["dp"], groups["idx"]), torch.device(device))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of t as the group's backend takes it: on the host for gloo,
    on this rank's card for nccl; bool as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if dist.get_backend(group) == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()),
                    copy=True).contiguous()
    return t.to("cpu", copy=True).contiguous()


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the ranks of `group` (None: t itself), on t's
    device."""
    if group is None:
        return t
    w = _wire(t, group)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(t.device, t.dtype)


def _gather_equal(w: torch.Tensor, group, n: int):
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return parts


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str = "dp",
               dim: int = 0) -> torch.Tensor:
    """The slices of every rank along `axis`, concatenated on `dim` in rank
    order, on t's device. The slices may differ in size on `dim`: the sizes
    go first, each slice is padded to the largest and trimmed again."""
    group, n = mesh.group(axis), mesh.size(axis)
    if group is None:
        return t
    size = torch.tensor([t.shape[dim]], dtype=torch.int64)
    sizes = [int(s) for s in _gather_equal(_wire(size, group), group, n)]
    if max(sizes) == 0:  # every rank's slice is empty: nothing to send
        return t
    w = _wire(t.movedim(dim, 0), group)
    if w.shape[0] < max(sizes):
        w = torch.cat([w, w.new_zeros((max(sizes) - w.shape[0],)
                                      + tuple(w.shape[1:]))])
    parts = _gather_equal(w, group, n)
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)])
    return out.to(t.device, t.dtype).movedim(0, dim)


def shard_bounds(n: int, mesh: Mesh, axis: str = "dp"):
    """[lo, hi) of this rank's contiguous slice of n rows: ceil(n / size)
    rows a rank, the last ones shorter (the source's P(axis))."""
    per = -(-n // mesh.size(axis))
    lo = min(n, mesh.coord(axis) * per)
    return lo, min(n, lo + per)


def local_slice(a, mesh: Mesh, axis: str = "dp", dim: int = 0):
    """This rank's slice of `a` on `dim` (shard_bounds)."""
    lo, hi = shard_bounds(a.shape[dim], mesh, axis)
    return a.narrow(dim, lo, hi - lo) if isinstance(a, torch.Tensor) \
        else a[(slice(None),) * dim + (slice(lo, hi),)]


def _offset(mesh: Mesh, n_local: int, axis: str = "dp") -> int:
    """Rows of the ranks before this one along `axis`: the global id of this
    rank's first row."""
    sizes = all_gather(torch.tensor([n_local], dtype=torch.int64), mesh, axis)
    return int(sizes[:mesh.coord(axis)].sum())


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------

def sharded_seed_fn(mesh: Mesh, fm: FMPair, L: int, min_seed_len: int,
                    max_mem_intv: int):
    """Returns fn(q [B_l, L'], lens [B_l], parents [B_l]) of this rank's
    reads -> (lane_of [M] int32, rows [M, 5], overflow [B]) of every rank's
    reads, gathered in rank order with read ids offset by the reads of the
    ranks before (collect_intv_flat's contract over the global batch). K3
    on the first L columns with the index replicated in every rank, MemOpt's
    other seeding options."""
    opt = MemOpt()
    opt.min_seed_len, opt.max_mem_intv = int(min_seed_len), int(max_mem_intv)

    def fn(q, lens, parents):
        lane_of, rows, ov = collect_intv_flat(fm, q[:, :L], lens, parents, opt)
        off = _offset(mesh, q.shape[0])
        return (all_gather(lane_of + off, mesh), all_gather(rows, mesh),
                all_gather(ov, mesh))
    return fn


def _pool_seeds(fm: FMPair, pool, opt):
    """collect_intv_flat on a read pool [N, L+2] (read, length, strand):
    (rows [M, 5], rid [M] int32, the row count [1], overflow [N]), the rows
    in (read, start, end) order."""
    L = pool.shape[1] - 2
    lane_of, rows, ov = collect_intv_flat(fm, pool[:, :L], pool[:, L],
                                          pool[:, L + 1], opt)
    return rows, lane_of, torch.tensor([rows.shape[0]]), ov


def sharded_log_seed_fn(mesh: Mesh, fm: FMPair, opt: MemOpt):
    """The production seeder with the index replicated and the read pools
    sharded over dp. Returns fn(pool [N_l, L+2] of this rank) -> (rows [M,
    5], rid [M], n_rows [n_dp], overflow [N]) of every shard in rank order:
    shard s's n_rows[s] rows follow the rows of the shards before it, with
    read ids local to the shard (callers add the reads of the shards
    before, s * N_l with pools of N_l, as the source's callers do). The
    source pads each shard's rows to a fixed capacity (an XLA shape); here
    only the rows cross the gather."""
    def fn(pool):
        return tuple(all_gather(t, mesh)
                     for t in _pool_seeds(fm, pool, opt))
    return fn


def sharded_extend_fn(mesh: Mesh, mats, o_del: int, e_del: int, o_ins: int,
                      e_ins: int, zdrop: int):
    """Batched SW extension (K1) with the lane axis sharded over dp:
    fn(q, qlens, t, tlens, msel, w, eb, h0) of this rank's lanes -> [6, B]
    of every rank's."""
    def fn(q, qlens, t, tlens, msel, w, eb, h0):
        return all_gather(sw_extend_batch(q, qlens, t, tlens, mats, msel,
                                          o_del, e_del, o_ins, e_ins, w, eb,
                                          zdrop, h0), mesh, dim=1)
    return fn


def sharded_pileup_counts_fn(mesh: Mesh, window: int, n_codes: int = 32):
    """Per-rank window counting (K9's general entry) merged across dp by
    all_reduce (the collective analog of the reference's per-window queue
    merge): fn(positions, stat, valid) of this rank's data -> [window,
    n_codes] int32 counts of every rank's."""
    def fn(positions, stat, valid):
        return group_sum(pileup_count_window(positions, stat, valid, window,
                                             n_codes), mesh.group("dp"))
    return fn


def sharded_chain_fn(mesh: Mesh, w: int, max_gap: int, max_occ: int,
                     NC: int = 64):
    """Device chaining (K6, ops/chain_batch.chain_scan_batch) with the lane
    axis of the [J, B] planes sharded over dp: fn(qbeg, len, rbeg, valid,
    rid, k, n_occ, l_pac) -> (log [J, B], ov [B])."""
    def fn(qbeg, ln, rbeg, valid, rid, kk, n_occ, l_pac):
        log, ov = chain_scan_batch(qbeg, ln, rbeg, valid, rid, kk, n_occ,
                                   int(l_pac), w, max_gap, max_occ, NC=NC)
        return all_gather(log, mesh, dim=1), all_gather(ov, mesh)
    return fn


def sharded_rescue_fn(mesh: Mesh, o_del: int, e_del: int, o_ins: int,
                      e_ins: int):
    """Batched mate rescue (K7, ops/sw_local.sw_local_batch, exact
    ksw_align2) with the lane axis sharded over dp: fn(query, qlens, target,
    tlens, mats, matsel, minsc, endsc, u8) -> the kernel's dict, imax_rows
    kept [Lt, B]."""
    def fn(query, qlens, target, tlens, mats, matsel, minsc, endsc, u8):
        out = sw_local_batch(query, qlens, target, tlens, mats, matsel,
                             o_del, e_del, o_ins, e_ins, minsc, endsc, u8)
        return {k: all_gather(v, mesh, dim=1 if k == "imax_rows" else 0)
                for k, v in out.items()}
    return fn


def _local_fm(mesh: Mesh, fm: FMPair) -> FMPair:
    """This rank's shard of fm over `idx` (fm itself on one shard)."""
    if mesh.size("idx") == 1:
        return fm
    return fm_shard(fm, mesh.size("idx"), mesh.coord("idx"),
                    mesh.group("idx"))


def index_sharded_seeder(mesh: Mesh, fm: FMPair):
    """collect_intv_flat's contract over a whole batch of lanes with the FM
    index sharded over `idx` and the lanes over `dp` (the split of
    sharded_index_seed_fn, the source's _collect_flat_index_sharded):
    fn(reads [B, L], lens [B], parents [B], opt) -> (lane_of, rows,
    overflow) of all B lanes. Every rank passes the same batch; it seeds its
    dp slice on its shard of the tables, in lockstep with the ranks of its
    idx group, which hold the same slice, and the slices' rows are gathered
    over dp in rank order, the lane ids offset by the lanes before."""
    fml = _local_fm(mesh, fm)

    def fn(reads, lens, parents, opt):
        lo, hi = shard_bounds(reads.shape[0], mesh)
        lane_of, rows, ov = collect_intv_flat(fml, reads[lo:hi], lens[lo:hi],
                                              parents[lo:hi], opt)
        return (all_gather(lane_of + lo, mesh), all_gather(rows, mesh),
                all_gather(ov, mesh))
    return fn


def sharded_index_seed_fn(mesh: Mesh, fm: FMPair, opt: MemOpt):
    """Production seeding with the FM INDEX SHARDED over the `idx` axis of a
    make_mesh2 grid and the read pools over `dp`: the fused tables and SA
    samples partition row-contiguously over idx, and every row read goes to
    its owner (seed_batch._routed_seed on the card). The ranks of an idx
    group pass the same pool and walk in lockstep, so the summed rows, and
    the seeds, are those of the replicated index. Returns fn(pool [N_l,
    L+2] of this rank's dp slice) -> sharded_log_seed_fn's outputs,
    gathered over dp."""
    fml = _local_fm(mesh, fm)

    def fn(pool):
        return tuple(all_gather(t, mesh) for t in _pool_seeds(fml, pool, opt))
    return fn


def sharded_index_sa_fn(mesh: Mesh, fm: FMPair):
    """Batched SA resolution (the bwt_sa walk) against the idx-sharded
    tables: fn(which, k) of this rank's dp slice -> positions of every dp
    slice, each walk step's row and the final sample routed over idx. The
    same positions as the replicated sa_batch."""
    fml = _local_fm(mesh, fm)

    def fn(which, k):
        return all_gather(sa_batch(fml, which, k), mesh)
    return fn
