"""FM tables on the device, batched SMEM seeding and the batched SA walk.

Port of the parts of biscuit_tpu/ops/seed_batch.py that the device engine
needs: the fused occ+BWT table (`_fused_tab`, copied as is), `FMPair` (the
tables carried to the device), occ4 and the bidirectional extend (K5,
`occ4_sel`/`extend_sel`), the 3-pass seed collection (K3, the contract of
`collect_intv_flat_sm`) and `sa_batch` (K4, the bwt_sa walk for a batch of
ranks), with `sa_batch_intervals`, the same walk for the ranks of a list of
seed intervals as the seeder leaves them on the device.

`fm_shard` cuts the tables row-contiguously over the ranks of an `idx`
process group (the source's `fm_shard_arrays` and its shard fields). Every
row read of the plain machines goes through `_tab_row` and `_sa_sample`,
which on a shard gather locally, zero the rows this shard does not own and
sum over the group, as the source's routed gather (seed_batch.py:265-289).
A kernel cannot make that collective call in the middle of a walk, so on a
CUDA device `collect_intv_flat` and `sa_batch` walk a shard by steps
(kernels/fm_route.cu, K10's path, parallel/mesh.py): a launch advances every
lane to its next row reads (a base of the seeder: every interval of a
backward round at once) and writes the rows this shard owns of them, and
their sum over the group feeds the next launch. K3's and K4's
kernels refuse a shard.

`collect_intv_flat`, `sa_batch` and `sa_batch_intervals` launch the CUDA
kernels kernels/smem_seed.cu and kernels/sa_walk.cu on a CUDA device and run
their plain versions on the CPU. torch on the CPU has no popcount and no `>>` or
`~` on uint32, so the table is held as int32 (the uint32 bit pattern) and
widened to int64 and masked before any shift; the plain versions compute
every rank in int64 and hand back the rank dtype.
"""
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..config import MEM_F_SELF_OVLP
from ..index.fmindex import BisIndex

from .. import kernels


def _popcount32_np(x: np.ndarray) -> np.ndarray:
    """SWAR popcount of a uint32 numpy array."""
    x = x.astype(np.uint32)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int64)


def _fused_tab(words: np.ndarray, occ_cp: np.ndarray, seq_len: int,
               wide: bool = False) -> np.ndarray:
    """Fused occ+BWT table: one 32-byte row per 64 BWT bases —
    [c0, c1, c2, c3, w0, w1, w2, w3] as 8 uint32 — so every occ4 query is a
    SINGLE row gather.

    wide=True (strands >= 2^31 chars, e.g. human): counts no longer fit a
    uint32, so the row becomes 12 uint32 — [lo0..lo3, hi0..hi3, w0..w3]."""
    words = np.asarray(words, np.uint32)
    cp = np.asarray(occ_cp).astype(np.int64)  # [n128+1, 4]
    n64 = (int(seq_len) + 63) >> 6
    wpad = np.zeros(n64 * 4, np.uint32)
    wpad[:len(words)] = words
    w4 = wpad.reshape(n64, 4)
    M = np.uint32(0x55555555)
    inv = ~wpad
    pc = np.stack([
        _popcount32_np(((inv >> np.uint32(1)) & inv) & M),
        _popcount32_np(((inv >> np.uint32(1)) & wpad) & M),
        _popcount32_np(((wpad >> np.uint32(1)) & inv) & M),
        _popcount32_np(((wpad >> np.uint32(1)) & wpad) & M),
    ], axis=1)                                   # [n64*4, 4] per-word counts
    blk_counts = pc.reshape(n64, 4, 4).sum(axis=1)  # [n64, 4] per-64-block
    b = np.arange(n64)
    base = cp[b >> 1]                            # 128-base checkpoints
    odd_add = np.where((b & 1)[:, None] == 1,
                       blk_counts[(b >> 1) << 1], 0)
    tot = (base + odd_add).astype(np.uint64)
    if wide:
        tab = np.empty((n64, 12), np.uint32)
        tab[:, 0:4] = (tot & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        tab[:, 4:8] = (tot >> np.uint64(32)).astype(np.uint32)
        tab[:, 8:] = w4
    else:
        tab = np.empty((n64, 8), np.uint32)
        tab[:, :4] = tot.astype(np.uint32)
        tab[:, 4:] = w4
    return tab


@dataclass(frozen=True)
class FMPair:
    """Daughter (0) and parent (1) FM tables on one device.

    tab         [2, n64, 8|12] int32, the uint32 rows of `_fused_tab`
    L2          [2, 5] int64
    primary     [2] int64
    sa_samples  [2, n_sa] int32 (narrow) | int64 (wide); rank-0 entry -1
    host_consts L2[0][0..3], L2[1][0..3], primary[0], primary[1] as ints,
                which K4 takes by value (no read of the device tables)
    Narrow indexes walk int32 ranks, wide ones (strands >= 2^31) int64.

    A shard (group set, `fm_shard`): tab is rows [shard_index * R, (shard_index
    + 1) * R) of the [2 * n64_global, W] flattened table and sa_samples the
    same slice of the [2 * n_sa_global] flattened samples; group is the
    process group of the idx axis that holds the other shards."""
    tab: torch.Tensor
    L2: torch.Tensor
    primary: torch.Tensor
    sa_samples: torch.Tensor
    seq_len: int
    wide: bool
    sa_intv: int
    host_consts: tuple
    n64_global: int = 0
    n_sa_global: int = 0
    group: object = None
    shard_index: int = 0

    @property
    def rdt(self) -> torch.dtype:
        return torch.int64 if self.wide else torch.int32

    @classmethod
    def from_numpy(cls, tab, L2, primary, seq_len, sa_samples, wide: bool,
                   sa_intv: int, device) -> "FMPair":
        """From the JAX FMPair's arrays as numpy (np.asarray(jfm.tab), ...)."""
        sa_dt = np.int64 if wide else np.int32

        def dev(a, dt):  # a writable contiguous copy, then to the device
            return torch.from_numpy(np.array(a, dt, order="C")).to(device)
        return cls(
            tab=dev(np.asarray(tab, np.uint32).view(np.int32), np.int32),
            L2=dev(L2, np.int64), primary=dev(primary, np.int64),
            sa_samples=dev(np.asarray(sa_samples).astype(sa_dt), sa_dt),
            seq_len=int(seq_len), wide=bool(wide), sa_intv=int(sa_intv),
            host_consts=tuple(int(v) for v in np.concatenate([
                np.asarray(L2, np.int64)[:, :4].reshape(-1),
                np.asarray(primary, np.int64)])))

    @classmethod
    def from_index(cls, idx: BisIndex, device) -> "FMPair":
        """The same arrays as biscuit_tpu's FMPair.from_index."""
        wide = idx.dau.sa_samples.dtype.itemsize == 8
        sa_intv = int(getattr(idx.dau, "sa_intv", 32))
        if sa_intv != int(getattr(idx.par, "sa_intv", 32)):
            raise ValueError("strands disagree on the SA sampling interval")
        n = int(idx.dau.seq_len)
        tab = np.stack([_fused_tab(idx.dau.words, idx.dau.occ_cp, n, wide),
                        _fused_tab(idx.par.words, idx.par.occ_cp, n, wide)])
        L2 = np.stack([idx.dau.L2, idx.par.L2]).astype(np.int64)
        prim = np.asarray([idx.dau.primary, idx.par.primary], np.int64)
        sa = np.stack([idx.dau.sa_samples.astype(np.int64),
                       idx.par.sa_samples.astype(np.int64)])
        if wide:
            sa[:, 0] = -1  # '$' row sentinel (bwt.c:84,94-96 wrap)
        # narrow: the stored uint32 0xFFFFFFFF wraps to -1 in int32
        return cls.from_numpy(tab, L2, prim, n, sa, wide, sa_intv, device)


def fm_shard_arrays(fm: FMPair, n_shards: int):
    """The source's host-side prep for index sharding: the [2, n64, W]
    fused table flattened to [2*n64, W] rows and the [2, n_sa] SA samples
    to [2*n_sa], each zero-padded so n_shards divides the leading axis (pad
    rows lie past every addressable global id, so no query selects one).
    Returns (tab_flat [Rp, W], sa_flat [Sp], n64, n_sa) on fm's device."""
    n64 = int(fm.tab.shape[1])
    W = int(fm.tab.shape[-1])
    tab_flat = fm.tab.reshape(2 * n64, W)
    Rp = -(-2 * n64 // n_shards) * n_shards
    if Rp != 2 * n64:
        tab_flat = torch.cat([tab_flat, tab_flat.new_zeros((Rp - 2 * n64, W))])
    n_sa = int(fm.sa_samples.shape[1])
    sa_flat = fm.sa_samples.reshape(-1)
    Sp = -(-2 * n_sa // n_shards) * n_shards
    if Sp != 2 * n_sa:
        sa_flat = torch.cat([sa_flat, sa_flat.new_zeros(Sp - 2 * n_sa)])
    return tab_flat, sa_flat, n64, n_sa


def fm_shard(fm: FMPair, n_shards: int, index: int, group) -> FMPair:
    """Shard `index` of n_shards of fm's tables (fm_shard_arrays), whose
    other shards the ranks of `group` hold: the source's per-device FMPair
    inside a shard_map body (parallel/mesh._local_fm). L2, primary and the
    scalars stay whole."""
    tab_flat, sa_flat, n64, n_sa = fm_shard_arrays(fm, n_shards)
    R, S = tab_flat.shape[0] // n_shards, sa_flat.shape[0] // n_shards
    return FMPair(tab=tab_flat[index * R:(index + 1) * R].clone(),
                  L2=fm.L2, primary=fm.primary,
                  sa_samples=sa_flat[index * S:(index + 1) * S].clone(),
                  seq_len=fm.seq_len, wide=fm.wide, sa_intv=fm.sa_intv,
                  host_consts=fm.host_consts, n64_global=n64,
                  n_sa_global=n_sa, group=group, shard_index=index)


def route_gather_plain(table: torch.Tensor, lo: int,
                       g: torch.Tensor) -> torch.Tensor:
    """table[g - lo] where this shard's rows [lo, lo + len(table)) hold
    global row g, zero elsewhere (g < 0 included): the local half of the
    source's routed gather. [n] + table.shape[1:] of table's dtype."""
    R = table.shape[0]
    loc = g - lo
    ok = (loc >= 0) & (loc < R)
    got = table[loc.clamp(0, R - 1)]
    return torch.where(ok.reshape(ok.shape + (1,) * (got.dim() - 1)), got, 0)


def _routed(fm: FMPair, table: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain routed gather: route_gather_plain summed over the shard
    group. Exactly one shard owns each row, so every shard gets every row
    (the source's masked gather and psum). The ranks of the group call it in
    lockstep, with the same shapes."""
    got = route_gather_plain(table, fm.shard_index * table.shape[0], g)
    if got.numel() == 0:
        return got
    from ..parallel.mesh import group_sum
    return group_sum(got, fm.group)


def _tab_row(fm: FMPair, which: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """Fused-table rows [n, W] of strands `which` [n] at 64-base blocks
    `blk` [n] (int64): one gather, or on a shard the routed gather."""
    if fm.group is None:
        return fm.tab[which, blk]
    return _routed(fm, fm.tab, which * fm.n64_global + blk)


def _sa_sample(fm: FMPair, which: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """SA samples [n] of strands `which` at sample indices `i` (int64)."""
    if fm.group is None:
        return fm.sa_samples[which, i]
    return _routed(fm, fm.sa_samples, which * fm.n_sa_global + i)


def _whole(fm: FMPair) -> None:
    """K3 and K4 read the whole tables: a shard cannot go to them."""
    if fm.group is not None:
        raise ValueError("a shard of the tables walks by steps "
                         "(kernels/fm_route.cu); K3 and K4 refuse it")


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_M55 = 0x55555555


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding 32-bit values."""
    x = x - ((x >> 1) & _M55)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _inv_psi_plain(fm: FMPair, which: torch.Tensor, kk: torch.Tensor):
    """One inverse-Psi step of seed_batch.sa_batch for int64 ranks: the
    BWT character c at kk, then L2[c] + occ(c, kk)."""
    W = fm.tab.shape[-1]
    prim = fm.primary[which]
    j = kk - (kk >= prim).long()
    row = _tab_row(fm, which, j >> 6)
    word = row.gather(1, (W - 4 + ((j >> 4) & 3))[:, None])[:, 0].long() & _M32
    c = (word >> (((~j) & 15) << 1)) & 3
    nxt = fm.L2[which, c] + _occ4(fm, which, kk).gather(1, c[:, None])[:, 0]
    return torch.where(kk == prim, torch.zeros_like(nxt), nxt)


def sa_batch_plain(fm: FMPair, which: torch.Tensor, k: torch.Tensor,
                   steps: torch.Tensor = None) -> torch.Tensor:
    """Plain torch bwt_sa walk: a vectorized while over the jobs still
    walking. which [n] int32 in {0, 1}, k [n] ranks -> positions [n] of the
    rank dtype. steps: an int64 [n] tensor that receives each job's number
    of inverse-Psi steps (what K4's bound counts)."""
    w = which.long()
    kk = k.long().clone()
    add = torch.zeros_like(kk)
    mask = fm.sa_intv - 1
    live = torch.nonzero((kk & mask) != 0).flatten()
    while live.numel():
        nk = _inv_psi_plain(fm, w[live], kk[live])
        kk[live] = nk
        add[live] += 1
        live = live[(nk & mask) != 0]
    if steps is not None:
        steps.copy_(add)
    shift = fm.sa_intv.bit_length() - 1
    return (add + _sa_sample(fm, w, kk >> shift).long()).to(fm.rdt)


def sa_batch_intervals_plain(fm: FMPair, which_row, x0_row, kmax_row,
                             off_row, total: int,
                             steps: torch.Tensor = None) -> torch.Tensor:
    """The contract of `sa_batch_intervals`: each row expanded to its ranks
    (repeat_interleave), then `sa_batch_plain`, each position scattered to
    out[off_row[r] + i]. steps: as for sa_batch_plain, in row order."""
    dev = x0_row.device
    kmax = kmax_row.long()
    row = torch.repeat_interleave(torch.arange(kmax.numel(), device=dev), kmax)
    within = torch.arange(row.numel(), device=dev) - (kmax.cumsum(0) - kmax)[row]
    pos = sa_batch_plain(fm, which_row[row], x0_row.long()[row] + within, steps)
    out = torch.empty(int(total), dtype=fm.rdt, device=dev)
    out[off_row.long()[row] + within] = pos
    return out


# ---------------------------------------------------------------------------
# K5: occ4 and the bidirectional extend, plain torch
# ---------------------------------------------------------------------------

def _occ4(fm: FMPair, which: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """occ4_sel in int64: counts [n, 4] of each class in bwt[0..k] of
    strand `which`; k in [-1, seq_len] (seed_batch.py:231-322)."""
    W = fm.tab.shape[-1]
    ksafe = k.clamp(0, fm.seq_len - 1)
    kk = ksafe - (ksafe >= fm.primary[which]).long()
    row = _tab_row(fm, which, kk >> 6).long() & _M32      # [n, W]
    acc = row[:, :4]
    if fm.wide:
        acc = acc | (row[:, 4:8] << 32)
    w4 = row[:, W - 4:]
    wi = ((kk >> 4) & 3)[:, None]
    tl = ((~kk) & 15)[:, None]
    q = torch.arange(4, device=k.device)[None, :]
    sel = q == wi
    sh = tl << 1
    wm = torch.where(sel, (w4 >> sh) << sh, w4)              # cut after kk
    inv = (~wm) & _M32
    lo = wm & _M55
    cnt = torch.stack([                                      # [n, word, class]
        _popcount32((inv >> 1) & inv & _M55) - torch.where(sel, tl, 0),
        _popcount32((inv >> 1) & lo),
        _popcount32((wm >> 1) & inv & _M55),
        _popcount32((wm >> 1) & lo)], -1)
    res = acc + torch.where((q <= wi)[..., None], cnt, 0).sum(1)
    L2 = fm.L2[which]
    res = torch.where((k == fm.seq_len)[:, None], L2[:, 1:] - L2[:, :4], res)
    return torch.where((k < 0)[:, None], 0, res)


def _extend(fm: FMPair, which, x_q, x_o, s):
    """bwt_extend in int64 (seed_batch.py:325-352): x_q is the rank on the
    queried strand `which`, x_o the other one. Returns (new_xq, new_xo,
    sizes), each [n, 4] by class."""
    n = x_q.shape[0]
    occ = _occ4(fm, torch.cat([which, which]), torch.cat([x_q - 1, x_q - 1 + s]))
    tk, tl = occ[:n], occ[n:]
    sizes = tl - tk
    new_xq = fm.L2[which, :4] + 1 + tk
    prim = fm.primary[which]
    b3 = x_o + ((x_q <= prim) & (x_q + s - 1 >= prim)).long()  # crosses '$'
    b2 = b3 + sizes[:, 3]
    b1 = b2 + sizes[:, 2]
    b0 = b1 + sizes[:, 1]
    return new_xq, torch.stack([b0, b1, b2, b3], 1), sizes


def occ_class_plain(fm: FMPair, which: torch.Tensor, k: torch.Tensor):
    """What an extension by class c needs of occ4, as a thread of K3
    computes it, for [n] ranks and every c: eq [n, 4], the count of class c
    in bwt[0..k], and gt [n, 4], the count of the classes above c. Each of
    the row's four BWT words (16 bases, from the top bits down) is cut behind
    the rank's base by a shift out and back in; a base of class c has both
    bits 0 after an xor with c in every base; the bases above c are hi | lo,
    hi, hi & lo or none; the cut-off bases read as A and are taken off class
    0 again; the row's counts give class c and the sum above it; the edges
    (k < 0, k == seq_len) replace the result. Used by no caller on the main
    path."""
    W = fm.tab.shape[-1]
    which, k = which.long(), k.long()
    ksafe = k.clamp(0, fm.seq_len - 1)
    kk = ksafe - (ksafe >= fm.primary[which]).long()
    row = _tab_row(fm, which, kk >> 6).long() & _M32
    pos = kk & 63
    cnt = [row[:, c] | (row[:, 4 + c] << 32) if fm.wide else row[:, c]
           for c in range(4)]
    L2 = fm.L2[which]
    eq, gt = [], []
    for c in range(4):
        pat = _M55 * c
        m2 = _M32 if c == 0 else 0
        m3 = _M32 if c <= 1 else 0
        m45 = 0 if c == 3 else _M55
        n_eq = torch.zeros_like(kk)
        n_gt = torch.zeros_like(kk)
        for q in range(4):
            sh = (32 * q + 30 - 2 * pos).clamp(0, 32)
            wm = ((row[:, W - 4 + q] >> sh) << sh) & _M32
            x = wm ^ pat
            n_eq = n_eq + _popcount32(~(x | (x >> 1)) & _M55)
            n_gt = n_gt + _popcount32(((wm >> 1) | (wm & m2)) & (wm | m3) & m45)
        if c == 0:
            n_eq = n_eq - (63 - pos)
        e = cnt[c] + n_eq
        g = sum(cnt[c + 1:], torch.zeros_like(kk)) + n_gt
        full = k == fm.seq_len
        e = torch.where(full, L2[:, c + 1] - L2[:, c], e)
        g = torch.where(full, L2[:, 4] - L2[:, c + 1], g)
        eq.append(torch.where(k < 0, 0, e))
        gt.append(torch.where(k < 0, 0, g))
    return torch.stack(eq, 1).to(fm.rdt), torch.stack(gt, 1).to(fm.rdt)


def rank_order(start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """The place of each of a lane's n rows in its stable sort by
    (start, end), as K3's threads find it: the rows with a smaller key, and
    those with an equal key and a smaller index. [n] int64, a permutation.
    Used by no caller on the main path."""
    s, e = start[:, None], end[:, None]
    idx = torch.arange(start.numel(), device=start.device)
    before = (start < s) | ((start == s) & ((end < e) | (
        (end == e) & (idx[None, :] < idx[:, None]))))
    return before.sum(1)


def occ4_sel_plain(fm: FMPair, which: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """JAX occ4_sel: which [n] strand ids, k [n] ranks -> [n, 4] counts of
    the rank dtype."""
    return _occ4(fm, which.long(), k.long()).to(fm.rdt)


def extend_sel_plain(fm: FMPair, which, x_q, x_o, s):
    """JAX extend_sel (without its unused is_back): (new_xq, new_xo, sizes)
    [n, 4] each, of the rank dtype."""
    out = _extend(fm, which.long(), x_q.long(), x_o.long(), s.long())
    return tuple(t.to(fm.rdt) for t in out)


# ---------------------------------------------------------------------------
# K3: mem_collect_intv for a batch of lanes, plain torch
# ---------------------------------------------------------------------------

SEED_CAP = 128  # S: rows a lane may hold; a lane that needs more is flagged


def seed_params(opt):
    """(min_seed_len, split_len, split_width, max_mem_intv, start_width) of
    mem_collect_intv (smem.py:107-113). split_len rounds in Python double
    precision and reaches the kernel as an int."""
    return (int(opt.min_seed_len),
            int(opt.min_seed_len * opt.split_factor + 0.499),
            int(opt.split_width), int(opt.max_mem_intv),
            2 if opt.flag & MEM_F_SELF_OVLP else 1)


_SCAN, _FWD, _BACK, _DONE = 0, 1, 2, 3
_NONE = 1 << 62  # no seed emitted yet in this smem1a call


class _Lanes:
    """The converted reads of a batch and their strands. Strand `parent`
    answers backward extension and strand 1 - parent forward extension
    (seed_batch.py:490-491)."""

    def __init__(self, fm: FMPair, reads, lens, parents):
        self.fm = fm
        self.q = reads.long()
        self.lens = lens.long()
        self.par = parents.long()

    def base(self, lanes, i):
        """q[lane, i], 4 outside [0, len)."""
        v = self.q[lanes, i.clamp(0, self.q.shape[1] - 1)]
        return torch.where((i >= 0) & (i < self.lens[lanes]), v, 4)

    def set_intv(self, lanes, c):
        """bwt_set_intv: (x0, x1, s) of base c; x1 from the other strand's
        L2 at the complement 3 - c."""
        p, L2 = self.par[lanes], self.fm.L2
        return L2[p, c] + 1, L2[1 - p, 3 - c] + 1, L2[p, c + 1] - L2[p, c]

    def extend(self, which, x_q, x_o, s, c):
        """Class c of bwt_extend: (new_xq, new_xo, size) [n] each."""
        out = _extend(self.fm, which, x_q, x_o, s)
        return tuple(t.gather(1, c[:, None])[:, 0] for t in out)


def _cat(parts, dev):
    lanes = [p[0] for p in parts]
    rows = [p[1] for p in parts]
    if not lanes:
        return (torch.zeros(0, dtype=torch.long, device=dev),
                torch.zeros((0, 5), dtype=torch.long, device=dev))
    return torch.cat(lanes), torch.cat(rows)


def _smem_plain(ln: _Lanes, tasks, n_tasks, msl: int):
    """smem1a over per-lane task lists, the lanes in lockstep, one step of
    each lane per round (the machine of seed_batch.smem_batch). tasks
    [B, T, 3] rows (x, min_intv, cont): cont=1 scans on from the returned
    end (pass 1), cont=0 runs once (pass 2). Returns the seeds at least
    msl long as (lane [n], rows [n, 5]), in the order they were found."""
    B, L = ln.q.shape
    dev = ln.q.device
    tasks = tasks.clone()
    z = lambda: torch.zeros(B, dtype=torch.long, device=dev)  # noqa: E731
    phase, t_idx, x, min_intv, i, ret = z(), z(), z(), z(), z(), z()
    prev_slot, n_prev, n_curr, j, last = z(), z(), z(), z(), z()
    rev = torch.zeros(B, dtype=torch.bool, device=dev)
    ik = torch.zeros((B, 4), dtype=torch.long, device=dev)   # x0, x1, s, end
    # prev and curr interval lists; a forward pass pushes at most L + 1
    buf = torch.zeros((B, 2, L + 1, 4), dtype=torch.long, device=dev)
    found = []
    while True:
        sc = torch.nonzero(phase == _SCAN).flatten()
        fw = torch.nonzero(phase == _FWD).flatten()
        bk = torch.nonzero(phase == _BACK).flatten()
        if sc.numel() + fw.numel() + bk.numel() == 0:
            break

        if sc.numel():  # take the next task, or start smem1a at its x
            t = t_idx[sc]
            left = t < n_tasks[sc]
            phase[sc[~left]] = _DONE
            a, t = sc[left], t[left]
            tx, tmi, tc = tasks[a, t].unbind(1)
            qx = ln.base(a, tx)
            inside = tx < ln.lens[a]
            init = inside & (qx < 4)
            bump = inside & (qx >= 4) & (tc == 1)
            tasks[a[bump], t[bump], 0] = tx[bump] + 1
            t_idx[a[~init & ~bump]] += 1
            s_ = a[init]
            x0, x1, s = ln.set_intv(s_, qx[init])
            ik[s_] = torch.stack([x0, x1, s, tx[init] + 1], 1)
            x[s_] = tx[init]
            min_intv[s_] = tmi[init].clamp(min=1)
            i[s_] = tx[init] + 1
            n_curr[s_] = 0
            phase[s_] = _FWD

        if fw.numel():  # one forward extension on strand 1 - parent
            qi = ln.base(fw, i[fw])
            need = qi < 4
            push = ~need        # read end or an ambiguous base: push, finish
            fin = ~need
            e = fw[need]
            ike = ik[e]
            nq, no, sz = ln.extend(1 - ln.par[e], ike[:, 1], ike[:, 0],
                                   ike[:, 2], 3 - qi[need])
            changed = sz != ike[:, 2]
            small = changed & (sz < min_intv[e])
            push[need] = changed
            fin[need] = small
            pa = fw[push]
            buf[pa, 1 - prev_slot[pa], n_curr[pa]] = ik[pa]
            n_curr[pa] += 1
            ad = e[~small]
            ik[ad] = torch.stack([no[~small], nq[~small], sz[~small],
                                  i[ad] + 1], 1)
            i[ad] += 1
            # finish: curr becomes prev, read back to front (the reversal)
            f = fw[fin]
            cs = 1 - prev_slot[f]
            ret[f] = buf[f, cs, n_curr[f] - 1, 3]
            rev[f] = True
            prev_slot[f] = cs
            n_prev[f] = n_curr[f]
            n_curr[f] = 0
            i[f] = x[f] - 1
            j[f] = 0
            last[f] = _NONE
            phase[f] = _BACK

        if bk.numel():  # one prev entry, extended backward on strand parent
            ia = i[bk]
            qi = ln.base(bk, ia)
            has = qi < 4
            jj = torch.where(rev[bk], n_prev[bk] - 1 - j[bk], j[bk])
            p = buf[bk, prev_slot[bk], jj]
            ok = torch.zeros((bk.numel(), 3), dtype=torch.long, device=dev)
            h = bk[has]
            ok[has] = torch.stack(ln.extend(ln.par[h], p[has, 0], p[has, 1],
                                            p[has, 2], qi[has]), 1)
            keep = ~has | (ok[:, 2] < min_intv[bk])
            start = ia + 1
            nc = n_curr[bk]
            # smem.py:72-74: emit only with curr empty, left of the last seed
            emit = keep & (nc == 0) & (start < last[bk])
            store = emit & (p[:, 3] - start >= msl)
            found.append((bk[store], torch.stack(
                [start, p[:, 3], p[:, 0], p[:, 1], p[:, 2]], 1)[store]))
            last[bk[emit]] = start[emit]
            cs = 1 - prev_slot[bk]
            last_s = buf[bk, cs, (nc - 1).clamp(min=0), 2]
            app = ~keep & ((nc == 0) | (ok[:, 2] != last_s))
            ap = bk[app]
            buf[ap, cs[app], nc[app]] = torch.cat([ok, p[:, 3:]], 1)[app]
            n_curr[ap] += 1
            j[bk] += 1
            row_done = j[bk] >= n_prev[bk]
            nc = n_curr[bk]
            d = bk[row_done & (nc == 0)]
            # smem1a returned: a scan goes on at ret, a single task is spent
            t = t_idx[d]
            cont = tasks[d, t, 2] == 1
            tasks[d[cont], t[cont], 0] = ret[d[cont]]
            t_idx[d[~cont]] += 1
            phase[d] = _SCAN
            nx = bk[row_done & (nc != 0)]
            rev[nx] = False
            prev_slot[nx] = 1 - prev_slot[nx]
            n_prev[nx] = n_curr[nx]
            n_curr[nx] = 0
            i[nx] -= 1
            j[nx] = 0
    return _cat(found, dev)


def _strategy_plain(ln: _Lanes, msl: int, max_intv: int):
    """Pass 3, bwt_seed_strategy1 from every position, the lanes in
    lockstep (the machine of seed_batch.seed_strategy_batch). Returns the
    seeds with a nonzero interval as (lane [n], rows [n, 5])."""
    B = ln.q.shape[0]
    dev = ln.q.device
    x = torch.zeros(B, dtype=torch.long, device=dev)
    i = torch.zeros_like(x)
    ik = torch.zeros((B, 3), dtype=torch.long, device=dev)
    run = torch.zeros(B, dtype=torch.bool, device=dev)
    found = []
    while True:
        sc = torch.nonzero(~run & (x < ln.lens)).flatten()
        if sc.numel():
            qx = ln.base(sc, x[sc])
            go = qx < 4
            x[sc[~go]] += 1
            g = sc[go]
            ik[g] = torch.stack(ln.set_intv(g, qx[go]), 1)
            i[g] = x[g] + 1
            run[g] = True
        r = torch.nonzero(run).flatten()
        if r.numel() == 0:
            if sc.numel() == 0:
                break
            continue
        ir = i[r]
        qi = ln.base(r, ir)
        at_end = ir >= ln.lens[r]
        amb = ~at_end & (qi >= 4)
        x[r[at_end]] = ln.lens[r[at_end]]
        x[r[amb]] = ir[amb] + 1
        stop = at_end | amb
        need = qi < 4
        e = r[need]
        ike = ik[e]
        nq, no, sz = ln.extend(1 - ln.par[e], ike[:, 1], ike[:, 0], ike[:, 2],
                               3 - qi[need])
        ie = ir[need]
        hit = (sz < max_intv) & (ie - x[e] >= msl)
        st = hit & (sz > 0)
        found.append((e[st], torch.stack([x[e], ie + 1, no, nq, sz], 1)[st]))
        x[e[hit]] = ie[hit] + 1
        on = ~hit
        ik[e[on]] = torch.stack([no, nq, sz], 1)[on]
        i[e[on]] += 1
        stop[need] = hit
        run[r[stop]] = False
    return _cat(found, dev)


def collect_intv_flat_plain(fm: FMPair, reads, lens, parents, opt,
                            S: int = SEED_CAP):
    """Plain torch mem_collect_intv for a batch; the contract of
    `collect_intv_flat`. Passes 1 and 2 run as one smem1a machine each,
    pass 3 as the seed_strategy1 machine (the plan of
    seed_batch._collect_sm_fused), then one stable sort per lane."""
    msl, split_len, split_width, max_intv, start_width = seed_params(opt)
    B, L = reads.shape
    dev = reads.device
    if B == 0 or L == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((0, 5), dtype=fm.rdt, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev))
    ln = _Lanes(fm, reads, lens, parents)
    one = torch.ones(B, dtype=torch.long, device=dev)
    tasks1 = torch.tensor([0, start_width, 1], device=dev).repeat(B, 1, 1)
    lane1, rows1 = _smem_plain(ln, tasks1, one, msl)
    # pass 2 (memchain.c:76-85): re-seed the middle of each long pass-1
    # SMEM with few occurrences, asking for one occurrence more
    m2 = (rows1[:, 1] - rows1[:, 0] >= split_len) & (rows1[:, 4] <= split_width)
    lane2, rows2 = lane1[m2], rows1[m2]
    n2 = torch.bincount(lane2, minlength=B)
    order = torch.sort(lane2, stable=True).indices
    lane2, rows2 = lane2[order], rows2[order]
    rank = torch.arange(lane2.numel(), device=dev) - (n2.cumsum(0) - n2)[lane2]
    tasks2 = torch.zeros((B, max(int(n2.max()), 1), 3), dtype=torch.long,
                         device=dev)
    tasks2[lane2, rank, 0] = (rows2[:, 0] + rows2[:, 1]) >> 1
    tasks2[lane2, rank, 1] = rows2[:, 4] + 1
    parts = [(lane1, rows1), _smem_plain(ln, tasks2, n2, msl)]
    if max_intv > 0:
        parts.append(_strategy_plain(ln, msl, max_intv))
    lane, rows = _cat(parts, dev)
    # the host's stable (start<<32 | end) sort, lane by lane; equal keys
    # are one substring of the read and so one row
    key = (lane * (L + 1) + rows[:, 0]) * (L + 2) + rows[:, 1]
    order = torch.sort(key, stable=True).indices
    lane, rows = lane[order], rows[order]
    ov = torch.bincount(lane, minlength=B) > S
    keep = ~ov[lane]
    return lane[keep].to(torch.int32), rows[keep].to(fm.rdt), ov


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# (tab, L2, primary, n64, seq_len, reads, lens, parents, B, L, min_seed_len,
#  split_len, split_width, max_mem_intv, start_width, S, scratch, rows, n, ov)
_SEED_SIG = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
             + [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 7
             + [ctypes.c_void_p] * 4)


def _seed_lib():
    lib = kernels.load("smem_seed", {"smem_seed_narrow": _SEED_SIG,
                                     "smem_seed_wide": _SEED_SIG})
    for fn in (lib.smem_seed_scratch_bytes, lib.smem_seed_lane_bytes):
        fn.argtypes = [ctypes.c_int] * 3  # (L, S, wide)
        fn.restype = ctypes.c_int64
    return lib


def seed_resident_warps(L: int, wide: bool, S: int = SEED_CAP):
    """(warps, i.e. lanes of the batch, of K3 that one SM holds at once at
    read length L, from the CUDA occupancy calculator; bytes of shared
    memory a lane's interval lists take there)."""
    lib = _seed_lib()
    return (int(lib.smem_seed_resident_warps(L, S, int(wide))),
            int(lib.smem_seed_lane_bytes(L, S, int(wide))))


def seed_lane_bytes(L: int, wide: bool, device, S: int = SEED_CAP,
                    routed: bool = False) -> int:
    """Device memory one lane of `collect_intv_flat` takes at read length
    L: its converted read, length and strand, its S rows of the rank dtype
    with their count and flag, twice over (the compacted copy), and on CUDA
    the scratch K3 gives a lane whose interval lists exceed an SM's shared
    memory, or with routed=True (a shard of the tables) the routed
    seeder's state, interval lists and slots of the step buffer with their
    count."""
    n = 4 * L + 8 + 2 * (S * 5 * (8 if wide else 4) + 5)
    if torch.device(device).type == "cuda":
        if routed:
            lib = _route_lib()
            n += int(lib.smem_route_state_bytes() + lib.smem_route_list_bytes(L)
                     + lib.smem_route_slots(L) * (48 if wide else 32) + 4)
        else:
            n += int(_seed_lib().smem_seed_scratch_bytes(L, S, int(wide)))
    return n


def _launch_seed(fm: FMPair, reads, lens, parents, params, S: int):
    """Launch K3 on prepared inputs (int32, contiguous, on fm's device):
    (rows [B, S, 5] of the rank dtype, n [B] int32, ov [B] bool). No host
    sync. The interval lists live in shared memory; only a read so long
    that one lane's lists exceed an SM's shared memory gets device memory
    for them."""
    _whole(fm)
    dev = kernels.check_cuda(fm.tab, reads, lens, parents)
    B, L = reads.shape
    kernels.check_lanes(B, lens, parents)
    rows = torch.empty((B, S, 5), dtype=fm.rdt, device=dev)
    n = torch.empty(B, dtype=torch.int32, device=dev)
    ov = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return rows, n, ov
    lib = _seed_lib()
    per_lane = int(lib.smem_seed_scratch_bytes(L, S, int(fm.wide)))
    scratch = (torch.empty((B, per_lane), dtype=torch.uint8, device=dev)
               if per_lane else None)
    fn = "smem_seed_wide" if fm.wide else "smem_seed_narrow"
    kernels.launch(lib, fn, "smem_seed", dev,
                   kernels.ptr(fm.tab), kernels.ptr(fm.L2),
                   kernels.ptr(fm.primary), fm.tab.shape[1], fm.seq_len,
                   kernels.ptr(reads), kernels.ptr(lens), kernels.ptr(parents),
                   B, L, *params, S,
                   kernels.ptr(scratch) if per_lane else None,
                   kernels.ptr(rows), kernels.ptr(n), kernels.ptr(ov))
    return rows, n, ov


def collect_intv_flat(fm: FMPair, reads, lens, parents, opt,
                      S: int = SEED_CAP):
    """Device mem_collect_intv (smem.collect_intv) for a batch of lanes.

    reads [B, L] int32 converted reads (any code > 3 is ambiguous), lens
    [B], parents [B] (0: daughter, 1: parent strand). Returns (lane_of [M]
    int32, rows [M, 5] of the rank dtype (start, end, x0, x1, size),
    overflow [B] bool), ordered by lane, start, end. A lane is flagged iff
    smem.collect_intv gives it more than S rows; a flagged lane has no
    rows. K3 on CUDA (a warp per lane, a thread an extension), on a shard
    of the tables the routed steps (_routed_seed), the plain machine on the
    CPU."""
    if kernels.route(reads) == "plain":
        return collect_intv_flat_plain(fm, reads, lens, parents, opt, S)
    reads = reads.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    parents = parents.to(torch.int32).contiguous()
    B, L = reads.shape
    kernels.check_lanes(B, lens, parents)
    # the kernel reads reads[b, :lens[b]] and the strand tables of parents[b]
    if bool(((lens < 0) | (lens > L) | ((parents & ~1) != 0)).any()):
        raise ValueError("lens must lie in [0, L] and parents in {0, 1}")
    launch = _launch_seed if fm.group is None else _routed_seed
    rows, n, ov = launch(fm, reads, lens, parents, seed_params(opt), S)
    if B == 0:
        return n, rows.reshape(0, 5), ov
    n = n.long()
    keep = torch.arange(S, device=reads.device)[None, :] < n[:, None]
    lane_of = torch.arange(B, dtype=torch.int32,
                           device=reads.device).repeat_interleave(n)
    return lane_of, rows[keep], ov


def collect_intv_batch(fm: FMPair, reads, lens, parents, opt,
                       S: int = SEED_CAP, on_device: bool = False,
                       seeder=None):
    """collect_intv_flat as per-lane lists of (start, end, x0, x1, size)
    tuples, with the overflow mask as numpy. on_device: also (lane_of,
    rows) as the seeder left them on the device, for K4's interval entry.
    seeder: fn(reads, lens, parents, opt) with collect_intv_flat's contract
    in its place (the index sharded over ranks:
    parallel.mesh.index_sharded_seeder), fm then unused."""
    if seeder is None:
        lane_of, rows, ov = collect_intv_flat(fm, reads, lens, parents, opt, S)
    else:
        lane_of, rows, ov = seeder(reads, lens, parents, opt)
    B = reads.shape[0]
    counts = np.bincount(lane_of.cpu().numpy(), minlength=B)
    flat = [tuple(r) for r in rows.cpu().tolist()]
    out, o = [], 0
    for c in counts.tolist():
        out.append(flat[o:o + c])
        o += c
    if on_device:
        return out, ov.cpu().numpy(), lane_of, rows
    return out, ov.cpu().numpy()


# (wide, intervals, tab, sa, consts, n64, n_sa, sa_shift, which, x0, kmax,
#  off, n_rows, out, total, counter)
_SA_SIG = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
           + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int64]
           + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])


def _lib():
    lib = kernels.load("sa_walk", {"sa_walk_launch": _SA_SIG})
    lib.sa_walk_occupancy.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.sa_walk_occupancy.restype = ctypes.c_int
    return lib


def sa_occupancy(wide: bool, intervals: bool) -> tuple:
    """(warps, walks in flight) of K4 one SM holds at once, from the CUDA
    occupancy calculator."""
    lib = _lib()
    warps, walks = ctypes.c_int(), ctypes.c_int()
    err = lib.sa_walk_occupancy(int(wide), int(intervals),
                                ctypes.byref(warps), ctypes.byref(walks))
    if err:
        raise RuntimeError("sa_walk_occupancy: "
                           + lib.kernel_error_string(err).decode())
    return warps.value, walks.value


def _launch_sa(fm: FMPair, which, x0, kmax, off, out, counter) -> None:
    """Launch K4 on prepared inputs (contiguous, on fm's device; which
    int32, x0 of the rank dtype, kmax int32 and off int64 or both None for
    the rank entry), into out, with counter two int32 words that are zero
    (the kernel leaves them zero). No host sync."""
    _whole(fm)
    intervals = kmax is not None
    extra = (kmax, off) if intervals else ()
    dev = kernels.check_cuda(fm.tab, fm.sa_samples, which, x0, *extra, out,
                             counter)
    if fm.tab.data_ptr() % 16:
        raise ValueError("K4 reads the fused table's rows as 16-byte vectors")
    n_rows = x0.numel()
    kernels.launch(_lib(), "sa_walk_launch",
                   "sa_walk_intervals" if intervals else "sa_walk", dev,
                   int(fm.wide), int(intervals),
                   kernels.ptr(fm.tab), kernels.ptr(fm.sa_samples),
                   (ctypes.c_int64 * 10)(*fm.host_consts), fm.tab.shape[1],
                   fm.sa_samples.shape[1], fm.sa_intv.bit_length() - 1,
                   kernels.ptr(which), kernels.ptr(x0),
                   kernels.ptr(kmax) if intervals else None,
                   kernels.ptr(off) if intervals else None, n_rows,
                   kernels.ptr(out), out.numel(), kernels.ptr(counter))


def sa_batch(fm: FMPair, which: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Batched SA lookup: which [n] int32 strand ids, k [n] ranks (the rank
    dtype) -> text positions [n] of the rank dtype. K4's rank entry on CUDA
    (no host sync), the plain walk on the CPU; on a shard of the tables on
    CUDA the routed steps (_routed_sa)."""
    if kernels.route(k) == "plain":
        return sa_batch_plain(fm, which, k)
    which = which.to(torch.int32).contiguous()
    k = k.to(fm.rdt).contiguous()
    n = k.numel()
    kernels.check_lanes(n, which, k)
    if fm.group is not None:
        return _routed_sa(fm, which, k)
    out = torch.empty(n, dtype=fm.rdt, device=k.device)
    if n:
        counter = torch.zeros(2, dtype=torch.int32, device=k.device)
        _launch_sa(fm, which, k, None, None, out, counter)
    return out


def sa_batch_intervals(fm: FMPair, which_row: torch.Tensor,
                       x0_row: torch.Tensor, kmax_row: torch.Tensor,
                       off_row: torch.Tensor, total: int) -> torch.Tensor:
    """Batched SA lookup of seed intervals, in the layout of the hybrid
    engine's seeder: row r asks for ranks x0_row[r] .. x0_row[r] +
    kmax_row[r] - 1 of strand which_row[r] (0: daughter, 1: parent) and
    gets their text positions at out[off_row[r] + i]. Returns out [total]
    of the rank dtype; the caller gives total (with off_row the exclusive
    prefix sum of kmax_row, the rows fill out exactly) and every rank lies in
    [0, seq_len]. K4's interval entry on CUDA (the rows stay on the card: no
    expansion, no host sync), sa_batch_intervals_plain on the CPU."""
    if kernels.route(x0_row) == "plain":
        return sa_batch_intervals_plain(fm, which_row, x0_row, kmax_row,
                                        off_row, total)
    which_row = which_row.to(torch.int32).contiguous()
    x0_row = x0_row.to(fm.rdt).contiguous()
    kmax_row = kmax_row.to(torch.int32).contiguous()
    off_row = off_row.to(torch.int64).contiguous()
    kernels.check_lanes(x0_row.numel(), which_row, kmax_row, off_row)
    out = torch.empty(int(total), dtype=fm.rdt, device=x0_row.device)
    if x0_row.numel() and total:
        counter = torch.zeros(2, dtype=torch.int32, device=x0_row.device)
        _launch_sa(fm, which_row, x0_row, kmax_row, off_row, out, counter)
    return out


# ---------------------------------------------------------------------------
# K10: the routed walks over a shard of the tables (kernels/fm_route.cu)
# ---------------------------------------------------------------------------

# (wide, L2, primary, seq_len, n64, tab, tab_rows, tab_lo, reads, lens,
#  parents, B, L, msl, split_len, split_width, max_intv, start_width, S,
#  states, buf, cnt, lists, rows, n, ov)
_ROUTE_SEED_SIG = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int64] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 7)
# (wide, L2, primary, seq_len, n64, tab, tab_rows, tab_lo, which, k, n,
#  shift, n_sa, mode, kk, add, buf, cnt, sample_req, samples, out)
_ROUTE_SA_SIG = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
                 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2
                 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int]
                 + [ctypes.c_void_p] * 7)
# (local, rows, lo, words, req, n, out)
_GATHER_SIG = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]

_WALKS = ("smem_route_step", "sa_route_step")
# step kernel -> what its walks did since reset_routed(): ROUTED_ROWS the
# fused rows the steps asked for (the rows a step's collective delivers,
# summed over steps, from the lanes' running totals that the step kernels
# keep), ROUTED_STEPS the steps (a launch and a collective each),
# ROUTED_CALLS the walks, ROUTED_MS the walks' whole calls in milliseconds
# on the host's clock (a step kernel's launches alone are timed by
# tools/route_bench.py)
ROUTED_ROWS = {k: 0 for k in _WALKS}
ROUTED_STEPS = {k: 0 for k in _WALKS}
ROUTED_CALLS = {k: 0 for k in _WALKS}
ROUTED_MS = {k: 0.0 for k in _WALKS}
# steps enqueued between host reads of the lanes' counts of rows asked,
# under nccl (under gloo every step crosses the host anyway): the fastest k
# of tools/route_bench.py's sweep of 1, 4, 8, 16, 32 on 8192 lanes over
# nccl on 4 cards (PERF.md)
ROUTE_SYNC_EVERY = 16


def reset_routed() -> None:
    """Set ROUTED_ROWS, ROUTED_STEPS, ROUTED_CALLS and ROUTED_MS to 0."""
    for k in _WALKS:
        ROUTED_ROWS[k] = ROUTED_STEPS[k] = ROUTED_CALLS[k] = 0
        ROUTED_MS[k] = 0.0


def _route_lib():
    lib = kernels.load("fm_route", {"smem_route_step": _ROUTE_SEED_SIG,
                                    "sa_route_step": _ROUTE_SA_SIG,
                                    "route_gather": _GATHER_SIG})
    lib.smem_route_state_bytes.argtypes = []
    for fn in (lib.smem_route_list_bytes, lib.smem_route_slots):
        fn.argtypes = [ctypes.c_int]
    for fn in (lib.smem_route_state_bytes, lib.smem_route_list_bytes,
               lib.smem_route_slots):
        fn.restype = ctypes.c_int64
    return lib


def route_gather(table: torch.Tensor, lo: int, g: torch.Tensor) -> torch.Tensor:
    """route_gather_plain's contract: the rows of this shard's table (rows
    [lo, lo + len(table)) of the global table) at global ids g [n] int64,
    zero where another shard owns them. The kernel on CUDA (a thread a
    32-bit word of the output), the plain version on the CPU."""
    if kernels.route(g) == "plain":
        return route_gather_plain(table, lo, g)
    g = g.to(torch.int64).contiguous()
    dev = kernels.check_cuda(table, g)
    words = table.element_size() * (table.numel() // max(table.shape[0], 1)) // 4
    out = torch.empty((g.numel(),) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=dev)
    kernels.launch(_route_lib(), "route_gather", "route_gather", dev,
                   kernels.ptr(table), table.shape[0], int(lo), int(words),
                   kernels.ptr(g), g.numel(), kernels.ptr(out))
    return out


def _step_loop(fm: FMPair, name: str, launch, buf: torch.Tensor,
               cnt: torch.Tensor) -> None:
    """The steps of a routed walk: launch() advances every lane and leaves
    in buf [B, slots, W] int32 the owned rows of each lane's next ask, its
    first cnt[0, b] slots, zeros where another shard owns a row, and adds
    that count to the lane's running total cnt[1, b]; between launches
    those slots are summed over the group, until no lane asks. Under nccl
    the whole buffer is summed on the card and the counts read once every
    ROUTE_SYNC_EVERY steps, a finished lane's step being a no-op; under
    gloo every step crosses the host, the asked slots alone, found from the
    counts. The ranks of the group run it in lockstep on the same lanes."""
    import time

    import torch.distributed as dist

    from ..parallel.mesh import group_sum
    t0 = time.perf_counter()
    nccl = dist.get_backend(fm.group) == "nccl"
    flat = buf.view(-1, buf.shape[-1])
    slot = torch.arange(buf.shape[1], dtype=torch.int32, device=buf.device)
    cnt.zero_()
    steps = 0
    while True:
        launch()
        steps += 1
        if nccl:
            if steps % ROUTE_SYNC_EVERY == 0 and not bool(cnt[0].any()):
                break
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=fm.group)
        else:
            sel = torch.nonzero((slot[None, :] < cnt[0, :, None]).reshape(-1))
            sel = sel.reshape(-1)
            if sel.numel() == 0:
                break
            flat.index_copy_(0, sel, group_sum(flat.index_select(0, sel),
                                               fm.group))
    ROUTED_ROWS[name] += int(cnt[1].sum())
    ROUTED_STEPS[name] += steps
    ROUTED_CALLS[name] += 1
    ROUTED_MS[name] += (time.perf_counter() - t0) * 1e3


def _routed_seed(fm: FMPair, reads, lens, parents, params, S: int):
    """K3's contract (_launch_seed's outputs) on a shard of the tables, by
    steps (_step_loop): a warp a lane, a step a base. smem_route_step takes
    each lane from the rows it asked for to its next ask, one extension in
    the forward phase and passes 2 and 3, every interval of the list in a
    backward round, and writes the owned rows of that ask. The ranks of the
    group run it in lockstep on the same lanes."""
    dev = kernels.check_cuda(fm.tab, reads, lens, parents)
    B, L = reads.shape
    lib = _route_lib()
    W = fm.tab.shape[-1]
    rows = torch.empty((B, S, 5), dtype=fm.rdt, device=dev)
    n = torch.empty(B, dtype=torch.int32, device=dev)
    ov = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return rows, n, ov
    states = torch.zeros((B, int(lib.smem_route_state_bytes())),
                         dtype=torch.uint8, device=dev)
    lists = torch.empty((B, int(lib.smem_route_list_bytes(L))),
                        dtype=torch.uint8, device=dev)
    buf = torch.empty((B, int(lib.smem_route_slots(L)), W), dtype=torch.int32,
                      device=dev)
    cnt = torch.empty((2, B), dtype=torch.int32, device=dev)
    P = kernels.ptr

    def launch():
        kernels.launch(lib, "smem_route_step", "smem_route_step", dev,
                       int(fm.wide), P(fm.L2), P(fm.primary), fm.seq_len,
                       fm.n64_global, P(fm.tab), fm.tab.shape[0],
                       fm.shard_index * fm.tab.shape[0], P(reads), P(lens),
                       P(parents), B, L, *params, S, P(states), P(buf),
                       P(cnt), P(lists), P(rows), P(n), P(ov))
    _step_loop(fm, "smem_route_step", launch, buf, cnt)
    return rows, n, ov


def _routed_sa(fm: FMPair, which, k) -> torch.Tensor:
    """sa_batch on a shard of the tables, by steps (_step_loop):
    sa_route_step walks every job one inverse-Psi step on the two rows it
    asked for and writes the owned rows of its next step; then each
    finished job's SA sample comes through route_gather and the group's
    sum, and a last launch adds the steps."""
    from ..parallel.mesh import group_sum
    dev = kernels.check_cuda(fm.tab, fm.sa_samples, which, k)
    n = k.numel()
    out = torch.empty(n, dtype=fm.rdt, device=dev)
    if n == 0:
        return out
    lib = _route_lib()
    W = fm.tab.shape[-1]
    kk = torch.empty(n, dtype=torch.int64, device=dev)
    add = torch.empty(n, dtype=torch.int64, device=dev)
    buf = torch.empty((n, 2, W), dtype=torch.int32, device=dev)
    cnt = torch.empty((2, n), dtype=torch.int32, device=dev)
    sample_req = torch.empty(n, dtype=torch.int64, device=dev)
    P = kernels.ptr
    mode = [0]

    def step(samples=None):
        kernels.launch(lib, "sa_route_step", "sa_route_step", dev,
                       int(fm.wide), P(fm.L2), P(fm.primary), fm.seq_len,
                       fm.n64_global, P(fm.tab), fm.tab.shape[0],
                       fm.shard_index * fm.tab.shape[0], P(which), P(k), n,
                       fm.sa_intv.bit_length() - 1, fm.n_sa_global, mode[0],
                       P(kk), P(add), P(buf), P(cnt), P(sample_req),
                       P(samples) if samples is not None else None, P(out))
        mode[0] = 1
    _step_loop(fm, "sa_route_step", step, buf, cnt)
    S_l = fm.sa_samples.shape[0]
    samples = group_sum(route_gather(fm.sa_samples, fm.shard_index * S_l,
                                     sample_req), fm.group)
    mode[0] = 2
    step(samples.contiguous())
    return out
