"""FM tables on the device and the batched SA walk.

Port of the parts of biscuit_tpu/ops/seed_batch.py that the device engine
needs while seeding stays on the host: the fused occ+BWT table
(`_fused_tab`, copied as is), `FMPair` (the tables carried to the device)
and `sa_batch` (the bwt_sa walk for a batch of ranks; the JAX version is
an XLA while_loop, `seed_batch.py:sa_batch`).

`sa_batch` launches the CUDA kernel kernels/sa_walk.cu on a CUDA device and
runs `sa_batch_plain` on the CPU. torch on the CPU has no popcount and no
`>>` or `~` on uint32, so the table is held as int32 (the uint32 bit
pattern) and widened to int64 and masked before any shift.
"""
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from biscuit_tpu.index.fmindex import BisIndex

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
    Narrow indexes walk int32 ranks, wide ones (strands >= 2^31) int64."""
    tab: torch.Tensor
    L2: torch.Tensor
    primary: torch.Tensor
    sa_samples: torch.Tensor
    seq_len: int
    wide: bool
    sa_intv: int

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
            seq_len=int(seq_len), wide=bool(wide), sa_intv=int(sa_intv))

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
    """One inverse-Psi step of seed_batch.sa_batch for int64 ranks."""
    W = fm.tab.shape[-1]
    prim = fm.primary[which]
    j = kk - (kk >= prim).long()
    row = fm.tab[which, j >> 6].long() & _M32           # [n, W]
    words = row[:, W - 4:]                              # [n, 4]
    wi = (j >> 4) & 3
    tl = (~j) & 15
    word = words.gather(1, wi[:, None])[:, 0]
    c = (word >> (tl << 1)) & 3
    # class-c count over words 0..wi, the selected word cut after position j
    q = torch.arange(4, device=kk.device)[None, :]
    sel = q == wi[:, None]
    sh = (tl << 1)[:, None]
    wm = torch.where(sel, (words >> sh) << sh, words)
    inv = (~wm) & _M32
    hi = torch.where((c & 2)[:, None] != 0, wm, inv) >> 1
    lo = torch.where((c & 1)[:, None] != 0, wm, inv)
    cnt = _popcount32(hi & lo & _M55)
    cnt = cnt - torch.where(sel & (c == 0)[:, None], tl[:, None], 0)
    cnt = torch.where(q <= wi[:, None], cnt, 0).sum(1)
    acc = row.gather(1, c[:, None])[:, 0]
    if fm.wide:
        acc = acc | (row.gather(1, (c + 4)[:, None])[:, 0] << 32)
    nxt = fm.L2[which, c] + acc + cnt
    return torch.where(kk == prim, torch.zeros_like(nxt), nxt)


def sa_batch_plain(fm: FMPair, which: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain torch bwt_sa walk: a vectorized while over the jobs still
    walking. which [n] int32 in {0, 1}, k [n] ranks -> positions [n] of the
    rank dtype."""
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
    shift = fm.sa_intv.bit_length() - 1
    return (add + fm.sa_samples[w, kk >> shift].long()).to(fm.rdt)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

# (tab, L2, primary, sa_samples, which, k, n64, n_sa, sa_shift, out, n)
_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [ctypes.c_int,
                                                      ctypes.c_void_p,
                                                      ctypes.c_int64]


def _lib():
    return kernels.load("sa_walk", {"sa_walk_narrow": _SIG,
                                    "sa_walk_wide": _SIG})


def sa_batch(fm: FMPair, which: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Batched SA lookup: which [n] int32 strand ids, k [n] ranks (the rank
    dtype) -> text positions [n] of the rank dtype. K4 on CUDA (one thread
    per job), the plain walk on the CPU."""
    if kernels.route(k) == "plain":
        return sa_batch_plain(fm, which, k)
    which = which.to(torch.int32).contiguous()
    k = k.to(fm.rdt).contiguous()
    dev = kernels.check_cuda(fm.tab, which, k)
    n = k.numel()
    kernels.check_lanes(n, which, k)
    out = torch.empty(n, dtype=fm.rdt, device=dev)
    if n == 0:
        return out
    n64, n_sa = fm.tab.shape[1], fm.sa_samples.shape[1]
    fn = "sa_walk_wide" if fm.wide else "sa_walk_narrow"
    kernels.launch(_lib(), fn, "sa_walk", dev,
                   kernels.ptr(fm.tab), kernels.ptr(fm.L2),
                   kernels.ptr(fm.primary), kernels.ptr(fm.sa_samples),
                   kernels.ptr(which), kernels.ptr(k), n64, n_sa,
                   fm.sa_intv.bit_length() - 1, kernels.ptr(out), n)
    return out
