"""Pileup window counts: a scatter-add of (site, code) pairs (K9).

Port of `pileup_count_window` in biscuit_tpu/parallel/mesh.py (an XLA
scatter-add) and of the count matrices the pileup engine's `_device_counts`
makes from two calls of it (biscuit_tpu/pileup/engine.py).

`pileup_window_counts` is the engine's call: for one window, every aligned
read base is a datum with an int32 site index (site * n_bams + sample), a
uint8 code base * 3 + meth and a pass flag; it returns int32 [window, 11]:
the methylation counts cm (3), the base counts cb (7) of the passing data
whose code is below 21, and the depth dp (1) of every datum, the sums that
the JAX engine takes on the host from a [window, 32] count matrix and a
[window, 1] depth matrix. A passing code in [21, 32) counts in neither cm
nor cb (the JAX slice `counts[:, :21]` drops it).

`pileup_count_window` keeps the general contract of mesh.py: the counts of
the valid data per (position, code), int32 [window, n_codes]. The JAX
function sends the other data to a spill bin that it then cuts off; here
they are skipped.

XLA drops an index past the end and wraps a negative one; the pileup engine
never makes either. Both entries refuse them instead, on both routes: a
datum (the general entry: a valid datum) with a site outside [0, window), a
passing datum with a code outside [0, 32) (the general entry: a valid one
outside [0, n_codes)) raises ValueError. (The JAX function also lets a code
>= n_codes spill into the next site's bins; that is refused too.)

On a CUDA tensor both launch kernels/pileup_count.cu (a block a chunk of
data, the chunk's bins in shared memory; a chunk whose sites spread too far
adds straight into device memory and is counted); on a CPU tensor they run
their plain versions, torch.bincount. Counts are integers, so the two agree
exactly whatever the order of the atomics.
"""
import ctypes

import torch

from .. import kernels


def _check_args(positions, stat, valid, window: int, n_codes: int) -> int:
    n = positions.numel()
    if positions.dim() != 1 or stat.shape != positions.shape \
            or valid.shape != positions.shape:
        raise ValueError(f"positions {tuple(positions.shape)}, stat "
                         f"{tuple(stat.shape)}, valid {tuple(valid.shape)}: "
                         "three vectors of one length")
    if positions.dtype not in (torch.int32, torch.int64) \
            or stat.dtype != positions.dtype:
        raise ValueError(f"positions of {positions.dtype} and stat of "
                         f"{stat.dtype}: both int32 or both int64")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid of {valid.dtype}: bool")
    if window < 0 or n_codes < 1 or window * n_codes >= 2 ** 31 - 2:
        raise ValueError(f"window={window}, n_codes={n_codes}")
    return n


def _raise_refused(n_refused: int, window: int, n_codes: int):
    raise ValueError(f"{n_refused} valid data outside window={window} "
                     f"or n_codes={n_codes}")


def _raise_refused_fused(n_refused: int, window: int):
    raise ValueError(f"{n_refused} data outside window={window} or passing "
                     "with a code outside [0, 32)")


# the fused counts: words a site, and where each lies
N_WORDS, N_CODES_COUNTED = 11, 21     # cm 3 + cb 7 + dp 1; base * 3 + meth
CM, CB, DP = slice(0, 3), slice(3, 10), 10
FUSED_CHUNK = 8192   # data a block of the fused kernel takes


def _check_fused(sites, codes, passm, window: int) -> int:
    n = sites.numel()
    if sites.dim() != 1 or codes.shape != sites.shape \
            or passm.shape != sites.shape:
        raise ValueError(f"sites {tuple(sites.shape)}, codes "
                         f"{tuple(codes.shape)}, pass {tuple(passm.shape)}: "
                         "three vectors of one length")
    if sites.dtype != torch.int32 or codes.dtype != torch.uint8 \
            or passm.dtype != torch.bool:
        raise ValueError(f"sites of {sites.dtype}, codes of {codes.dtype}, "
                         f"pass of {passm.dtype}: int32, uint8 and bool")
    if window < 0 or window * N_WORDS >= 2 ** 31 - 2:
        raise ValueError(f"window={window}")
    return n


def pileup_window_counts_plain(sites, codes, passm, window: int):
    """cm, cb and dp of a window by three torch.bincounts: int32
    [window, 11]."""
    _check_fused(sites, codes, passm, window)
    s, c = sites.long(), codes.long()
    bad = int(((s < 0) | (s >= window) | (passm & (c >= 32))).sum())
    if bad:
        _raise_refused_fused(bad, window)
    keep = passm & (c < N_CODES_COUNTED)
    sk, ck = s[keep], c[keep]
    cm = torch.bincount(sk * 3 + ck % 3, minlength=window * 3)
    cb = torch.bincount(sk * 7 + ck // 3, minlength=window * 7)
    dp = torch.bincount(s, minlength=window)
    return torch.cat([cm.reshape(window, 3), cb.reshape(window, 7),
                      dp.reshape(window, 1)], 1).to(torch.int32)


def pileup_count_window_plain(positions, stat, valid, window: int,
                              n_codes: int = 32) -> torch.Tensor:
    """The counts by one torch.bincount over the valid data."""
    _check_args(positions, stat, valid, window, n_codes)
    p, s = positions[valid].long(), stat[valid].long()
    bad = (p < 0) | (p >= window) | (s < 0) | (s >= n_codes)
    if bool(bad.any()):
        _raise_refused(int(bad.sum()), window, n_codes)
    counts = torch.bincount(p * n_codes + s, minlength=window * n_codes)
    return counts.to(torch.int32).reshape(window, n_codes)


_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
_SIG_FUSED = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]


def _lib():
    return kernels.load("pileup_count", {"pileup_count_i32": _SIG,
                                         "pileup_count_i64": _SIG,
                                         "pileup_window_counts": _SIG_FUSED})


def _launch_fused(sites, codes, passm, window: int) -> torch.Tensor:
    """Zero the counts and launch K9's fused entry: int32 [window * 11 + 2]
    on the inputs' device, the last two words counting the refused data and
    the chunks that took the device-memory path. No host sync."""
    n = _check_fused(sites, codes, passm, window)
    dev = kernels.check_cuda(sites, codes, passm)
    out = torch.zeros(window * N_WORDS + 2, dtype=torch.int32, device=dev)
    if n:
        kernels.launch(_lib(), "pileup_window_counts", "pileup_window_counts",
                       dev, kernels.ptr(sites), kernels.ptr(codes),
                       kernels.ptr(passm), n, window, kernels.ptr(out))
    return out


def pileup_window_counts(sites, codes, passm, window: int):
    """cm, cb and dp of a window: (int32 [window, 11] on the device of
    `sites`, the number of chunks that took the kernel's device-memory path,
    None on the plain route). K9's fused entry on CUDA, three bincounts on
    the CPU; a datum out of range raises ValueError in both."""
    if kernels.route(sites) == "plain":
        return pileup_window_counts_plain(sites, codes, passm, window), None
    out = _launch_fused(sites, codes, passm, window)
    n_refused, n_wide = out[-2:].tolist()  # waits for the kernel
    if n_refused:
        _raise_refused_fused(n_refused, window)
    return out[:-2].reshape(window, N_WORDS), n_wide


def _launch(positions, stat, valid, window: int, n_codes: int) -> torch.Tensor:
    """Zero the counts and launch K9's general entry: int32 [window *
    n_codes + 2] on the inputs' device, the last two words counting the
    refused data and the chunks that took the device-memory path. No host
    sync."""
    n = _check_args(positions, stat, valid, window, n_codes)
    positions, stat, valid = (t.contiguous() for t in (positions, stat, valid))
    dev = kernels.check_cuda(positions, stat, valid)
    counts = torch.zeros(window * n_codes + 2, dtype=torch.int32, device=dev)
    if n:
        fn = ("pileup_count_i64" if positions.dtype == torch.int64
              else "pileup_count_i32")
        kernels.launch(_lib(), fn, "pileup_count", dev, kernels.ptr(positions),
                       kernels.ptr(stat), kernels.ptr(valid), n, window,
                       n_codes, kernels.ptr(counts))
    return counts


def pileup_count_window(positions, stat, valid, window: int,
                        n_codes: int = 32) -> torch.Tensor:
    """Counts of the valid data per (position, code): int32 [window,
    n_codes] on the device of `positions`. K9's general entry on CUDA, the
    plain version on the CPU; a valid datum out of range raises ValueError
    in both."""
    if kernels.route(positions) == "plain":
        return pileup_count_window_plain(positions, stat, valid, window,
                                         n_codes)
    counts = _launch(positions, stat, valid, window, n_codes)
    n_refused = int(counts[-2])  # waits for the kernel
    if n_refused:
        _raise_refused(n_refused, window, n_codes)
    return counts[:-2].reshape(window, n_codes)
