"""Pileup window counts: a scatter-add of (site, code) pairs (K9).

Port of `pileup_count_window` in biscuit_tpu/parallel/mesh.py (an XLA
scatter-add): every aligned read base of a window is one datum with a
window-relative position (site * n_bams + sample), a code (base * 3 + meth,
below n_codes) and a `valid` flag. The result counts the valid data per
(position, code): int32 [window, n_codes]. The JAX function sends the other
data to a spill bin that it then cuts off; here they are skipped.

XLA drops an index past the end and wraps a negative one; the pileup engine
never makes either. Both versions here refuse them instead: a valid datum
with a position outside [0, window) or a code outside [0, n_codes) raises
ValueError. (The JAX function also lets a code >= n_codes spill into the
next site's bins; that is refused too.)

`pileup_count_window` launches kernels/pileup_count.cu on a CUDA tensor
(one thread a datum, int32 atomics, int32 and int64 index variants) and
runs `pileup_count_window_plain` on a CPU tensor. Counts are integers, so
the two agree exactly whatever the order of the atomics.
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
    if window < 0 or n_codes < 1 or window * n_codes >= 2 ** 31 - 1:
        raise ValueError(f"window={window}, n_codes={n_codes}")
    return n


def _raise_refused(n_refused: int, window: int, n_codes: int):
    raise ValueError(f"{n_refused} valid data outside window={window} "
                     f"or n_codes={n_codes}")


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


def _lib():
    return kernels.load("pileup_count", {"pileup_count_i32": _SIG,
                                         "pileup_count_i64": _SIG})


def _launch(positions, stat, valid, window: int, n_codes: int) -> torch.Tensor:
    """Zero the counts and launch K9: int32 [window * n_codes + 1] on the
    inputs' device, the last word counting the refused data. No host sync."""
    n = _check_args(positions, stat, valid, window, n_codes)
    positions, stat, valid = (t.contiguous() for t in (positions, stat, valid))
    dev = kernels.check_cuda(positions, stat, valid)
    counts = torch.zeros(window * n_codes + 1, dtype=torch.int32, device=dev)
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
    n_codes] on the device of `positions`. K9 on CUDA, the plain version on
    the CPU; a valid datum out of range raises ValueError in both."""
    if kernels.route(positions) == "plain":
        return pileup_count_window_plain(positions, stat, valid, window,
                                         n_codes)
    counts = _launch(positions, stat, valid, window, n_codes)
    n_refused = int(counts[-1])  # waits for the kernel
    if n_refused:
        _raise_refused(n_refused, window, n_codes)
    return counts[:-1].reshape(window, n_codes)
