"""Batched banded GLOBAL alignment with CIGAR (exact ksw_global2).

Port of biscuit_tpu/ops/pallas_global.py: `sw_global_batch` (the Pallas
kernel `_glob_kernel`) returns (score [B], z) and `global_traceback` (an
XLA while_loop there) returns (ops [max_ops, B], n_ops [B], ov [B]).
`sw_global_cigar` is the two behind each other, (score, ops, n_ops, ov),
which on the card is one launch: what the engine calls.

z is [ceil(Lt/4), Lq, B] int32 with four direction bytes per word (target
row i at bits 8*(i&3)); cells outside a lane's band, and rows at or past
its target length, hold 0. The JAX z has the same values on its first B
lanes (it pads lanes to a multiple of 128). On the card z lies lane-major
in memory ([B, ceil(Lt/4), Lq], so that a warp stores a lane's words as
runs) and is returned as the permuted view of that shape: equal in every
element, not contiguous. Both tracebacks take a z of any strides.

Direction bits per cell (ops/sw.py:176-184):
  bits 0-1: which of M/E/F made H (0=M, 1=E, 2=F)
  bit  2  : E(i+1) extended from E (not opened from M)
  bit  5  : F(i, j+1) extended from F

On a CUDA device all three run in K2 (kernels/sw_global.cu: a warp per
lane, the H and E rows in registers in strips of C columns a thread, F by
a warp scan, each word of z written once; the instance of C is picked from
Lq, the wide instance past the widest C); on the CPU the plain torch
versions below run, following the JAX code step by step.
"""
import ctypes

import numpy as np
import torch

from .. import kernels
from . import strip_scan
from .strip_scan import MINUS_INF, VERYNEG

MAX_OPS = 64


def sw_global_batch_plain(query, qlens, target, tlens, mat_b, w,
                          o_del, e_del, o_ins, e_ins):
    """query [B, Lq], target [B, Lt] int32; qlens [B]; tlens and w [B]
    already clamped to >= 1; mat_b [B, 25]. Returns (score [B], z)."""
    B, Lq = query.shape
    Lt = target.shape[1]
    dev = query.device
    i32 = torch.int32
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jcell = torch.arange(Lq, dtype=i32, device=dev)[None, :]
    jfull = torch.arange(Lq + 1, dtype=i32, device=dev)[None, :]
    lane = torch.arange(B, device=dev)
    mi = torch.tensor(MINUS_INF, dtype=i32, device=dev)
    vneg = torch.full((B, 1), VERYNEG, dtype=i32, device=dev)

    h = torch.where(jfull == 0, 0,
                    torch.where((jfull <= w[:, None]) & (jfull <= qlens[:, None]),
                                -(o_ins + e_ins * jfull), mi)).to(i32)
    e = torch.full((B, Lq), MINUS_INF, dtype=i32, device=dev)
    prof = torch.stack([mat_b.gather(1, t * 5 + query.long())
                        for t in range(5)], 1)                 # [B, 5, Lq]
    Lt4 = (Lt + 3) // 4
    z = torch.zeros((Lt4, Lq, B), dtype=i32, device=dev)
    for i in range(Lt):
        run = i < tlens
        beg = torch.clamp(i - w, min=0)
        end = torch.clamp(torch.minimum(i + w + 1, qlens), max=Lq)
        h1_first = torch.where(beg == 0, -(o_del + e_del * (i + 1)), mi)
        S = prof[lane, target[:, i].long()]
        jm = (jcell >= beg[:, None]) & (jcell < end[:, None])
        M = h[:, :-1] + S
        E = e
        # F(beg) = MINUS_INF; F(j) = max(F(j-1) - e_ins, M(j-1) - oe_ins)
        b_arr = torch.where(jm, (M - oe_ins) + jcell * e_ins, VERYNEG)
        cm = torch.cummax(b_arr, 1).values
        cm_excl = torch.cat([vneg, cm[:, :-1]], 1)
        F = torch.maximum(MINUS_INF - (jcell - beg[:, None]) * e_ins,
                          cm_excl - (jcell - 1) * e_ins)
        ME = torch.maximum(M, E)
        H = torch.maximum(ME, F)
        d = torch.where(M >= E, 0, 1)
        d = torch.where(H > ME, 2, d)
        d = d | (((E - e_del) > (M - oe_del)).to(i32) << 2)
        d = d | (((F - e_ins) > (M - oe_ins)).to(i32) << 5)
        d = torch.where(run[:, None] & jm, d, 0).to(i32)
        z[i >> 2] |= (d << ((i & 3) << 3)).t()

        Hsh = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev), H], 1)
        jmsh = (jfull >= (beg + 1)[:, None]) & (jfull <= end[:, None])
        newh = torch.where(jfull == beg[:, None], h1_first[:, None],
                           torch.where(jmsh, Hsh, h))
        newe = torch.where(jm, torch.maximum(E - e_del, M - oe_del),
                           torch.where(jcell == end[:, None], mi, e))
        h = torch.where(run[:, None], newh, h)
        e = torch.where(run[:, None], newe, e)
    score = h.gather(1, qlens.long()[:, None])[:, 0]
    return score, z


def _push(st, op, ln, mask, max_ops):
    """Run-length push (scalar push(), ops/sw.py:197-201), masked."""
    ops, n, last_op, last_len, ov = st
    same = mask & (last_op == op)
    newr = mask & (~same)
    emit = newr & (last_op >= 0)
    slot = torch.clamp(n, max=max_ops - 1).long()
    lanes = torch.nonzero(emit).flatten()
    ops[slot[lanes], lanes] = (last_op | (last_len << 4))[lanes]
    ov = ov | (emit & (n >= max_ops))
    n = torch.where(emit, n + 1, n)
    last_len = torch.where(same, last_len + ln, torch.where(newr, ln, last_len))
    last_op = torch.where(newr, op, last_op)
    return ops, n, last_op, last_len, ov


def global_traceback_plain(z, qlens, tlens, w, max_ops: int = MAX_OPS):
    """Plain torch traceback: the lockstep loop of pallas_global.py:242-315
    over the lanes still walking."""
    Lt4, Lq, B = z.shape
    dev = z.device
    i32 = torch.int32
    zb = z.reshape(Lt4 * Lq, B).t()                        # [B, Lt4*Lq]
    i = tlens.to(i32) - 1
    k = torch.minimum(i + w.to(i32) + 1, qlens.to(i32)) - 1
    which = torch.zeros(B, dtype=i32, device=dev)
    st = (torch.zeros((max_ops, B), dtype=i32, device=dev),
          torch.zeros(B, dtype=i32, device=dev),
          torch.full((B,), -1, dtype=i32, device=dev),
          torch.zeros(B, dtype=i32, device=dev),
          torch.zeros(B, dtype=torch.bool, device=dev))
    one = torch.ones(B, dtype=i32, device=dev)
    while True:
        act = (i >= 0) & (k >= 0)
        if not bool(act.any()):
            break
        isafe = torch.where(act, i, 0)
        ksafe = torch.where(act, k, 0)
        row = ((isafe >> 2) * Lq + ksafe).long()
        word = zb.gather(1, row[:, None])[:, 0]
        byte = (word >> ((isafe & 3) << 3)) & 0xFF
        wh = (byte >> (which << 1)) & 3
        is_m = act & (wh == 0)
        is_d = act & (wh == 1)
        is_i = act & (wh >= 2)
        st = _push(st, 0, one, is_m, max_ops)
        st = _push(st, 2, one, is_d, max_ops)
        st = _push(st, 1, one, is_i, max_ops)
        i = torch.where(is_m | is_d, i - 1, i)
        k = torch.where(is_m | is_i, k - 1, k)
        which = torch.where(act, wh, which)
    st = _push(st, 2, i + 1, i >= 0, max_ops)
    st = _push(st, 1, k + 1, k >= 0, max_ops)
    st = _push(st, 3, torch.zeros_like(one), torch.ones_like(act), max_ops)
    ops, n, _lo, _ll, ov = st
    idx = torch.arange(max_ops, dtype=i32, device=dev)[:, None]
    rev = torch.clamp(n[None, :] - 1 - idx, 0, max_ops - 1).long()
    ops_rev = ops.gather(0, rev)
    ops_rev = torch.where(idx < n[None, :], ops_rev, 0).to(i32)
    return ops_rev, n, ov


def sw_global_cigar_plain(query, qlens, target, tlens, mat_b, w,
                          o_del, e_del, o_ins, e_ins, max_ops: int = MAX_OPS):
    """The plain DP and the plain traceback behind it: tlens and w raw (the
    DP clamps them to >= 1, the traceback does not). Returns (score, ops,
    n_ops, ov)."""
    score, z = sw_global_batch_plain(
        query, qlens, target, torch.clamp(tlens, min=1), mat_b,
        torch.clamp(w, min=1), o_del, e_del, o_ins, e_ins)
    return (score, *global_traceback_plain(z, qlens, tlens, w, max_ops))


# (query, target, mat_b, qlens, tlens, w, scratch, score, z,
#  B, Lq, Lt, code_bytes, C, o_del, e_del, o_ins, e_ins)
_SIG_DP = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
# (query, target, mat_b, qlens, tlens, w, scratch, score, z, ops, n_ops, ov,
#  B, Lq, Lt, code_bytes, C, o_del, e_del, o_ins, e_ins, max_ops)
_SIG_CIGAR = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
# (z, qlens, tlens, w, ops, n_ops, ov, B, max_ops, z's three strides in words)
_SIG_TB = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_int64] * 3


def _lib():
    lib = kernels.load("sw_global", {"sw_global": _SIG_DP,
                                     "sw_global_cigar": _SIG_CIGAR,
                                     "global_traceback": _SIG_TB})
    lib.sw_global_scratch_words.restype = ctypes.c_int64
    return lib


def resident_warps(C: int, Lq: int = 0) -> int:
    """Warps (lanes of the batch) of K2's fused instance C that one SM
    holds at once (of the wide instance, C = 0, at query width Lq), from the
    CUDA occupancy calculator."""
    return int(_lib().sw_global_resident_warps(C, Lq))


def _launch(query, qlens, target, tlens, mat_b, w, o_del: int, e_del: int,
            o_ins: int, e_ins: int, max_ops: int = 0):
    """Launch K2 on prepared inputs: query [B, Lq], target [B, Lt] uint8 or
    int32 codes as they come (lane-major, one lane's row contiguous), mat_b
    [B, 25] and qlens, tlens, w [B] (raw: the kernel clamps tlens and w to
    >= 1 for the DP), all int32. max_ops = 0: the DP alone, returns (score
    [B], z as the [ceil(Lt/4), Lq, B] view of its lane-major memory). Else
    the DP with the traceback behind it in the same launch: (score, ops
    [max_ops, B], n_ops [B], ov [B] bool), z being scratch. No host sync."""
    i32 = torch.int32
    B, Lq = query.shape
    Lt = target.shape[1]
    C = strip_scan.strip_width(Lq)
    dev = kernels.check_cuda(query, target, mat_b, qlens, tlens, w)
    kernels.check_lanes(B, qlens, tlens, w)
    score = torch.empty(B, dtype=i32, device=dev)
    z = torch.empty((B, (Lt + 3) // 4, Lq), dtype=i32, device=dev)
    scratch = (strip_scan.wide_scratch(_lib(), "sw_global_scratch_words",
                                       C, B, Lq, dev) if B else None)
    head = (kernels.ptr(query), kernels.ptr(target), kernels.ptr(mat_b),
            kernels.ptr(qlens), kernels.ptr(tlens), kernels.ptr(w),
            kernels.ptr(scratch) if scratch is not None else None,
            kernels.ptr(score), kernels.ptr(z))
    sizes = (B, Lq, Lt, query.element_size(), C, o_del, e_del, o_ins, e_ins)
    if max_ops == 0:
        if B:
            kernels.launch(_lib(), "sw_global", "sw_global", dev, *head, *sizes)
        return score, z.permute(1, 2, 0)
    if not 1 <= max_ops <= MAX_OPS:
        raise ValueError(f"max_ops must be in [1, {MAX_OPS}]")
    ops = torch.empty((max_ops, B), dtype=i32, device=dev)
    n_ops = torch.empty(B, dtype=i32, device=dev)
    ov = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        kernels.launch(_lib(), "sw_global_cigar", "sw_global", dev, *head,
                       kernels.ptr(ops), kernels.ptr(n_ops), kernels.ptr(ov),
                       *sizes, max_ops)
    return score, ops, n_ops, ov


def _prepared(qlens, tlens, mats, matsel, w):
    """Each lane's matrix [B, 25] and the per-lane vectors as int32."""
    i32 = torch.int32
    mat_b = mats.to(i32)[matsel.long()].reshape(-1, 25).contiguous()
    return mat_b, qlens.to(i32), tlens.to(i32), w.to(i32)


def sw_global_batch(query, qlens, target, tlens, mats, matsel,
                    o_del: int, e_del: int, o_ins: int, e_ins: int, w):
    """Banded global DP for a padded batch. query [B, Lq], target [B, Lt]
    (codes 0-4, pad 4), qlens/tlens/w/matsel [B], mats [M, 5, 5]. Returns
    (score [B] int32, z [ceil(Lt/4), Lq, B] int32; on the card a permuted
    view of lane-major memory)."""
    i32 = torch.int32
    mat_b, qlens, tlens, w = _prepared(qlens, tlens, mats, matsel, w)
    if kernels.route(query) == "plain":
        return sw_global_batch_plain(
            query.to(i32), qlens, target.to(i32), torch.clamp(tlens, min=1),
            mat_b, torch.clamp(w, min=1), o_del, e_del, o_ins, e_ins)
    query, target = strip_scan.kernel_codes(query, target)
    return _launch(query, qlens, target, tlens, mat_b, w,
                   o_del, e_del, o_ins, e_ins)


def sw_global_cigar(query, qlens, target, tlens, mats, matsel,
                    o_del: int, e_del: int, o_ins: int, e_ins: int, w,
                    max_ops: int = MAX_OPS):
    """sw_global_batch and global_traceback behind it (raw tlens and w, as
    the two take them): (score [B], ops [max_ops, B] packed op|len<<4 in
    reference order, n_ops [B], ov [B] bool). One launch of K2 on the card;
    the composition of the two plain versions on the CPU."""
    i32 = torch.int32
    mat_b, qlens, tlens, w = _prepared(qlens, tlens, mats, matsel, w)
    if kernels.route(query) == "plain":
        return sw_global_cigar_plain(query.to(i32), qlens, target.to(i32),
                                     tlens, mat_b, w, o_del, e_del, o_ins,
                                     e_ins, max_ops)
    if not 1 <= max_ops <= MAX_OPS:
        raise ValueError(f"max_ops must be in [1, {MAX_OPS}]")
    query, target = strip_scan.kernel_codes(query, target)
    return _launch(query, qlens, target, tlens, mat_b, w,
                   o_del, e_del, o_ins, e_ins, max_ops)


def global_traceback(z, qlens, tlens, w, max_ops: int = MAX_OPS):
    """Traceback over z from sw_global_batch (raw, unclamped tlens and w); z
    may have any strides. Returns (ops [max_ops, B] int32 packed op|len<<4
    in reference order, n_ops [B] int32, ov [B] bool: the lane needed more
    than max_ops runs)."""
    i32 = torch.int32
    if kernels.route(z) == "plain":
        return global_traceback_plain(z, qlens, tlens, w, max_ops)
    if not 1 <= max_ops <= MAX_OPS:
        raise ValueError(f"max_ops must be in [1, {MAX_OPS}]")
    if z.dim() != 3 or z.dtype != i32:
        raise ValueError("z must be a [ceil(Lt/4), Lq, B] int32 tensor")
    B = z.shape[2]
    qlens, tlens, w = (x.to(i32).contiguous() for x in (qlens, tlens, w))
    dev = kernels.check_cuda(qlens, tlens, w)
    if z.device != dev:
        raise ValueError(f"tensors on {z.device} and {dev}")
    kernels.check_lanes(B, qlens, tlens, w)
    ops = torch.empty((max_ops, B), dtype=i32, device=dev)
    n_ops = torch.empty(B, dtype=i32, device=dev)
    ov = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return ops, n_ops, ov
    kernels.launch(_lib(), "global_traceback", "global_traceback", dev,
                   kernels.ptr(z), kernels.ptr(qlens), kernels.ptr(tlens),
                   kernels.ptr(w), kernels.ptr(ops), kernels.ptr(n_ops),
                   kernels.ptr(ov), B, max_ops, *z.stride())
    return ops, n_ops, ov


def decode_cigars(ops: np.ndarray, n_ops: np.ndarray):
    """[max_ops, B], [B] -> list of [(op, len), ...] per lane."""
    out = []
    for b in range(ops.shape[1]):
        n = int(n_ops[b])
        out.append([(int(ops[j, b]) & 15, int(ops[j, b]) >> 4)
                    for j in range(n)])
    return out
