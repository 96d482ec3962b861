"""Batched banded affine-gap Smith-Waterman extension (exact ksw_extend2).

Port of biscuit_tpu/ops/pallas_sw.py (`sw_extend_batch_pallas`, the
Pallas kernel `_sw_kernel`) with the inputs and the packed [6, B] int32
output of biscuit_tpu/ops/sw_batch.py:sw_extend_batch. Rows of the output:
score, qle, tle, gtle, gscore, max_off.

The band clamp (ksw.c:399-407) runs here for both paths, with the JAX
wrapper's float32 division truncated to int32. Then a CUDA tensor goes to
K1 (kernels/sw_extend.cu: a warp per lane, the DP row in registers in
strips of C columns a thread, F by a warp scan; the instance of C is picked
from Lq, the wide instance past the widest C) and a CPU tensor to
`sw_extend_batch_plain`, a row loop vectorized over lanes that follows
`_sw_kernel` step by step.
"""
import ctypes

import torch

from .. import kernels
from . import strip_scan

NEG = -(1 << 28)


def band_clamp(qlens, w_in, end_bonus, mats, o_del, e_del, o_ins, e_ins):
    """Per-lane band width clamp, as pallas_sw.py:231-237."""
    mmax = int(mats.max())
    max_ins = ((qlens * mmax + end_bonus - o_ins) / e_ins + 1.0).to(torch.int32)
    w = torch.minimum(w_in, torch.clamp(max_ins, min=1))
    max_del = ((qlens * mmax + end_bonus - o_del) / e_del + 1.0).to(torch.int32)
    return torch.minimum(w, torch.clamp(max_del, min=1))


def sw_extend_batch_plain(query, qlens, target, tlens, mat_b, w, h0,
                          o_del, e_del, o_ins, e_ins, zdrop, filled=None):
    """query [B, Lq], target [B, Lt] int32 codes; qlens, tlens, w (already
    clamped), h0 [B] int32; mat_b [B, 25] per-lane matrix (row = target
    char). Returns [6, B] int32. `filled`, a [B] int64 tensor, receives the
    DP cells each lane fills: the columns [beg, end) of every row it runs
    before it breaks, which are the cells the kernel's lane fills too."""
    B, Lq = query.shape
    Lt = target.shape[1]
    dev = query.device
    i32 = torch.int32
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jcell = torch.arange(Lq, dtype=i32, device=dev)[None, :]
    jfull = torch.arange(Lq + 1, dtype=i32, device=dev)[None, :]
    lane = torch.arange(B, device=dev)

    # first H row (ksw.c:395-397): closed-form decay chain
    h1v = torch.clamp(h0 - oe_ins, min=0)
    decay = torch.clamp(h1v[:, None] - (jfull - 1) * e_ins, min=0)
    zero = torch.zeros((), dtype=i32, device=dev)
    h = torch.where(jfull == 0, h0[:, None],
                    torch.where(jfull <= qlens[:, None], decay, zero))
    e = torch.zeros((B, Lq + 1), dtype=i32, device=dev)
    # query profiles: prof[b, t, j] = mat_b[b, t*5 + query[b, j]]
    prof = torch.stack([mat_b.gather(1, t * 5 + query.long())
                        for t in range(5)], 1)
    end = qlens.clone()
    mx = h0.clone()
    max_i = torch.full((B,), -1, dtype=i32, device=dev)
    max_j, max_ie, gscore = max_i.clone(), max_i.clone(), max_i.clone()
    max_off = torch.zeros(B, dtype=i32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    negc = torch.full((B, 1), NEG, dtype=i32, device=dev)

    n_rows = min(Lt, int(tlens.max())) if B else 0
    for i in range(n_rows):
        if bool(done.all()):
            break
        act = (~done) & (i < tlens)
        beg_i = torch.clamp(i - w, min=0)
        end_i = torch.minimum(torch.minimum(end, i + w + 1), qlens)
        collapsed = act & (beg_i >= end_i)
        run = act & (beg_i < end_i)
        at_tail = end_i == qlens
        if filled is not None:
            filled += torch.where(run, end_i - beg_i, zero)

        S = prof[lane, target[:, i].long()]                     # [B, Lq]
        h1_first = torch.where(
            beg_i == 0, torch.clamp(h0 - (o_del + e_del * (i + 1)), min=0), zero)
        jm = (jcell >= beg_i[:, None]) & (jcell < end_i[:, None])

        Hdiag = h[:, :-1]
        E = torch.where(jm, e[:, :-1], zero)
        M = torch.where(jm & (Hdiag != 0), Hdiag + S, zero)
        tF = torch.clamp(M - oe_ins, min=0)
        b_arr = torch.where(jm, tF + jcell * e_ins, NEG)
        cm = torch.cummax(b_arr, 1).values
        cm_shift = torch.cat([negc, cm[:, :-1]], 1)
        F = torch.where(jm, torch.clamp(cm_shift - (jcell - 1) * e_ins, min=0),
                        zero)
        H = torch.maximum(torch.maximum(M, E), F)

        m_val = torch.clamp(H.max(1).values, min=0)
        mj = torch.where(H == m_val[:, None], jcell, -1).max(1).values
        h1_last = torch.where(jcell == (end_i - 1)[:, None], H, NEG).max(1).values
        h1_last = torch.where(run & (h1_last != NEG), h1_last, zero)

        Hsh = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev), H], 1)
        newh = torch.where(jfull == beg_i[:, None], h1_first[:, None], Hsh)
        newe = torch.where(
            jm, torch.maximum(E - e_del, torch.clamp(M - oe_del, min=0)), zero)
        newe = torch.cat([newe, torch.zeros((B, 1), dtype=i32, device=dev)], 1)
        h = torch.where(run[:, None], newh, h)
        e = torch.where(run[:, None], newe, e)

        gup = run & at_tail & (gscore <= h1_last)
        gscore = torch.where(gup, h1_last, gscore)
        max_ie = torch.where(gup, i, max_ie)
        cq = collapsed & at_tail & (gscore <= h1_first)
        gscore = torch.where(cq, torch.maximum(gscore, h1_first), gscore)
        max_ie = torch.where(cq, i, max_ie)

        brk0 = run & (m_val == 0)
        improved = run & (m_val > mx)
        di = i - max_i
        dj = mj - max_j
        zd = torch.where(di > dj, mx - m_val - (di - dj) * e_del > zdrop,
                         mx - m_val - (dj - di) * e_ins > zdrop)
        zbrk = run & (~improved) & (zdrop > 0) & zd & (~brk0)
        max_off = torch.where(
            improved, torch.maximum(max_off, (mj - i).abs()), max_off)
        mx = torch.where(improved, m_val, mx)
        max_i = torch.where(improved, i, max_i)
        max_j = torch.where(improved, mj, max_j)

        # end carry: ksw truncates F at last_nz + 2
        nz = (h != 0) | (e != 0)
        last_nz = torch.where(nz & (jfull <= end_i[:, None]), jfull,
                              -1).max(1).values
        end = torch.where(run, torch.minimum(last_nz + 2, qlens), end_i)
        done = done | collapsed | brk0 | zbrk | (i + 1 >= tlens)
    return torch.stack([mx, max_j + 1, max_i + 1, max_ie + 1, gscore,
                        max_off]).to(i32)


def f_row_strips(M, beg, end, oe_ins: int, e_ins: int, C: int):
    """F of one row as K1 computes it, from M [B, Lq] and the band
    [beg, end) of each lane ([B] int32): tF = max(M - oe_ins, 0) inside the
    band and 0 outside it, the strip-and-carry scan, and the band's mask on
    the result (a carry that runs past `end` is dropped). For the CPU tests
    of the kernel's algebra; no caller on the main path."""
    j = torch.arange(M.shape[1], dtype=torch.int32)[None, :]
    jm = (j >= beg[:, None]) & (j < end[:, None])
    zero = torch.zeros((), dtype=M.dtype)
    tF = torch.where(jm, torch.clamp(M - oe_ins, min=0), zero)
    return torch.where(jm, strip_scan.f_row_strips(tF, e_ins, C), zero)


# (query, target, mat_b, qlens, tlens, w, h0, scratch, out,
#  B, Lq, Lt, code_bytes, C, o_del, e_del, o_ins, e_ins, zdrop)
_SIG = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10


def _lib():
    lib = kernels.load("sw_extend", {"sw_extend": _SIG})
    lib.sw_extend_scratch_words.restype = ctypes.c_int64
    return lib


def resident_warps(C: int, Lq: int = 0) -> int:
    """Warps (lanes of the batch) of K1's instance C that one SM holds at
    once (of the wide instance, C = 0, at query width Lq), from the CUDA
    occupancy calculator."""
    return int(_lib().sw_extend_resident_warps(C, Lq))


def _launch(query, qlens, target, tlens, mat_b, w, h0, o_del: int,
            e_del: int, o_ins: int, e_ins: int, zdrop: int) -> torch.Tensor:
    """Launch K1 on prepared inputs: query [B, Lq], target [B, Lt] uint8 or
    int32 codes as they come (lane-major, one lane's row contiguous), mat_b
    [B, 25] and qlens, tlens, w (clamped), h0 [B], all int32. Returns
    [6, B] int32. No host sync."""
    B, Lq = query.shape
    Lt = target.shape[1]
    C = strip_scan.strip_width(Lq)
    dev = kernels.check_cuda(query, target, mat_b, qlens, tlens, w, h0)
    kernels.check_lanes(B, qlens, tlens, w, h0)
    out = torch.empty((6, B), dtype=torch.int32, device=dev)
    if B:
        scratch = strip_scan.wide_scratch(_lib(), "sw_extend_scratch_words",
                                          C, B, Lq, dev)
        kernels.launch(_lib(), "sw_extend", "sw_extend", dev,
                       kernels.ptr(query), kernels.ptr(target),
                       kernels.ptr(mat_b), kernels.ptr(qlens),
                       kernels.ptr(tlens), kernels.ptr(w), kernels.ptr(h0),
                       kernels.ptr(scratch) if scratch is not None else None,
                       kernels.ptr(out), B, Lq, Lt, query.element_size(), C,
                       o_del, e_del, o_ins, e_ins, zdrop)
    return out


def sw_extend_batch(query, qlens, target, tlens, mats, matsel,
                    o_del: int, e_del: int, o_ins: int, e_ins: int,
                    w_in, end_bonus, zdrop: int, h0):
    """query [B, Lq], target [B, Lt] (codes 0..4), qlens/tlens/w_in/
    end_bonus/h0/matsel [B] int32, mats [M, 5, 5] int32. Returns [6, B]
    int32: score, qle, tle, gtle, gscore, max_off (exact ksw_extend2)."""
    i32 = torch.int32
    B = query.shape[0]
    qlens, tlens, h0 = qlens.to(i32), tlens.to(i32), h0.to(i32)
    mats = mats.to(i32)
    mat_b = mats[matsel.long()].reshape(B, 25)
    w = band_clamp(qlens, w_in.to(i32), end_bonus.to(i32), mats,
                   o_del, e_del, o_ins, e_ins)
    if kernels.route(query) == "plain":
        return sw_extend_batch_plain(query.to(i32), qlens, target.to(i32),
                                     tlens, mat_b, w, h0,
                                     o_del, e_del, o_ins, e_ins, zdrop)
    query, target = strip_scan.kernel_codes(query, target)
    return _launch(query, qlens, target, tlens, mat_b.contiguous(), w, h0,
                   o_del, e_del, o_ins, e_ins, zdrop)
