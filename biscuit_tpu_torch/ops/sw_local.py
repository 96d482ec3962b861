"""Batched local alignment (exact ksw_align2) for mate rescue.

Port of biscuit_tpu/ops/sw_local.py. `sw_local_batch` is K7, the XLA
function `sw_local_kernel`: a CUDA tensor goes to kernels/sw_local.cu (a
warp per lane, the DP row in registers in strips of C columns a thread, F
by a warp scan; the instance of C is picked from Lq, the wide instance past
the widest C) and a CPU tensor to `sw_local_batch_plain`, a row loop
vectorized over lanes that follows `sw_local_kernel` step by step. Both
return gmax, te, qe, shift, sat ([B] int32) and the per-row maxima
imax_rows ([Lt, B] int32), from which the host (`local_post`, copied
unchanged) replays the score2 runs. `sw_align_batch` assembles the forward
and the reverse pass as the JAX function of the same name does.

Per-lane quirks carried exactly (sw_local.py:7-19): the striped padding of
the query to 16 (u8 lanes) or 8 (i16 lanes) columns that score 0 and count
in the row maxima, columns past that forced to 0; u8 saturation once
gmax + shift >= 255; the endsc break after the row's update.
"""
import ctypes
from typing import List, Optional

import numpy as np
import torch

from ..ops.sw import KswResult

from .. import kernels
from . import strip_scan

NEGB = -(1 << 28)


def sw_local_batch_plain(query, qlens, target, tlens, mat_b, minsc, endsc, u8,
                         o_del: int, e_del: int, o_ins: int, e_ins: int):
    """query [B, Lq] int32 codes (Lq a multiple of 16), target [B, Lt];
    qlens, tlens, minsc, endsc, u8 [B] int32; mat_b [B, 25] per-lane matrix
    (row = target char). Returns the dict of `sw_local_kernel`. As there,
    minsc is not read: local_post applies it to the row maxima."""
    B, Lq = query.shape
    Lt = target.shape[1]
    dev = query.device
    i32 = torch.int32
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jcell = torch.arange(Lq, dtype=i32, device=dev)[None, :]
    zero = torch.zeros((), dtype=i32, device=dev)

    shift = torch.where(u8 > 0, (256 - mat_b.min(1).values) & 0xFF, zero)
    lanes = torch.where(u8 > 0, 16, 8).to(i32)
    ext = (qlens + lanes - 1) // lanes * lanes
    # prof[b, t, j] = mat_b[b, t*5 + query[b, j]]; pad columns score 0
    prof = torch.stack([mat_b.gather(1, t * 5 + query.long())
                        for t in range(5)], 1)
    prof = torch.where((jcell < qlens[:, None])[:, None, :], prof, zero)
    inb = jcell < ext[:, None]
    lane = torch.arange(B, device=dev)

    H = torch.zeros((B, Lq), dtype=i32, device=dev)
    E = torch.zeros((B, Lq), dtype=i32, device=dev)
    Hmax = torch.zeros((B, Lq), dtype=i32, device=dev)
    gmax = torch.zeros(B, dtype=i32, device=dev)
    te = torch.full((B,), -1, dtype=i32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    rows = torch.full((Lt, B), NEGB, dtype=i32, device=dev)
    negc = torch.full((B, 1), NEGB, dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    for i in range(Lt):
        if bool(done.all()):
            break
        active = (~done) & (i < tlens)
        S = prof[lane, target[:, i].long()]                      # [B, Lq]
        Hdiag = torch.cat([zcol, H[:, :-1]], 1)
        M = torch.clamp(Hdiag + S, min=0)
        H1 = torch.maximum(M, E)
        tF = torch.clamp(H1 - oe_ins, min=0)
        cm = torch.cummax(tF + jcell * e_ins, 1).values
        cm_excl = torch.cat([negc, cm[:, :-1]], 1)
        F = torch.maximum(-jcell * e_ins, cm_excl - (jcell - 1) * e_ins)
        F = torch.clamp(F, min=0)
        Hn = torch.where(inb, torch.maximum(H1, F), zero)
        En = torch.maximum(E - e_del, torch.clamp(Hn - oe_del, min=0))
        En = torch.where(inb, En, zero)

        imax = Hn.max(1).values
        upd = active & (imax > gmax)
        gmax = torch.where(upd, imax, gmax)
        te = torch.where(upd, i, te)
        Hmax = torch.where(upd[:, None], Hn, Hmax)
        brk = upd & (((u8 > 0) & (gmax + shift >= 255)) | (gmax >= endsc))
        done = done | brk | (i + 1 >= tlens)
        rows[i] = torch.where(active, imax, NEGB)
        H = torch.where(active[:, None], Hn, H)
        E = torch.where(active[:, None], En, E)

    sat = (u8 > 0) & (gmax + shift >= 255)
    # first maximum, as np.argmax (an all-zero row gives 0)
    qe = torch.where(Hmax == Hmax.max(1, keepdim=True).values, jcell,
                     Lq).min(1).values
    return dict(gmax=gmax, te=te, qe=qe.to(i32), shift=shift.to(i32),
                sat=sat.to(i32), imax_rows=rows)


def f_row_strips(H1, ext, oe_ins: int, e_ins: int, C: int):
    """F of one row as K7 computes it, from H1 = max(M, E) [B, Lq] and each
    lane's striped width ext ([B] int32): H1 cut to 0 at ext,
    tF = max(H1 - oe_ins, 0), the strip-and-carry scan, and the cut at ext
    on the result. For the CPU tests of the kernel's algebra; no caller on
    the main path."""
    j = torch.arange(H1.shape[1], dtype=torch.int32)[None, :]
    inb = j < ext[:, None]
    zero = torch.zeros((), dtype=H1.dtype)
    tF = torch.clamp(torch.where(inb, H1, zero) - oe_ins, min=0)
    return torch.where(inb, strip_scan.f_row_strips(tF, e_ins, C), zero)


# (query, target, mat_b, qlens, tlens, endsc, u8, scratch, out, rows,
#  B, Lq, Lt, code_bytes, C, o_del, e_del, o_ins, e_ins)
_SIG = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9


def _lib():
    lib = kernels.load("sw_local", {"sw_local": _SIG})
    lib.sw_local_scratch_words.restype = ctypes.c_int64
    return lib


def resident_warps(C: int, Lq: int = 0) -> int:
    """Warps (lanes of the batch) of K7's instance C that one SM holds at
    once (of the wide instance, C = 0, at query width Lq), from the CUDA
    occupancy calculator."""
    return int(_lib().sw_local_resident_warps(C, Lq))


def _launch(query, qlens, target, tlens, mat_b, endsc, u8, o_del: int,
            e_del: int, o_ins: int, e_ins: int):
    """Launch K7 on prepared inputs: query [B, Lq], target [B, Lt] uint8 or
    int32 codes as they come (lane-major, one lane's row contiguous), mat_b
    [B, 25] and qlens, tlens, endsc, u8 [B], all int32, the lengths within
    [0, Lq] and [0, Lt]. Returns (out [5, B], imax_rows [Lt, B]) int32. No
    host sync."""
    B, Lq = query.shape
    Lt = target.shape[1]
    C = strip_scan.strip_width(Lq)
    dev = kernels.check_cuda(query, target, mat_b, qlens, tlens, endsc, u8)
    kernels.check_lanes(B, qlens, tlens, endsc, u8)
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    rows = torch.empty((Lt, B), dtype=torch.int32, device=dev)
    if B:
        scratch = strip_scan.wide_scratch(_lib(), "sw_local_scratch_words",
                                          C, B, Lq, dev)
        kernels.launch(_lib(), "sw_local", "sw_local", dev,
                       kernels.ptr(query), kernels.ptr(target),
                       kernels.ptr(mat_b), kernels.ptr(qlens),
                       kernels.ptr(tlens), kernels.ptr(endsc),
                       kernels.ptr(u8),
                       kernels.ptr(scratch) if scratch is not None else None,
                       kernels.ptr(out), kernels.ptr(rows),
                       B, Lq, Lt, query.element_size(), C, o_del, e_del,
                       o_ins, e_ins)
    return out, rows


def sw_local_batch(query, qlens, target, tlens, mats, matsel,
                   o_del: int, e_del: int, o_ins: int, e_ins: int,
                   minsc, endsc, u8):
    """query [B, Lq] (Lq a multiple of 16), target [B, Lt] (codes 0..4);
    qlens/tlens/matsel/minsc/endsc/u8 [B] int32; mats [M, 5, 5]. Returns
    dict(gmax, te, qe, shift, sat) of [B] int32 and imax_rows [Lt, B]
    int32, as `sw_local_kernel`."""
    i32 = torch.int32
    B, Lq = query.shape
    Lt = target.shape[1]
    if Lq % 16:
        raise ValueError(f"Lq={Lq}: the query width must be a multiple of 16")
    qlens, tlens, endsc, u8 = (x.to(i32) for x in (qlens, tlens, endsc, u8))
    mat_b = mats.to(i32)[matsel.long()].reshape(B, 25)
    if kernels.route(query) == "plain":
        return sw_local_batch_plain(query.to(i32), qlens, target.to(i32),
                                    tlens, mat_b, minsc, endsc, u8,
                                    o_del, e_del, o_ins, e_ins)
    if B and bool(((qlens < 0) | (qlens > Lq) | (tlens < 0)
                   | (tlens > Lt)).any()):
        raise ValueError(f"qlens must lie in [0, Lq={Lq}], tlens in "
                         f"[0, Lt={Lt}]")
    query, target = strip_scan.kernel_codes(query, target)
    out, rows = _launch(query, qlens, target, tlens, mat_b.contiguous(),
                        endsc, u8, o_del, e_del, o_ins, e_ins)
    gmax, te, qe, shift, sat = out.unbind(0)
    return dict(gmax=gmax, te=te, qe=qe, shift=shift, sat=sat,
                imax_rows=rows)


def local_post(out, mats_np, matsel, minsc, tlens) -> List[KswResult]:
    """Host side of the forward pass: saturation, qe gating, and the score2
    run bookkeeping replayed from the per-row maxima (ops/sw.py:276-299)."""
    gmax = np.asarray(out["gmax"])
    te = np.asarray(out["te"])
    qe = np.asarray(out["qe"])
    sat = np.asarray(out["sat"]).astype(bool)
    rows = np.asarray(out["imax_rows"])               # [Lt, B]
    B = gmax.shape[0]
    Lt = rows.shape[0]
    minsc = np.asarray(minsc)
    tlens = np.asarray(tlens)

    res = [KswResult() for _ in range(B)]
    score = np.where(sat, 255, gmax)
    mmax = mats_np[matsel].reshape(B, 25).max(axis=1)
    iw = (score + mmax - 1) // np.maximum(mmax, 1)
    low, high = te - iw, te + iw

    # replay the run list: entries finalize when the row chain breaks
    # (b[-1][1] + 1 != i) — note a non-improving row does NOT refresh the
    # stored index, so monotone-decreasing runs split (ksw.c:198-204)
    ent_sc = np.full(B, -1, np.int64)                 # open entry score
    ent_i = np.full(B, -2, np.int64)                  # open entry row
    score2 = np.full(B, -1, np.int64)
    te2 = np.full(B, -1, np.int64)

    def finalize(mask):
        el = mask & (ent_i >= 0)
        outside = (ent_i < low) | (ent_i > high)
        win = el & outside & (ent_sc > score2)
        score2[win] = ent_sc[win]
        te2[win] = ent_i[win]
        ent_sc[mask] = -1
        ent_i[mask] = -2

    for i in range(Lt):
        imax = rows[i].astype(np.int64)
        hit = imax >= minsc
        cont = hit & (ent_i + 1 == i)
        start = hit & ~cont
        finalize(start)                               # previous run closed
        ent_sc[start] = imax[start]
        ent_i[start] = i
        improve = cont & (ent_sc < imax)
        ent_sc[improve] = imax[improve]
        ent_i[improve] = i
        # non-improving continuation rows leave ent_i stale on purpose
    finalize(np.ones(B, bool))

    for b in range(B):
        r = res[b]
        r.score = int(score[b])
        r.te = int(te[b])
        if sat[b]:
            continue                                  # skip qe/score2
        r.qe = int(qe[b])
        if score2[b] > -1:
            r.score2 = int(score2[b])
            r.te2 = int(te2[b])
    return res


def _run_pass(reqs, minsc, endsc, o_del, e_del, o_ins, e_ins, mats_np,
              device) -> List[KswResult]:
    """One K7 call over request tuples (query, target, matsel, xbyte) with
    per-lane minsc/endsc, then local_post. The query width is rounded up to
    a multiple of 16 so that every lane's striped `ext` fits."""
    B = len(reqs)
    Lq = max(-(-max(len(r[0]) for r in reqs) // 16) * 16, 16)
    Lt = max(max(len(r[1]) for r in reqs), 1)
    q = np.full((B, Lq), 4, np.int32)
    t = np.full((B, Lt), 4, np.int32)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    msel = np.zeros(B, np.int32)
    u8v = np.zeros(B, np.int32)
    for i, (qq, tt, m, xb) in enumerate(reqs):
        q[i, :len(qq)] = qq
        qlens[i] = len(qq)
        t[i, :len(tt)] = tt
        tlens[i] = len(tt)
        msel[i] = m
        u8v[i] = 1 if xb else 0
    T = lambda a: torch.from_numpy(a).to(device)
    out = sw_local_batch(T(q), T(qlens), T(t), T(tlens),
                         T(mats_np.astype(np.int32)), T(msel),
                         o_del, e_del, o_ins, e_ins, T(minsc), T(endsc),
                         T(u8v))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return local_post(out, mats_np, msel, minsc, tlens)


def sw_align_batch(reqs, o_del: int, e_del: int, o_ins: int, e_ins: int,
                   mats_np: np.ndarray, xsubo: Optional[int] = None,
                   device="cpu"):
    """Batched exact ksw_align2 (xstart=True) over request tuples
    (query u8[ql], target u8[tl], matsel int, xbyte bool) on `device`.
    mats_np [M, 5, 5]. xsubo as in sw.sw_align (the same for every lane).
    Returns (one KswResult per request, bit-identical to
    [sw.sw_align(q, t, mats[m], ...) for ...], the number of lanes K7 ran
    in the forward and the reverse pass together)."""
    if not reqs:
        return [], 0
    B = len(reqs)
    sc = (o_del, e_del, o_ins, e_ins)
    minsc = np.full(B, xsubo if xsubo is not None else 0x10000, np.int32)
    endsc = np.full(B, 0x10000, np.int32)
    fwd = _run_pass(reqs, minsc, endsc, *sc, mats_np, device)

    # reverse pass for (tb, qb): prefixes up to (qe, te), reversed, with
    # endsc = fwd score (sw.py:312-320); skipped when xsubo given and the
    # score missed it, or when the lane saturated/never scored (qe < 0)
    rev_idx = []
    rev_reqs = []
    for i, r in enumerate(fwd):
        if xsubo is not None and r.score < xsubo:
            continue
        if r.qe < 0 or r.te < 0:
            # empty reverse input: _local_core returns the default result
            # (score 0) — combine exactly like the scalar path does
            rr = KswResult()
            if rr.score == r.score:
                r.tb = r.te - rr.te
                r.qb = r.qe - rr.qe
            continue
        qq, tt, m, xb = reqs[i]
        rev_reqs.append((np.ascontiguousarray(qq[:r.qe + 1][::-1]),
                         np.ascontiguousarray(tt[:r.te + 1][::-1]), m, xb))
        rev_idx.append(i)
    if rev_reqs:
        B2 = len(rev_reqs)
        en2 = np.asarray([fwd[i].score for i in rev_idx], np.int32)
        rev = _run_pass(rev_reqs, np.full(B2, 0x10000, np.int32), en2, *sc,
                        mats_np, device)
        for k, i in enumerate(rev_idx):
            if rev[k].score == fwd[i].score:
                fwd[i].tb = fwd[i].te - rev[k].te
                fwd[i].qb = fwd[i].qe - rev[k].qe
    return fwd, B + len(rev_reqs)
