"""Seed chaining: mem_chain's B-tree scan for a batch of lanes (K6).

Port of biscuit_tpu/ops/chain_batch.py (`chain_scan_batch`, an XLA
while_loop over [NC, B] planes). Per lane, the seeds' occurrences are
visited in order; each one merges into the chain with the largest position
<= its own (the B-tree lower neighbour, bisect_right - 1, so ties go to the
latest-inserted chain) or founds a new chain inserted after the equal
keys. Within the KMAX-occurrences-per-seed and NC-chains-per-lane caps the
reference's while condition (memchain.c:326) is replayed exactly by the
`allow` rule; a lane that would need more than NC chains is flagged and
reruns on the host.

`chain_scan_batch` launches kernels/chain_scan.cu on a CUDA device (the
same plane machine with the planes in registers: a warp a lane, slot s in
thread s % 32; the lower neighbour a ballot, an insert a shuffle a
register) and runs `chain_scan_batch_plain`, the plane machine in
torch, on the CPU. Both
return (log [J, B] int32 of chain_id << 2 | kind, ov [B] bool), with the
`pacrej` and `apnd` arithmetic in the rank dtype of `occ_rbeg`.
"""
import ctypes

import torch

from .. import kernels

# action log encoding: entry = chain_id << 2 | kind
K_NONE, K_NEW, K_APPEND, K_EXTRA = 0, 1, 2, 3
NC_MAX = 64  # chain slots a kernel warp holds
JC = 32      # occurrence columns the kernel stages at a time


def chain_scan_batch_plain(occ_qbeg, occ_len, occ_rbeg, occ_valid, occ_rid,
                           occ_k, n_occ, l_pac: int, w: int, max_gap: int,
                           max_occ: int, NC: int = 64):
    """The JAX plane machine, one occurrence of every lane per step.
    occ_* [J, B]: query begin, seed length, reference begin (rank dtype),
    validity, contig id, occurrence index within its seed (int32 apart
    from occ_rbeg); n_occ [B]."""
    J, B = occ_qbeg.shape
    dev = occ_qbeg.device
    rdt = occ_rbeg.dtype
    i32 = torch.int32
    slots = torch.arange(NC, device=dev)[:, None]
    lane = torch.arange(B, device=dev)
    cnt = torch.zeros(B, dtype=i32, device=dev)
    n = torch.zeros(B, dtype=i32, device=dev)
    ov = torch.zeros(B, dtype=torch.bool, device=dev)
    pos, fr, lr = (torch.zeros((NC, B), dtype=rdt, device=dev) for _ in range(3))
    cid, crid, fq, lq, ll = (torch.zeros((NC, B), dtype=i32, device=dev)
                             for _ in range(5))
    log = torch.zeros((J, B), dtype=i32, device=dev)
    jmax = int(n_occ.max()) if B else 0
    for col in range(jmax):
        qb, ln, rb = occ_qbeg[col], occ_len[col], occ_rbeg[col]
        kk = occ_k[col]
        cnt0 = torch.where(kk == 0, 0, cnt)
        allow = (cnt0 < max_occ) & ((cnt0 <= 5) | (kk < max_occ))
        act = (col < n_occ) & (occ_valid[col] != 0) & ~ov & allow

        # lower neighbour: the last of the n sorted chains with pos <= rb
        ins = ((slots < n) & (pos <= rb)).sum(0)
        found = ins >= 1
        js = (ins - 1).clamp(min=0)
        c_rid, c_fq, c_fr, c_lq, c_lr, c_ll, c_id = (
            p[js, lane] for p in (crid, fq, fr, lq, lr, ll, cid))

        # merge_seed_to_chain (memchain.c:227-256), in its exact order
        lnr = ln.to(rdt)
        cllr = c_ll.to(rdt)
        contained = (qb >= c_fq) & (qb + ln <= c_lq + c_ll) \
            & (rb >= c_fr) & (rb + lnr <= c_lr + cllr)
        pacrej = ((c_lr < l_pac) | (c_fr < l_pac)) & (rb >= l_pac)
        qd = (qb - c_lq).to(rdt)
        rd = rb - c_lr
        apnd = (rd >= 0) & (qd - rd <= w) & (rd - qd <= w) \
            & (qd - cllr < max_gap) & (rd - cllr < max_gap)
        near = act & found & (c_rid == occ_rid[col])
        is_extra = near & contained
        is_app = near & ~contained & ~pacrej & apnd
        merged = is_extra | is_app
        want_new = act & ~merged
        do_new = want_new & (n < NC)
        ov = ov | (want_new & (n >= NC))

        # append: the chain's last seed becomes this one
        atj = (slots == js) & is_app
        lq = torch.where(atj, qb, lq)
        lr = torch.where(atj, rb, lr)
        ll = torch.where(atj, ln, ll)

        # insert: slots >= ins move up by one, the new chain lands at ins
        shift = slots >= ins
        at = slots == ins

        def insert(plane, newv):
            shifted = torch.cat([plane[:1], plane[:-1]], 0)
            cand = torch.where(at, newv.to(plane.dtype),
                               torch.where(shift, shifted, plane))
            return torch.where(do_new, cand, plane)

        pos, cid, crid = insert(pos, rb), insert(cid, n), insert(crid, occ_rid[col])
        fq, fr = insert(fq, qb), insert(fr, rb)
        lq, lr, ll = insert(lq, qb), insert(lr, rb), insert(ll, ln)

        kind = do_new * K_NEW + is_app * K_APPEND + is_extra * K_EXTRA
        ide = torch.where(do_new, n, torch.where(merged, c_id, 0))
        log[col] = (ide << 2) | kind.to(i32)
        n = n + do_new.to(i32)
        cnt = cnt0 + do_new.to(i32)
    return log, ov


# (qbeg, len, rbeg, valid, rid, k, n_occ, J, B, l_pac, w, max_gap, max_occ,
#  NC, log, ov)
_SIG = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 2)


def _lib():
    return kernels.load("chain_scan", {"chain_scan_narrow": _SIG,
                                       "chain_scan_wide": _SIG})


def chain_scan_batch(occ_qbeg, occ_len, occ_rbeg, occ_valid, occ_rid, occ_k,
                     n_occ, l_pac: int, w: int, max_gap: int, max_occ: int,
                     NC: int = 64):
    """Chain scan over a batch: (log [J, B] int32, ov [B] bool). K6 on CUDA
    (a warp a lane), the plain plane machine on the CPU."""
    if kernels.route(occ_rbeg) == "plain":
        return chain_scan_batch_plain(occ_qbeg, occ_len, occ_rbeg, occ_valid,
                                      occ_rid, occ_k, n_occ, l_pac, w,
                                      max_gap, max_occ, NC)
    if not 1 <= NC <= NC_MAX:
        raise ValueError(f"NC={NC}: the kernel holds 1 to {NC_MAX} chains")
    planes = [t.to(torch.int32).contiguous()
              for t in (occ_qbeg, occ_len, occ_valid, occ_rid, occ_k)]
    if occ_rbeg.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"occ_rbeg of {occ_rbeg.dtype}: int32 or int64 ranks")
    rbeg = occ_rbeg.contiguous()
    n_occ = n_occ.to(torch.int32).contiguous()
    dev = kernels.check_cuda(rbeg, n_occ, *planes)
    J, B = rbeg.shape
    for t in planes:
        if t.shape != rbeg.shape:
            raise ValueError(f"occurrence plane {tuple(t.shape)}, "
                             f"expected {(J, B)}")
    kernels.check_lanes(B, n_occ)
    if bool(((n_occ < 0) | (n_occ > J)).any()):
        raise ValueError(f"n_occ must lie in [0, J={J}]")
    log = torch.empty((J, B), dtype=torch.int32, device=dev)
    ov = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return log, ov
    _launch(*planes[:2], rbeg, *planes[2:], n_occ, l_pac, w, max_gap,
            max_occ, NC, log, ov)
    return log, ov


def _launch(qbeg, ln, rbeg, valid, rid, kocc, n_occ, l_pac: int, w: int,
            max_gap: int, max_occ: int, NC: int, log, ov) -> None:
    """Launch K6 on checked, contiguous planes into log and ov. No host
    sync."""
    J, B = rbeg.shape
    fn = "chain_scan_wide" if rbeg.dtype == torch.int64 else "chain_scan_narrow"
    kernels.launch(_lib(), fn, "chain_scan", rbeg.device,
                   kernels.ptr(qbeg), kernels.ptr(ln), kernels.ptr(rbeg),
                   kernels.ptr(valid), kernels.ptr(rid), kernels.ptr(kocc),
                   kernels.ptr(n_occ), J, B, int(l_pac), int(w), int(max_gap),
                   int(max_occ), NC, kernels.ptr(log), kernels.ptr(ov))
