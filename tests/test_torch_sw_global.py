"""Torch global alignment + traceback (the plain twins of the K2 CUDA
kernels) vs the JAX package: score and z against the Pallas DP in
interpret mode, ops/n_ops/ov against its global_traceback, and the CIGAR
against the scalar sw.sw_global. Cases of test_pallas_global.py; exact
equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biscuit_tpu.ops import sw
from biscuit_tpu.ops.pallas_global import (
    global_traceback as jax_traceback, sw_global_batch_pallas)
from biscuit_tpu_torch.ops import strip_scan
from biscuit_tpu_torch.ops.sw_global import (
    decode_cigars, global_traceback, global_traceback_plain, sw_global_batch,
    sw_global_batch_plain, sw_global_cigar)

from torch_testdata import global_edge_case

# the plain versions are loops of small ops: under pytest-xdist, intra-op
# threads of several workers only contend for the cores
torch.set_num_threads(1)


def _rand_case(rng, qlen, tlen):
    q = rng.integers(0, 4, qlen).astype(np.int32)
    t = q.copy()  # target = mutated copy so alignments are realistic
    for _ in range(max(1, tlen // 12)):
        p = int(rng.integers(0, len(t)))
        r = rng.random()
        if r < 0.5:
            t[p] = rng.integers(0, 4)
        elif r < 0.75 and len(t) > 4:
            t = np.delete(t, p)
        else:
            t = np.insert(t, p, rng.integers(0, 4))
    if len(t) < tlen:
        t = np.concatenate([t, rng.integers(0, 4, tlen - len(t))])
    return q, t[:tlen].astype(np.int32)


def _pad(cases, Lq=None, Lt=None):
    B = len(cases)
    Lq = Lq or max(len(q) for q, _ in cases)
    Lt = Lt or max(len(t) for _, t in cases)
    q = np.full((B, Lq), 4, np.int32)
    t = np.full((B, Lt), 4, np.int32)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    for b, (qq, tt) in enumerate(cases):
        q[b, :len(qq)], t[b, :len(tt)] = qq, tt
        qlens[b], tlens[b] = len(qq), len(tt)
    return q, qlens, t, tlens


def _check(cases, mats, matsel, o_del, e_del, o_ins, e_ins, ws, max_ops=64):
    """Port vs JAX on one batch; returns the port's (score, cigars, ov)."""
    return _check_padded(_pad(cases), mats, matsel, o_del, e_del, o_ins,
                         e_ins, ws, max_ops)


def _lane_major(z):
    """z with the same elements in the memory layout the kernel writes:
    [B, Lt4, Lq] contiguous, seen as [Lt4, Lq, B]."""
    v = z.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    assert v.shape == z.shape and not v.is_contiguous()
    return v


def _check_padded(padded, mats, matsel, o_del, e_del, o_ins, e_ins, ws,
                  max_ops=64, tb_tlens=None):
    """tb_tlens: the target lengths the tracebacks are asked of, where they
    differ from the DP's (a target longer than Lt is cut there)."""
    q, qlens, t, tlens = padded
    tb_tlens = tlens if tb_tlens is None else tb_tlens
    B = q.shape[0]
    sc = (o_del, e_del, o_ins, e_ins)
    J = jnp.asarray
    js, jz = sw_global_batch_pallas(J(q), J(qlens), J(t), J(tlens), J(mats),
                                    J(matsel), *sc, J(ws), interpret=True)
    jops, jn, jov = jax_traceback(jz, J(qlens), J(tb_tlens), J(ws),
                                  max_ops=max_ops)
    T = torch.from_numpy
    score, z = sw_global_batch(T(q), T(qlens), T(t), T(tlens), T(mats),
                               T(matsel), *sc, T(ws))
    ops, n_ops, ov = global_traceback(z, T(qlens), T(tb_tlens), T(ws),
                                      max_ops=max_ops)
    # a z of the kernel's lane-major strides walks the same, in the wrapper
    # and in the plain traceback; and the fused entry gives all four at once
    for tb in (global_traceback, global_traceback_plain):
        for g, w in zip(tb(_lane_major(z), T(qlens), T(tb_tlens), T(ws),
                           max_ops), (ops, n_ops, ov)):
            assert torch.equal(g, w)
    if tb_tlens is tlens:
        for g, w in zip(sw_global_cigar(T(q), T(qlens), T(t), T(tlens),
                                        T(mats), T(matsel), *sc, T(ws),
                                        max_ops=max_ops),
                        (score, ops, n_ops, ov)):
            assert torch.equal(g, w)
    np.testing.assert_array_equal(score.numpy(), np.asarray(js))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz)[:, :, :B])
    np.testing.assert_array_equal(ops.numpy(), np.asarray(jops))
    np.testing.assert_array_equal(n_ops.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    ov = ov.numpy()
    # an overflowed lane's op list is incomplete: the engine realigns it
    cigars = None if ov.any() else decode_cigars(ops.numpy(), n_ops.numpy())
    return score.numpy(), cigars, ov


# (B, Lq, Lt, scores, w): strip widths 2, 4 and 5; e_ins 1, 2, 3 and 0; the
# band from one column either side to the whole rectangle
EDGE_CASES = ((31, 40, 64, (6, 1, 6, 1), 100), (33, 100, 120, (6, 1, 5, 2), 5),
              (37, 160, 200, (5, 2, 3, 3), 2), (17, 64, 72, (6, 1, 6, 0), 17),
              (19, 48, 40, (6, 1, 6, 1), 1))


def _edge_lanes(B, Lq, Lt, sc, w_val):
    """The lanes of global_edge_case: plain == JAX (Pallas in interpret
    mode) == scalar sw.sw_global, ties, gaps across strips, w = 1,
    qlen = Lq, tlen = 1, tlen > Lt and the empty query included."""
    q, qlens, t, tlens, mats, matsel, ws = global_edge_case(42 + Lq, B, Lq, Lt,
                                                            w_val)
    cut = np.minimum(tlens, Lt)
    scores, cigars, ov = _check_padded((q, qlens, t, tlens), mats, matsel, *sc,
                                       ws, tb_tlens=cut)
    assert (tlens > Lt).any() and (qlens == 0).any() and (qlens == Lq).any()
    assert not ov.any()
    n = 0
    for b in range(B):
        # the scalar takes no empty sequence and no band that leaves the
        # query behind (a row without cells); under w = 0 the batch's DP
        # runs with w = 1 and its traceback with 0, as the JAX one
        wb = int(ws[b])
        if (qlens[b] == 0 or tlens[b] == 0 or tlens[b] > Lt or wb < 1
                or tlens[b] - 1 - wb >= qlens[b]):
            continue
        want_s, want_c = sw.sw_global(
            q[b, :qlens[b]], t[b, :tlens[b]], mats[matsel[b]].astype(np.int64),
            *sc, wb)
        assert scores[b] == want_s, f"lane {b}: {scores[b]} != {want_s}"
        assert cigars[b] == want_c, f"lane {b}:\n {cigars[b]}\n {want_c}"
        n += 1
    assert n >= (B // 2 if w_val >= 100 else 1)


@pytest.mark.parametrize("seed", [0, 1, 2, *(
    pytest.param(c, id="edge-%d-%d-%d-w%d" % (c[0], c[1], c[2], c[4]))
    for c in EDGE_CASES)])
def test_global_matches_jax_and_scalar(seed):
    if isinstance(seed, tuple):
        return _edge_lanes(*seed)
    rng = np.random.default_rng(seed)
    mat = np.full((5, 5), -2, np.int64)
    np.fill_diagonal(mat, 1)
    mat[4, :] = -1
    mat[:, 4] = -1
    mat2 = mat.copy()
    mat2[1, 3] = 1  # asymmetric bisulfite-style matrix
    mats = np.stack([mat, mat2]).astype(np.int32)
    o_del, e_del, o_ins, e_ins = 6, 1, 5, 2
    cases, ws, matsel = [], [], []
    for i in range(48):
        qlen = int(rng.integers(8, 101))
        tlen = int(rng.integers(max(4, qlen - 10), qlen + 12))
        w = max(int(rng.integers(3, 40)), abs(tlen - qlen) + 3)
        cases.append(_rand_case(rng, qlen, tlen))
        ws.append(w)
        matsel.append(i & 1)
    matsel = np.array(matsel, np.int32)
    scores, cigars, ov = _check(cases, mats, matsel, o_del, e_del, o_ins,
                                e_ins, np.array(ws, np.int32))
    assert not ov.any()
    for b, (q, t) in enumerate(cases):
        want_s, want_c = sw.sw_global(q, t, mats[matsel[b]].astype(np.int64),
                                      o_del, e_del, o_ins, e_ins, ws[b])
        assert scores[b] == want_s, f"lane {b}: {scores[b]} != {want_s}"
        assert cigars[b] == want_c, f"lane {b}:\n {cigars[b]}\n {want_c}"


def test_global_narrow_band_and_edges():
    """w=1 bands, tlen >> qlen within band, single-base cases."""
    rng = np.random.default_rng(7)
    mat = np.full((5, 5), -3, np.int64)
    np.fill_diagonal(mat, 2)
    mats = np.stack([mat]).astype(np.int32)
    cases, ws = [], []
    for qlen, tlen, w in [(1, 1, 1), (1, 3, 3), (3, 1, 3), (5, 5, 1),
                          (16, 20, 5), (30, 30, 2), (8, 8, 30)]:
        cases.append(_rand_case(rng, qlen, tlen))
        ws.append(w)
    scores, cigars, _ov = _check(cases, mats, np.zeros(len(cases), np.int32),
                                 6, 1, 6, 1, np.array(ws, np.int32))
    for b, (q, t) in enumerate(cases):
        want_s, want_c = sw.sw_global(q, t, mat, 6, 1, 6, 1, ws[b])
        assert scores[b] == want_s
        assert cigars[b] == want_c


def test_traceback_overflow_matches_jax():
    """max_ops too small: the lanes are flagged, and the truncated op
    buffers equal the JAX traceback's word for word."""
    rng = np.random.default_rng(3)
    mat = np.full((5, 5), -2, np.int64)
    np.fill_diagonal(mat, 1)
    mats = np.stack([mat]).astype(np.int32)
    cases = [_rand_case(rng, 60, 64) for _ in range(4)]
    _s, _c, ov = _check(cases, mats, np.zeros(4, np.int32), 6, 1, 6, 1,
                        np.full(4, 10, np.int32), max_ops=2)
    assert ov.any()


# ---------------------------------------------------------------------------
# the algebra K2 rests on: F of a row as a warp computes it
# ---------------------------------------------------------------------------

def _serial_f(M, beg, end, oe_ins, e_ins):
    """F(beg) = MINUS_INF, F(j+1) = max(F(j) - e_ins, M(j) - oe_ins), in
    Python integers; columns outside the band are None."""
    out = []
    for b in range(M.shape[0]):
        row = [None] * M.shape[1]
        f = strip_scan.MINUS_INF
        for j in range(int(beg[b]), int(end[b])):
            row[j] = f
            f = max(f - e_ins, int(M[b, j]) - oe_ins)
        out.append(row)
    return out


def _assert_f(got, want):
    for b, row in enumerate(want):
        for j, f in enumerate(row):
            if f is not None:
                assert int(got[b, j]) == f, (b, j, int(got[b, j]), f)


@pytest.mark.parametrize("e_ins", [0, 1, 3])
@pytest.mark.parametrize("C", [2, 5, 8, 17])    # 17: a strip of the wide instance
def test_global_f_scan_matches_the_serial_recurrence(C, e_ins):
    """Random M with runs of sentinel cells (a ramped MINUS_INF plus a
    score) inside the band, bands that begin past column 0 and begin and end
    inside a strip, an empty band, the whole row."""
    rng = np.random.default_rng(10 * C + e_ins)
    B, Lq, oe_ins = 48, 32 * C - 3, 6 + e_ins
    M = rng.integers(-40, 60, (B, Lq)).astype(np.int32)
    sent = rng.random((B, Lq)) < 0.3
    M[sent] = (strip_scan.MINUS_INF - rng.integers(0, 500, (B, Lq)))[sent]
    beg = rng.integers(0, Lq, B).astype(np.int32)
    end = np.minimum(beg + rng.integers(0, Lq, B), Lq).astype(np.int32)
    beg[0], end[0] = 0, Lq
    beg[1], end[1] = C + 1, 3 * C - 1      # both inside a strip
    beg[2], end[2] = 7, 7                  # empty
    beg[3], end[3] = Lq - 1, Lq
    T = torch.from_numpy
    got = strip_scan.global_f_row_strips(T(M), T(beg), T(end), oe_ins, e_ins, C)
    assert got.dtype == torch.int32 and got.shape == (B, Lq)
    want = _serial_f(M, beg, end, oe_ins, e_ins)
    _assert_f(got.numpy(), want)
    # sentinel cells are inside bands, and F's direction bit is set on some
    bit5 = [(f - e_ins) > (int(M[b, j]) - oe_ins)
            for b, row in enumerate(want) for j, f in enumerate(row)
            if f is not None]
    assert any(bit5) and not all(bit5)
    assert any(sent[b, beg[b]:end[b]].any() for b in range(B))
    with pytest.raises(ValueError):
        strip_scan.global_f_row_strips(T(M), T(beg), T(end), oe_ins, e_ins,
                                       C - 1)


def test_global_f_scan_stays_inside_int32():
    """The margin case: 512 columns, e_ins = 6, every M as low as a ramped
    sentinel gets over 1024 rows of the dearest mismatch, bands that leave
    most columns at VERYNEG."""
    rng = np.random.default_rng(1)
    B, Lq, C, e_ins, oe_ins = 8, 512, 16, 6, 12
    low = strip_scan.MINUS_INF - 1024 * 20 - 6 * 1024
    M = np.full((B, Lq), low, np.int32)
    M[1::2] = rng.integers(low, low + 100, (B // 2, Lq))
    beg = np.array([0, 0, 500, 3, 255, 256, 511, 100], np.int32)
    end = np.array([512, 512, 512, 4, 257, 512, 512, 101], np.int32)
    T = torch.from_numpy
    got = strip_scan.global_f_row_strips(T(M), T(beg), T(end), oe_ins, e_ins, C)
    _assert_f(got.numpy(), _serial_f(M, beg, end, oe_ins, e_ins))
    assert strip_scan.VERYNEG - 2 * (Lq - 1) * e_ins > -2 ** 31 + 9 * 10 ** 8


def _dp_in_strips(q, qlens, t, tlens, mat_b, w, o_del, e_del, o_ins, e_ins, C):
    """The global DP row by row with F from global_f_row_strips and
    everything else as the recurrence says: what K2 computes. Returns
    (score [B], the direction bytes [Lt, B, Lq])."""
    MI = strip_scan.MINUS_INF
    B, Lq = q.shape
    Lt = t.shape[1]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    j1 = np.arange(Lq + 1)[None, :]
    h = np.where(j1 == 0, 0, np.where((j1 <= w[:, None]) & (j1 <= qlens[:, None]),
                                      -(o_ins + e_ins * j1), MI)).astype(np.int64)
    e = np.full((B, Lq), MI, np.int64)
    d_all = np.zeros((Lt, B, Lq), np.int64)
    jc = np.arange(Lq)[None, :]
    lanes = np.arange(B)
    for i in range(Lt):
        run = i < tlens
        beg = np.maximum(i - w, 0)
        end = np.minimum(np.minimum(i + w + 1, qlens), Lq)
        S = mat_b[lanes[:, None], t[:, i][:, None] * 5 + q]
        M = h[:, :-1] + S
        F = strip_scan.global_f_row_strips(
            torch.from_numpy(M.astype(np.int32)), torch.from_numpy(beg.astype(np.int32)),
            torch.from_numpy(end.astype(np.int32)), oe_ins, e_ins, C).numpy().astype(np.int64)
        jm = (jc >= beg[:, None]) & (jc < end[:, None]) & run[:, None]
        me = np.maximum(M, e)
        H = np.maximum(me, F)
        d = np.where(M >= e, 0, 1)
        d = np.where(H > me, 2, d)
        d |= ((e - e_del) > (M - oe_del)).astype(np.int64) << 2
        d |= ((F - e_ins) > (M - oe_ins)).astype(np.int64) << 5
        d_all[i] = np.where(jm, d, 0)
        h1_first = np.where(beg == 0, -(o_del + e_del * (i + 1)), MI)
        newh = h.copy()
        newh[:, 1:] = np.where(jm, H, h[:, 1:])
        for b in np.nonzero(run & (beg <= Lq))[0]:
            newh[b, beg[b]] = h1_first[b]
        newe = np.where(jm, np.maximum(e - e_del, M - oe_del), e)
        for b in np.nonzero(run & (end < Lq))[0]:
            newe[b, end[b]] = MI
        h, e = newh, newe
    return h[lanes, qlens], d_all


@pytest.mark.parametrize("e_ins", [0, 1, 3])
@pytest.mark.parametrize("C", [2, 5, 8])
def test_dp_with_the_strip_scan_matches_plain(C, e_ins):
    """Scores and every direction byte of sw_global_batch_plain, sentinel
    cells and bands with beg > 0 included, from a DP whose F is the warp's
    scan."""
    B, Lq, Lt = 24, min(32 * C, 56), 48
    q, qlens, t, tlens, mats, matsel, ws = global_edge_case(C + e_ins, B, Lq, Lt, 5)
    ws[::3] = 2
    ws[1::7] = 100
    tl, wv = np.maximum(np.minimum(tlens, Lt), 1), np.maximum(ws, 1)
    mat_b = mats[matsel].reshape(B, 25)
    sc = (6, 1, 6 - e_ins, e_ins)
    T = torch.from_numpy
    score, z = sw_global_batch_plain(T(q), T(qlens), T(t), T(tl), T(mat_b),
                                     T(wv), *sc)
    got_s, got_d = _dp_in_strips(q, qlens, t, tl, mat_b.astype(np.int64), wv,
                                 *sc, C)
    np.testing.assert_array_equal(score.numpy(), got_s)
    zb = z.numpy().astype(np.int64) & 0xFFFFFFFF
    for i in range(Lt):
        byte = (zb[i >> 2] >> ((i & 3) << 3)) & 0xFF     # [Lq, B]
        np.testing.assert_array_equal(byte.T, got_d[i], err_msg=f"row {i}")
    assert (got_d & 0x20).any() and (got_d & 3 == 2).any()
