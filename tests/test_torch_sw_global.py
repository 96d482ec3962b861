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
from biscuit_tpu_torch.ops.sw_global import (decode_cigars, global_traceback,
                                             sw_global_batch)

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
    q, qlens, t, tlens = _pad(cases)
    B = len(cases)
    sc = (o_del, e_del, o_ins, e_ins)
    J = jnp.asarray
    js, jz = sw_global_batch_pallas(J(q), J(qlens), J(t), J(tlens), J(mats),
                                    J(matsel), *sc, J(ws), interpret=True)
    jops, jn, jov = jax_traceback(jz, J(qlens), J(tlens), J(ws),
                                  max_ops=max_ops)
    T = torch.from_numpy
    score, z = sw_global_batch(T(q), T(qlens), T(t), T(tlens), T(mats),
                               T(matsel), *sc, T(ws))
    ops, n_ops, ov = global_traceback(z, T(qlens), T(tlens), T(ws),
                                      max_ops=max_ops)
    np.testing.assert_array_equal(score.numpy(), np.asarray(js))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz)[:, :, :B])
    np.testing.assert_array_equal(ops.numpy(), np.asarray(jops))
    np.testing.assert_array_equal(n_ops.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    ov = ov.numpy()
    # an overflowed lane's op list is incomplete: the engine realigns it
    cigars = None if ov.any() else decode_cigars(ops.numpy(), n_ops.numpy())
    return score.numpy(), cigars, ov


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_matches_jax_and_scalar(seed):
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
