"""Torch SW extension (the plain twin of the K1 CUDA kernel) vs the JAX
package: the Pallas kernel in interpret mode and the XLA sw_extend_batch,
on the cases of test_pallas_sw.py. Integer outputs, exact equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biscuit_tpu.config import MemOpt
from biscuit_tpu.ops.pallas_sw import sw_extend_batch_pallas
from biscuit_tpu.ops.sw_batch import sw_extend_batch as sw_extend_xla
from biscuit_tpu_torch.ops.sw_extend import sw_extend_batch

# the plain versions are loops of small ops: under pytest-xdist, intra-op
# threads of several workers only contend for the cores
torch.set_num_threads(1)


def _rand_case(rng, B, Lq, Lt):
    opt = MemOpt()
    query = rng.integers(0, 4, size=(B, Lq)).astype(np.int32)
    target = rng.integers(0, 4, size=(B, Lt)).astype(np.int32)
    # half the lanes extend a planted match so scores are non-trivial
    for b in range(0, B, 2):
        L = min(Lq, Lt) - rng.integers(0, 5)
        target[b, :L] = query[b, :L]
        for _ in range(rng.integers(0, 4)):
            p = rng.integers(0, L)
            target[b, p] = rng.integers(0, 4)
    qlens = rng.integers(Lq // 2, Lq + 1, size=B).astype(np.int32)
    tlens = rng.integers(Lt // 2, Lt + 1, size=B).astype(np.int32)
    mats = np.stack([opt.gamat, opt.ctmat]).astype(np.int32)
    matsel = rng.integers(0, 2, size=B).astype(np.int32)
    w = np.full(B, opt.w, np.int32)
    bonus = np.where(rng.random(B) < 0.5, opt.pen_clip5, 0).astype(np.int32)
    h0 = rng.integers(1, 40, size=B).astype(np.int32)
    return opt, (query, qlens, target, tlens, mats, matsel, w, bonus, h0)


def _both(arrs, opt, zdrop):
    query, qlens, target, tlens, mats, matsel, w, bonus, h0 = arrs
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    J = jnp.asarray
    jargs = (J(query), J(qlens), J(target), J(tlens), J(mats), J(matsel),
             *sc, J(w), J(bonus), zdrop, J(h0))
    T = torch.from_numpy
    got = sw_extend_batch(T(query), T(qlens), T(target), T(tlens), T(mats),
                          T(matsel), *sc, T(w), T(bonus), zdrop, T(h0))
    assert got.dtype == torch.int32 and got.shape == (6, query.shape[0])
    return jargs, got.numpy()


@pytest.mark.parametrize("B,Lq,Lt", [(8, 32, 64), (130, 64, 128)])
def test_sw_extend_matches_jax(B, Lq, Lt):
    rng = np.random.default_rng(42 + B)
    opt, arrs = _rand_case(rng, B, Lq, Lt)
    jargs, got = _both(arrs, opt, opt.zdrop)
    np.testing.assert_array_equal(got, np.asarray(sw_extend_xla(*jargs)))
    np.testing.assert_array_equal(
        got, np.asarray(sw_extend_batch_pallas(*jargs, interpret=True)))


@pytest.mark.parametrize("w_val", [1, 2, 5, 17])
def test_sw_extend_narrowing_adversarial(w_val):
    """Tiny bands, long targets (collapse via i-w >= end), dead bands
    (m==0 rows), tail death and regrowth: where the band narrowing, the
    gscore reach gating and F truncation at last_nz+2 are observable."""
    rng = np.random.default_rng(1000 + w_val)
    opt = MemOpt()
    B, Lq, Lt = 64, 48, 160
    query = rng.integers(0, 4, size=(B, Lq)).astype(np.int32)
    target = rng.integers(0, 4, size=(B, Lt)).astype(np.int32)
    for b in range(B):
        k, L = b % 4, min(Lq, Lt)
        if k == 0:      # full planted match
            target[b, :L] = query[b, :L]
        elif k == 1:    # match then garbage: mid-band death
            target[b, :L // 3] = query[b, :L // 3]
        elif k == 2:    # garbage then match: F/tail regrowth attempts
            target[b, L // 2:L] = query[b, :L - L // 2]
    qlens = rng.integers(8, Lq + 1, size=B).astype(np.int32)
    tlens = rng.integers(Lt // 2, Lt + 1, size=B).astype(np.int32)
    mats = np.stack([opt.gamat, opt.ctmat]).astype(np.int32)
    matsel = rng.integers(0, 2, size=B).astype(np.int32)
    w = np.full(B, w_val, np.int32)
    bonus = np.where(rng.random(B) < 0.5, opt.pen_clip5, 0).astype(np.int32)
    h0 = rng.integers(1, 60, size=B).astype(np.int32)
    arrs = (query, qlens, target, tlens, mats, matsel, w, bonus, h0)
    for zdrop in (0, 10, opt.zdrop):
        jargs, got = _both(arrs, opt, zdrop)
        np.testing.assert_array_equal(got, np.asarray(sw_extend_xla(*jargs)),
                                      err_msg=f"zdrop={zdrop}")
        if zdrop == opt.zdrop:
            np.testing.assert_array_equal(
                got, np.asarray(sw_extend_batch_pallas(*jargs, interpret=True)))


def test_sw_extend_plain_counts_the_cells_it_fills():
    """`filled` receives the cells of the rows a lane runs before it breaks:
    by hand on two lanes, then on random lanes each alone and in a batch."""
    from biscuit_tpu_torch.ops.sw_extend import band_clamp, sw_extend_batch_plain
    opt = MemOpt()
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    T = torch.from_numpy

    def run(arrs, zdrop, count=True):
        query, qlens, target, tlens, mats, matsel, w, bonus, h0 = map(T, arrs)
        filled = torch.zeros(len(qlens), dtype=torch.int64) if count else None
        out = sw_extend_batch_plain(
            query, qlens, target, tlens, mats[matsel.long()].reshape(-1, 25),
            band_clamp(qlens, w, bonus, mats, *sc), h0, *sc, zdrop, filled)
        return out, filled

    # the clamp narrows the band to w = 3 for a query of 8. Lane 0, an exact
    # match, fills columns [max(i - 3, 0), min(i + 4, 8)) of its 8 rows:
    # 4 + 5 + 6 + 7 + 7 + 6 + 5 + 4. Lane 1, A against C, scores nothing in
    # row 0 and breaks after its 4 cells
    i32 = lambda *a: np.array(a, np.int32)
    q = np.stack([np.arange(8) % 4, np.zeros(8)]).astype(np.int32)
    t = np.stack([np.arange(8) % 4, np.ones(8)]).astype(np.int32)
    mats = np.stack([opt.gamat, opt.ctmat]).astype(np.int32)
    hand = (q, i32(8, 8), t, i32(8, 8), mats, i32(0, 0), i32(100, 100),
            i32(0, 0), i32(60, 1))
    assert run(hand, 0)[1].tolist() == [44, 4]

    opt, arrs = _rand_case(np.random.default_rng(7), 24, 32, 64)
    out, filled = run(arrs, opt.zdrop)
    assert torch.equal(out, run(arrs, opt.zdrop, count=False)[0])
    qlens, tlens = arrs[1].astype(np.int64), arrs[3].astype(np.int64)
    assert (filled.numpy() > 0).all() and (filled.numpy() <= qlens * tlens).all()
    # the planted lanes run on, the random ones break early
    assert filled[0::2].sum() > filled[1::2].sum()
    for b in range(len(qlens)):
        one = tuple(a if a.ndim == 3 else a[b:b + 1] for a in arrs)
        assert run(one, opt.zdrop)[1].tolist() == [int(filled[b])]
