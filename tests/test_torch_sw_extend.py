"""Torch SW extension (the plain twin of the K1 CUDA kernel) vs the JAX
package: the Pallas kernel in interpret mode and the XLA sw_extend_batch,
on the cases of test_pallas_sw.py and on the edge lanes of
torch_testdata.extend_edge_case, which the bring-up check puts through the
kernel on the card. Integer outputs, exact equality. And the algebra the
kernel rests on, which can run here: its F scan in strips of C columns with
decayed carries against the serial recurrence, and the choice of C."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biscuit_tpu.ops.pallas_sw import sw_extend_batch_pallas
from biscuit_tpu.ops.sw_batch import sw_extend_batch as sw_extend_xla
from biscuit_tpu_torch.ops import strip_scan
from biscuit_tpu_torch.ops.sw_extend import f_row_strips, sw_extend_batch

from torch_testdata import (DP_EDGE_SHAPES_CPU, extend_edge_case, jax_opt,
                            port_opt)

# the plain versions are loops of small ops: under pytest-xdist, intra-op
# threads of several workers only contend for the cores
torch.set_num_threads(1)


def _rand_case(rng, B, Lq, Lt):
    opt = port_opt()
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
    jopt = jax_opt()  # each package reads scores of its own options class
    J = jnp.asarray
    jargs = (J(query), J(qlens), J(target), J(tlens), J(mats), J(matsel),
             jopt.o_del, jopt.e_del, jopt.o_ins, jopt.e_ins, J(w), J(bonus),
             zdrop, J(h0))
    T = torch.from_numpy
    got = sw_extend_batch(T(query), T(qlens), T(target), T(tlens), T(mats),
                          T(matsel), *sc, T(w), T(bonus), zdrop, T(h0))
    assert got.dtype == torch.int32 and got.shape == (6, query.shape[0])
    return jargs, got.numpy()


@pytest.mark.parametrize("B,Lq,Lt,edge", [
    pytest.param(8, 32, 64, False, id="8-32-64"),
    pytest.param(130, 64, 128, False, id="130-64-128"),
    *(pytest.param(*s, True, id="edge-%d-%d-%d" % s)
      for s in DP_EDGE_SHAPES_CPU)])
def test_sw_extend_matches_jax(B, Lq, Lt, edge):
    """edge: the lanes of extend_edge_case (ties, gaps across strips, empty
    query or target, tlen > Lt, w = 0, qlen = Lq) at the widths of the
    kernel's strip instances and batch sizes around a warp."""
    if edge:
        opt, arrs = port_opt(), extend_edge_case(42 + Lq, B, Lq, Lt)
    else:
        opt, arrs = _rand_case(np.random.default_rng(42 + B), B, Lq, Lt)
    jargs, got = _both(arrs, opt, opt.zdrop)
    np.testing.assert_array_equal(got, np.asarray(sw_extend_xla(*jargs)))
    np.testing.assert_array_equal(
        got, np.asarray(sw_extend_batch_pallas(*jargs, interpret=True)))


def _check_zdrops(arrs, opt):
    for zdrop in (0, 10, opt.zdrop):
        jargs, got = _both(arrs, opt, zdrop)
        np.testing.assert_array_equal(got, np.asarray(sw_extend_xla(*jargs)),
                                      err_msg=f"zdrop={zdrop}")
        if zdrop == opt.zdrop:
            np.testing.assert_array_equal(
                got, np.asarray(sw_extend_batch_pallas(*jargs, interpret=True)))


@pytest.mark.parametrize("w_val,edge", [
    *(pytest.param(w, False, id=str(w)) for w in (1, 2, 5, 17)),
    *(pytest.param(w, True, id=f"edge-{w}") for w in (2, 5))])
def test_sw_extend_narrowing_adversarial(w_val, edge):
    """Tiny bands, long targets (collapse via i-w >= end), dead bands
    (m==0 rows), tail death and regrowth: where the band narrowing, the
    gscore reach gating and F truncation at last_nz+2 are observable.
    edge: the lanes of extend_edge_case under the same tiny bands, where the
    band's two ends cut through a strip of the kernel in every row."""
    rng = np.random.default_rng(1000 + w_val)
    opt = port_opt()
    if edge:
        return _check_zdrops(extend_edge_case(w_val, 33, 100, 120, w_val), opt)
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
    _check_zdrops((query, qlens, target, tlens, mats, matsel, w, bonus, h0),
                  opt)


def test_sw_extend_plain_counts_the_cells_it_fills():
    """`filled` receives the cells of the rows a lane runs before it breaks:
    by hand on two lanes, then on random lanes each alone and in a batch."""
    from biscuit_tpu_torch.ops.sw_extend import band_clamp, sw_extend_batch_plain
    opt = port_opt()
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


def f_row_serial(tF, e_ins):
    """F of a row by the serial recurrence of ksw_extend2's inner loop:
    F(0) = 0, F(j) = max(F(j-1) - e_ins, tF(j-1))."""
    F = np.zeros_like(tF)
    for j in range(1, tF.shape[1]):
        F[:, j] = np.maximum(F[:, j - 1] - e_ins, tF[:, j - 1])
    return F


@pytest.mark.parametrize("e_ins", [0, 1, 3])
@pytest.mark.parametrize("C", [2, 5, 8, 17])    # 17: a strip of the wide instance
def test_f_scan_in_strips_is_the_serial_f(C, e_ins):
    """One row's F as K1 computes it (strips of C columns, carries combined
    by shifts of 1..16 and decayed by the columns crossed, the band as a
    mask) against the serial chain that starts at beg with f = 0 and is cut
    at end, and against the plain version's cummax form. The band's ends
    fall inside strips, on their edges, and on an empty band."""
    rng = np.random.default_rng(100 * C + e_ins)
    B, Lq, oe_ins = 96, 32 * C - int(rng.integers(0, C)), 6 + e_ins
    # M as a row holds it: runs of high scores, zeros and negatives
    M = rng.integers(-8, 40, (B, Lq)) * (rng.random((B, Lq)) < 0.3)
    M[::3] += rng.integers(0, 120, (B, Lq))[::3] * (rng.random((B, Lq)) < 0.05)[::3]
    M = M.astype(np.int32)
    beg = rng.integers(0, Lq // 2, B).astype(np.int32)
    end = rng.integers(Lq // 2, Lq + 1, B).astype(np.int32)
    beg[0], end[0] = 0, Lq                      # the whole row
    beg[1], end[1] = C, 3 * C                   # on strip edges
    beg[2], end[2] = C + 1, 2 * C + 1           # inside strips
    beg[3], end[3] = 7, 7                       # empty
    beg[4], end[4] = Lq - 1, Lq                 # the last column alone
    j = np.arange(Lq)[None, :]
    jm = (j >= beg[:, None]) & (j < end[:, None])
    tF = np.where(jm, np.maximum(M - oe_ins, 0), 0).astype(np.int32)
    want = np.where(jm, f_row_serial(tF, e_ins), 0)
    T = torch.from_numpy
    got = f_row_strips(T(M), T(beg), T(end), oe_ins, e_ins, C).numpy()
    np.testing.assert_array_equal(got, want)
    # the form sw_extend_batch_plain (and _sw_kernel) uses
    NEG = -(1 << 28)
    cm = np.maximum.accumulate(np.where(jm, tF + j * e_ins, NEG), axis=1)
    cm_shift = np.concatenate([np.full((B, 1), NEG), cm[:, :-1]], 1)
    plain = np.where(jm, np.maximum(cm_shift - (j - 1) * e_ins, 0), 0)
    np.testing.assert_array_equal(got, plain)
    assert (got > 0).sum() > B      # the case is not all zeros
    # a wider strip than the row needs changes nothing
    if C < 8:
        wide = f_row_strips(T(M), T(beg), T(end), oe_ins, e_ins, 8).numpy()
        np.testing.assert_array_equal(wide, want)


@pytest.mark.parametrize("Lq,C", [(1, 2), (16, 2), (64, 2), (65, 4), (100, 4),
                                  (150, 5), (160, 5), (161, 6), (250, 8),
                                  (257, 12), (385, 16), (512, 16)])
def test_strip_width_is_the_smallest_that_fits(Lq, C):
    assert strip_scan.strip_width(Lq) == C
    assert C in strip_scan.STRIP_WIDTHS and 32 * C >= Lq


@pytest.mark.parametrize("Lq", [513, 640, 16000, 1 << 20])
def test_a_query_past_the_widest_strip_runs_the_wide_instance(Lq):
    assert strip_scan.strip_width(Lq) == strip_scan.WIDE
    assert strip_scan.WIDE not in strip_scan.STRIP_WIDTHS
    # a compiled width needs no device scratch, whatever the library says
    assert strip_scan.wide_scratch(None, "unused", 5, 4, 150, "cpu") is None


def test_strip_width_refuses_a_query_no_instance_takes():
    """Only the int32 margin of the F scans bounds the wide instance."""
    too_wide = strip_scan.MAX_QUERY_WIDTH + 1
    with pytest.raises(ValueError, match=str(too_wide)):
        strip_scan.strip_width(too_wide)
    with pytest.raises(ValueError):
        strip_scan.strip_width(-1)
    assert (strip_scan.VERYNEG - 2 * strip_scan.MAX_QUERY_WIDTH * 256
            > -2 ** 31 + 4 * 10 ** 8)
    with pytest.raises(ValueError):
        strip_scan.f_row_strips(torch.zeros((1, 65), dtype=torch.int32), 1, 2)


def test_strip_widths_are_the_instances_of_both_sources():
    """STRIP_WIDTHS is the list FOR_EACH_C of each CUDA source, the global
    kernel's too, and each includes the strips' header."""
    import os
    import re
    from torch_testdata import REPO
    want = " ".join(f"X({c})" for c in strip_scan.STRIP_WIDTHS)
    for name in ("sw_extend.cu", "sw_local.cu", "sw_global.cu"):
        with open(os.path.join(REPO, "biscuit_tpu_torch", "kernels", name)) as f:
            src = f.read()
        assert re.search(r"#define FOR_EACH_C\(X\) (.*)", src).group(1) == want
        assert "hbuf" not in src and "ebuf" not in src
        assert '#include "strip.cuh"' in src and "CASE(0)" in src


def test_kernel_codes_passes_uint8_and_int32_through():
    q8 = torch.zeros((3, 16), dtype=torch.uint8)
    q32 = torch.zeros((3, 16), dtype=torch.int32)
    a, b = strip_scan.kernel_codes(q8, q8)
    assert a is q8 and b is q8
    a, b = strip_scan.kernel_codes(q32, q32)
    assert a is q32 and b is q32
    for x, y in ((q8, q32), (q32.long(), q32.long()), (q32.t(), q32.t())):
        a, b = strip_scan.kernel_codes(x, y)
        assert a.is_contiguous() and b.is_contiguous()
        assert a.dtype == b.dtype and a.dtype in (torch.uint8, torch.int32)
        assert a.shape == x.shape


def test_ptxas_resources_reads_registers_and_spills():
    from biscuit_tpu_torch.kernels import ptxas_resources
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1aILi5EEvPKv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aILi5EEvPKv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 0 barriers, 13312 bytes smem\n"
        "ptxas info    : Compiling entry function 'b' for 'sm_90a'\n"
        "ptxas info    : Function properties for b\n"
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 18 registers, 400 bytes cmem[0]\n")
    assert ptxas_resources(log) == [("a<5>", 40, 0, 0, 13312),
                                    ("b", 18, 4, 8, 0)]
    from biscuit_tpu_torch.kernels import kernel_label
    assert kernel_label(
        "_ZN43_GLOBAL__N__0928b1f1_10_sa_walk_cu_fda321cb14sa_walk_kernel"
        "IiLi8EEEvPKjPKlS4_PKT_PKiS7_lliPS5_l") == "sa_walk_kernel<int, 8>"
    assert kernel_label(
        "_ZN45_GLOBAL__N__3beff904_12_sw_global_cu_05e8c04923global_"
        "traceback_kernelEPKhPKiS3_S3_PiS4_Pbiiii") == "global_traceback_kernel"
    assert kernel_label(
        "_ZN45_GLOBAL__N__3beff904_12_sw_global_cu_05e8c04916sw_global_"
        "kernelILi5ELb1EEEvPKvS2_PKiS4_") == "sw_global_kernel<5, true>"
    assert kernel_label(
        "_ZN48_GLOBAL__N__5c2e7a10_15_pileup_coun"
        "t_cu_3d9b41f219pileup_count_kernelILb1EihEEvPKT0_PKT1_PKhlliiPi") == "pileup_count_kernel<true, int, unsigned char>"
