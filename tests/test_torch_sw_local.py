"""K7 (exact ksw_align2 for mate rescue) in the torch port vs the JAX
package, on the CPU.

The plain version `sw_local_batch_plain` (through the `sw_local_batch`
wrapper, which picks it for CPU tensors) must equal the XLA function
`sw_local_kernel` in every output, the per-row maxima included; the port's
`sw_align_batch` must equal the scalar `sw.sw_align` in all seven fields;
`local_post` must stay its JAX source's code; and the engine's
`sw_local_batch_fn` must use the rescue's matrix order (mats[0] = ctmat).
The edge lanes of torch_testdata.local_edge_case, which the bring-up check
puts through the kernel on the card, go through the same comparison here;
and the kernel's F scan in strips of C columns with decayed carries, which
can run here, is held to the serial lazy-F recurrence.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biscuit_tpu.config import MemOpt as JaxMemOpt
from biscuit_tpu_torch.config import MemOpt
from biscuit_tpu.ops import sw
from biscuit_tpu.ops.sw_local import sw_local_kernel
from biscuit_tpu_torch import kernels
from biscuit_tpu_torch.ops.sw_local import (f_row_strips, sw_align_batch,
                                            sw_local_batch)

from torch_testdata import (DP_EDGE_SHAPES_CPU, REPO, jax_index,
                            local_edge_case, make_dataset)

torch.set_num_threads(1)

REGIMES = {  # a, b, o_del, e_del, o_ins, e_ins
    "default": (1, 2, 6, 1, 6, 1),
    "cheap": (1, 1, 1, 1, 1, 1),
    "asym": (2, 3, 5, 2, 3, 1),
    "saturating": (4, 2, 6, 1, 6, 1),
    "e_ins0": (1, 2, 6, 1, 6, 0),     # the scan's decay vanishes
    "e_ins3": (2, 3, 5, 2, 3, 3),
}
FIELDS = ("score", "te", "qe", "score2", "te2", "tb", "qb")


def mk_mats(a, b):
    """Two distinguishable, asymmetric matrices (as tests/test_sw_local.py)."""
    m = np.zeros((2, 5, 5), np.int64)
    m[:, :4, :4] = -b
    for i in range(4):
        m[:, i, i] = a
    m[1] = m[0].T
    m[1, 0, 1] = a
    return m


def lane_case(rng, B, Lq, Lt, u8_mix, saturating=False):
    """Lanes at rescue-like shapes: targets hold a mutated copy of the query
    in two of three lanes; qlens not multiples of 8 or 16; a third of the
    lanes stop early on a small endsc; one empty query, one empty target."""
    q = np.full((B, Lq), 4, np.int32)
    t = np.full((B, Lt), 4, np.int32)
    qlens = rng.integers(5, Lq - 3, B).astype(np.int32)
    tlens = rng.integers(Lq // 2, Lt + 1, B).astype(np.int32)
    qlens[qlens % 8 == 0] += 1
    for b in range(B):
        qq = rng.integers(0, 4, qlens[b])
        tt = rng.integers(0, 4, tlens[b])
        if b % 3:
            off = int(rng.integers(0, max(1, tlens[b] - qlens[b])))
            n = min(qlens[b], tlens[b] - off)
            tt[off:off + n] = qq[:n]
            if saturating:  # repeats: scores past 255 at a = 4
                for k in range(off + n, tlens[b] - qlens[b], qlens[b]):
                    tt[k:k + qlens[b]] = qq
            nm = int(rng.integers(0, 1 + tlens[b] // 8))
            tt[rng.integers(0, tlens[b], nm)] = rng.integers(0, 4, nm)
        q[b, :qlens[b]] = qq
        t[b, :tlens[b]] = tt
    qlens[0], tlens[1] = 0, 0
    u8 = {"none": np.zeros(B), "all": np.ones(B),
          "mixed": rng.integers(0, 2, B)}[u8_mix].astype(np.int32)
    matsel = rng.integers(0, 2, B).astype(np.int32)
    minsc = rng.integers(10, 60, B).astype(np.int32)
    endsc = np.where(rng.random(B) < 0.33, rng.integers(5, 80, B),
                     0x10000).astype(np.int32)
    return q, qlens, t, tlens, matsel, minsc, endsc, u8


def _edge_params():
    """The edge lanes at every CPU shape under the default scores and at two
    under e_ins = 0, e_ins = 3 and the saturating scores."""
    for B, Lq, Lt in DP_EDGE_SHAPES_CPU:
        Lq16 = -(-Lq // 16) * 16
        for regime in ("default", "e_ins0", "e_ins3", "saturating"):
            if regime == "default" or Lq in (100, 160):
                yield pytest.param(regime, (B, Lq16, Lt),
                                   id=f"edge-{regime}-{B}-{Lq16}-{Lt}")


@pytest.mark.parametrize("regime,u8_mix", [
    *(pytest.param(r, u, id=f"{r}-{u}")
      for r in ("default", "cheap", "asym", "saturating")
      for u in ("none", "all", "mixed")),
    *_edge_params()])
def test_plain_matches_jax_kernel(regime, u8_mix):
    """u8_mix a shape (B, Lq, Lt): the lanes of local_edge_case (stripes
    that end inside a strip of the kernel, ties, empty query or target,
    qlen = Lq), u8 and i16 lanes mixed."""
    a, b, *sc = REGIMES[regime]
    if isinstance(u8_mix, tuple):
        (q, ql, t, tl, mats, ms), (mn, en, u8) = local_edge_case(
            7 + u8_mix[1], *u8_mix, a, b)
        n_scored = u8_mix[0] // 2
    else:
        mats = mk_mats(a, b).astype(np.int32)
        rng = np.random.default_rng(
            [*REGIMES].index(regime) * 3
            + ["none", "all", "mixed"].index(u8_mix))
        q, ql, t, tl, ms, mn, en, u8 = lane_case(rng, 40, 176, 420, u8_mix,
                                                 regime == "saturating")
        n_scored = 30
    want = sw_local_kernel(*(jnp.asarray(x) for x in (q, ql, t, tl, mats, ms)),
                           *sc, jnp.asarray(mn), jnp.asarray(en),
                           jnp.asarray(u8))
    T = torch.from_numpy
    kernels.reset_launches()
    got = sw_local_batch(T(q), T(ql), T(t), T(tl), T(mats), T(ms), *sc,
                         T(mn), T(en), T(u8))
    assert not any(kernels.LAUNCHES.values())
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == np.int32 and g.shape == w.shape, k
        assert np.array_equal(g, w), f"{k}: lanes {np.nonzero(g != w)}"
    if regime == "saturating" and u8_mix != "none" and len(ql) > 30:
        assert got["sat"].sum() > 0
    assert (got["te"] >= 0).sum() > n_scored


@pytest.mark.parametrize("e_ins", [0, 1, 3])
@pytest.mark.parametrize("C", [2, 5, 8, 17])    # 17: a strip of the wide instance
def test_f_scan_in_strips_is_the_lazy_f(C, e_ins):
    """One row's F as K7 computes it (strips of C columns, carries combined
    by shifts of 1..16 and decayed by the columns crossed, the stripe's end
    `ext` as a mask) against ksw's serial lazy-F chain,
    F(0) = 0, F(j) = max(F(j-1) - e_ins, tF(j-1)), and against the closed
    form of sw_local_batch_plain (and sw_local_kernel). ext falls inside
    strips, on their edges, at 0 and at Lq."""
    rng = np.random.default_rng(200 * C + e_ins)
    B, Lq, oe_ins = 96, 32 * C // 16 * 16, 6 + e_ins
    H1 = rng.integers(0, 40, (B, Lq)) * (rng.random((B, Lq)) < 0.3)
    H1[::3] += rng.integers(0, 250, (B, Lq))[::3] * (rng.random((B, Lq)) < 0.05)[::3]
    H1 = H1.astype(np.int32)
    # the kernel's ext is a multiple of 8, which no strip of 2 or 8 columns
    # straddles; the scan must hold for any cut, so half are arbitrary
    ext = (rng.integers(0, Lq // 8 + 1, B) * 8).astype(np.int32)
    ext[::2] = rng.integers(0, Lq + 1, B)[::2]
    ext[:6] = (0, Lq, 8, 2 * C * 8, C + 1, 1)
    j = np.arange(Lq)[None, :]
    inb = j < ext[:, None]
    tF = np.maximum(np.where(inb, H1, 0) - oe_ins, 0).astype(np.int32)
    F = np.zeros_like(tF)
    for k in range(1, Lq):
        F[:, k] = np.maximum(F[:, k - 1] - e_ins, tF[:, k - 1])
    want = np.where(inb, F, 0)
    T = torch.from_numpy
    got = f_row_strips(T(H1), T(ext), oe_ins, e_ins, C).numpy()
    np.testing.assert_array_equal(got, want)
    NEGB = -(1 << 28)
    cm = np.maximum.accumulate(tF + j * e_ins, axis=1)
    cm_excl = np.concatenate([np.full((B, 1), NEGB), cm[:, :-1]], 1)
    plain = np.maximum(np.maximum(-j * e_ins, cm_excl - (j - 1) * e_ins), 0)
    np.testing.assert_array_equal(got, np.where(inb, plain, 0))
    assert (got > 0).sum() > B
    assert any(e % C for e in ext.tolist())     # a cut inside a strip


def scalar_case(regime, xsubo, seed=17, n=60):
    """The requests of tests/test_sw_local.py and the scalar answers."""
    a, b, *sc = REGIMES[regime]
    mats = mk_mats(a, b)
    rng = np.random.default_rng(seed)
    reqs, oracle = [], []
    for trial in range(n):
        qlen = int(rng.integers(5, 180))
        tlen = int(rng.integers(5, 400))
        base = rng.integers(0, 4, max(qlen, tlen) + 8).astype(np.uint8)
        q = base[:qlen].copy()
        t = base[4:4 + tlen].copy() if trial % 3 else \
            rng.integers(0, 4, tlen).astype(np.uint8)
        nmut = int(rng.integers(0, 1 + tlen // 5))
        t[rng.integers(0, tlen, nmut)] = rng.integers(0, 4, nmut).astype(np.uint8)
        m = int(rng.integers(0, 2))
        xb = bool(qlen * a < 250) if trial % 2 else False
        reqs.append((q, t, m, xb))
        oracle.append(sw.sw_align(q, t, mats[m], *sc, xstart=True,
                                  xsubo=xsubo, xbyte=xb))
    return mats, sc, reqs, oracle


def assert_same(got, want, reqs):
    for i, (o, g) in enumerate(zip(want, got)):
        for f in FIELDS:
            assert getattr(o, f) == getattr(g, f), (
                f"lane {i} field {f}: scalar {getattr(o, f)} != batch "
                f"{getattr(g, f)} (qlen={len(reqs[i][0])} "
                f"tlen={len(reqs[i][1])} m={reqs[i][2]} u8={reqs[i][3]})")


@pytest.mark.parametrize("xsubo", [None, 19, 60])
@pytest.mark.parametrize("regime", ["default", "cheap", "asym"])
def test_sw_align_batch_matches_scalar(regime, xsubo):
    mats, sc, reqs, oracle = scalar_case(regime, xsubo)
    got, n_lanes = sw_align_batch(reqs, *sc, mats, xsubo=xsubo)
    assert_same(got, oracle, reqs)
    n_rev = sum((xsubo is None or r.score >= xsubo) and r.qe >= 0
                and r.te >= 0 for r in got)
    assert n_lanes == len(reqs) + n_rev


def test_sw_align_batch_saturation():
    """u8 lanes that saturate at 255 skip qe/score2 like the scalar
    (tests/test_sw_local.py:56), beside an i16 lane that does not."""
    mats = mk_mats(4, 2)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, 120).astype(np.uint8)
    t = np.concatenate([q, q, q]).astype(np.uint8)  # score ~480 >> 255
    reqs = [(q, t, 0, True), (q, t, 0, False)]
    want = [sw.sw_align(q, t, mats[0], 6, 1, 6, 1, xstart=True, xsubo=10,
                        xbyte=xb) for xb in (True, False)]
    got, _n = sw_align_batch(reqs, 6, 1, 6, 1, mats, xsubo=10)
    assert want[0].score == 255 and want[1].score > 255
    assert_same(got, want, reqs)


def _function_ast(path, name):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.dump(node)
    raise AssertionError(f"{name} not in {path}")


def test_local_post_is_its_source():
    src = os.path.join(REPO, "biscuit_tpu", "ops", "sw_local.py")
    dst = os.path.join(REPO, "biscuit_tpu_torch", "ops", "sw_local.py")
    assert _function_ast(dst, "local_post") == _function_ast(src, "local_post")


def test_engine_fn_matches_jax_engine(tmp_path):
    """The port's DeviceAligner.sw_local_batch_fn against the JAX engine's
    and the scalar rescue call (region._matesw_core): parent 1 aligns with
    gamat, parent 0 with ctmat. Bisulfite-converted queries make the two
    matrices give different answers, so a swapped order fails here."""
    from biscuit_tpu.align.device_engine import DeviceAligner as JaxAligner
    from biscuit_tpu.align.pipeline import AlignerState as JaxState
    from biscuit_tpu_torch.align.device_engine import (DeviceAligner,
                                                       reset_stages,
                                                       stage_report)
    from biscuit_tpu_torch.align.pipeline import AlignerState
    _fa, _fq, idx = make_dataset(tmp_path, genome_size=20000, n_reads=4)
    opt = MemOpt()
    rng = np.random.default_rng(5)
    reqs = []
    for k in range(24):
        t = rng.integers(0, 4, 400).astype(np.uint8)
        off, ql = int(rng.integers(0, 230)), int(rng.integers(60, 151))
        q = t[off:off + ql].copy()
        q[q == (1 if k % 2 else 2)] = 3 if k % 2 else 0  # C>T or G>A
        q[::17] = (q[::17] + 1) % 4
        reqs.append((q, t, k % 4 // 2, ql * opt.a < 250 or k % 8 == 7))
    xsubo = opt.min_seed_len * opt.a
    reset_stages()
    got = DeviceAligner(AlignerState(idx), "cpu").sw_local_batch_fn(opt)(
        reqs, xsubo)
    rep = stage_report()
    want = JaxAligner(JaxState(jax_index(idx))).sw_local_batch_fn(JaxMemOpt())(
        reqs, xsubo)
    assert_same(got, want, reqs)
    jopt = JaxMemOpt()  # the JAX package's scalar reads its own options
    scalar = [sw.sw_align(q, t, jopt.gamat if p else jopt.ctmat, jopt.o_del,
                          jopt.e_del, jopt.o_ins, jopt.e_ins, xstart=True,
                          xsubo=xsubo, xbyte=xb) for q, t, p, xb in reqs]
    assert_same(got, scalar, reqs)
    swapped = [sw.sw_align(q, t, jopt.ctmat if p else jopt.gamat, jopt.o_del,
                           jopt.e_del, jopt.o_ins, jopt.e_ins, xstart=True,
                           xsubo=xsubo, xbyte=xb) for q, t, p, xb in reqs]
    assert any(g.score != s.score for g, s in zip(got, swapped))
    assert rep["rescue_lanes"] >= len(reqs)
