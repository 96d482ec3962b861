"""Torch seeding (K5 occ4/extend, K3 mem_collect_intv) vs the JAX package.

occ4_sel_plain and extend_sel_plain (the CPU twins of K5, which the CUDA
seeder inlines) must equal JAX occ4_sel and extend_sel, and
collect_intv_flat_plain (the CPU twin of K3) must equal the JAX device
engine's default seeder (collect_intv_flat_sm, log machine) and the host
smem.collect_intv on every lane, on narrow (int32 rank) and wide (int64
rank, BISCUIT_TPU_WIDE_INDEX=1) indexes. Exact equality throughout: every
value is an integer.
"""
import collections
import copy

import numpy as np
import pytest
import torch

from biscuit_tpu.config import MemOpt as JaxMemOpt
from biscuit_tpu_torch.config import MEM_F_SELF_OVLP, MemOpt
from biscuit_tpu_torch.index.build import build_index
from biscuit_tpu.ops import seed_batch as jsb
from biscuit_tpu_torch.align.smem import collect_intv
from biscuit_tpu_torch.ops import seed_batch as tsb
from biscuit_tpu_torch.ops.fm import FMNumpy

from torch_testdata import (jax_index, lanes_both_ways as _lanes, load_reads,
                            make_dataset, seed_edge_reads)

# the plain versions are loops of small ops: under pytest-xdist, intra-op
# threads of several workers only contend for the cores
torch.set_num_threads(1)

NT = np.frombuffer(b"ACGT", np.uint8)


def _repeat_fasta(path, seed=3):
    """A 30 kbp random chromosome carrying a repeat family: 80 exact and 10
    mutated copies of a 120 bp element (seeds of more than 64
    occurrences) and 12 copies of a 400 bp element at 3% divergence
    (long SMEMs of 2-10 occurrences, which pass 2 re-seeds). Returns the
    genome as nt4 codes and the start of each copy."""
    rng = np.random.default_rng(seed)
    short = rng.integers(0, 4, 120)
    long_ = rng.integers(0, 4, 400)
    parts, starts, at = [], [], 0
    for k in range(102):
        parts.append(rng.integers(0, 4, int(rng.integers(100, 300))))
        at += len(parts[-1])
        starts.append(at)
        if k < 90:
            e = short.copy()
            if k >= 80:
                e[rng.integers(0, 120, 2)] = rng.integers(0, 4, 2)
        else:
            e = long_.copy()
            m = rng.random(400) < 0.03
            e[m] = rng.integers(0, 4, int(m.sum()))
        parts.append(e)
        at += len(e)
    g = np.concatenate(parts + [rng.integers(0, 4, 2000)])
    with open(path, "w") as f:
        f.write(">chrR\n")
        s = NT[g].tobytes().decode()
        for i in range(0, len(s), 60):
            f.write(s[i:i + 60] + "\n")
    return g, np.asarray(starts)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Narrow and wide indexes of one generator genome, the lanes of its
    reads with the edge cases added, and the repeat-family index with its
    lanes."""
    d = tmp_path_factory.mktemp("tseed")
    fa, fq, narrow = make_dataset(d, genome_size=60000, n_reads=24, seed=5,
                                  snp_rate=0.01)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BISCUIT_TPU_WIDE_INDEX", "1")
        wide = build_index(fa)
    assert wide.dau.sa_samples.dtype.itemsize == 8
    reads = [s.seq.astype(np.int64) for s in load_reads(fq, 24)]
    rng = np.random.default_rng(9)
    amb = reads[0].copy()
    amb[[10, 11, 50]] = 4
    reads += [amb, reads[1][:15], np.full(80, 4), rng.integers(0, 4, 100)]

    rfa = str(d / "repeat.fa")
    g, copies = _repeat_fasta(rfa)
    rep_idx = build_index(rfa)
    # reads inside copies of either element, and across the genome
    starts = np.concatenate([copies[[0, 40, 85, 95, 100]] + 10,
                             copies[[91, 98]] + 330,
                             rng.integers(0, len(g) - 100, 23)])
    rep_reads = [g[s:s + 100] for s in starts]
    rep_reads += [3 - r[::-1] for r in rep_reads[:6]]  # reverse strand
    return {"narrow": (narrow, _lanes(reads)), "wide": (wide, _lanes(reads)),
            "repeat": (rep_idx, _lanes(rep_reads)),
            "edge": (narrow, _lanes(seed_edge_reads(reads[:6])))}


def _fms(idx):
    return {0: FMNumpy(idx.dau), 1: FMNumpy(idx.par)}


def _host(opt, idx, q, lens, par):
    fms = _fms(idx)
    return [collect_intv(opt, fms[int(p)], fms[1 - int(p)], q[b, :lens[b]])
            for b, p in enumerate(par)]


_PLAIN = {}


def _plain(data, name):
    """collect_intv_flat on CPU tensors (the plain machine), once per
    dataset."""
    if name not in _PLAIN:
        idx, (q, lens, par) = data[name]
        tfm = tsb.FMPair.from_index(idx, "cpu")
        T = torch.from_numpy
        _PLAIN[name] = tsb.collect_intv_flat(tfm, T(q), T(lens), T(par),
                                             MemOpt())
    return _PLAIN[name]


def _ranks(rng, idx, n):
    L = int(idx.dau.seq_len)
    k = rng.integers(-1, L + 1, n)
    edges = [-1, 0, L - 1, L]
    for p in (int(idx.dau.primary), int(idx.par.primary)):
        edges += [p - 1, p, p + 1]
    k[:len(edges)] = edges
    return k


@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_occ4_sel_plain_matches_jax(data, layout):
    idx = data[layout][0]
    jfm = jsb.FMPair.from_index(jax_index(idx))
    tfm = tsb.FMPair.from_index(idx, "cpu")
    rng = np.random.default_rng(1)
    k = _ranks(rng, idx, 3000)
    which = rng.integers(0, 2, k.size).astype(np.int32)
    rdt = np.int64 if tfm.wide else np.int32
    with jsb._rank_ctx(jfm):
        want = np.asarray(jsb.occ4_sel(jfm, jsb.jnp.asarray(which),
                                       jsb.jnp.asarray(k.astype(rdt))))
    got = tsb.occ4_sel_plain(tfm, torch.from_numpy(which),
                             torch.from_numpy(k.astype(rdt)))
    assert got.dtype == tfm.rdt
    np.testing.assert_array_equal(got.numpy(), want)
    # and the scalar occ4 of the port's FMNumpy
    fms = _fms(idx)
    for wh, kk, g in list(zip(which, k, got.tolist()))[:400]:
        assert tuple(g) == tuple(fms[int(wh)].occ4_s(int(kk)))


@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_occ4_by_words_matches_plain_and_jax(data, layout):
    """occ4 as a thread of K3 computes it (for each class its count and the
    count of the classes above, from shifted, xor-ed and masked BWT words; the
    edges replace the result) on random ranks and on -1, 0, each primary and
    its neighbours, seq_len - 1 and seq_len, and on every position of a
    word."""
    idx = data[layout][0]
    jfm = jsb.FMPair.from_index(jax_index(idx))
    tfm = tsb.FMPair.from_index(idx, "cpu")
    rng = np.random.default_rng(4)
    k = np.concatenate([_ranks(rng, idx, 3000), np.arange(640, 640 + 130)])
    which = rng.integers(0, 2, k.size).astype(np.int32)
    rdt = np.int64 if tfm.wide else np.int32
    T = torch.from_numpy
    eq, gt = tsb.occ_class_plain(tfm, T(which), T(k.astype(rdt)))
    assert eq.dtype == tfm.rdt and gt.dtype == tfm.rdt
    occ = tsb.occ4_sel_plain(tfm, T(which), T(k.astype(rdt)))
    assert torch.equal(eq, occ)
    above = torch.flip(torch.cumsum(torch.flip(occ, [1]), 1), [1]) - occ
    assert torch.equal(gt, above.to(tfm.rdt))
    with jsb._rank_ctx(jfm):
        want = np.asarray(jsb.occ4_sel(jfm, jsb.jnp.asarray(which),
                                       jsb.jnp.asarray(k.astype(rdt))))
    np.testing.assert_array_equal(eq.numpy(), want)


def test_rank_order_is_the_stable_sort():
    """Each row's count of rows before it is its place in the stable sort
    by (start, end), ties (which a lane's rows do not have, see below)
    included."""
    rng = np.random.default_rng(6)
    for n in (0, 1, 2, 31, 32, 33, 128):
        start = torch.from_numpy(rng.integers(0, 12, n))
        end = start + torch.from_numpy(rng.integers(1, 6, n))
        rank = tsb.rank_order(start, end)
        order = torch.sort(start * 1000 + end, stable=True).indices
        assert sorted(rank.tolist()) == list(range(n))
        placed = torch.empty(n, dtype=torch.long)
        placed[rank] = torch.arange(n)
        assert torch.equal(placed, order)


@pytest.mark.parametrize("layout", ["narrow", "wide", "repeat"])
def test_rows_do_not_depend_on_the_order_of_the_passes(data, layout):
    """What lets K3 store a lane's rows in any order before its sort: within
    a lane, rows with equal (start, end) are equal rows (one substring of
    the read has one interval), and pass 3's rows are those
    `_strategy_plain` gives alone, whatever passes 1 and 2 found."""
    idx, (q, lens, par) = data[layout]
    opt = MemOpt()
    lane_of, rows, ov = _plain(data, layout)
    assert not ov.any()
    full = collections.defaultdict(list)
    for b, r in zip(lane_of.tolist(), rows.tolist()):
        full[b].append(tuple(r))
    for b, rs in full.items():
        by_key = {}
        for r in rs:
            assert by_key.setdefault(r[:2], r) == r, f"lane {b}: {r}"
    tfm = tsb.FMPair.from_index(idx, "cpu")
    T = torch.from_numpy
    no_p3 = copy.copy(opt)
    no_p3.max_mem_intv = 0
    l12, r12, _ = tsb.collect_intv_flat(tfm, T(q), T(lens), T(par), no_p3)
    msl, _sl, _sw, max_intv, _st = tsb.seed_params(opt)
    l3, r3 = tsb._strategy_plain(tsb._Lanes(tfm, T(q), T(lens), T(par)), msl,
                                 max_intv)
    assert l3.numel() > 0
    merged = collections.defaultdict(list)
    for b, r in zip(l12.tolist() + l3.tolist(), r12.tolist() + r3.tolist()):
        merged[b].append(tuple(r))
    assert set(merged) == set(full)
    for b in full:
        assert sorted(merged[b]) == sorted(full[b]), f"lane {b}"


@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_extend_sel_plain_matches_jax(data, layout):
    """Random bi-intervals, with some straddling either primary row (the
    `crosses` term) and some empty or reaching seq_len."""
    idx = data[layout][0]
    jfm = jsb.FMPair.from_index(jax_index(idx))
    tfm = tsb.FMPair.from_index(idx, "cpu")
    L = int(idx.dau.seq_len)
    rng = np.random.default_rng(2)
    n = 3000
    which = rng.integers(0, 2, n).astype(np.int32)
    x_q = rng.integers(1, L + 1, n)
    prim = np.where(which == 1, int(idx.par.primary), int(idx.dau.primary))
    x_q[:600] = prim[:600] - rng.integers(0, 5, 600)
    s = np.minimum(rng.integers(0, 40, n), L + 1 - x_q)
    x_q[600:610], s[600:610] = 1, L          # the whole index
    x_o = rng.integers(1, L + 1, n)
    rdt = np.int64 if tfm.wide else np.int32
    with jsb._rank_ctx(jfm):
        J = [jsb.jnp.asarray(a.astype(rdt)) for a in (x_q, x_o, s)]
        want = jsb.extend_sel(jfm, jsb.jnp.asarray(which), *J, None)
        want = [np.asarray(a) for a in want]
    T = [torch.from_numpy(a.astype(rdt)) for a in (x_q, x_o, s)]
    got = tsb.extend_sel_plain(tfm, torch.from_numpy(which), *T)
    assert ((x_q <= prim) & (x_q + s - 1 >= prim)).sum() > 100
    for g, w in zip(got, want):
        assert g.dtype == tfm.rdt
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("layout", ["narrow", "wide", "repeat"])
def test_collect_intv_flat_plain_matches_jax_and_host(data, layout):
    """Every lane: generator reads converted both ways, ambiguous bases, a
    read shorter than min_seed_len, an all-N read and a random one (or the
    repeat family's reads). Neither seeder flags a lane."""
    idx, (q, lens, par) = data[layout]
    opt = MemOpt()
    lane_of, rows, ov = _plain(data, layout)
    jfm = jsb.FMPair.from_index(jax_index(idx))
    jl, jr, jov = jsb.collect_intv_flat_sm(jfm, q, lens, par, JaxMemOpt())
    assert not ov.any() and not jov.any()
    assert rows.dtype == (torch.int64 if jfm.wide else torch.int32)
    np.testing.assert_array_equal(lane_of.numpy(), jl)
    np.testing.assert_array_equal(rows.numpy(), jr)
    want = _host(opt, idx, q, lens, par)
    counts = np.bincount(lane_of.numpy(), minlength=len(par))
    assert counts.tolist() == [len(w) for w in want]
    flat = [tuple(r) for r in rows.tolist()]
    assert flat == [r for w in want for r in w]
    if layout == "repeat":
        # pass 2 ran and some seeds have more than KMAX=64 occurrences
        assert (rows[:, 4] > 64).any()
        assert any(len(w) for w in want)
        no_p2 = copy.copy(opt)
        no_p2.split_width = -1
        assert _host(no_p2, idx, q, lens, par) != want
    else:
        # lanes 48-49 hold the ambiguous read, 50-51 the short one, then
        # the all-N read and the random one
        assert counts[48:50].sum() > 0
        assert counts[50:54].tolist() == [0, 0, 0, 0]


def test_collect_intv_batch_lists_match_host(data):
    """The per-lane tuple lists the engine consumes."""
    idx, (q, lens, par) = data["narrow"]
    tfm = tsb.FMPair.from_index(idx, "cpu")
    T = torch.from_numpy
    got, ov = tsb.collect_intv_batch(tfm, T(q[:12]), T(lens[:12]),
                                     T(par[:12]), MemOpt())
    assert isinstance(ov, np.ndarray) and not ov.any()
    assert got == _host(MemOpt(), idx, q[:12], lens[:12], par[:12])


def test_small_cap_flags_exactly_the_lanes_over_it(data):
    """With S rows per lane, a lane is flagged iff the host gives it more
    than S rows; flagged lanes have no rows, the others keep theirs."""
    idx, (q, lens, par) = data["repeat"]
    opt = MemOpt()
    S = 3
    tfm = tsb.FMPair.from_index(idx, "cpu")
    T = torch.from_numpy
    lane_of, rows, ov = tsb.collect_intv_flat(tfm, T(q), T(lens), T(par),
                                              opt, S=S)
    want = [len(w) for w in _host(opt, idx, q, lens, par)]
    assert ov.tolist() == [n > S for n in want]
    assert 0 < int(ov.sum()) < len(want)
    full_lane, full_rows, _ = _plain(data, "repeat")
    keep = ~ov.numpy()[full_lane.numpy()]
    np.testing.assert_array_equal(lane_of.numpy(), full_lane.numpy()[keep])
    np.testing.assert_array_equal(rows.numpy(), full_rows.numpy()[keep])


@pytest.mark.parametrize("flag", [0, MEM_F_SELF_OVLP],
                         ids=["default", "self_ovlp"])
def test_edge_lanes_match_host(data, flag):
    """The lanes of torch_testdata.seed_edge_reads (N at every kind of place,
    reads of no and one base, tandem repeats, joined reads), which the
    bring-up check also puts through K3 on the card: the rows are the
    host's, and under S = 1 exactly the lanes with more rows are flagged."""
    idx, (q, lens, par) = data["edge"]
    opt = MemOpt()
    opt.flag |= flag
    tfm = tsb.FMPair.from_index(idx, "cpu")
    T = torch.from_numpy
    got, ov = tsb.collect_intv_batch(tfm, T(q), T(lens), T(par), opt)
    want = _host(opt, idx, q, lens, par)
    assert not ov.any() and got == want
    assert sum(len(w) > 1 for w in want) > 2 and [] in want
    _lane, rows1, ov1 = tsb.collect_intv_flat(tfm, T(q), T(lens), T(par), opt,
                                              S=1)
    assert ov1.tolist() == [len(w) > 1 for w in want]
    assert rows1.shape[0] == sum(len(w) == 1 for w in want)


def test_self_overlap_start_width_matches_host(data):
    """MEM_F_SELF_OVLP asks pass 1 for two occurrences (smem.py:112). The
    JAX log machine does not read the flag; the port follows the host."""
    idx, (q, lens, par) = data["repeat"]
    opt = MemOpt()
    opt.flag |= MEM_F_SELF_OVLP
    assert tsb.seed_params(opt)[4] == 2
    tfm = tsb.FMPair.from_index(idx, "cpu")
    T = torch.from_numpy
    got, ov = tsb.collect_intv_batch(tfm, T(q), T(lens), T(par), opt)
    want = _host(opt, idx, q, lens, par)
    assert not ov.any() and got == want
    assert want != _host(MemOpt(), idx, q, lens, par)


def test_seed_params_and_empty_batches(data):
    opt = MemOpt()
    assert tsb.seed_params(opt) == (19, 28, 10, 20, 1)
    opt.min_seed_len, opt.split_factor = 13, 2.5
    assert tsb.seed_params(opt)[:2] == (13, int(13 * 2.5 + 0.499))
    tfm = tsb.FMPair.from_index(data["narrow"][0], "cpu")
    z = torch.zeros(0, dtype=torch.int32)
    for q, lens in [(torch.zeros((0, 50), dtype=torch.int32), z),
                    (torch.full((3, 0), 4, dtype=torch.int32),
                     torch.zeros(3, dtype=torch.int32))]:
        lane_of, rows, ov = tsb.collect_intv_flat(tfm, q, lens, lens, opt)
        assert lane_of.shape == (0,) and rows.shape == (0, 5)
        assert ov.shape == (q.shape[0],) and not ov.any()
