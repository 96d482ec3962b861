"""K4's interval entry and the device engine's `sa` stage vs the JAX package.

`sa_batch_intervals_plain` (the CPU twin of the interval entry of
kernels/sa_walk.cu) must give, for every row, the positions of the JAX
package's expansion of the row (np.repeat of the strand, x0 + arange) through
`sa_batch_np`, at out[off + i], on narrow (sa_intv 4), wide (sa_intv 16) and
BISCUIT_TPU_SA_INTV=32 builds of one genome and on the edge rows of
`torch_testdata.sa_rows`. An sa_intv-32 view of the narrow tables (its
samples stride-subsampled) gives the positions of the index built at 32.
The engine's `_collect_seeds`, which hands the seeder's rows and after them
those of the lanes the host seeded to one call of the interval entry, gives
every (lane, seed, k) the position of the per-occurrence packing it
replaced. Exact equality throughout.
"""
import numpy as np
import pytest
import torch

from biscuit_tpu.ops import seed_batch as jsb
from biscuit_tpu_torch.align import device_engine as eng
from biscuit_tpu_torch.align.pipeline import AlignerState
from biscuit_tpu_torch.config import MemOpt
from biscuit_tpu_torch.index.build import build_index
from biscuit_tpu_torch.ops import seed_batch as tsb

from torch_testdata import (SA_ROW_CASES, jax_index, load_pairs, load_reads,
                            make_dataset, repeat_dataset, sa_intv_view,
                            sa_rows, sa_rows_expanded)

# the plain versions are loops of small ops: under pytest-xdist, intra-op
# threads of several workers only contend for the cores
torch.set_num_threads(1)

LAYOUTS = {"narrow": {}, "wide": {"BISCUIT_TPU_WIDE_INDEX": "1"},
           "intv32": {"BISCUIT_TPU_SA_INTV": "32"}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsa")
    fa, fq, narrow = make_dataset(d, genome_size=60000, n_reads=40)
    idx = {"narrow": narrow}
    for name, env in LAYOUTS.items():
        if env:
            with pytest.MonkeyPatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, v)
                idx[name] = build_index(fa)
    _fa, pe, _ = make_dataset(d / "pe", genome_size=60000, n_reads=20,
                              pe=True, index=False)
    return {"idx": idx, "se": fq, "pe": pe}


def test_layouts_sample_as_named(data):
    intv = {k: (int(v.dau.sa_intv), v.dau.sa_samples.dtype.itemsize)
            for k, v in data["idx"].items()}
    assert intv == {"narrow": (4, 4), "wide": (16, 8), "intv32": (32, 4)}


def _jax_expansion(jfm, which, x0, kmax, off, total):
    """out[off[r] + i] = SA position of rank x0[r] + i, through the JAX
    package's sa_batch_np on the expanded jobs (padded to a multiple of
    1024 with rank 1, so that few shapes compile)."""
    w, k = sa_rows_expanded(which, x0, kmax)
    out = np.zeros(total, np.int64)
    if total:
        n = -(-total // 1024) * 1024
        wp, kp = np.zeros(n, np.int32), np.ones(n, np.int64)
        wp[:total], kp[:total] = w, k
        pos = jsb.sa_batch_np(jfm, wp, kp.astype(np.int64 if jfm.wide
                                                 else np.int32))[:total]
        out[np.repeat(off, kmax) + k - np.repeat(x0, kmax)] = pos
    return out


@pytest.mark.parametrize("case", SA_ROW_CASES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sa_batch_intervals_plain_matches_jax(data, layout, case):
    idx = data["idx"][layout]
    jfm = jsb.FMPair.from_index(jax_index(idx))
    tfm = tsb.FMPair.from_index(idx, "cpu")
    n = int(idx.dau.seq_len)
    which, x0, kmax = sa_rows(case, n, (int(idx.dau.primary),
                                        int(idx.par.primary)), tfm.sa_intv)
    off = np.cumsum(kmax) - kmax
    total = int(kmax.sum())
    want = _jax_expansion(jfm, which, x0, kmax, off, total)
    T = torch.from_numpy
    args = (T(which.astype(np.int32)), T(x0).to(tfm.rdt), T(kmax), T(off),
            total)
    steps = torch.zeros(total, dtype=torch.int64)
    got = tsb.sa_batch_intervals_plain(tfm, *args, steps=steps)
    assert got.dtype == tfm.rdt and got.shape == (total,)
    np.testing.assert_array_equal(got.numpy(), want)
    # on CPU tensors the public entry is the plain version
    np.testing.assert_array_equal(tsb.sa_batch_intervals(tfm, *args).numpy(),
                                  want)
    # the rank entry on the expanded jobs agrees, step counts included
    w, k = sa_rows_expanded(which, x0, kmax)
    steps_r = torch.zeros(total, dtype=torch.int64)
    np.testing.assert_array_equal(tsb.sa_batch_plain(
        tfm, T(w.astype(np.int32)), T(k), steps_r).numpy(), want)
    assert torch.equal(steps, steps_r)
    sampled = k % tfm.sa_intv == 0
    assert not steps.numpy()[sampled].any()
    assert steps.numpy()[~sampled].min(initial=1) >= 1
    if case == "edge":  # the -1 sentinel of rank 0 plus its steps (none)
        assert (want[np.repeat(off, kmax)[k == 0]] == -1).all()


def test_sa_intv_view_matches_the_index_built_at_32(data):
    """Stride-subsampling the samples of the sa_intv-4 tables gives the
    walks and positions of the index built at 32, at no index build."""
    base = tsb.FMPair.from_index(data["idx"]["narrow"], "cpu")
    built = tsb.FMPair.from_index(data["idx"]["intv32"], "cpu")
    view = sa_intv_view(base, 32)
    assert view.sa_intv == built.sa_intv == 32
    assert view.host_consts == built.host_consts == base.host_consts
    assert torch.equal(view.tab, built.tab)
    n_sa = built.sa_samples.shape[1]
    assert torch.equal(view.sa_samples[:, :n_sa], built.sa_samples)
    rng = np.random.default_rng(3)
    ranks = torch.from_numpy(rng.integers(0, base.seq_len + 1, 4096))
    which = torch.from_numpy(rng.integers(0, 2, 4096).astype(np.int32))
    s_view = torch.zeros(4096, dtype=torch.int64)
    s_built = torch.zeros(4096, dtype=torch.int64)
    got = tsb.sa_batch_plain(view, which, ranks, s_view)
    assert torch.equal(got, tsb.sa_batch_plain(built, which, ranks, s_built))
    assert torch.equal(got, tsb.sa_batch_plain(base, which, ranks))
    assert torch.equal(s_view, s_built)
    # a longer walk than at sa_intv 4 (the geometric mean of rank sampling)
    assert float(s_view.double().mean()) > 8


def _per_occurrence(st, fmp, lanes, seeds):
    """What the old `sa` stage returned for every (lane, seed, k): one
    sa_batch over every occurrence below SA_PREFETCH_CAP, packed a job at a
    time, and the scalar walk beyond."""
    which, ranks, where = [], [], {}
    for li, ((_s, p), lane_seeds) in enumerate(zip(lanes, seeds)):
        for si, (_sb, _se, x0, _x1, size) in enumerate(lane_seeds):
            for k in range(min(size, eng.SA_PREFETCH_CAP)):
                where[li, si, k] = len(ranks)
                which.append(p)
                ranks.append(x0 + k)
    pos = tsb.sa_batch_plain(fmp, torch.tensor(which, dtype=torch.int32),
                             torch.tensor(ranks, dtype=torch.int64)).tolist()

    def want(li, si, k, x0):
        if (li, si, k) in where:
            return pos[where[li, si, k]]
        return st.fm[lanes[li][1]].sa_s(x0 + k)
    return want


def _plan(seqs, pe):
    if not pe:
        return [(s, p) for s in seqs for p in (0, 1)]
    # the PE lane policy: read 1 seeds the parent strand first
    return [(s, p if i % 2 == 0 else 1 - p) for i, s in enumerate(seqs)
            for p in (1, 0)]


@pytest.mark.parametrize("kind", ["se", "pe", "se_overflow", "se_repeats"])
def test_collect_seeds_matches_per_occurrence_packing(data, kind, monkeypatch,
                                                      tmp_path):
    idx = data["idx"]["narrow"]
    if kind == "pe":
        seqs = load_pairs(*data["pe"])
    elif kind == "se_repeats":
        # seeds of 80 occurrences: the first SA_PREFETCH_CAP through K4, the
        # rest by the scalar walk
        _fa, fq, idx = repeat_dataset(tmp_path)
        seqs = load_reads(fq, 40)
    else:
        seqs = load_reads(data["se"], 40)
    if kind == "se_overflow":
        # a seeder capacity of 3 rows flags most lanes: their rows come from
        # the host seeder and go through the rank entry
        real = eng.collect_intv_batch
        monkeypatch.setattr(eng, "collect_intv_batch",
                            lambda *a, **k: real(*a, S=3, **k))
    st = AlignerState(idx)
    dev = eng.DeviceAligner(st, "cpu")
    lanes = _plan(seqs, kind == "pe")
    eng.reset_stages()
    seeds, lookups = dev._collect_seeds(MemOpt(), lanes)
    rep = eng.stage_report()
    want = _per_occurrence(st, dev.fmpair, lanes, seeds)
    n_checked = n_beyond = 0
    for li, lane_seeds in enumerate(seeds):
        for si, (_sb, _se, x0, _x1, size) in enumerate(lane_seeds):
            for k in range(min(size, eng.SA_PREFETCH_CAP + 2)):
                assert lookups[li](si, k, x0) == want(li, si, k, x0)
                n_checked += 1
                n_beyond += k >= eng.SA_PREFETCH_CAP
    jobs = sum(min(r[4], eng.SA_PREFETCH_CAP) for s in seeds for r in s)
    assert rep["sa_jobs"] + rep["sa_overflow_jobs"] == jobs > 0
    assert n_checked >= jobs
    if kind == "se_overflow":
        assert rep["seed_overflow_lanes"] > len(lanes) // 2
        assert 0 < rep["sa_overflow_jobs"] and 0 < rep["sa_jobs"]
    else:
        assert rep["seed_overflow_lanes"] == rep["sa_overflow_jobs"] == 0
        assert rep["sa_rows"] == sum(len(s) for s in seeds)
    if kind == "se_repeats":
        assert n_beyond > 0


@pytest.mark.parametrize("kind", ["se", "se_overflow"])
def test_collect_seeds_hands_the_entry_rows_that_fill_out(data, kind,
                                                          monkeypatch):
    """The interval entry writes out[off_row[r] + i] for i < kmax_row[r]
    and no slot outside [0, total): what `_collect_seeds` computes on the
    device (which_row, x0_row, kmax_row, off_row) must agree with what it
    computes on the host (total, the lookups' kmax and off) from the seed
    tuples. The rows are those of the lanes the device seeded, in lane
    order (a lane it flags has none), then those of the lanes the host
    seeded, in lane order: one call of the interval entry, and none of the
    rank entry."""
    seqs = load_reads(data["se"], 40)
    S = 3 if kind == "se_overflow" else tsb.SEED_CAP
    seeded, handed = [], []
    real_seeder, real_entry = eng.collect_intv_batch, eng.sa_batch_intervals

    def seeder(*a, **k):
        got = real_seeder(*a, S=S, **k)
        seeded.append(got[1])
        return got

    def entry(fm, *args):
        handed.append(args)
        return real_entry(fm, *args)
    # the engine holds no name of the rank entry to call
    assert not hasattr(eng, "sa_batch")
    monkeypatch.setattr(eng, "collect_intv_batch", seeder)
    monkeypatch.setattr(eng, "sa_batch_intervals", entry)
    st = AlignerState(data["idx"]["narrow"])
    dev = eng.DeviceAligner(st, "cpu")
    lanes = _plan(seqs, False)
    eng.reset_stages()
    seeds, _lookups = dev._collect_seeds(MemOpt(), lanes)
    rep = eng.stage_report()
    assert len(seeded) == len(handed) == 1
    overflow = seeded[0]
    which_row, x0_row, kmax_row, off_row, total = handed[0]
    host = [(lanes[i][1], r[2], min(r[4], eng.SA_PREFETCH_CAP))
            for flagged in (False, True)
            for i in range(len(lanes)) if overflow[i] == flagged
            for r in seeds[i]]
    want = np.asarray(host, np.int64).reshape(-1, 3)
    np.testing.assert_array_equal(which_row.numpy(), want[:, 0])
    np.testing.assert_array_equal(x0_row.numpy(), want[:, 1])
    kmax = kmax_row.numpy()
    np.testing.assert_array_equal(kmax, want[:, 2])
    np.testing.assert_array_equal(off_row.numpy(), np.cumsum(kmax) - kmax)
    assert total == int(kmax.sum()) == rep["sa_jobs"] + \
        rep["sa_overflow_jobs"] > 0
    n_dev_rows = sum(len(seeds[i]) for i in range(len(lanes))
                     if not overflow[i])
    assert n_dev_rows == rep["sa_rows"] <= kmax.size
    assert bool(overflow.any()) == (kind == "se_overflow") == \
        (kmax.size > n_dev_rows) == (rep["sa_overflow_jobs"] > 0)
