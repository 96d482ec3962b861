"""Torch chain scan (K6) and mem_chain_batch vs the JAX package and host.

chain_scan_batch_plain (the CPU twin of kernels/chain_scan.cu) must give
the JAX chain_scan_batch's action log and overflow flags on occurrence
streams built from real lanes, with NC=64 and with NC=2 (overflow), in
int32 and int64 ranks; the port's mem_chain_batch must return the JAX
mem_chain_batch's lanes (the same None lanes) and the host mem_chain's
chains. Exact equality throughout.
"""
import numpy as np
import pytest
import torch

from biscuit_tpu.align.chain import mem_chain_batch as jax_mem_chain_batch
from biscuit_tpu.config import MemOpt as JaxMemOpt
from biscuit_tpu_torch.align import bns as bnsmod
from biscuit_tpu_torch.config import MemOpt
from biscuit_tpu.ops.chain_batch import chain_scan_batch as jax_scan
from biscuit_tpu_torch.align import pipeline as tpipe
from biscuit_tpu_torch.align.chain import (CHAIN_JMAX, CHAIN_KMAX, getbss,
                                           mem_chain, mem_chain_batch)
from biscuit_tpu_torch.align.device_engine import DeviceAligner
from biscuit_tpu_torch.ops import chain_batch as tcb

from torch_testdata import (chain_edge_lanes, chain_planes, jax_index,
                            load_reads, make_dataset)

# the plain versions are loops of small ops: under pytest-xdist, intra-op
# threads of several workers only contend for the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """Seeds and SA lookups of 60 reads converted both ways, through the
    port's engine on the CPU; every third read mutated so that chains
    fragment (appends and inserts beyond a single chain), and some made
    chimeras of thirds of three reads (three chains on a lane)."""
    _fa, fq, idx = make_dataset(tmp_path_factory.mktemp("tchain"),
                                genome_size=60000, n_reads=60, seed=13,
                                snp_rate=0.01)
    st = tpipe.AlignerState(idx)
    seqs = load_reads(fq, 60)
    for i in range(0, len(seqs), 3):
        mut = seqs[i].seq.copy()
        mut[::23] = (mut[::23] + 2) % 4
        if i % 6 == 3 and i + 8 < len(seqs):
            n = len(mut) // 3
            mut = np.concatenate([seqs[i + 2].seq[:n], seqs[i + 5].seq[n:2 * n],
                                  seqs[i + 8].seq[2 * n:]])
        seqs[i].seq = mut
        seqs[i].seq0 = mut
    plan = [(s, p) for s in seqs for p in (0, 1)]
    opt = MemOpt()
    seeds, lookups = DeviceAligner(st, "cpu")._collect_seeds(opt, plan)
    jobs = [(s.l_seq, p, seeds[li], lookups[li])
            for li, (s, p) in enumerate(plan)]
    return st, plan, jobs


def _stream(opt, idx, jobs):
    """The occurrence records mem_chain_batch builds, for every lane."""
    recs_all = []
    for l_seq, parent, mem, lk in jobs:
        recs = []
        for seed_i, (sb, se, x0, _x1, size) in enumerate(mem):
            for k in range(min(int(size), CHAIN_KMAX)):
                rb = lk(seed_i, k, x0)
                rid = bnsmod.intv2rid(idx, rb, rb + se - sb)
                vd = rid >= 0 and not ((opt.bsstrand & 1) and getbss(
                    parent, idx, rb) != opt.bsstrand >> 1)
                recs.append((sb, se - sb, rb, int(vd), max(rid, 0), k))
        recs_all.append(recs[:CHAIN_JMAX])
    return recs_all


def _scan_both(planes, n_occ, args, NC, shift=0):
    """The plain scan on the planes, and the JAX scan on them in int32 with
    every reference position and l_pac less `shift` (the scan compares
    positions with each other and with l_pac only, so a shift changes
    nothing): both (log, ov) as numpy, and the plain result as tensors."""
    import jax.numpy as jnp
    jp = [jnp.asarray((p - shift if c == 2 else p).astype(np.int32))
          for c, p in enumerate(planes)]
    jlog, jov = jax_scan(*jp, jnp.asarray(n_occ), np.int32(args[0] - shift),
                         *args[1:], NC=NC)
    T = [torch.from_numpy(p) for p in planes] + [torch.from_numpy(n_occ)]
    log, ov = tcb.chain_scan_batch_plain(*T, *args, NC=NC)
    np.testing.assert_array_equal(log.numpy(), np.asarray(jlog))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    # on CPU tensors the public op is the plain machine
    log2, ov2 = tcb.chain_scan_batch(*T, *args, NC=NC)
    assert torch.equal(log2, log) and torch.equal(ov2, ov)
    return log, ov


def _check_edge_lanes(log, ov, NC, first):
    """The edge lanes (chain_edge_lanes) from column `first` on: under
    NC = 64 the long lane acts to its last occurrences; the lane of exactly
    NC chains makes them all, the next one flags, the pacrej lane founds a
    second chain where it crosses l_pac and appends to it."""
    kinds = log.numpy() & 3
    if NC == 64:
        assert not ov[first] and kinds[CHAIN_JMAX - 8:, first].any()
        assert (kinds[:, first] == tcb.K_EXTRA).any()
    assert (kinds[:, first + 1] == tcb.K_NEW).sum() == NC
    assert not ov[first + 1] and ov[first + 2]
    assert kinds[:3, first + 3].tolist() == [tcb.K_NEW, tcb.K_NEW,
                                             tcb.K_APPEND]


@pytest.mark.parametrize("NC", [64, 2])
@pytest.mark.parametrize("rdt", [np.int32, np.int64])
def test_chain_scan_plain_matches_jax(lanes, NC, rdt):
    """The streams of real lanes, beside lanes at the scan's edges
    (chain_edge_lanes: CHAIN_JMAX occurrences, exactly NC chains and one
    more, a seed that crosses l_pac). int64 ranks are held to the JAX scan
    in int32 on the same values (the JAX scan raises a TypeError under x64:
    its log row turns int64), and the edge lanes once more around an
    l_pac >= 2^31, shifted down by 2^31 for the JAX scan."""
    st, _plan, jobs = lanes
    opt = MemOpt()
    args = (int(st.idx.l_pac), int(opt.w), int(opt.max_chain_gap),
            int(opt.max_occ))
    path = _stream(opt, st.idx, jobs)
    edge = chain_edge_lanes(NC, args[0])
    assert max(len(r) for r in path) < len(edge[0]) == CHAIN_JMAX
    planes, n_occ = chain_planes(path + edge, rdt)
    log, ov = _scan_both(planes, n_occ, args, NC)
    B = len(path)
    kinds = np.bincount((log.numpy()[:, :B] & 3).ravel(), minlength=4)
    assert kinds[tcb.K_NEW] > 0 and kinds[tcb.K_APPEND] > 0
    if NC == 2:
        assert ov[:B].any() and not ov[:B].all()
    else:
        assert not ov[:B].any() and kinds[tcb.K_EXTRA] > 0
    _check_edge_lanes(log, ov, NC, B)
    if rdt == np.int64:
        big = (1 << 31) + 12345
        planes, n_occ = chain_planes(chain_edge_lanes(NC, big, seed=1), rdt)
        assert planes[2].min() < big <= planes[2].max()
        log, ov = _scan_both(planes, n_occ, (big, *args[1:]), NC,
                             shift=1 << 31)
        _check_edge_lanes(log, ov, NC, 0)


def _synthetic_jobs(idx):
    """Lanes past each cap: a seed of more than KMAX occurrences, more than
    JMAX occurrences in all, more than NC chains; and a read shorter than
    min_seed_len (no chains)."""
    spread = lambda si, k, x0: 500 + 911 * (2 * k + si)  # noqa: E731
    many = [(0, 25, 1, 1, 60), (30, 55, 1, 1, 60)]
    return [(100, 0, [(0, 20, 1, 1, CHAIN_KMAX + 6)], spread),
            (100, 1, [(s, s + 20, 1, 1, 60) for s in range(0, 80, 4)], spread),
            (100, 0, many, spread),
            (12, 1, [], spread)]


def test_mem_chain_batch_matches_jax_and_host(lanes):
    st, plan, jobs = lanes
    opt = MemOpt()
    jobs = jobs + _synthetic_jobs(st.idx)
    got = mem_chain_batch(opt, st.idx, jobs, "cpu")
    want = jax_mem_chain_batch(JaxMemOpt(), jax_index(st.idx), jobs)
    assert [g is None for g in got] == [w is None for w in want]
    assert [g is None for g in got[-4:]] == [True, True, True, False]
    assert got[-1] == []
    n_dev = 0
    for li, (l_seq, p, mem, lk) in enumerate(jobs[:len(plan)]):
        if got[li] is None:
            continue
        n_dev += 1
        s = plan[li][0]
        fm, fmc = st.fm_pair(p)
        host = mem_chain(opt, fm, fmc, st.idx, l_seq, tpipe.bsconvert(s, p),
                         p, seeds_intv=mem, sa_lookup=lk)
        for chains in (host, want[li]):
            assert len(got[li]) == len(chains)
            for cg, cw in zip(got[li], chains):
                assert (cg.pos, cg.rid, cg.is_alt, cg.frac_rep) == \
                    (cw.pos, cw.rid, cw.is_alt, cw.frac_rep)
                assert [vars(x) for x in cg.seeds] == [vars(x) for x in cw.seeds]
                assert [vars(x) for x in cg.seeds_extra] == \
                    [vars(x) for x in cw.seeds_extra]
    assert n_dev >= 0.9 * len(plan)
    assert sum(len(c.seeds) > 1 for g in got[:len(plan)] if g for c in g) > 0


def test_kernel_constants_match_the_sources():
    """The constants the wrappers and chip_smoke.py read are the CUDA
    sources' own: K6's chain slots and staging chunk, K9's fused chunk."""
    import re
    from biscuit_tpu_torch.ops import pileup_count
    from torch_testdata import REPO

    def const(name, src):
        with open(f"{REPO}/biscuit_tpu_torch/kernels/{src}") as f:
            m = re.search(rf"\b{name} = (\d+)", f.read())
        return int(m.group(1))
    assert const("NC_MAX", "chain_scan.cu") == tcb.NC_MAX == 64
    assert const("JC", "chain_scan.cu") == tcb.JC
    assert const("FUSED_CHUNK", "pileup_count.cu") == pileup_count.FUSED_CHUNK
    assert const("FUSED_W", "pileup_count.cu") == pileup_count.N_WORDS
