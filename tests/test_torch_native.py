"""The port's native (C++) align engine against the JAX package's and the
port's host engine.

biscuit_tpu_torch/native/align_host.cpp is a copy of the JAX package's
source (tests/test_torch_engine.py holds it line for line), built by the
port's own loader into the port's own library, and align/native_engine.py a
copy of the JAX package's module. On the same reads and one index (the JAX
package's, and the port's over the same arrays), the port's
`process_seqs_native` must give the SAM of the JAX package's, and of the
port's host engine, byte for byte: SE, PE with -b 0 and -b 1, reads whose
best region scores below T (the weak-region data of
test_torch_engine.test_weak_regions_stay_out_of_sa_tags), two threads, and
the region-marshalling path with its fork pool (-V, -@ 2, 256 reads). Then
the ABI guard and the AVX-512 kernels' own tests (models:
tests/test_native_abi.py, tests/test_native_engine.py), on the port's
library.
"""
import ctypes as Ct
import glob
import re

import numpy as np
import pytest
import torch

from biscuit_tpu.align.native_engine import \
    process_seqs_native as jax_native
from biscuit_tpu.align.pipeline import AlignerState as JaxState
from biscuit_tpu.index.build import build_index as jax_build_index
from biscuit_tpu_torch import native
from biscuit_tpu_torch.align.native_engine import (NativeAligner,
                                                   process_seqs_native)
from biscuit_tpu_torch.align.pipeline import AlignerState, process_seqs

from torch_testdata import (REPO, damage_mates, jax_opt, load_pairs,
                            load_reads, make_dataset, port_index, port_opt,
                            trim_fastq)

torch.set_num_threads(1)

N_READS, N_PAIRS = 96, 48


def _both(fa):
    """(the JAX package's state, the port's) over one index."""
    jidx = jax_build_index(fa, prefix=fa)
    return JaxState(jidx), AlignerState(port_index(jidx))


@pytest.fixture(scope="module")
def se(tmp_path_factory):
    """60 kbp, 96 SE reads of 100 bp with SNPs and an indel in two of
    every four."""
    d = tmp_path_factory.mktemp("tnat")
    fa, fq, _ = make_dataset(d, genome_size=60000, n_reads=N_READS, seed=11,
                             snp_rate=0.01, indel_every=4, index=False)
    return fq, _both(fa)


@pytest.fixture(scope="module")
def pe(tmp_path_factory):
    """48 pairs of 100 bp; every third mate 2 damaged so that only mate
    rescue places it."""
    d = tmp_path_factory.mktemp("tnatpe")
    fa, fqs, _ = make_dataset(d, genome_size=60000, n_reads=N_PAIRS, seed=23,
                              snp_rate=0.02, pe=True, index=False)
    damage_mates(fqs[1], 3)
    return fqs, _both(fa)


def _flag(sam):
    return int(sam.split("\t")[1])


def _sams(run, st, seqs, opt, **kw):
    run(opt, st, seqs, 0, **kw)
    return [s.sam for s in seqs]


def _three_ways(states, load, flag=0, **fields):
    """SAM of the port's native engine, the JAX package's and the port's
    host engine on fresh copies of the same reads."""
    jst, tst = states
    port = _sams(process_seqs_native, tst, load(False), port_opt(flag, **fields))
    theirs = _sams(jax_native, jst, load(True), jax_opt(flag, **fields))
    host = _sams(process_seqs, tst, load(False), port_opt(flag, **fields))
    return port, theirs, host


def test_se_native_matches_jax_native_and_host(se):
    from biscuit_tpu_torch.config import MEM_F_NO_MULTI
    fq, states = se
    port, theirs, host = _three_ways(
        states, lambda j: load_reads(fq, N_READS, jax_pkg=j), MEM_F_NO_MULTI)
    assert port == theirs == host
    assert sum(not _flag(s) & 4 for s in port) > N_READS // 2


@pytest.mark.parametrize("bmode", [0, 1])
def test_pe_native_matches_jax_native_and_host(pe, bmode):
    from biscuit_tpu_torch.config import MEM_F_NO_MULTI, MEM_F_PE
    fqs, states = pe
    port, theirs, host = _three_ways(
        states, lambda j: load_pairs(*fqs, jax_pkg=j),
        MEM_F_NO_MULTI | MEM_F_PE, parent=bmode)
    assert port == theirs == host
    assert len(port) == 2 * N_PAIRS


@pytest.mark.parametrize("layout", ["se", "pe"])
def test_native_weak_regions_match_jax_native_and_host(tmp_path, layout):
    """640 bp reads (PE: mates 1 of 640 bp beside mates 2 of 150), every
    third damaged at every 9th base, T = 20: reads whose best region scores
    below T, on which the JAX device engine lists in SA:Z what the host
    engine never formats. The native engines' SAM, SA:Z tags included, is
    the host engine's."""
    from biscuit_tpu_torch.config import MEM_F_NO_MULTI, MEM_F_PE
    is_pe = layout == "pe"
    fa, fq, _ = make_dataset(tmp_path, genome_size=200_000, n_reads=24,
                             seed=7, read_len=640, snp_rate=0.001, pe=is_pe,
                             index=False)
    if is_pe:
        trim_fastq(fq[1], 150)
    damage_mates(fq[0] if is_pe else fq, 3)
    load = ((lambda j: load_pairs(*fq, jax_pkg=j)) if is_pe
            else (lambda j: load_reads(fq, 24, jax_pkg=j)))
    port, theirs, host = _three_ways(
        _both(fa), load, MEM_F_NO_MULTI | (MEM_F_PE if is_pe else 0), T=20)
    assert port == theirs == host
    assert sum(not _flag(s) & 4 for s in port) > len(port) // 2


def test_native_two_threads_give_one_threads_sam(se):
    fq, (_jst, tst) = se
    nat = NativeAligner(tst)
    one = _sams(process_seqs_native, tst, load_reads(fq, N_READS),
                port_opt(n_threads=1), engine=nat)
    two = _sams(process_seqs_native, tst, load_reads(fq, N_READS),
                port_opt(n_threads=2), engine=nat)
    assert one == two


def test_region_path_with_its_fork_pool_matches_host(tmp_path, monkeypatch):
    """-V (MEM_F_REF_HDR) takes the native engine's region-marshalling
    path: C++ worker1, then build_regs and worker2 in a fork pool when -@ >
    1 and the batch holds 256 reads or more. Its SAM is the host
    engine's."""
    import multiprocessing
    from biscuit_tpu_torch.config import MEM_F_NO_MULTI, MEM_F_REF_HDR
    fa, fq, idx = make_dataset(tmp_path, genome_size=40000, n_reads=256,
                               seed=5, snp_rate=0.01)
    st = AlignerState(idx)
    pools = []
    real_context = multiprocessing.get_context

    def context(method=None):
        pools.append(method)
        return real_context(method)
    monkeypatch.setattr(multiprocessing, "get_context", context)
    got = _sams(process_seqs_native, st, load_reads(fq, 256),
                port_opt(MEM_F_NO_MULTI | MEM_F_REF_HDR, n_threads=2))
    assert pools == ["fork"]
    want = _sams(process_seqs, st, load_reads(fq, 256),
                 port_opt(MEM_F_NO_MULTI | MEM_F_REF_HDR))
    assert got == want
    assert sum(not _flag(s) & 4 for s in got) > 200


# ---------------------------------------------------------------------------
# the ABI guard and the C++ kernels' own tests, on the port's library
# ---------------------------------------------------------------------------

def _exported_names():
    """Function names defined inside extern "C" blocks of the port's
    native/*.cpp (the parser of tests/test_native_abi.py)."""
    names = set()
    for path in glob.glob(f"{REPO}/biscuit_tpu_torch/native/*.cpp"):
        src = open(path).read()
        for m in re.finditer(r'extern\s+"C"\s*\{', src):
            depth, i = 1, m.end()
            while i < len(src) and depth:
                if src[i] == "{":
                    depth += 1
                elif src[i] == "}":
                    depth -= 1
                i += 1
            region = src[m.end():i]
            for fm in re.finditer(
                    r"^[A-Za-z_][\w:<>,\s*&]*?\b(\w+)\s*\([^;{]*\)\s*\{",
                    region, re.M):
                names.add(fm.group(1))
        for fm in re.finditer(
                r'extern\s+"C"\s+[\w:<>,\s*&]*?\b(\w+)\s*\([^;{]*\)\s*\{',
                src):
            names.add(fm.group(1))
    return names


def test_every_export_has_argtypes():
    L = native.lib()
    exported = _exported_names()
    assert {"bt_align_se_batch", "bt_align_pe_batch", "bt_worker1_batch",
            "sais_u8_i32", "bwt_merge_build"} <= exported
    missing = [name for name in sorted(exported)
               if getattr(L, name, None) is not None
               and getattr(L, name).argtypes is None]
    assert not missing, f"exports without argtypes in native._declare: {missing}"


def test_the_library_releases_the_gil():
    """The hybrid engine's injector thread runs while bt_align_se_batch
    runs: ctypes releases the GIL around a call of a CDLL's function, and
    holds it only for a PyDLL's (FUNCFLAG_PYTHONAPI)."""
    L = native.lib()
    assert not isinstance(L, Ct.PyDLL)
    assert not L._func_flags_ & Ct._FUNCFLAG_PYTHONAPI


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """An 8 kbp genome: every rank of both strands, exhaustively."""
    d = tmp_path_factory.mktemp("tnatsmall")
    _fa, _fq, idx = make_dataset(d, genome_size=8000, n_reads=4, seed=3)
    return NativeAligner(AlignerState(idx))


def test_avx512_occ_vector_exhaustive(small):
    """The AVX-512 batched single-class occ kernel (occ_cg_one_x8) and its
    variable-class twin are bit-exact with the scalar occ_cg_one over every
    rank in [0, seq_len] and every class, on both strands. Skips where the
    CPU lacks AVX-512 VPOPCNTDQ (the build falls back to the scalar path)."""
    nat = small
    L = nat.lib
    i64p = Ct.POINTER(Ct.c_int64)
    es, gs = Ct.c_int64(), Ct.c_int64()
    rng = np.random.default_rng(7)
    checked = 0
    for fmc in (nat.dau, nat.par):
        n = int(fmc.seq_len)
        ranks = np.arange(0, n + 1, dtype=np.int64)
        ranks = np.concatenate([ranks, np.zeros((-len(ranks)) % 8, np.int64)])
        e8, g8 = np.zeros(8, np.int64), np.zeros(8, np.int64)
        for c in range(4):
            for j in range(0, len(ranks), 8):
                if not L.bt_occ_cg_x8(Ct.byref(fmc), ranks[j:j + 8].ctypes
                                      .data_as(i64p), c, e8.ctypes.data_as(i64p),
                                      g8.ctypes.data_as(i64p)):
                    pytest.skip("AVX-512 VPOPCNTDQ not available")
                for t in range(min(8, n + 1 - j)):
                    assert L.bt_occ_cg_scalar(Ct.byref(fmc), int(ranks[j + t]),
                                              c, Ct.byref(es), Ct.byref(gs))
                    assert (es.value, gs.value) == (e8[t], g8[t]), \
                        f"rank {ranks[j + t]} class {c}"
                    checked += 1
        cs = rng.integers(0, 4, len(ranks)).astype(np.int64)
        for j in range(0, len(ranks), 8):
            assert L.bt_occ_cg_x8v(Ct.byref(fmc),
                                   ranks[j:j + 8].ctypes.data_as(i64p),
                                   cs[j:j + 8].ctypes.data_as(i64p),
                                   e8.ctypes.data_as(i64p),
                                   g8.ctypes.data_as(i64p))
            for t in range(min(8, n + 1 - j)):
                assert L.bt_occ_cg_scalar(Ct.byref(fmc), int(ranks[j + t]),
                                          int(cs[j + t]), Ct.byref(es),
                                          Ct.byref(gs))
                assert (es.value, gs.value) == (e8[t], g8[t]), \
                    f"x8v rank {ranks[j + t]} class {cs[j + t]}"
                checked += 1
    assert checked > 8 * 8000


def test_sw_extend_vector_row_fuzz():
    """The AVX-512 sw_extend row kernel is bit-exact with the scalar row
    and with the port's ops/sw.sw_extend over random inputs under four
    scoring regimes, the cheap-gap preset (O = E = 1, where F runs over
    more than 16 columns) included."""
    from biscuit_tpu_torch.ops.sw import sw_extend as py_sw_extend
    L = native.lib()
    u8p, i8p = Ct.POINTER(Ct.c_uint8), Ct.POINTER(Ct.c_int8)
    i32p = Ct.POINTER(Ct.c_int32)

    def mk_mat(a, b):
        m = np.full((5, 5), -b, np.int8)
        for i in range(4):
            m[i, i] = a
        m[4, :] = -1
        m[:, 4] = -1
        return m

    # (mat, o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop)
    regimes = [(mk_mat(1, 2), 6, 1, 6, 1, 100, 5, 100),
               (mk_mat(1, 1), 1, 1, 1, 1, 100, 0, 200),
               (mk_mat(1, 4), 2, 1, 2, 1, 100, 50, 200),
               (mk_mat(2, 3), 5, 2, 3, 1, 25, 10, 50)]
    rng = np.random.default_rng(11)
    checked = 0
    for mat, o_del, e_del, o_ins, e_ins, w, eb, zdrop in regimes:
        for trial in range(40):
            qlen, tlen = int(rng.integers(24, 220)), int(rng.integers(8, 300))
            base = rng.integers(0, 4, max(qlen, tlen)).astype(np.uint8)
            q, t = base[:qlen].copy(), base[:tlen].copy()
            nmut = int(rng.integers(0, 1 + tlen // 4))
            t[rng.integers(0, tlen, nmut)] = rng.integers(0, 4, nmut)
            h0 = int(rng.integers(1, 80))
            out_s, out_v = np.zeros(6, np.int32), np.zeros(6, np.int32)
            args = (q.ctypes.data_as(u8p), qlen, t.ctypes.data_as(u8p), tlen,
                    mat.ctypes.data_as(i8p), o_del, e_del, o_ins, e_ins,
                    w, eb, zdrop, h0)
            L.bt_sw_extend(*args, 0, out_s.ctypes.data_as(i32p))
            if not L.bt_sw_extend(*args, 1, out_v.ctypes.data_as(i32p)):
                pytest.skip("AVX-512 sw row kernel not in this build")
            assert (out_s == out_v).all(), (o_ins, e_ins, qlen, tlen, trial)
            py = py_sw_extend(q, t, mat.astype(np.int64), o_del, e_del,
                              o_ins, e_ins, w, eb, zdrop, h0)
            assert tuple(int(x) for x in out_s) == tuple(int(x) for x in py)
            checked += 1
    assert checked == 160
