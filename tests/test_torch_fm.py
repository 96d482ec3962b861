"""Torch FM tables and the plain SA walk vs the JAX package.

FMPair.from_index must carry the JAX FMPair's arrays across unchanged, on
narrow (int32 rank) and wide (int64 rank, BISCUIT_TPU_WIDE_INDEX=1)
indexes, and sa_batch_plain (the CPU twin of the K4 CUDA kernel) must give
the positions of the JAX sa_batch and of the scalar FMNumpy.sa_s walk.
Exact equality throughout.
"""
import numpy as np
import pytest
import torch

from biscuit_tpu_torch.index.build import build_index
from biscuit_tpu.ops import seed_batch as jsb
from biscuit_tpu.ops.fm import FMNumpy as JaxFMNumpy
from biscuit_tpu_torch import kernels
from biscuit_tpu_torch.ops import seed_batch as tsb
from biscuit_tpu_torch.ops.fm import FMNumpy

from torch_testdata import jax_index, make_dataset

# the plain versions are loops of small ops: under pytest-xdist, intra-op
# threads of several workers only contend for the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    fa, _fq, narrow = make_dataset(tmp_path_factory.mktemp("tfm"),
                                   genome_size=60000, n_reads=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BISCUIT_TPU_WIDE_INDEX", "1")
        wide = build_index(fa)
    assert wide.dau.sa_samples.dtype.itemsize == 8
    return {"narrow": narrow, "wide": wide}


def _jax_arrays(jfm):
    return (np.asarray(jfm.tab), np.asarray(jfm.L2), np.asarray(jfm.primary),
            int(jfm.seq_len), np.asarray(jfm.sa_samples))


@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_fmpair_from_index_matches_jax(indexes, layout):
    idx = indexes[layout]
    jfm = jsb.FMPair.from_index(jax_index(idx))
    tfm = tsb.FMPair.from_index(idx, "cpu")
    tab, L2, prim, seq_len, sa = _jax_arrays(jfm)
    assert tfm.wide == jfm.wide == (layout == "wide")
    assert tfm.sa_intv == jfm.sa_intv and tfm.seq_len == seq_len
    np.testing.assert_array_equal(tfm.tab.numpy().view(np.uint32), tab)
    np.testing.assert_array_equal(tfm.L2.numpy(), L2)
    np.testing.assert_array_equal(tfm.primary.numpy(), prim)
    assert tfm.sa_samples.dtype == (torch.int64 if jfm.wide else torch.int32)
    np.testing.assert_array_equal(tfm.sa_samples.numpy(), sa)
    # the same arrays handed over as numpy build the same tables
    again = tsb.FMPair.from_numpy(tab, L2, prim, seq_len, sa, jfm.wide,
                                  jfm.sa_intv, "cpu")
    for a, b in [(again.tab, tfm.tab), (again.L2, tfm.L2),
                 (again.primary, tfm.primary),
                 (again.sa_samples, tfm.sa_samples)]:
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_sa_batch_plain_matches_jax(indexes, layout):
    idx = indexes[layout]
    jfm = jsb.FMPair.from_index(jax_index(idx))
    tfm = tsb.FMPair.from_index(idx, "cpu")
    n = int(idx.dau.seq_len)
    rng = np.random.default_rng(5 if layout == "narrow" else 6)
    ranks = rng.integers(0, n + 1, 2048)
    ranks[:4] = [0, 1, n, int(idx.dau.primary)]
    ranks[4:6] = int(idx.par.primary)
    which = rng.integers(0, 2, ranks.size).astype(np.int32)
    rdt = np.int64 if jfm.wide else np.int32
    want = jsb.sa_batch_np(jfm, which, ranks.astype(rdt))
    k = torch.from_numpy(ranks.astype(rdt))
    w = torch.from_numpy(which)
    got = tsb.sa_batch_plain(tfm, w, k)
    assert got.dtype == tfm.rdt
    np.testing.assert_array_equal(got.numpy(), want)
    # on a CPU tensor the public op is the plain walk
    np.testing.assert_array_equal(tsb.sa_batch(tfm, w, k).numpy(), want)
    # and both agree with the scalar walk of the copied and the JAX FMNumpy
    fms = {1: FMNumpy(idx.par), 0: FMNumpy(idx.dau)}
    jfms = {1: JaxFMNumpy(idx.par), 0: JaxFMNumpy(idx.dau)}
    for wh, r, g in list(zip(which, ranks, got.tolist()))[:300]:
        assert g == fms[int(wh)].sa_s(int(r)) == jfms[int(wh)].sa_s(int(r))


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    x[:3] = [0, 0xFFFFFFFF, 0x80000001]
    want = tsb._popcount32_np(x.astype(np.uint32))
    got = tsb._popcount32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_route_only_cpu_and_cuda():
    """An op picks its path from the device of its input alone: the CPU
    runs the plain version, CUDA the kernel, anything else raises."""
    assert kernels.route(torch.zeros(1)) == "plain"
    with pytest.raises(ValueError):
        kernels.route(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        kernels.check_cuda(torch.zeros(1))


def test_check_lanes_rejects_wrong_shapes():
    """A kernel reads n entries of each per-lane vector: a wrapper refuses
    a vector of another length or rank before it launches."""
    kernels.check_lanes(3, torch.zeros(3), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.check_lanes(3, torch.zeros(3), torch.zeros(2))
    with pytest.raises(ValueError):
        kernels.check_lanes(4, torch.zeros(2, 2))
