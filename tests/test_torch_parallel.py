"""K10, multi-device execution over torch.distributed, and the port's driver
entry (biscuit_tpu_torch/parallel/, biscuit_tpu_torch/graft_entry.py) vs
the JAX package, on the CPU.

`dryrun_multichip(n, device="cpu")` spawns n gloo ranks (one group a world
size) and holds each of its eight stages, in every rank, to its one-rank
run; here it runs at 2 and 4 ranks. Each stage's one-rank output (the
port's sharded function on a mesh of one rank, the plain versions of the
kernels) must equal the JAX function's on the same numpy inputs
(graft_entry.stage_inputs): K1 against ops/sw_batch.sw_extend_batch, K9's
general entry against parallel/mesh.pileup_count_window, K6 against
chain_scan_batch, K7 against sw_local_kernel, K3 against
collect_intv_flat_sm in log mode and the log machine _collect_sm_log on
each shard of the pool, and the index-sharded stage's seeds and SA
positions against the replicated _collect_sm_log and sa_batch_np. The
local half of the routed gather (route_gather, the step kernels' gather on
the card), summed over the shards of fm_shard_arrays (equal to the JAX
package's), must give the replicated tables' rows. entry() must equal
collect_intv_flat_sm on its reads. TorchProcessAllgather over 3
ranks with lists of unequal length must give their rank-ordered
concatenation, and from_env must read both of its forms. Exact equality
throughout: every value is an integer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biscuit_tpu.config import MemOpt as JaxMemOpt
from biscuit_tpu.ops import seed_batch as jsb
from biscuit_tpu.ops.chain_batch import chain_scan_batch as jax_chain
from biscuit_tpu.ops.sw_batch import sw_extend_batch as jax_extend
from biscuit_tpu.ops.sw_local import sw_local_kernel
from biscuit_tpu.parallel.mesh import pileup_count_window as jax_count
from biscuit_tpu_torch import graft_entry
from biscuit_tpu_torch.config import MemOpt
from biscuit_tpu_torch.ops.seed_batch import FMPair
from biscuit_tpu_torch.parallel import exchange, mesh as tmesh

from torch_testdata import jax_index

torch.set_num_threads(1)

N_RANKS = 4  # the stage inputs of a dry run over 4 ranks
# the log machine's settings in the source's dry run: lanes, C, T2,
# LOG_LEN, W
LOG_ARGS = (8, 32, 16, 4096, 32)


@pytest.fixture(scope="module")
def tiny():
    """The dry run's tiny index, its FMPair on each side and the stage
    inputs at N_RANKS ranks."""
    idx = graft_entry._tiny_index()
    return {"idx": idx, "fm": FMPair.from_index(idx, "cpu"),
            "jfm": jsb.FMPair.from_index(jax_index(idx)),
            "inp": graft_entry.stage_inputs(idx, N_RANKS)}


def _sargs():
    o = JaxMemOpt()
    return (int(o.min_seed_len), int(o.max_mem_intv),
            int(o.min_seed_len * o.split_factor + 0.499), int(o.split_width))


T = torch.from_numpy


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_equals_one_rank(n):
    """Every stage, in every rank, equals its one-rank run (an exception
    otherwise); the ranks share the CPU under gloo, import neither jax nor
    the JAX package, and the closing line is the source's."""
    out = graft_entry.dryrun_multichip(n, device="cpu")
    assert out["backend"] == "gloo" and out["nccl"] is False
    assert out["device"] == "cpu"
    assert out["line"].startswith(f"dryrun_multichip n={n}: seeds max_end=")
    n_dp = 2 if n >= 4 else 1
    assert f"pileup counts merged={8 * n * graft_entry.L_POOL}," in out["line"]
    assert out["line"].endswith(f"sharded-index mesh=({n_dp},{n // n_dp})"
                                " (all sharded == single-device)")
    assert len(out["seconds"]) == 9
    assert out["launches"] == {}  # the CPU runs the plain versions


def test_entry_equals_collect_intv_flat_sm(tiny):
    step, args = graft_entry.entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args[1:])
    lane_of, rows, ov = step(*args)
    q, lens, par = (a.numpy() for a in args[1:])
    assert q.shape == (64, graft_entry.L_SEED)
    jl, jr, jov = jsb.collect_intv_flat_sm(tiny["jfm"], q, lens, par,
                                           JaxMemOpt())
    assert not ov.any() and not jov.any() and len(jl) > 64
    np.testing.assert_array_equal(lane_of.numpy(), jl)
    np.testing.assert_array_equal(rows.numpy(), jr)


def test_entry_runs_on_the_card_unless_told(monkeypatch):
    """With no card, entry() and dryrun_multichip() raise rather than fall
    back to the CPU."""
    monkeypatch.delenv("BISCUIT_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(2)


def test_stage_1_seeds_equal_collect_intv_flat_sm(tiny):
    q, lens, par = tiny["inp"]["seed"]
    one = tmesh.make_mesh(1)
    lane_of, rows, ov = tmesh.sharded_seed_fn(
        one, tiny["fm"], graft_entry.L_POOL, 19, 20)(T(q), T(lens), T(par))
    jl, jr, jov = jsb.collect_intv_flat_sm(tiny["jfm"], q, lens, par,
                                           JaxMemOpt())
    assert not ov.any() and not jov.any()
    np.testing.assert_array_equal(lane_of.numpy(), jl)
    np.testing.assert_array_equal(rows.numpy(), jr)


def test_stage_2_extension_equals_jax(tiny):
    opt = JaxMemOpt()
    mats = np.stack([opt.gamat, opt.ctmat]).astype(np.int32)
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    ext = tiny["inp"]["extend"]
    got = tmesh.sharded_extend_fn(tmesh.make_mesh(1), T(mats), *sc,
                                  opt.zdrop)(*(T(a) for a in ext))
    q, ql, t, tl, msel, w, eb, h0 = (jnp.asarray(a) for a in ext)
    want = jax_extend(q, ql, t, tl, jnp.asarray(mats), msel, *sc, w, eb,
                      opt.zdrop, h0)
    assert got.shape == (6, q.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stage_3_counts_equal_jax(tiny):
    pos, code, valid, W = tiny["inp"]["pileup"]
    assert code.max() < 32
    got = tmesh.sharded_pileup_counts_fn(tmesh.make_mesh(1), W)(
        T(pos), T(code), T(valid))
    want = jax_count(jnp.asarray(pos), jnp.asarray(code), jnp.asarray(valid),
                     W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == len(pos)


def test_stages_4_5_pool_seeds_equal_the_log_machine(tiny):
    """The one-rank pool seeds (the rows of each read in order, their
    count), and those of each shard's slice of the pool, equal the source's
    log machine _collect_sm_log on it."""
    pool = tiny["inp"]["pool"]
    fn = tmesh.sharded_log_seed_fn(tmesh.make_mesh(1), tiny["fm"], MemOpt())
    rows, rid, n_rows, ov = fn(T(pool))
    assert n_rows.tolist() == [rows.shape[0]] and not ov.any()
    N_l = pool.shape[0] // N_RANKS
    got = {}
    for s in range(N_RANKS):
        sl = pool[s * N_l:(s + 1) * N_l]
        pr, rr, tr, _ovr, spill, nc, _unf = jsb._collect_sm_log(
            tiny["jfm"], jnp.asarray(sl), *_sargs(), *LOG_ARGS)
        t = int(tr)
        assert not bool(spill) and int(nc) >= N_l and t > 0
        sp, srid, sn, sov = fn(T(sl))
        assert not sov.any() and sn.tolist() == [t] == [sp.shape[0]]
        np.testing.assert_array_equal(srid.numpy(), np.asarray(rr)[:t])
        np.testing.assert_array_equal(sp.numpy(), np.asarray(pr)[:t])
        got.update(graft_entry._per_read(sp, srid, s * N_l))
    # the whole pool's per-read sets are the shards' with their offsets
    one = graft_entry._per_read(rows, rid, 0)
    assert got == one and len(one) == pool.shape[0]


def test_stage_6_chain_equals_jax(tiny):
    planes, l_pac, w, gap, max_occ, NC = tiny["inp"]["chain"]
    log, ov = tmesh.sharded_chain_fn(tmesh.make_mesh(1), w, gap, max_occ,
                                     NC=NC)(*(T(a) for a in planes), l_pac)
    jlog, jov = jax_chain(*(jnp.asarray(a) for a in planes), jnp.int32(l_pac),
                          w, gap, max_occ, NC=NC)
    np.testing.assert_array_equal(log.numpy(), np.asarray(jlog))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))


def test_stage_7_rescue_equals_jax(tiny):
    opt = JaxMemOpt()
    sc = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    ra = tiny["inp"]["rescue"]
    got = tmesh.sharded_rescue_fn(tmesh.make_mesh(1), *sc)(
        *(T(a) for a in ra))
    j = [jnp.asarray(a) for a in ra]
    want = sw_local_kernel(*j[:6], *sc, *j[6:])
    assert set(got) == set(want) and got["imax_rows"].shape[1] == ra[0].shape[0]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


def test_stage_8_index_sharded_seeds_and_walk_equal_replicated(tiny):
    """The index-sharded stage's one-rank seeds (the replicated tables)
    equal the source's replicated log machine on each dp slice of the pool,
    and its SA positions sa_batch_np."""
    n_dp, n_idx = tiny["inp"]["grid"]
    assert (n_dp, n_idx) == (2, 2)
    pool = tiny["inp"]["pool"]
    one = tmesh.make_mesh2(1, 1)
    fn = tmesh.sharded_index_seed_fn(one, tiny["fm"], MemOpt())
    N_l = pool.shape[0] // n_dp
    for s in range(n_dp):
        sl = pool[s * N_l:(s + 1) * N_l]
        sp, srid, sn, _ = fn(T(sl))
        pr, rr, tr, *_ = jsb._collect_sm_log(tiny["jfm"], jnp.asarray(sl),
                                             *_sargs(), *LOG_ARGS)
        t = int(tr)
        assert sn.tolist() == [t]
        np.testing.assert_array_equal(srid.numpy(), np.asarray(rr)[:t])
        np.testing.assert_array_equal(sp.numpy(), np.asarray(pr)[:t])
    whichs, ranks = tiny["inp"]["sa"]
    got = tmesh.sharded_index_sa_fn(one, tiny["fm"])(T(whichs), T(ranks))
    np.testing.assert_array_equal(
        got.numpy(), jsb.sa_batch_np(tiny["jfm"], whichs, ranks))


def test_backend_rule(monkeypatch):
    """gloo on the CPU and where ranks would share a card; nccl only where
    every rank has a card of its own."""
    assert tmesh.backend_for("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.backend_for("cuda", 2) == "gloo"
    assert tmesh.backend_for("cuda", 1) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.backend_for("cuda", 4) == "nccl"
    assert tmesh.backend_for("cuda:0", 8) == "gloo"
    assert tmesh.backend_for("cpu", 4) == "gloo"


def test_shards_partition_the_tables(tiny):
    """fm_shard over n shards: the rows of the flattened table and samples,
    zero-padded to a multiple of n, one contiguous slice a shard."""
    from biscuit_tpu_torch.ops.seed_batch import fm_shard, fm_shard_arrays
    fm = tiny["fm"]
    tab, sa, n64, n_sa = fm_shard_arrays(fm, 3)
    assert (n64, n_sa) == (fm.tab.shape[1], fm.sa_samples.shape[1])
    assert tab.shape[0] % 3 == 0 and sa.shape[0] % 3 == 0
    parts = [fm_shard(fm, 3, i, None) for i in range(3)]
    assert torch.equal(torch.cat([p.tab for p in parts]), tab)
    assert torch.equal(torch.cat([p.sa_samples for p in parts]), sa)
    assert torch.equal(tab[:2 * n64], fm.tab.reshape(2 * n64, -1))
    assert not tab[2 * n64:].any()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_route_gather_over_shards_gives_the_replicated_rows(tiny, n):
    """The local half of the routed gather (route_gather, whose plain
    version runs here, and the step kernels' gather on the card), on each of
    n shards of fm_shard_arrays (equal to the JAX package's), summed over
    the shards: the fused rows and SA samples of the replicated tables at
    each global id, zeros at an id below 0 (a lane that asks for nothing)."""
    from biscuit_tpu_torch.ops.seed_batch import (fm_shard, fm_shard_arrays,
                                                  route_gather)
    fm = tiny["fm"]
    tab, sa, n64, n_sa = fm_shard_arrays(fm, n)
    jtab, jsa, jn64, jn_sa = jsb.fm_shard_arrays(tiny["jfm"], n)
    assert (n64, n_sa) == (jn64, jn_sa)
    np.testing.assert_array_equal(tab.numpy().view(np.uint32), jtab)
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    parts = [fm_shard(fm, n, i, None) for i in range(n)]
    rng = np.random.default_rng(n)
    for table, whole, hi in ((lambda p: p.tab, tab, 2 * n64),
                             (lambda p: p.sa_samples, sa, 2 * n_sa)):
        g = T(np.concatenate([rng.integers(0, hi, 500), [-1, 0, hi - 1]]))
        got = sum(route_gather(table(p), i * table(p).shape[0], g)
                  for i, p in enumerate(parts))
        want = whole[g.clamp(min=0)]
        want[g < 0] = 0
        assert got.dtype == whole.dtype and torch.equal(got, want)


def test_from_env_reads_both_forms(tmp_path, monkeypatch):
    env = "BISCUIT_TPU_TORCH_PES_EXCHANGE"
    monkeypatch.delenv(env, raising=False)
    assert exchange.from_env() is None
    monkeypatch.setenv(env, f"{tmp_path}:1:3")
    ex = exchange.from_env()
    assert isinstance(ex, exchange.FileAllgather)
    assert (ex.dir, ex.rank, ex.n) == (str(tmp_path), 1, 3)
    monkeypatch.setenv(env, "torch")
    # no process group joined: the group is this process alone
    assert exchange.from_env()([3, 1, 2]) == [3, 1, 2]
    # the JAX package's switch steers nothing here
    monkeypatch.delenv(env)
    monkeypatch.setenv("BISCUIT_TPU_PES_EXCHANGE", f"{tmp_path}:0:2")
    assert exchange.from_env() is None


def test_torch_process_allgather_over_3_ranks(tmp_path):
    """Lists of unequal length (rank r: 3 + r values) come back as their
    rank-ordered concatenation in every rank, also through from_env's
    `torch` form; empty lists included."""
    import torch.multiprocessing as mp

    from torch_testdata import allgather_rank
    mp.start_processes(allgather_rank, args=(3, str(tmp_path)), nprocs=3,
                       join=True, start_method="spawn")
    want = [v for r in range(3) for v in range(r * 10, r * 10 + 3 + r)]
    for r in range(3):
        got = (tmp_path / f"rank{r}.txt").read_text().split("\n")
        assert got[0] == " ".join(map(str, want))
        assert got[1] == " ".join(map(str, want))  # from_env("torch")
        assert got[2] == "0 1"  # rank 1 alone sends values
        assert got[3] == ""  # no rank does
