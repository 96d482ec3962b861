"""`align` on an FM index sharded over ranks (BISCUIT_TPU_TORCH_INDEX_SHARD,
parallel/mesh.index_shard_mesh and index_sharded_seeder) against the JAX
package's BISCUIT_TPU_INDEX_SHARD, on the CPU.

The port's ranks are processes started with torchrun's variables (a free
port of this host), joined under gloo; on the CPU the seeder's routed walk
is the plain lockstep machine, one all_reduce over the idx group a row read.
The JAX CLI runs one process over two host devices
(XLA_FLAGS=--xla_force_host_platform_device_count=2). Exact everywhere:
arrays torch.equal, SAM byte for byte. Every multi-rank run has a timeout of
its own: a rank that falls out of lockstep leaves the others waiting in a
collective.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from biscuit_tpu.config import MemOpt as JaxMemOpt
from biscuit_tpu.ops import seed_batch as jsb
from biscuit_tpu_torch.config import MemOpt

from torch_testdata import (REPO, cli_env, damage_mates, jax_index,
                            lanes_both_ways, make_dataset, run_cli)

torch.set_num_threads(1)

SHARD = "BISCUIT_TPU_TORCH_INDEX_SHARD"
TIMEOUT = 600  # seconds a multi-rank run may take before it counts as hung


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ranks(n, argv, **env):
    """`align <argv>` as n ranks with torchrun's variables under
    BISCUIT_TPU_TORCH_INDEX_SHARD=2: [(rc, stdout, stderr)] by rank."""
    base = cli_env(**{SHARD: "2", "WORLD_SIZE": str(n),
                      "MASTER_ADDR": "127.0.0.1",
                      "MASTER_PORT": str(_free_port())}, **env)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "biscuit_tpu_torch.cli", "align", *argv],
        cwd=REPO, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


# case -> (data set, options before the files, environment of both CLIs):
# SE; PE; SE in sub-batches of 16 reads, which the hybrid pipelines through
# its injector thread; SE under -V, whose chunk the hybrid hands to the
# device engine (its seed stage on the shard, its SA walk on the whole
# tables); PE on the device engine named by each CLI's switch
CASES = {"se": ("se", [], {}), "pe": ("pe", [], {}),
         "se-pipelined": ("se", [], {"BISCUIT_TPU_DEVICE_BATCH": "16"}),
         "se-V": ("se", ["-V"], {}),
         "pe-device-jax": ("pe", [], {"BISCUIT_TPU_TORCH_ENGINE": "device-jax",
                                      "BISCUIT_TPU_ENGINE": "device-jax"})}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 20 kbp genome: 40 SE reads of 100 bp, 24 pairs of 100 bp with every
    third mate 2 damaged (only rescue places it); sam(case) gives the
    port's one-process SAM and the JAX CLI's under BISCUIT_TPU_INDEX_SHARD=2
    on two host devices."""
    d = tmp_path_factory.mktemp("idx_shard")
    fa, fq, idx = make_dataset(d / "se", genome_size=20000, n_reads=40,
                               read_len=100, seed=11)
    pfa, (f1, f2), _ = make_dataset(d / "pe", genome_size=20000, n_reads=24,
                                    read_len=100, seed=11, pe=True)
    damage_mates(f2)
    files = {"se": [fa, fq], "pe": [pfa, f1, f2]}
    sams = {}

    def sam(case):
        if case not in sams:
            layout, opts, env = CASES[case]
            argv = ["align", *opts, *files[layout]]
            jax_env = {"BISCUIT_TPU_ENGINE": "device",
                       "BISCUIT_TPU_INDEX_SHARD": "2",
                       "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
                       **env}
            sams[case] = (run_cli("biscuit_tpu_torch", argv, **env).stdout,
                          run_cli("biscuit_tpu", argv, **jax_env).stdout)
        return sams[case]
    return {"idx": idx, "files": files, "sam": sam}


@pytest.mark.parametrize("case, n", [("se", 2), ("se", 4), ("pe", 2),
                                     ("pe", 4), ("se-pipelined", 2),
                                     ("se-V", 2), ("pe-device-jax", 2)])
def test_rank_0_sam_equals_one_process_and_the_jax_cli(data, case, n):
    """n ranks, a (n // 2) x 2 grid: rank 0's SAM equals the port's
    one-process SAM and the JAX CLI's with its index sharded over 2 devices;
    the other ranks print no SAM and none of the [M::...] lines."""
    layout, opts, env = CASES[case]
    res = _ranks(n, [*opts, *data["files"][layout]], **env)
    for r, (rc, _out, err) in enumerate(res):
        assert rc == 0, (r, err[-3000:])
    sam = res[0][1]
    port, jax = data["sam"](case)
    assert sam.count("\n") > 40
    assert sam == port
    assert sam == jax
    assert "[M::process]" in res[0][2]
    for _rc, out, err in res[1:]:
        assert out == ""
        assert not any(ln.startswith("[M::") for ln in err.splitlines())


@pytest.mark.parametrize("world", ["1", "3"])
def test_a_world_the_shards_do_not_divide_exits_1(data, world):
    """WORLD_SIZE 1 (or unset), or one that n does not divide, exits 1
    before any group is joined, naming both variables."""
    env = {SHARD: "2"}
    if world != "1":
        env.update(WORLD_SIZE=world, RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()))
    r = run_cli("biscuit_tpu_torch", ["align", *data["files"]["se"]], rc=1,
                **env)
    assert r.stdout == ""
    assert f"{SHARD}=2" in r.stderr and f"WORLD_SIZE={world}" in r.stderr


def _seeder_rank(rank, n, store, out_dir, q, lens, par):
    """One rank of test_index_sharded_seeder_equals_the_jax_one: the whole
    batch through index_sharded_seeder on a (n // 2) x 2 grid."""
    import torch.distributed as dist

    from biscuit_tpu_torch.graft_entry import _tiny_index
    from biscuit_tpu_torch.ops.seed_batch import FMPair
    from biscuit_tpu_torch.parallel.mesh import (index_sharded_seeder,
                                                 make_mesh2)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=n)
    fm = FMPair.from_index(_tiny_index(), "cpu")
    fn = index_sharded_seeder(make_mesh2(n // 2, 2), fm)
    got = fn(*(torch.from_numpy(a) for a in (q, lens, par)), MemOpt())
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.parametrize("n", [2, 4])
def test_index_sharded_seeder_equals_the_jax_one(tmp_path, monkeypatch, n):
    """index_sharded_seeder on every rank of a (n // 2) x 2 grid (lanes split
    over dp, rows routed over idx) gives collect_intv_flat's contract over
    the whole batch, equal to the JAX collect_intv_flat_sm under
    BISCUIT_TPU_INDEX_SHARD=2 (the test process's 8 host devices, a 4 x 2
    grid) on the same 37 lanes (reads converted either way), a count the
    grids do not divide."""
    import torch.multiprocessing as mp

    from biscuit_tpu_torch.graft_entry import _tiny_index
    idx = _tiny_index()
    rng = np.random.default_rng(41)
    reads = [idx.pac[p:p + 96].astype(np.int64)
             for p in rng.integers(0, idx.l_pac - 96, 37)]
    q, lens, par = lanes_both_ways(reads)
    q, lens, par = q[:37], lens[:37], par[:37]
    mp.start_processes(_seeder_rank, args=(n, str(tmp_path / "store"),
                                           str(tmp_path), q, lens, par),
                       nprocs=n, join=True, start_method="spawn")
    monkeypatch.setenv("BISCUIT_TPU_INDEX_SHARD", "2")
    jfm = jsb.FMPair.from_index(jax_index(idx))
    jl, jr, jov = jsb.collect_intv_flat_sm(jfm, q, lens, par, JaxMemOpt())
    assert not jov.any() and len(jl) > 37
    for r in range(n):
        lane_of, rows, ov = torch.load(tmp_path / f"rank{r}.pt")
        assert not ov.any() and ov.shape == (37,)
        np.testing.assert_array_equal(lane_of.numpy(), jl)
        np.testing.assert_array_equal(rows.numpy(), jr)
