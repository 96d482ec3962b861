"""The torch port's SE align slice vs the JAX package, on the CPU.

The port's process_seqs_device (plain torch versions of the kernels) must
write SAM byte-identical to the JAX device engine and to the JAX host
engine, with seeding and the chain scan on its batched path; its `align`
CLI must write what it writes in-process; it must never import jax; and
its copies of the host align modules must stay their sources' code with
only the imports changed (and, in chain.py, mem_chain_batch's call into
the port's chain scan).
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from biscuit_tpu.config import MemOpt, MEM_F_NO_MULTI, MEM_F_PE
from biscuit_tpu.align.pipeline import AlignerState, process_seqs
from biscuit_tpu.align.device_engine import process_seqs_device as jax_device
from biscuit_tpu_torch import kernels
from biscuit_tpu_torch.align import pipeline as tpipe
from biscuit_tpu_torch.align.device_engine import (process_seqs_device,
                                                   reset_stages, stage_report)

from torch_testdata import REPO, load_reads, make_dataset

# the plain versions are loops of small ops: under pytest-xdist, intra-op
# threads of several workers only contend for the cores
torch.set_num_threads(1)

N_READS = 120


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """60 kbp genome, 2 chroms, SE 100 bp reads with SNPs, and an indel in
    every other of each 4 reads so the global alignment path has work."""
    d = tmp_path_factory.mktemp("teng")
    fa, fq, idx = make_dataset(d, genome_size=60000, n_reads=N_READS,
                               n_chroms=2, seed=11, snp_rate=0.01,
                               indel_every=4)
    return fa, fq, idx


def _opt():
    opt = MemOpt()
    opt.flag |= MEM_F_NO_MULTI
    return opt


@pytest.fixture(scope="module")
def port_sam(data):
    _fa, fq, idx = data
    seqs = load_reads(fq, N_READS)
    kernels.reset_launches()
    reset_stages()
    process_seqs_device(_opt(), tpipe.AlignerState(idx), seqs, 0, device="cpu")
    return [s.sam for s in seqs], stage_report(), dict(kernels.LAUNCHES)


def test_se_sam_matches_jax_device_and_host(data, port_sam):
    _fa, fq, idx = data
    got, report, launches = port_sam
    st = AlignerState(idx)
    dev_seqs = load_reads(fq, N_READS)
    jax_device(_opt(), st, dev_seqs, 0)
    host_seqs = load_reads(fq, N_READS)
    process_seqs(_opt(), st, host_seqs, 0)
    for g, v, h in zip(got, dev_seqs, host_seqs):
        assert g == v.sam, f"port: {g}\njax device: {v.sam}"
        assert g == h.sam, f"port: {g}\njax host: {h.sam}"
    # the slice really ran its device stages, on the plain versions
    cigars = [ln.split("\t")[5] for g in got for ln in g.splitlines()]
    assert sum(("I" in c or "D" in c) for c in cigars) >= N_READS // 8
    assert report["sa"] > 0 and report["extend"] > 0 and report["cigar"] > 0
    # seeding and the chain scan ran on the port's batched path: the plain
    # seeder and scan, with few lanes redone on the host
    assert report["seed"] > 0 and report["chain_scan"] > 0
    assert report["seed_overflow_lanes"] <= 2 * N_READS // 100
    assert report["chain_host_lanes"] <= 2 * N_READS // 10
    assert not any(launches.values())


def test_port_host_engine_matches_jax_host(data, port_sam):
    _fa, fq, idx = data
    seqs = load_reads(fq, N_READS)
    tpipe.process_seqs(_opt(), tpipe.AlignerState(idx), seqs, 0)
    assert [s.sam for s in seqs] == port_sam[0]


def _env():
    env = dict(os.environ)
    env.pop("BISCUIT_TPU_PLATFORM", None)  # conftest sets it; it imports jax
    env["BISCUIT_TPU_TORCH_DEVICE"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above
    return env


def test_cli_align_matches_in_process(data, port_sam):
    fa, fq, _idx = data
    r = subprocess.run([sys.executable, "-m", "biscuit_tpu_torch.cli",
                        "align", fa, fq], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    head = [ln for ln in r.stdout.splitlines() if ln.startswith("@")]
    assert [ln.split("\t")[0] for ln in head] == ["@SQ", "@SQ", "@PG"]
    body = "".join(ln + "\n" for ln in r.stdout.splitlines()
                   if not ln.startswith("@"))
    assert body == "".join(port_sam[0])


def test_port_never_imports_jax(data):
    """Import the CLI and align one read (`-1`) through the CPU engine."""
    fa, fq, _idx = data
    with open(fq) as f:
        read = f.read().splitlines()[1]
    code = (
        "import contextlib, io, sys\n"
        "from biscuit_tpu_torch import cli\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        f"    rc = cli.main(['align', '-1', {read!r}, {fa!r}])\n"
        "sam = [ln for ln in buf.getvalue().splitlines() if ln[:1] != '@']\n"
        "print(rc, sam[0].split()[2], 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rc, chrom, has_jax = r.stdout.split()
    assert rc == "0" and chrom.startswith("chr") and has_jax == "False"


def test_pe_raises_not_implemented(data):
    _fa, fq, idx = data
    opt = _opt()
    opt.flag |= MEM_F_PE
    with pytest.raises(NotImplementedError, match="K7"):
        process_seqs_device(opt, tpipe.AlignerState(idx),
                            load_reads(fq, 2), 0, device="cpu")


def test_traceback_overflow_lanes_realigned_on_host(data):
    """A lane whose traceback needs more than max_ops runs is flagged and
    realigned by the scalar sw.sw_global, next to an ordinary lane. (The
    JAX engine decodes every lane before it checks the flag, and raises
    IndexError on such a lane.)"""
    from biscuit_tpu.ops import sw
    from biscuit_tpu_torch.align.device_engine import DeviceAligner
    opt = _opt()
    opt.b, opt.o_del, opt.o_ins, opt.e_del, opt.e_ins = 20, 1, 1, 1, 1
    opt.__post_init__()  # cheap gaps, dear mismatches: ~75 runs per lane
    rng = np.random.default_rng(0)
    reqs = [((i, 40), rng.integers(0, 4, 120).astype(np.uint8),
             rng.integers(0, 4, 120).astype(np.uint8), 40, i & 1)
            for i in range(4)]
    easy = rng.integers(0, 4, 100).astype(np.uint8)
    reqs.append(("easy", easy, easy.copy(), 5, 0))
    reset_stages()
    got = DeviceAligner(tpipe.AlignerState(data[2]), "cpu").sw_global_batch(
        opt, reqs)
    assert stage_report()["traceback_overflow_lanes"] == 4
    for key, q, r, w, parent in reqs:
        mat = opt.ctmat if parent else opt.gamat
        assert got[key] == sw.sw_global(q, r, mat, opt.o_del, opt.e_del,
                                        opt.o_ins, opt.e_ins, w)


class _NoImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import


def _code(path, drop=()):
    """Module body as AST dumps, without the docstring, any import
    statement and the top-level names in `drop`."""
    with open(path) as f:
        tree = _NoImports().visit(ast.parse(f.read()))
    out = []
    for i, node in enumerate(tree.body):
        if i == 0 and isinstance(node, ast.Expr):
            continue
        if isinstance(node, ast.FunctionDef) and node.name in drop:
            continue
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) in drop for t in node.targets):
            continue
        out.append(ast.dump(node))
    return out


@pytest.mark.parametrize("name", ["trace", "smem", "chain", "region", "sam",
                                  "pair", "pipeline"])
def test_copied_module_matches_source(name):
    drop = ()
    if name == "chain":  # its call into the chain scan is the port's own
        drop = ("mem_chain_batch",)
    src = os.path.join(REPO, "biscuit_tpu", "align", name + ".py")
    dst = os.path.join(REPO, "biscuit_tpu_torch", "align", name + ".py")
    assert _code(dst, drop) == _code(src, drop)
