"""The torch port's align slice (SE and PE) vs the JAX package, on the CPU.

The port's process_seqs_device (plain torch versions of the kernels) must
write SAM byte-identical to the JAX device engine and to the JAX host
engine, SE and PE (mate rescue on, and off under -S), with seeding, the
chain scan and mate rescue on its batched path; its `align` CLI must write
what it writes in-process, for SE, two FASTQs and interleaved mates (-p);
it must never import jax; and its copies of the host align modules must
stay their sources' code with only the imports changed (and, in chain.py,
mem_chain_batch's call into the port's chain scan).
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from biscuit_tpu.config import (MemOpt, MEM_F_NO_MULTI, MEM_F_NO_RESCUE,
                                MEM_F_PE)
from biscuit_tpu.align.pipeline import AlignerState, process_seqs
from biscuit_tpu.align.device_engine import process_seqs_device as jax_device
from biscuit_tpu_torch import kernels
from biscuit_tpu_torch.align import pipeline as tpipe
from biscuit_tpu_torch.align.device_engine import (process_seqs_device,
                                                   reset_stages, stage_report)

from torch_testdata import (REPO, damage_mates, load_pairs, load_reads,
                            make_dataset)

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


def test_port_never_imports_jax(data, pe_data):
    """Import the CLI and align one read (`-1`) and one pair (`-1`/`-2`)
    through the CPU engine."""
    fa, fq, _idx = data
    with open(fq) as f:
        read = f.read().splitlines()[1]
    pfa, (fq1, fq2), _pidx = pe_data
    mates = []
    for path in (fq1, fq2):  # pair 1: mate 2 is undamaged
        with open(path) as f:
            mates.append(f.read().splitlines()[5])
    code = (
        "import contextlib, io, sys\n"
        "from biscuit_tpu_torch import cli\n"
        "def run(argv):\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        rc = cli.main(['align'] + argv)\n"
        "    return rc, [ln.split() for ln in buf.getvalue().splitlines()\n"
        "                if ln[:1] != '@']\n"
        f"rc, se = run(['-1', {read!r}, {fa!r}])\n"
        f"rc2, pe = run(['-1', {mates[0]!r}, '-2', {mates[1]!r}, {pfa!r}])\n"
        "print(rc, se[0][2], rc2, len(pe), *(int(f[1]) for f in pe),\n"
        "      pe[0][2], 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rc, chrom, rc2, n_pe, flag1, flag2, pchrom, has_jax = r.stdout.split()
    assert rc == "0" and chrom.startswith("chr") and has_jax == "False"
    # one record per mate, both paired (0x1) and mapped, as read 1 and 2
    assert rc2 == "0" and n_pe == "2" and pchrom.startswith("chr")
    for flag, mate in ((int(flag1), 0x40), (int(flag2), 0x80)):
        assert flag & 0x1 and not flag & 0x4 and flag & mate


# ---------------------------------------------------------------------------
# paired-end: the PE branch of process_seqs_device with mate rescue (K7)
# ---------------------------------------------------------------------------

N_PAIRS = 80
DAMAGE_EVERY = 3


@pytest.fixture(scope="module")
def pe_data(tmp_path_factory):
    """60 kbp genome, 80 pairs of 100 bp with SNPs at 2%; every third
    mate 2 damaged at every 9th base, so that it has no seed and only mate
    rescue can place it (as tests/test_device_engine.py:94-99)."""
    d = tmp_path_factory.mktemp("tpe")
    fa, (fq1, fq2), idx = make_dataset(d, genome_size=60000, n_reads=N_PAIRS,
                                       seed=23, snp_rate=0.02, pe=True)
    damage_mates(fq2, DAMAGE_EVERY)
    return fa, (fq1, fq2), idx


def _pe_opt(rescue=True):
    opt = _opt()
    opt.flag |= MEM_F_PE | (0 if rescue else MEM_F_NO_RESCUE)
    return opt


@pytest.fixture(scope="module")
def port_pe_sam(pe_data):
    """The port's PE SAM on the CPU, per rescue setting, with its stage
    report and kernel launches."""
    _fa, fqs, idx = pe_data
    out = {}
    for rescue in (True, False):
        seqs = load_pairs(*fqs)
        kernels.reset_launches()
        reset_stages()
        process_seqs_device(_pe_opt(rescue), tpipe.AlignerState(idx), seqs,
                            0, device="cpu")
        out[rescue] = ([s.sam for s in seqs], stage_report(),
                       dict(kernels.LAUNCHES))
    return out


def _damaged_mapped(sams):
    """Primary records of damaged mates (mate 2 of every DAMAGE_EVERY-th
    pair) that are mapped."""
    n = 0
    for p in range(0, len(sams) // 2, DAMAGE_EVERY):
        for ln in sams[2 * p + 1].splitlines():
            flag = int(ln.split("\t")[1])
            n += not flag & 0x904
    return n


@pytest.mark.parametrize("rescue", [True, False], ids=["rescue", "no_rescue"])
def test_pe_sam_matches_jax_device_and_host(pe_data, port_pe_sam, rescue):
    _fa, fqs, idx = pe_data
    got, report, launches = port_pe_sam[rescue]
    st = AlignerState(idx)
    dev_seqs = load_pairs(*fqs)
    jax_device(_pe_opt(rescue), st, dev_seqs, 0)
    host_seqs = load_pairs(*fqs)
    process_seqs(_pe_opt(rescue), st, host_seqs, 0)
    assert len(got) == 2 * N_PAIRS
    for g, v, h in zip(got, dev_seqs, host_seqs):
        assert g == v.sam, f"port: {g}\njax device: {v.sam}"
        assert g == h.sam, f"port: {g}\njax host: {h.sam}"
    assert report["seed"] > 0 and report["chain_scan"] > 0
    assert report["extend"] > 0 and report["cigar"] > 0
    assert not any(launches.values())
    if rescue:
        # K7's plain version ran, and rescue placed damaged mates that the
        # run without it leaves unmapped
        assert report["rescue"] > 0 and report["rescue_lanes"] > 0
        placed = _damaged_mapped(got) - _damaged_mapped(port_pe_sam[False][0])
        assert placed >= 1
    else:
        assert "rescue" not in report and report["rescue_lanes"] == 0


def test_matesw_batch_matches_sequential(pe_data):
    """The port's matesw_batch over its K7 (plain on the CPU) leaves the
    region lists identical to the sequential per-pair matesw loop, the
    order-dependent skips and dedup insertions included (model:
    tests/test_device_engine.py:69-125)."""
    import copy
    from biscuit_tpu_torch.align.device_engine import DeviceAligner
    from biscuit_tpu_torch.align.pair import pestat
    from biscuit_tpu_torch.align.region import matesw, matesw_batch
    _fa, fqs, idx = pe_data
    st = tpipe.AlignerState(idx)
    seqs = load_pairs(*fqs)
    opt = _pe_opt()
    dev = DeviceAligner(st, "cpu")
    regs = dev.regs_for_batch(opt, seqs)
    pes = pestat(opt, idx, regs)
    regs_a, regs_b = copy.deepcopy(regs), copy.deepcopy(regs)
    for i in range(N_PAIRS):
        matesw(opt, idx, pes, (seqs[2 * i], seqs[2 * i + 1]),
               (regs_a[2 * i], regs_a[2 * i + 1]))
    pairs = [((seqs[2 * i], seqs[2 * i + 1]), (regs_b[2 * i], regs_b[2 * i + 1]))
             for i in range(N_PAIRS)]
    matesw_batch(opt, idx, pes, pairs, dev.sw_local_batch_fn(opt))
    n_rescued = 0
    for i in range(len(seqs)):
        la, lb = regs_a[i], regs_b[i]
        assert len(la) == len(lb), f"read {i}: {len(la)} vs {len(lb)} regions"
        n_rescued += len(la) != len(regs[i])
        for a, b in zip(la, lb):
            for f in ("rb", "re", "qb", "qe", "rid", "score", "truesc",
                      "csub", "sub", "seedcov", "secondary", "bss", "parent"):
                assert getattr(a, f) == getattr(b, f), f"read {i} field {f}"
    assert n_rescued > 0, "no rescue happened; strengthen the data"


@pytest.mark.parametrize("layout", ["two_files", "interleaved"])
def test_cli_pe_matches_in_process(pe_data, port_pe_sam, tmp_path, layout):
    """`align fa r1.fq r2.fq`, and `align -p fa interleaved.fq` (a second
    file is then ignored, with a warning), write the in-process PE SAM."""
    fa, (fq1, fq2), _idx = pe_data
    if layout == "two_files":
        argv = [fa, fq1, fq2]
    else:
        with open(fq1) as f1, open(fq2) as f2:
            l1, l2 = f1.read().splitlines(), f2.read().splitlines()
        inter = tmp_path / "interleaved.fq"
        inter.write_text("".join(
            "\n".join(l1[k:k + 4] + l2[k:k + 4]) + "\n"
            for k in range(0, len(l1), 4)))
        argv = ["-p", fa, str(inter), fq2]
    r = subprocess.run([sys.executable, "-m", "biscuit_tpu_torch.cli",
                        "align", *argv], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert ("second query file is ignored" in r.stderr) == (layout != "two_files")
    body = "".join(ln + "\n" for ln in r.stdout.splitlines()
                   if not ln.startswith("@"))
    assert body == "".join(port_pe_sam[True][0])


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
