"""The torch port's align slice (SE and PE) vs the JAX package, on the CPU.

The port's process_seqs_device (plain torch versions of the kernels) must
write SAM byte-identical to the JAX device engine and to the JAX host
engine, SE and PE (mate rescue on, and off under -S), with seeding, the
chain scan and mate rescue on its batched path; its `align` CLI must write
what it writes in-process, for SE, two FASTQs and interleaved mates (-p);
it must never import jax or any module of the JAX package; its `index`
must write the JAX package's files; and its copies of the JAX package's
host modules must stay their sources' code with only the imports changed
(and what each entry of COPIES leaves out on purpose).

Each side gets inputs of its own classes: the JAX engines the JAX
package's MemOpt, BisIndex and BSeq, the port its own, with the port's
index made by bisindex_from_numpy from the arrays of the JAX package's, so
that both align against the very same index.
"""
import ast
import collections
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from biscuit_tpu import config as jconfig
from biscuit_tpu.index.build import build_index as jax_build_index
from biscuit_tpu.index.fmindex import BisIndex as JaxBisIndex
from biscuit_tpu.align.pipeline import AlignerState, process_seqs
from biscuit_tpu.align.device_engine import process_seqs_device as jax_device
from biscuit_tpu_torch import config as tconfig
from biscuit_tpu_torch import kernels
from biscuit_tpu_torch.align import pipeline as tpipe
from biscuit_tpu_torch.align.device_engine import (process_seqs_device,
                                                   reset_stages, stage_report)
from biscuit_tpu_torch.index.fmindex import BisIndex, bisindex_from_numpy

from torch_testdata import (REPO, damage_mates, index_fields, load_pairs,
                            load_reads, make_dataset, port_index)

# one index twice: the JAX package's object, and the port's over its arrays
Both = collections.namedtuple("Both", "jax port")


def _both_indexes(fa):
    """The index of `fa`, built and written by the JAX package."""
    jidx = jax_build_index(fa, prefix=fa)
    return Both(jidx, port_index(jidx))

# the plain versions are loops of small ops: under pytest-xdist, intra-op
# threads of several workers only contend for the cores
torch.set_num_threads(1)

N_READS = 120


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """60 kbp genome, 2 chroms, SE 100 bp reads with SNPs, and an indel in
    every other of each 4 reads so the global alignment path has work."""
    d = tmp_path_factory.mktemp("teng")
    fa, fq, _ = make_dataset(d, genome_size=60000, n_reads=N_READS,
                             n_chroms=2, seed=11, snp_rate=0.01,
                             indel_every=4, index=False)
    return fa, fq, _both_indexes(fa)


def _opt(cfg=tconfig):
    """Options of the port's MemOpt, or with cfg=jconfig the JAX package's."""
    opt = cfg.MemOpt()
    opt.flag |= cfg.MEM_F_NO_MULTI
    return opt


@pytest.fixture(scope="module")
def port_sam(data):
    _fa, fq, idx = data
    seqs = load_reads(fq, N_READS)
    kernels.reset_launches()
    reset_stages()
    process_seqs_device(_opt(), tpipe.AlignerState(idx.port), seqs, 0,
                        device="cpu")
    return [s.sam for s in seqs], stage_report(), dict(kernels.LAUNCHES)


def test_se_sam_matches_jax_device_and_host(data, port_sam):
    _fa, fq, idx = data
    got, report, launches = port_sam
    st = AlignerState(idx.jax)
    dev_seqs = load_reads(fq, N_READS, jax_pkg=True)
    jax_device(_opt(jconfig), st, dev_seqs, 0)
    host_seqs = load_reads(fq, N_READS, jax_pkg=True)
    process_seqs(_opt(jconfig), st, host_seqs, 0)
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
    tpipe.process_seqs(_opt(), tpipe.AlignerState(idx.port), seqs, 0)
    assert [s.sam for s in seqs] == port_sam[0]


def _env():
    env = dict(os.environ)
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
        "theirs = [m for m in sys.modules if m == 'jax' or m == 'biscuit_tpu'\n"
        "          or m.startswith(('jax.', 'biscuit_tpu.'))]\n"
        "print(rc, se[0][2], rc2, len(pe), *(int(f[1]) for f in pe),\n"
        "      pe[0][2], not theirs)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rc, chrom, rc2, n_pe, flag1, flag2, pchrom, clean = r.stdout.split()
    # neither jax nor biscuit_tpu (nor a submodule of either) was imported
    assert rc == "0" and chrom.startswith("chr") and clean == "True"
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
    fa, (fq1, fq2), _ = make_dataset(d, genome_size=60000, n_reads=N_PAIRS,
                                     seed=23, snp_rate=0.02, pe=True,
                                     index=False)
    damage_mates(fq2, DAMAGE_EVERY)
    return fa, (fq1, fq2), _both_indexes(fa)


def _pe_opt(rescue=True, cfg=tconfig):
    opt = _opt(cfg)
    opt.flag |= cfg.MEM_F_PE | (0 if rescue else cfg.MEM_F_NO_RESCUE)
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
        process_seqs_device(_pe_opt(rescue), tpipe.AlignerState(idx.port),
                            seqs, 0, device="cpu")
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
    st = AlignerState(idx.jax)
    dev_seqs = load_pairs(*fqs, jax_pkg=True)
    jax_device(_pe_opt(rescue, jconfig), st, dev_seqs, 0)
    host_seqs = load_pairs(*fqs, jax_pkg=True)
    process_seqs(_pe_opt(rescue, jconfig), st, host_seqs, 0)
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


@pytest.mark.parametrize("layout", ["se", "pe"])
def test_no_global_alignment_is_left_for_worker2(port_sam, port_pe_sam,
                                                 layout):
    """The CIGAR prefill computes every global alignment that reg2sam asks
    for: none runs late, at worker2 time."""
    report = port_sam[1] if layout == "se" else port_pe_sam[True][1]
    assert report["cigar"] > 0 and report["cigar_late_lanes"] == 0


@pytest.mark.parametrize("layout", ["se", "pe"])
def test_needs_global_is_what_alnreg_setSAM_asks_for(data, pe_data, layout):
    """The prefill leaves a region out only when alnreg_setSAM asks no
    global alignment of it. device_engine._needs_global re-derives the
    first lines of mem_alnreg_setSAM (the band from infer_bw, the ungapped
    case); on every mapped region of the SE and PE test chunks,
    alnreg_setSAM on a copy calls its global_fn exactly when
    _needs_global says so."""
    import copy
    from biscuit_tpu_torch.align import sam as tsam
    from biscuit_tpu_torch.align.device_engine import (DeviceAligner,
                                                       _needs_global)
    se = layout == "se"
    _fa, fq, idx = data if se else pe_data
    seqs = load_reads(fq, N_READS) if se else load_pairs(*fq)
    opt = _opt() if se else _pe_opt()
    regs = DeviceAligner(tpipe.AlignerState(idx.port), "cpu").regs_for_batch(
        opt, seqs)

    class Asked(Exception):
        pass

    def ask(*_a):
        raise Asked
    seen = collections.Counter()
    for s, rs in zip(seqs, regs):
        for r in rs:
            if r.rb < 0 or r.re < 0:
                continue
            try:
                tsam.alnreg_setSAM(opt, idx.port, s, copy.copy(r),
                                   global_fn=ask)
                asked = False
            except Asked:
                asked = True
            assert asked == _needs_global(opt, r), (s.name, r.rb, r.re)
            seen[asked] += 1
    assert seen[True] > 0 and seen[False] > 0, seen


@pytest.mark.parametrize("layout", ["se", "pe"])
def test_weak_regions_stay_out_of_sa_tags(tmp_path, monkeypatch, layout):
    """A read whose best region scores below T: 640 bp reads (PE: mates 1
    of 640 bp beside mates 2 of 150) on a 200 kbp genome, every third one
    damaged at every 9th base, so that it has no seed of its own and only
    chance hits of the three-letter genome (PE: and its rescue), under
    T = 20. The JAX device engine, whose CIGAR prefill fills every region
    its candidates over-approximate, lists weak regions in SA:Z that the
    host engine never formats; the port's prefill writes into a cache, not
    into the regions, so its SAM, SA:Z tags included, is the host
    engine's, and reg2sam asks for no alignment the prefill left out."""
    from torch_testdata import trim_fastq
    pe = layout == "pe"
    fa, fq, idx = make_dataset(tmp_path, genome_size=200_000, n_reads=24,
                               seed=7, read_len=640, snp_rate=0.001, pe=pe)
    if pe:
        trim_fastq(fq[1], 150)
    damage_mates(fq[0] if pe else fq, 3)

    def sam(run, cfg, st, **kw):
        seqs = (load_pairs(*fq, jax_pkg=cfg is jconfig) if pe
                else load_reads(fq, 24, jax_pkg=cfg is jconfig))
        opt = _pe_opt(cfg=cfg) if pe else _opt(cfg)
        opt.T = 20
        run(opt, st, seqs, 0, **kw)
        return [s.sam for s in seqs]
    reset_stages()
    port = sam(process_seqs_device, tconfig, tpipe.AlignerState(idx),
               device="cpu")
    assert stage_report()["cigar_late_lanes"] == 0
    assert port == sam(tpipe.process_seqs, tconfig, tpipe.AlignerState(idx))
    jst = AlignerState(JaxBisIndex.load(fa))
    jdev = sam(jax_device, jconfig, jst)
    assert any("\tSA:Z:" in d and "\tSA:Z:" not in p
               for d, p in zip(jdev, port))


def test_matesw_batch_matches_sequential(pe_data):
    """The port's matesw_batch over its K7 (plain on the CPU) leaves the
    region lists identical to the sequential per-pair matesw loop, the
    order-dependent skips and dedup insertions included (model:
    tests/test_device_engine.py:69-125)."""
    import copy
    from biscuit_tpu_torch.align.device_engine import DeviceAligner
    from biscuit_tpu_torch.align.pair import pestat
    from biscuit_tpu_torch.align.region import matesw, matesw_batch
    _fa, fqs, both = pe_data
    idx = both.port
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
    got = DeviceAligner(tpipe.AlignerState(data[2].port), "cpu").sw_global_batch(
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


class _NoArgs(ast.NodeTransformer):
    """Drops the parameters named in `names` from every function (with
    their defaults) and the keyword arguments of those names from every
    call."""

    def __init__(self, names):
        self.names = set(names)

    def visit_FunctionDef(self, node):
        a = node.args
        keep = [x.arg not in self.names for x in a.posonlyargs + a.args]
        n_plain = len(keep) - len(a.defaults)
        a.defaults = [d for d, k in zip(a.defaults, keep[n_plain:]) if k]
        a.args = [x for x in a.args if x.arg not in self.names]
        kw = [(x, d) for x, d in zip(a.kwonlyargs, a.kw_defaults)
              if x.arg not in self.names]
        a.kwonlyargs, a.kw_defaults = [x for x, _ in kw], [d for _, d in kw]
        self.generic_visit(node)
        return node

    def visit_Call(self, node):
        node.keywords = [k for k in node.keywords if k.arg not in self.names]
        self.generic_visit(node)
        return node


class _Renamed(ast.NodeTransformer):
    """Replaces each string constant, and each keyword argument's name,
    that is a key of `names` by its value."""

    def __init__(self, names):
        self.names = names

    def visit_Constant(self, node):
        if isinstance(node.value, str) and node.value in self.names:
            node.value = self.names[node.value]
        return node

    def visit_keyword(self, node):
        if node.arg in self.names:
            node.arg = self.names[node.arg]
        self.generic_visit(node)
        return node


# the port's own environment switches, where its copies read the JAX
# package's, and the CLI module the sharded drivers start: a run of either
# package never steers the other
SWITCHES = {"BISCUIT_TPU_STREAMS": "BISCUIT_TPU_TORCH_STREAMS",
            "BISCUIT_TPU_PILEUP": "BISCUIT_TPU_TORCH_PILEUP",
            "BISCUIT_TPU_FASTQ_STRIDE": "BISCUIT_TPU_TORCH_FASTQ_STRIDE",
            "BISCUIT_TPU_PES_EXCHANGE": "BISCUIT_TPU_TORCH_PES_EXCHANGE",
            "BISCUIT_TPU_MA_RAW": "BISCUIT_TPU_TORCH_MA_RAW",
            "BISCUIT_TPU_INDEX_SHARD": "BISCUIT_TPU_TORCH_INDEX_SHARD",
            "biscuit_tpu.cli": "biscuit_tpu_torch.cli"}


def _code(path, drop=(), args=(), renamed=()):
    """Module body as AST dumps, without the docstring, any import
    statement, the top-level names in `drop` (functions, classes,
    assignments, and calls such as `sys.path.insert` standing as
    statements) and the
    parameters and keyword arguments named in `args`, with the switches
    named in `renamed` read as the port's (SWITCHES)."""
    with open(path) as f:
        tree = _NoArgs(args).visit(_NoImports().visit(ast.parse(f.read())))
    tree = _Renamed({k: SWITCHES[k] for k in renamed}).visit(tree)
    out = []
    for i, node in enumerate(tree.body):
        if i == 0 and isinstance(node, ast.Expr):
            continue
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name in drop:
            continue
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) in drop for t in node.targets):
            continue
        if isinstance(node, ast.AnnAssign) and node.target.id in drop:
            continue
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call) \
                and ast.unparse(node.value.func) in drop:
            continue
        out.append(ast.dump(node))
    return out


# every module the port copied from the JAX package: id -> (path inside
# either package, or the pair (source, copy) of paths from the repository's
# root; top-level names left out of the comparison[, parameters and keyword
# arguments left out of it[, the environment switches it reads under the
# port's name (SWITCHES)]]). What is left out or renamed is what the copy
# deliberately changes or does not carry.
_ALIGN = {n: (f"align/{n}.py", ()) for n in ("trace", "smem", "region",
                                             "pair")}
COPIES = {
    **_ALIGN,
    # global_fn: the device engine's cached global alignments, handed by
    # worker2_se / worker2_pe through reg2sam_se / reg2sam_pe /
    # reg2sam_pe_nopairing, select_format, format_sam and _tag_XAXB to every
    # alnreg_setSAM call; alnreg_setSAM calls it with its region
    "sam": ("align/sam.py", (), ("global_fn",)),
    "pipeline": ("align/pipeline.py", (), ("global_fn",)),
    # its call into the chain scan is the port's own
    "chain": ("align/chain.py", ("mem_chain_batch",)),
    "config": ("config.py", ()),
    "utils/rng": ("utils/rng.py", ()),
    "utils/ksort": ("utils/ksort.py", ()),
    "index/fasta": ("index/fasta.py", ()),
    # bisindex_from_numpy is the port's addition
    "index/fmindex": ("index/fmindex.py", ("bisindex_from_numpy",)),
    "index/build": ("index/build.py", ()),
    # the loader of sais.cpp, bwt_merge.cpp, align_host.cpp,
    # pileup_native.cpp and streams_native.cpp: no PGO or sanitizer build
    # (one build at a time under a lock, _stale, which lib also asks), no
    # -lz; _declare is the source's whole table
    # (test_native_declare_is_a_prefix_of_the_source)
    "native": ("native/__init__.py", (
        "_SAN", "_SO", "_PGO_DIR", "_PGO_STAMP", "_PGO_SO_MARK", "_src_stamp",
        "_has_gcda", "_pgo_profile_fresh", "_stale", "_build", "lib",
        "train_pgo", "_declare")),
    "align/native_engine": ("align/native_engine.py", ()),
    "io/fastq": ("io/fastq.py", ()),
    "io/bgzf": ("io/bgzf.py", ()),
    "io/bai": ("io/bai.py", ()),
    "io/sambam": ("io/sambam.py", ()),
    "ops/sw": ("ops/sw.py", ()),
    "align/bns": ("align/bns.py", ()),
    "align/io_helpers": ("align/io_helpers.py", ()),
    "pileup/stats": ("pileup/stats.py", ()),
    "pileup/common": ("pileup/common.py", ()),
    # the engine is picked by the `device` argument (None: the C++ window
    # engine of pileup/native.py, as the source's default; a torch device:
    # the counts from the port's fused window count over reused staging
    # buffers, test_pileup_window_fast_differs_only_in_its_counts; a Mesh:
    # the same fused count on this rank's slice of the window's data, summed
    # over the ranks; a torch device with raw BAM sources: the C++ walk of
    # pileup/walk.py around the same _device_counts), not by
    # BISCUIT_TPU_PILEUP; no numpy bincount branch,
    # no _mesh_counts; the device engine's windows run in-process on a CUDA
    # device, and so do a mesh's, native windows in the fork pool on any
    # device (run_windows, the source's run_windows_pooled); stage timers
    "pileup/engine": ("pileup/engine.py", (
        "pileup_window", "_pileup_window_fast", "_device_counts",
        "_mesh_counts", "_MESH_FNS", "_pool_window1", "run_windows_pooled",
        "_window1", "run_windows", "STAGES", "_COUNT_SPAN", "reset_stages",
        "_STAGING", "_staged", "_CODE_OF_STAT")),
    "pileup/native": ("pileup/native.py", ()),
    "io/vcf": ("io/vcf.py", ()),
    "subcmds/vcf2bed": ("subcmds/vcf2bed.py", (), (), ("BISCUIT_TPU_STREAMS",)),
    "subcmds/mergecg": ("subcmds/mergecg.py", (), (), ("BISCUIT_TPU_STREAMS",)),
    "subcmds/epiread": ("subcmds/epiread.py", (), (), ("BISCUIT_TPU_PILEUP",)),
    "subcmds/rectangle": ("subcmds/rectangle.py", ()),
    "subcmds/asm": ("subcmds/asm.py", ()),
    "subcmds/bc": ("subcmds/bc.py", ()),
    "subcmds/bsstrand": ("subcmds/bsstrand.py", ()),
    "subcmds/bsconv": ("subcmds/bsconv.py", ()),
    "subcmds/cinread": ("subcmds/cinread.py", ()),
    "subcmds/qc": ("subcmds/qc.py", ()),
    "subcmds/tview": ("subcmds/tview.py", ()),
    # the companion scripts, inside the port's package: the repository's
    # root, which each puts on sys.path, lies one directory further up
    "scripts/QC": (("scripts/QC.py", "biscuit_tpu_torch/scripts/QC.py"),
                   ("REPO",)),
    "scripts/flip_pbat_strands": (
        ("scripts/flip_pbat_strands.py",
         "biscuit_tpu_torch/scripts/flip_pbat_strands.py"),
        ("sys.path.insert",)),
    "scripts/pybiscuit": (("scripts/pybiscuit.py",
                           "biscuit_tpu_torch/scripts/pybiscuit.py"),
                          ("sys.path.insert",)),
    # the process allgather is torch.distributed's (TorchProcessAllgather for
    # JaxProcessAllgather), and from_env reads the port's switch, whose
    # second form is `torch`; FileAllgather is the source's
    "parallel/exchange": ("parallel/exchange.py", (
        "JaxProcessAllgather", "TorchProcessAllgather", "from_env")),
    # the sharded drivers, inside the port's package: their workers run the
    # port's CLI under the port's switches; shard_align's _spool reads the
    # source with the port's reader and needs no sys.path entry (the driver
    # runs with -m from the repository's root); shard_pileup's REPO lies one
    # directory further up
    "tools/shard_align": (("tools/shard_align.py",
                           "biscuit_tpu_torch/tools/shard_align.py"),
                          ("_spool",), (),
                          ("biscuit_tpu.cli", "BISCUIT_TPU_FASTQ_STRIDE",
                           "BISCUIT_TPU_PES_EXCHANGE")),
    "tools/shard_pileup": (("tools/shard_pileup.py",
                            "biscuit_tpu_torch/tools/shard_pileup.py"),
                           ("REPO",), (),
                           ("biscuit_tpu.cli", "BISCUIT_TPU_MA_RAW")),
}


@pytest.mark.parametrize("name", list(COPIES))
def test_copied_module_matches_source(name):
    rel, drop, args, renamed = (COPIES[name] + ((), ()))[:4]
    if isinstance(rel, tuple):
        src, dst = (os.path.join(REPO, p) for p in rel)
    else:
        src = os.path.join(REPO, "biscuit_tpu", rel)
        dst = os.path.join(REPO, "biscuit_tpu_torch", rel)
    assert _code(dst, drop, args) == _code(src, drop, args, renamed)
    # a renamed switch is read under the port's name, never the source's
    for k in renamed:
        assert _code(dst) != _code(src) and repr(k) not in str(_code(dst))


@pytest.mark.parametrize("name", ["sais.cpp", "bwt_merge.cpp",
                                  "align_host.cpp", "pileup_native.cpp",
                                  "streams_native.cpp"])
def test_copied_native_source_matches(name):
    """The C++ sources of the index construction, of the native align
    engine, of the pileup and epiread window engines and of the vcf2bed and
    mergecg line filters are their sources' code: every line that is not a
    // comment is the same."""
    def code(pkg):
        with open(os.path.join(REPO, pkg, "native", name)) as f:
            return [ln for ln in f if not ln.lstrip().startswith("//")]
    assert code("biscuit_tpu_torch") == code("biscuit_tpu")
    assert len(code("biscuit_tpu")) > 100


def _function(rel, pkg, name):
    """The FunctionDef `name` at the top level of <pkg>/<rel>, without its
    docstring."""
    with open(os.path.join(REPO, pkg, rel)) as f:
        tree = ast.parse(f.read())
    fn, = (n for n in tree.body
           if isinstance(n, ast.FunctionDef) and n.name == name)
    if isinstance(fn.body[0], ast.Expr) and isinstance(
            fn.body[0].value, ast.Constant):
        fn.body = fn.body[1:]
    return fn


def test_native_declare_is_a_prefix_of_the_source():
    """The port's _declare is the source's whole table: the functions of
    sais.cpp, bwt_merge.cpp, align_host.cpp, pileup_native.cpp and
    streams_native.cpp, in the source's order, with its argtypes."""
    mine = _function("native/__init__.py", "biscuit_tpu_torch", "_declare").body
    theirs = _function("native/__init__.py", "biscuit_tpu", "_declare").body
    assert len(mine) >= 70
    assert ast.unparse(mine[-1]) == "L.bt_mergecg_free.restype = None"
    assert [ast.dump(n) for n in mine] == [ast.dump(n) for n in theirs]


def test_pileup_window_fast_differs_only_in_its_counts():
    """_pileup_window_fast is the source's apart from its `device` argument
    and the count matrices: where the source switches on BISCUIT_TPU_PILEUP
    (an assignment and an if), the port has one call of _device_counts."""
    mine = _function("pileup/engine.py", "biscuit_tpu_torch",
                     "_pileup_window_fast")
    theirs = _function("pileup/engine.py", "biscuit_tpu", "_pileup_window_fast")
    assert [a.arg for a in mine.args.args] == \
        [a.arg for a in theirs.args.args] + ["device"]
    is_counts = lambda n: "_device_counts" in ast.dump(n) \
        or "_mode" in ast.dump(n)
    cut_mine = [ast.dump(n) for n in mine.body if not is_counts(n)]
    cut_theirs = [ast.dump(n) for n in theirs.body if not is_counts(n)]
    assert len(mine.body) - len(cut_mine) == 1
    assert len(theirs.body) - len(cut_theirs) == 2
    assert cut_mine == cut_theirs and len(cut_mine) >= 30


@pytest.mark.parametrize("name", ["main_index", "main_sort", "main_bamindex"])
def test_cli_function_matches_source(name):
    assert ast.dump(_function("cli.py", "biscuit_tpu_torch", name)) == \
        ast.dump(_function("cli.py", "biscuit_tpu", name))


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "biscuit_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_port_has_no_import_of_jax_or_the_jax_package():
    """No .py of the port, and not chip_smoke.py, has an import statement of
    jax or biscuit_tpu at any depth of its code."""
    banned = ("jax", "biscuit_tpu")
    hits = []
    files = _port_sources()
    assert len(files) > 40
    walked = {os.path.relpath(f, os.path.join(REPO, "biscuit_tpu_torch"))
              for f in files}
    assert {"graft_entry.py", "parallel/mesh.py", "parallel/exchange.py",
            "tools/shard_align.py", "tools/shard_pileup.py",
            "tools/dist_run.py"} <= walked
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            hits += [f"{os.path.relpath(path, REPO)}:{node.lineno}: {n}"
                     for n in names if n.split(".")[0] in banned]
    assert not hits, hits


# ---------------------------------------------------------------------------
# the index: the same files from either package, and across packages
# ---------------------------------------------------------------------------

def _index_files(prefix):
    """(the .json bytes, {member: bytes} of the .npz). np.savez stamps each
    zip member with the time of writing, so the members are compared, not
    the container."""
    with open(prefix + ".btidx.json", "rb") as f:
        meta = f.read()
    with zipfile.ZipFile(prefix + ".btidx.npz") as z:
        return meta, {n: z.read(n) for n in z.namelist()}


def _same_index(a, b):
    fa, fb = index_fields(a), index_fields(b)
    for tag in ("par", "dau"):
        for k, v in fa[tag].items():
            w = fb[tag][k]
            assert np.array_equal(v, w) and np.asarray(v).dtype == \
                np.asarray(w).dtype, (tag, k)
    assert np.array_equal(fa["pac"], fb["pac"]) and fa["l_pac"] == fb["l_pac"]
    assert fa["anns"] == fb["anns"] and fa["ambs"] == fb["ambs"]


def test_index_cli_writes_the_jax_packages_files(data, tmp_path):
    """`index` of both CLIs on copies of one FASTA: the same files, and each
    package loads the other's."""
    fa, _fq, idx = data
    prefixes = {}
    for pkg in ("biscuit_tpu_torch", "biscuit_tpu"):
        mine = str(tmp_path / f"{pkg}.fa")
        with open(fa) as f, open(mine, "w") as g:
            g.write(f.read())
        r = subprocess.run([sys.executable, "-m", pkg + ".cli", "index", mine],
                           cwd=REPO, env=_env(), capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        prefixes[pkg] = mine
    assert _index_files(prefixes["biscuit_tpu_torch"]) == \
        _index_files(prefixes["biscuit_tpu"])
    theirs_by_port = BisIndex.load(prefixes["biscuit_tpu"])
    ours_by_jax = JaxBisIndex.load(prefixes["biscuit_tpu_torch"])
    assert type(theirs_by_port) is BisIndex
    assert type(ours_by_jax) is JaxBisIndex
    _same_index(theirs_by_port, idx.jax)
    _same_index(ours_by_jax, idx.jax)


def test_bisindex_from_numpy_carries_every_field(data):
    _fa, _fq, idx = data
    assert type(idx.port) is BisIndex and type(idx.jax) is JaxBisIndex
    assert type(idx.port.par) is not type(idx.jax.par)
    assert all(type(a) is not type(b)
               for a, b in zip(idx.port.anns, idx.jax.anns))
    _same_index(idx.port, idx.jax)
    # plain arrays in, nothing of the giver's classes kept
    again = bisindex_from_numpy(**index_fields(idx.port))
    _same_index(again, idx.jax)


@pytest.mark.parametrize("name", ["nonsense", "mpileup", "QC", "view",
                                  "--version"])
def test_cli_answers_unknown_subcommands_as_the_jax_cli(name):
    """A name that neither CLI has: both write the same line to stderr,
    nothing to stdout, and exit 1."""
    from biscuit_tpu import cli as jcli
    from biscuit_tpu_torch import cli
    assert name not in cli.SUBCOMMANDS and name not in jcli.SUBCOMMANDS
    runs = [subprocess.run([sys.executable, "-m", f"{pkg}.cli", name],
                           cwd=REPO, env=_env(), capture_output=True,
                           text=True, timeout=120)
            for pkg in ("biscuit_tpu_torch", "biscuit_tpu")]
    for r in runs:
        assert (r.returncode, r.stdout, r.stderr) == \
            (1, "", f"Unknown subcommand: {name}\n")


def test_cli_has_every_subcommand_of_the_jax_cli():
    from biscuit_tpu import cli as jcli
    from biscuit_tpu_torch import cli
    assert list(cli.SUBCOMMANDS) == list(jcli.SUBCOMMANDS)
    assert not hasattr(cli, "NOT_PORTED")


# ---------------------------------------------------------------------------
# reads wider than the widest compiled strip, and the CLI's main
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["se", "pe"])
def test_reads_wider_than_the_widest_strip_align_on_the_device_engine(
        data, tmp_path, layout):
    """Reads of 560 bp, wider than the 512 columns of the widest compiled
    strip (on the card: the DP kernels' wide instance), go through the
    device engine like any other: no lane is sent elsewhere for its width,
    the ops meet queries over 512 columns, and the SAM is the port's host
    engine's."""
    from biscuit_tpu_torch.ops import strip_scan, sw_extend, sw_global, sw_local
    fa, _fq, idx = data
    pe = layout == "pe"
    wfa, wfq, _ = make_dataset(tmp_path, genome_size=60000, n_reads=4 if pe else 6,
                               n_chroms=2, seed=11, read_len=560, snp_rate=0.01,
                               indel_every=2, pe=pe, index=False)
    with open(fa, "rb") as f1, open(wfa, "rb") as f2:
        assert f1.read() == f2.read()       # the same seed: the same genome
    load = (lambda: load_pairs(*wfq)) if pe else (lambda: load_reads(wfq, 6))
    opt = _pe_opt if pe else _opt
    widths = collections.defaultdict(int)
    real = {}
    for mod, name in ((sw_extend, "sw_extend_batch"),
                      (sw_global, "sw_global_cigar"),
                      (sw_local, "sw_local_batch")):
        real[name] = getattr(mod, name)

    def spy(name):
        def fn(query, *a, **k):
            widths[name] = max(widths[name], query.shape[1])
            return real[name](query, *a, **k)
        return fn
    import biscuit_tpu_torch.align.device_engine as eng
    saved = (eng.sw_extend_batch, eng.sw_global_cigar, sw_local.sw_local_batch)
    eng.sw_extend_batch = spy("sw_extend_batch")
    eng.sw_global_cigar = spy("sw_global_cigar")
    sw_local.sw_local_batch = spy("sw_local_batch")
    try:
        reset_stages()
        seqs = load()
        process_seqs_device(opt(), tpipe.AlignerState(idx.port), seqs, 0,
                            device="cpu")
    finally:
        eng.sw_extend_batch, eng.sw_global_cigar, sw_local.sw_local_batch = saved
    host = load()
    tpipe.process_seqs(opt(), tpipe.AlignerState(idx.port), host, 0)
    assert [s.sam for s in seqs] == [s.sam for s in host]
    assert sum(not int(s.sam.split("\t")[1]) & 4 for s in seqs) >= len(seqs) - 1
    cap = 32 * max(strip_scan.STRIP_WIDTHS)
    assert widths["sw_global_cigar"] > cap
    assert strip_scan.strip_width(widths["sw_global_cigar"]) == strip_scan.WIDE
    if pe:
        assert widths["sw_local_batch"] > cap
    assert not any(k.endswith("_host_lanes") and k != "chain_host_lanes"
                   for k in stage_report())


def test_main_prints_the_summary_and_exit_codes_match_the_jax_cli(
        tmp_path, capsys):
    """`main` ends a subcommand that returned 0 with the three [main] lines
    on stderr, as biscuit_tpu/cli.py does; stdout is the subcommand's alone;
    `version`, no arguments and an unknown subcommand exit as there."""
    import re
    import shutil
    from biscuit_tpu import cli as jcli
    from biscuit_tpu_torch import __version__, cli as tcli
    fa = tmp_path / "g.fa"
    fa.write_text(">c\n" + "ACGTTGCAAGCTTGCATGCCTGCAGGTCGACT" * 8 + "\n")
    errs = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        own = tmp_path / name / "g.fa"
        own.parent.mkdir()
        shutil.copy(fa, own)
        capsys.readouterr()
        assert cli.main(["index", str(own)]) == 0
        out, err = capsys.readouterr()
        assert out == ""
        errs[name] = [ln for ln in err.splitlines() if ln.startswith("[main]")]
    assert len(errs["jax"]) == len(errs["port"]) == 3
    assert errs["port"][0] == f"[main] Version: {__version__}"
    assert errs["port"][1].startswith("[main] CMD: biscuit_tpu_torch index ")
    pat = r"\[main\] Real time: \d+\.\d{3} sec; CPU: \d+\.\d{3} sec"
    assert re.fullmatch(pat, errs["port"][2]) and re.fullmatch(pat, errs["jax"][2])
    for argv in (["version"], [], ["no_such_subcommand"]):
        capsys.readouterr()
        want = jcli.main(list(argv))
        capsys.readouterr()
        assert tcli.main(list(argv)) == want
        out, err = capsys.readouterr()
        assert "[main]" not in err
        assert (argv == ["version"]) == out.startswith("biscuit_tpu_torch ")


def test_cli_exits_quietly_on_a_broken_pipe(data):
    """`align ... | head -1`: the reader closes the pipe after the first
    line; the CLI exits 1 without a traceback, as the JAX package's."""
    fa, fq, _idx = data
    p = subprocess.Popen([sys.executable, "-m", "biscuit_tpu_torch.cli",
                          "align", fa, fq], cwd=REPO, env=_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    first = p.stdout.readline()
    p.stdout.close()
    err = p.stderr.read().decode()
    assert p.wait(timeout=300) == 1, err[-2000:]
    assert first.startswith(b"@SQ")
    assert "Traceback" not in err and "[main] Version" not in err
