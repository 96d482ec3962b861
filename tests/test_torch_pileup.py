"""The torch port's pileup slice (sorted BAM to VCF) vs the JAX package, on
the CPU.

K9, the window count scatter-add: the port's plain version must equal the
JAX function `pileup_count_window` (XLA on the CPU) exactly, and the port's
`_device_counts` the JAX package's and the numpy bincount branch of its
engine on a real window. The slice as a whole: the port's `pileup` CLI under
its `device` engine (BISCUIT_TPU_TORCH_PILEUP=device) must write the VCF
(apart from the `##program` line, which holds the command line) and the
`_meth_average.tsv` that `python -m biscuit_tpu.cli pileup` writes under
BISCUIT_TPU_PILEUP=numpy and =device; its `sort` and `bamindex`
the same BAM and .bai; and its subprocess imports neither jax nor the JAX
package. The data come from tools/make_testdata.py and the port's own
`index`, `align` and `sort`.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from biscuit_tpu.parallel.mesh import pileup_count_window as jax_count
from biscuit_tpu.pileup import engine as jengine
from biscuit_tpu_torch.io.sambam import AlignmentFile
from biscuit_tpu_torch.ops.pileup_count import (pileup_count_window,
                                                pileup_count_window_plain,
                                                pileup_window_counts,
                                                pileup_window_counts_plain)
from biscuit_tpu_torch.pileup import engine as tengine
from biscuit_tpu_torch.pileup.common import NCONTXTS, RefCache

from torch_testdata import (REPO, WINDOW_KINDS, make_dataset,
                            window_count_case, window_count_inputs)

torch.set_num_threads(1)

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# K9 against the JAX function
# ---------------------------------------------------------------------------

def _count_case(kind, window, n_codes, rng):
    """(positions, stat, valid) as int64 / bool numpy arrays."""
    if kind == "empty":
        n = 0
    elif kind == "one_site":
        n = 500
    else:
        n = 4000
    pos = rng.integers(0, window, n)
    if kind == "one_site":
        pos[:] = window // 3
    if kind == "sorted":  # as reads in coordinate order give them
        pos = np.sort(pos)
    stat = rng.integers(0, min(n_codes, 21), n)
    valid = rng.random(n) >= (0.0 if kind == "all_valid" else 0.1)
    return pos, stat, valid


@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("n_codes", [32, 1])
@pytest.mark.parametrize("kind", ["mixed", "sorted", "all_valid", "empty",
                                  "one_site"])
def test_pileup_count_plain_matches_jax(kind, n_codes, dtype):
    import jax.numpy as jnp
    window = 700
    rng = np.random.default_rng(3)
    pos, stat, valid = _count_case(kind, window, n_codes, rng)
    # the JAX function takes int32 (no x64); the port takes either width
    want = np.asarray(jax_count(jnp.asarray(pos.astype(np.int32)),
                                jnp.asarray(stat.astype(np.int32)),
                                jnp.asarray(valid), window, n_codes))
    args = (torch.from_numpy(pos.astype(dtype)),
            torch.from_numpy(stat.astype(dtype)), torch.from_numpy(valid))
    got = pileup_count_window_plain(*args, window, n_codes)
    assert got.dtype == torch.int32 and got.shape == (window, n_codes)
    assert np.array_equal(got.numpy(), want)  # integer counts: exact
    assert int(got.sum()) == int(valid.sum())
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(pileup_count_window(*args, window, n_codes), got)


@pytest.mark.parametrize("where", ["position_high", "position_negative",
                                   "code_high", "code_negative"])
def test_pileup_count_refuses_an_index_out_of_range(where):
    """XLA drops an index past the end and wraps a negative one; the port
    raises, unless the datum's `valid` is false."""
    window, n_codes = 50, 32
    pos = torch.arange(40)
    stat = torch.arange(40) % 21
    valid = torch.ones(40, dtype=torch.bool)
    {"position_high": pos, "position_negative": pos,
     "code_high": stat, "code_negative": stat}[where][7] = \
        {"position_high": window, "position_negative": -1,
         "code_high": n_codes, "code_negative": -2}[where]
    with pytest.raises(ValueError, match="1 valid data outside"):
        pileup_count_window(pos, stat, valid, window, n_codes)
    valid[7] = False
    got = pileup_count_window(pos, stat, valid, window, n_codes)
    assert int(got.sum()) == 39


def test_pileup_count_refuses_other_types_and_shapes():
    pos = torch.arange(8)
    ok = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        pileup_count_window(pos, pos.to(torch.int32), ok, 10)
    with pytest.raises(ValueError):
        pileup_count_window(pos, pos, ok.to(torch.uint8), 10)
    with pytest.raises(ValueError):
        pileup_count_window(pos, pos[:4], ok, 10)
    with pytest.raises(ValueError):
        pileup_count_window(pos.float(), pos.float(), ok, 10)


# ---------------------------------------------------------------------------
# the data of the slice: the port's index, align, sort
# ---------------------------------------------------------------------------

def _env(**more):
    env = dict(os.environ)
    env["BISCUIT_TPU_TORCH_DEVICE"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env.update(more)
    return env


def _cli(pkg, argv, stdout=None, **env):
    r = subprocess.run([sys.executable, "-m", pkg + ".cli", *argv], cwd=REPO,
                       env=_env(**env), stdout=stdout, stderr=subprocess.PIPE,
                       text=True, timeout=600)
    assert r.returncode == 0, (pkg, argv, r.stderr[-3000:])
    return r


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """A 30 kbp genome of 2 chromosomes, 400 directional WGBS reads of 100 bp
    with SNPs at 1%, aligned and sorted by the port's CLI: (fasta, SAM,
    sorted BAM, the same BAM under a second name)."""
    d = tmp_path_factory.mktemp("tplp")
    fa, fq, _ = make_dataset(d, genome_size=30000, n_reads=400, seed=13,
                             snp_rate=0.01, index=False)
    _cli("biscuit_tpu_torch", ["index", fa])
    sam = str(d / "aln.sam")
    with open(sam, "w") as f:
        _cli("biscuit_tpu_torch", ["align", fa, fq], stdout=f)
    out = str(d / "aln.bam")
    _cli("biscuit_tpu_torch", ["sort", "-o", out, sam])
    twin = str(d / "twin.bam")
    with open(out, "rb") as f, open(twin, "wb") as g:
        g.write(f.read())
    return fa, sam, out, twin


# ---------------------------------------------------------------------------
# _device_counts on a real window
# ---------------------------------------------------------------------------

def test_device_counts_match_jax_and_numpy(bam, monkeypatch):
    """The datum arrays of one real window, caught where the port's window
    function hands them over: the port's count matrices equal the JAX
    package's (its scatter-add under XLA) and the numpy bincount branch of
    its engine (engine.py, _pileup_window_fast)."""
    fa, _sam, path, twin = bam
    caught = []
    real = tengine._device_counts
    monkeypatch.setattr(tengine, "_device_counts",
                        lambda *a: caught.append(a) or real(*a))
    bams = [AlignmentFile(path), AlignmentFile(twin)]
    hdr = bams[0].header
    conf = tengine.PileupConf()
    bs = [[0.0] * NCONTXTS for _ in bams]
    cs = [[0] * NCONTXTS for _ in bams]
    tengine.reset_stages()
    text = tengine.pileup_window(bams, RefCache(fa), conf, 0, hdr.names[0], 1,
                                 hdr.lengths[0], bs, cs, CPU)
    assert text.count("\n") > 500 and len(caught) == 1
    p, sid, stat, passm, P, n_bams, device = caught[0]
    assert device is CPU and n_bams == 2 and P == hdr.lengths[0] - 1
    assert len(p) > 10000 and 0 < passm.sum() < len(p) and set(sid) == {0, 1}
    st = tengine.STAGES
    assert st["windows"] == 1 and st["data"] == len(p)
    assert st["sites"] == text.count("\n")
    assert min(st["decode"], st["count"], st["emit"]) > 0

    cm, cb, dp = real(p, sid, stat, passm, P, n_bams, CPU)
    assert cm.shape == (P, 2, 3) and cb.shape == (P, 2, 7) and dp.shape == (P, 2)
    assert cm.dtype == cb.dtype == dp.dtype == np.int64
    jcm, jcb, jdp = jengine._device_counts(p, sid, stat, passm, P, n_bams)
    for got, want in ((cm, jcm), (cb, jcb), (dp, jdp)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    # the numpy branch
    ndp = np.bincount(p * n_bams + sid, minlength=P * n_bams).reshape(P, n_bams)
    pp, ps, pstat = p[passm], sid[passm], stat[passm]
    ncm = np.bincount((pp * n_bams + ps) * 3 + (pstat & 0xF),
                      minlength=P * n_bams * 3).reshape(P, n_bams, 3)
    ncb = np.bincount((pp * n_bams + ps) * 7 + (pstat >> 4),
                      minlength=P * n_bams * 7).reshape(P, n_bams, 7)
    assert np.array_equal(cm, ncm) and np.array_equal(cb, ncb)
    assert np.array_equal(dp, ndp) and dp.sum() == len(p)


def _split(counts, P, n_bams):
    """cm, cb, dp as int64 numpy from the fused [P * n_bams, 11] counts."""
    c = counts.numpy().reshape(P, n_bams, 11).astype(np.int64)
    return c[..., 0:3], c[..., 3:10], c[..., 10]


def _fused_matches_jax(p, sid, stat, passm, P, n_bams):
    """The fused plain op, the wrapper on CPU tensors and the port's
    _device_counts (its staging included) against the JAX package's
    _device_counts: every count equal."""
    (sites, codes, ok), window = window_count_inputs(p, sid, stat, passm, P,
                                                     n_bams)
    args = tuple(torch.from_numpy(a) for a in (sites, codes, ok))
    got = pileup_window_counts_plain(*args, window)
    assert got.dtype == torch.int32 and got.shape == (window, 11)
    counts, n_wide = pileup_window_counts(*args, window)
    assert torch.equal(counts, got) and n_wide is None
    want = jengine._device_counts(p, sid, stat, passm, P, n_bams)
    engine = tengine._device_counts(p, sid, stat, passm, P, n_bams, CPU)
    for g, e, w in zip(_split(got, P, n_bams), engine, want):
        assert np.array_equal(g, w) and np.array_equal(e, w)
        assert e.dtype == w.dtype == np.int64 and e.shape == w.shape
    assert int(got[:, 10].sum()) == len(p)   # every datum in the depth
    return got


@pytest.mark.parametrize("n_bams", [1, 2], ids=["one_sample", "two_samples"])
def test_window_counts_plain_matches_jax_device_counts(bam, monkeypatch,
                                                       n_bams):
    """The fused count (cm, cb and dp in one call) on the datum arrays of a
    real window, caught where the port's window function hands them over."""
    fa, _sam, path, twin = bam
    caught = []
    real = tengine._device_counts
    monkeypatch.setattr(tengine, "_device_counts",
                        lambda *a: caught.append(a) or real(*a))
    bams = [AlignmentFile(path), AlignmentFile(twin)][:n_bams]
    hdr = bams[0].header
    tengine.pileup_window(bams, RefCache(fa), tengine.PileupConf(), 0,
                          hdr.names[0], 1, hdr.lengths[0],
                          [[0.0] * NCONTXTS for _ in bams],
                          [[0] * NCONTXTS for _ in bams], CPU)
    p, sid, stat, passm, P, nb, _device = caught[0]
    assert nb == n_bams and len(p) > 10000 and 0 < passm.sum() < len(p)
    _fused_matches_jax(p, sid, stat, passm, P, nb)


@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_window_counts_edge_cases_match_jax(kind):
    """Windows the real ones rarely are: shuffled data, two samples, every
    datum on one site, no data, and passing codes in [21, 32), which the
    JAX engine's counts[:, :21] drops from cm and cb (and which count in
    the depth)."""
    p, sid, stat, passm, P, n_bams = window_count_case(kind, seed=5)
    got = _fused_matches_jax(p, sid, stat, passm, P, n_bams)
    if kind == "code_21_to_31":
        odd = passm & ((stat >> 4) * 3 + (stat & 0xF) >= 21)
        assert odd.any()
        assert int(got[:, :3].sum()) == int(got[:, 3:10].sum()) \
            == int(passm.sum() - odd.sum())
    if kind == "empty":
        assert len(p) == 0 and not got.any()


@pytest.mark.parametrize("where", ["site_high_not_passing", "site_negative",
                                   "code_32_passing"])
def test_window_counts_refuse_a_datum_out_of_range(where):
    """Every datum counts in the depth, so a site out of range raises
    whatever its pass flag; a code outside [0, 32) raises where it passes
    (the JAX function would spill it into the next site's bins)."""
    (sites, codes, ok), window = window_count_inputs(
        *window_count_case("sorted", seed=2, P=50, n=40))
    sites, codes, ok = (torch.from_numpy(a) for a in (sites, codes, ok))
    if where == "site_high_not_passing":
        sites[7], ok[7] = window, False
    elif where == "site_negative":
        sites[7] = -1
    else:
        codes[7], ok[7] = 32, True
    for fn in (pileup_window_counts_plain, pileup_window_counts):
        with pytest.raises(ValueError, match="1 data outside"):
            fn(sites, codes, ok, window)
    if where == "code_32_passing":
        ok[7] = False
        got = pileup_window_counts_plain(sites, codes, ok, window)
        assert int(got[:, 10].sum()) == 40 and int(got[:, :3].sum()) == \
            int(ok.sum())


# ---------------------------------------------------------------------------
# the slice as a whole, through both CLIs
# ---------------------------------------------------------------------------

# id -> (options, number of BAMs)
CONFIGS = {
    "one_sample": (["-@", "1"], 1),
    "two_samples": (["-@", "1"], 2),
    "nome": (["-N", "-@", "1"], 1),
    "verbose": (["-v", "1", "-@", "1"], 1),       # the per-datum path
    "serial_windows": (["-s", "4000", "-@", "1"], 1),
    "pooled_windows": (["-s", "4000"], 2),        # -@ 3: the fork pool
}
_RUNS = {}  # (package, mode, config) -> (VCF lines without ##program, tsv)


def _pileup(pkg, mode, config, bam, tmp):
    key = (pkg, mode, config)
    if key not in _RUNS:
        fa, _sam, path, twin = bam
        opts, n_bams = CONFIGS[config]
        out = os.path.join(tmp, f"{pkg}_{mode}_{config}.vcf")
        # the port's device engine, whichever engine is its default
        env = {"BISCUIT_TPU_PILEUP": mode} if mode else \
            {"BISCUIT_TPU_TORCH_PILEUP": "device"}
        _cli(pkg, ["pileup", *opts, "-o", out, fa, *(path, twin)[:n_bams]],
             **env)
        with open(out) as f:
            vcf = [ln for ln in f if not ln.startswith("##program")]
        with open(out + "_meth_average.tsv") as f:
            _RUNS[key] = (vcf, f.read())
    return _RUNS[key]


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tplp_out"))


# JAX in a forked window worker is not safe, so the JAX package's device
# mode runs with one worker (as tests/test_multichip.py runs it)
@pytest.mark.parametrize("mode,config", [
    (m, c) for c in CONFIGS for m in ("numpy", "device")
    if not (m == "device" and c == "pooled_windows")])
def test_pileup_cli_matches_jax_package(bam, outdir, mode, config):
    vcf, tsv = _pileup("biscuit_tpu_torch", "", config, bam, outdir)
    jvcf, jtsv = _pileup("biscuit_tpu", mode, config, bam, outdir)
    assert vcf == jvcf
    assert tsv == jtsv and tsv.count("\n") >= 3
    body = [ln for ln in vcf if not ln.startswith("#")]
    assert len(body) > 1000
    assert sum("CV:BT" in ln for ln in body) > 500       # methylation lines
    assert sum(ln.split("\t")[4] != "." for ln in body) > 20   # ALT alleles
    if config == "verbose":
        assert all("DIAGNOSE" in ln for ln in body)
    if config == "two_samples":
        assert all(len(ln.split("\t")) == 11 for ln in body)


def test_pileup_windows_give_one_vcf(bam, outdir):
    """One window a chromosome, 4 kbp windows in order in one process, and
    4 kbp windows from the fork pool: the same records."""
    whole = _pileup("biscuit_tpu_torch", "", "one_sample", bam, outdir)[0]
    serial = _pileup("biscuit_tpu_torch", "", "serial_windows", bam, outdir)[0]
    assert [ln for ln in whole if ln[0] != "#"] == \
        [ln for ln in serial if ln[0] != "#"]
    two = _pileup("biscuit_tpu_torch", "", "two_samples", bam, outdir)[0]
    pooled = _pileup("biscuit_tpu_torch", "", "pooled_windows", bam, outdir)[0]
    assert [ln for ln in two if ln[0] != "#"] == \
        [ln for ln in pooled if ln[0] != "#"]


@pytest.mark.parametrize("spill", [False, True], ids=["in_memory", "spilled"])
def test_sort_and_bamindex_match_jax_package(bam, tmp_path, spill):
    """`sort` (also through its -m spill runs, which write temporary BAMs)
    and `bamindex`: the BAM and the .bai of both CLIs are the same bytes."""
    _fa, sam, sorted_bam, _twin = bam
    opts = ["-m", "150"] if spill else []
    outs = {}
    for pkg in ("biscuit_tpu_torch", "biscuit_tpu"):
        out = str(tmp_path / f"{pkg}.bam")
        _cli(pkg, ["sort", *opts, "-o", out, sam])
        _cli(pkg, ["bamindex", out])
        with open(out, "rb") as f, open(out + ".bai", "rb") as g:
            outs[pkg] = (f.read(), g.read())
    assert outs["biscuit_tpu_torch"] == outs["biscuit_tpu"]
    with open(sorted_bam, "rb") as f:
        assert outs["biscuit_tpu_torch"][0] == f.read()
    recs = list(AlignmentFile(str(tmp_path / "biscuit_tpu_torch.bam")))
    keys = [(r.tid if r.tid >= 0 else 1 << 30, r.pos) for r in recs]
    assert len(recs) >= 400 and keys == sorted(keys)


def test_pileup_subprocess_imports_neither_jax_nor_the_jax_package(bam, tmp_path):
    fa, _sam, path, _twin = bam
    out = str(tmp_path / "o.vcf")
    code = (
        "import sys\n"
        "from biscuit_tpu_torch import cli\n"
        f"rc = cli.main(['pileup', '-o', {out!r}, {fa!r}, {path!r}])\n"
        "theirs = [m for m in sys.modules if m == 'jax' or m == 'biscuit_tpu'\n"
        "          or m.startswith(('jax.', 'biscuit_tpu.'))]\n"
        "print(rc, not theirs)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_env(BISCUIT_TPU_TORCH_PILEUP="device"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["0", "True"]
    with open(out) as f:
        assert sum(1 for ln in f if ln[0] != "#") > 1000
