"""The port's QC family (`bsstrand`, `bsconv`, `cinread`, `qc`, `tview`,
`bc`) and its companion scripts (`QC.py`, `flip_pbat_strands.py`,
`pybiscuit.py`) against the JAX package, on the CPU.

Each case runs `python -m biscuit_tpu_torch.cli <name>` (or
`python -m biscuit_tpu_torch.scripts.<script>`) and `python -m
biscuit_tpu.cli <name>` (or `scripts/<script>.py`) with the same arguments,
side by side, each writing into an empty directory of its own. Their exit
codes, stdout and every file written must be the same bytes (a gzip file is
compared decompressed: its header holds the time it was written), and their
stderr the same apart from the `[main]` summary lines, which name the
package and the run's times, with each run's directory read as `{out}`. The
family is host code in both packages: no kernel, no torch. The data: a
diploid SE sample and a PE sample of one 30 kbp genome from
tools/make_testdata.py, aligned, sorted and indexed by the port's own
`index`, `align` and `sort`, and piled up by its `pileup`.
"""
import io
import os
import subprocess
import sys
from collections import namedtuple

import numpy as np
import pytest

from biscuit_tpu_torch.io.sambam import AlignmentFile
from biscuit_tpu_torch.pileup.common import RefCache
from biscuit_tpu_torch.subcmds.cinread import (TGT_NAMES, TP_NAMES,
                                               CinreadConf, CinreadData,
                                               cinread_func)

from torch_testdata import (REPO, cli_env, diploid_dataset, run_cli,
                            tree_files)

PKGS = ("biscuit_tpu_torch", "biscuit_tpu")


def _env():
    """cli_env() without BISCUIT_TPU_PLATFORM, which makes biscuit_tpu
    import jax on start (3 s a process here): the family uses no jax."""
    env = cli_env()
    env.pop("BISCUIT_TPU_PLATFORM", None)
    return env


Run = namedtuple("Run", "rc stdout stderr files")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{name: path}: the genome (fa), a diploid SE sample of 400 reads
    (se_fq, se_bam) and a PE sample of 200 pairs (pe_fq1, pe_fq2, pe_bam) of
    100 bp, half from a haplotype with SNPs at 2%; both BAMs with a .bai;
    the PE sample's VCF from the port's `pileup` and the beta and coverage
    of its CpGs with the cytosine's base (cg_table: chrom, beg, end, beta,
    coverage, C or G), from vcf2bed -e; the QC assets of
    scripts/build_qc_assets.py (assets); where tview looks (tview_at: chr1
    where most PE reads begin in 100 bp)."""
    d = tmp_path_factory.mktemp("tqc")
    kw = dict(snp_rate=0.02, index=False, genome_size=30000, seed=23,
              read_len=100)
    fa, se_fq, _ = diploid_dataset(d / "se", n_reads=400, **kw)
    pe_fa, (fq1, fq2), _ = diploid_dataset(d / "pe", n_reads=200, pe=True,
                                           **kw)
    with open(fa) as f, open(pe_fa) as g:
        assert f.read() == g.read()   # one genome: one seed, one size
    paths = {"fa": fa, "se_fq": se_fq, "pe_fq1": fq1, "pe_fq2": fq2,
             "assets": str(d / "assets"), "vcf": str(d / "pe.vcf"),
             "cg_table": str(d / "cg.txt")}
    run_cli("biscuit_tpu_torch", ["index", fa])
    for name, fqs in (("se", [se_fq]), ("pe", [fq1, fq2])):
        sam, bam = str(d / f"{name}.sam"), str(d / f"{name}.bam")
        with open(sam, "w") as f:
            f.write(run_cli("biscuit_tpu_torch", ["align", fa, *fqs],
                            BISCUIT_TPU_TORCH_ENGINE="native").stdout)
        run_cli("biscuit_tpu_torch", ["sort", "-o", bam, sam])
        run_cli("biscuit_tpu_torch", ["bamindex", bam])
        paths[f"{name}_bam"] = bam
    run_cli("biscuit_tpu_torch", ["pileup", "-o", paths["vcf"], fa,
                                  paths["pe_bam"]],
            BISCUIT_TPU_TORCH_PILEUP="native")
    rows = [ln.split("\t") for ln in run_cli(
        "biscuit_tpu_torch", ["vcf2bed", "-t", "cg", "-e",
                              paths["vcf"]]).stdout.splitlines()]
    with open(paths["cg_table"], "w") as f:
        f.writelines("\t".join(r[:3] + r[7:9] + r[3:4]) + "\n" for r in rows)
    starts = np.array([r.pos for r in AlignmentFile(paths["pe_bam"])
                       if r.tid == 0])
    at = max(range(100, 15000, 50), key=lambda p: np.count_nonzero(
        (starts > p - 100) & (starts <= p)))
    paths["tview_at"] = f"chr1:{at}"
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "build_qc_assets.py"),
                    "-r", fa, "-o", paths["assets"], "-i"],
                   check=True, capture_output=True, timeout=300)
    return paths


def _command(pkg, script, args):
    if script is None:
        return [sys.executable, "-m", f"{pkg}.cli", *args]
    if pkg == "biscuit_tpu_torch":
        return [sys.executable, "-m", f"biscuit_tpu_torch.scripts.{script}",
                *args]
    return [sys.executable, os.path.join(REPO, "scripts", f"{script}.py"),
            *args]


def _both(data, tmp_path, argv, script=None):
    """argv ({out}: the run's own empty directory, {name}: a path of
    `data`) through each package at once: {package: Run}, stderr without
    its [main] lines and with the run's directory read as {out}."""
    procs = {}
    for pkg in PKGS:
        out = tmp_path / pkg
        out.mkdir()
        args = [a.format(out=out, **data) for a in argv]
        procs[pkg] = out, subprocess.Popen(
            _command(pkg, script, args), cwd=REPO, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    runs = {}
    for pkg, (out, p) in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        stderr = "".join(ln for ln in stderr.decode().splitlines(True)
                         if not ln.startswith("[main] "))
        runs[pkg] = Run(p.returncode, stdout, stderr.replace(str(out), "{out}"),
                        tree_files(out))
    return runs


def _same(data, tmp_path, argv, script=None):
    """The port's Run, which must equal the JAX package's and exit 0."""
    runs = _both(data, tmp_path, argv, script)
    mine, theirs = runs["biscuit_tpu_torch"], runs["biscuit_tpu"]
    assert (mine.rc, theirs.rc) == (0, 0), mine.stderr[-3000:]
    assert mine.stderr == theirs.stderr
    assert mine.stdout == theirs.stdout
    assert mine.files == theirs.files
    return mine


def _records(text):
    return [ln for ln in text.splitlines() if ln and not ln.startswith("@")]


# id -> bsstrand's arguments: the report alone, -c (correct YD) and -y (YC,
# YG counts), to a BAM, a SAM file and stdout (-), and a -g region
BSSTRAND = {
    "report_se": ["{fa}", "{se_bam}"],
    "correct_to_bam": ["-c", "{fa}", "{pe_bam}", "{out}/c.bam"],
    "correct_counts_to_stdout": ["-c", "-y", "{fa}", "{pe_bam}", "-"],
    "keep_to_bam": ["{fa}", "{pe_bam}", "{out}/k.bam"],
    "keep_to_stdout": ["{fa}", "{se_bam}", "-"],
    "keep_region_to_sam": ["-g", "chr1:2000-12000", "{fa}", "{se_bam}",
                           "{out}/k.sam"],
}


@pytest.mark.parametrize("case", list(BSSTRAND))
def test_bsstrand_matches_jax_package(data, tmp_path, case):
    run = _same(data, tmp_path, ["bsstrand", *BSSTRAND[case]])
    assert "Mapped reads: " in run.stderr and "Confusion counts" in run.stderr
    assert int(run.stderr.split("Mapped reads: ")[1].split()[0]) > 50
    if case == "correct_counts_to_stdout":
        recs = _records(run.stdout.decode())
        assert len(recs) > 300 and all("\tYC:i:" in r for r in recs
                                       if not int(r.split("\t")[1]) & 4)
    elif case == "keep_to_stdout":
        assert len(_records(run.stdout.decode())) > 300
    elif len(BSSTRAND[case]) > 2:
        blob, = run.files.values()
        assert len(blob) > 1000


# id -> bsconv's arguments: -p tab rows; filters by CpH retention count (-m)
# and fraction (-f), -u, -v (show the filtered reads, ZN tagged), -a with a
# -g region; to stdout (-), a BAM and a SAM file
BSCONV = {
    "tab": ["-p", "{fa}", "{pe_bam}"],
    "max_cph_to_bam": ["-m", "2", "{fa}", "{pe_bam}", "{out}/m.bam"],
    "cph_frac_u_to_sam": ["-f", "0.1", "-u", "{fa}", "{se_bam}",
                          "{out}/f.sam"],
    "show_filtered": ["-v", "-m", "1", "{fa}", "{se_bam}"],
    "max_cpa_region": ["-a", "1", "-g", "chr2", "{fa}", "{pe_bam}", "-"],
}


@pytest.mark.parametrize("case", list(BSCONV))
def test_bsconv_matches_jax_package(data, tmp_path, case):
    run = _same(data, tmp_path, ["bsconv", *BSCONV[case]])
    assert "[main_bsconv] Processed " in run.stderr
    if case == "tab":
        rows = [ln.split("\t") for ln in run.stdout.decode().splitlines()
                if not ln.startswith("@")]
        assert len(rows) > 300 and all(len(r) == 9 for r in rows)
    elif run.files:
        blob, = run.files.values()
        assert len(blob) > 1000
    else:
        recs = _records(run.stdout.decode())
        assert len(recs) > 10 and all("\tZN:Z:CA_R" in r for r in recs)


# id -> cinread's arguments: each target (-t), and every column (-p) with
# secondary alignments kept (-s) into a file (-o)
CINREAD = {t: ["-t", t, "{fa}", "{pe_bam}"] for t in TGT_NAMES}
CINREAD["all_columns_to_file"] = ["-t", "c", "-s", "-p", ",".join(TP_NAMES),
                                  "-o", "{out}/cin.txt", "{fa}", "{se_bam}"]


@pytest.mark.parametrize("case", list(CINREAD))
def test_cinread_matches_jax_package(data, tmp_path, case):
    run = _same(data, tmp_path, ["cinread", *CINREAD[case]])
    text = (run.files["cin.txt"] if run.files else run.stdout).decode()
    rows = [ln.split("\t") for ln in text.splitlines()]
    n_cols = len(TP_NAMES) if run.files else 5
    assert len(rows) > 100 and all(len(r) == n_cols for r in rows)


def test_cinread_vectorized_counts_match_scalar(data):
    """The port's cinread_func: its vectorized count path (skip_printing,
    which qc takes) counts what its per-site walk counts, for every
    target."""
    af = AlignmentFile(data["pe_bam"])
    rs = RefCache(data["fa"])
    names = af.header.names
    for tgt in range(len(TGT_NAMES)):
        c1 = CinreadConf(tgt=tgt, skip_printing=0)
        c2 = CinreadConf(tgt=tgt, skip_printing=1)
        d1, d2 = CinreadData(), CinreadData()
        sink = io.StringIO()
        for b in af:
            cinread_func(b, rs, c1, d1, names, sink)
            cinread_func(b, rs, c2, d2, names, sink)
        assert np.array_equal(d1.counts, d2.counts), tgt
        assert d2.counts.sum() > 0 and sink.getvalue(), tgt


# qc's tables: the PE sample with its insert sizes, the SE sample with -s
QC_SUFFIXES = ("_mapq_table.txt", "_dup_report.txt", "_strand_table.txt",
               "_totalReadConversionRate.txt", "_CpGRetentionByReadPos.txt",
               "_CpHRetentionByReadPos.txt")


@pytest.mark.parametrize("layout", ["pe", "se"])
def test_qc_matches_jax_package(data, tmp_path, layout):
    opts = ["-s"] if layout == "se" else []
    run = _same(data, tmp_path, ["qc", *opts, "{fa}", "{%s_bam}" % layout,
                                 "{out}/s"])
    want = {"s" + x for x in QC_SUFFIXES}
    if layout == "pe":
        want.add("s_isize_table.txt")
        assert run.files["s_isize_table.txt"].count(b"\n") > 50
    assert set(run.files) == want
    conv = run.files["s_totalReadConversionRate.txt"].decode().split("\n")
    assert len(conv[2].split("\t")) == 4


@pytest.mark.parametrize("mode", ["t", "m", "b", "n"])
def test_tview_dump_matches_jax_package(data, tmp_path, mode):
    run = _same(data, tmp_path, ["tview", "-d", "-g", "{tview_at}", "-w", "60",
                                 "-c", mode, "{pe_bam}", "{fa}"])
    lines = run.stdout.decode().splitlines()
    assert len(lines) > 6 and max(map(len, lines)) >= 60


# id -> bc's arguments: SE and PE, to stdout and into .fq.gz files (-o),
# the barcode in mate 2 (-m) at another place and length (-s, -l)
BC = {
    "se_stdout": ["{se_fq}"],
    "se_file": ["-o", "{out}/bc", "{se_fq}"],
    "pe_files": ["-o", "{out}/bc", "{pe_fq1}", "{pe_fq2}"],
    "pe_mate2_stdout": ["-m", "2", "-s", "3", "-l", "6", "{pe_fq1}",
                        "{pe_fq2}"],
}


@pytest.mark.parametrize("case", list(BC))
def test_bc_matches_jax_package(data, tmp_path, case):
    run = _same(data, tmp_path, ["bc", *BC[case]])
    text = b"".join(run.files.values()) or run.stdout
    heads = text.decode().splitlines()[::4]
    assert len(heads) >= 400 and all("_AAAAAAAA " in h for h in heads)
    want = {"se_file": {"bc.fq.gz"},
            "pe_files": {"bc_R1.fq.gz", "bc_R2.fq.gz"}}.get(case, set())
    assert set(run.files) == want


@pytest.mark.parametrize("vcf", [False, True])
def test_qc_script_matches_jax_script(data, tmp_path, vcf):
    """QC.py on the assets of scripts/build_qc_assets.py: the coverage and
    uniformity tables, qc's tables, and with -v the conversion rates of the
    VCF."""
    opts = ["-v", "{vcf}"] if vcf else []
    run = _same(data, tmp_path, [*opts, "-o", "{out}/qc", "{assets}", "{fa}",
                                 "s", "{pe_bam}"], script="QC")
    assert "Finished BISCUIT QC" in run.stderr
    assert "qc/s_covdist_all_cpg_topgc_table.txt" in run.files
    assert ("qc/s_totalBaseConversionRate.txt" in run.files) == vcf
    assert len(run.files) == 7 + 13 + vcf


@pytest.mark.parametrize("region", [None, "chr1:1000-20000"])
def test_flip_pbat_strands_matches_jax_script(data, tmp_path, region):
    """The flipped BAM and its .bai; flipping the flipped BAM again gives
    back the input's records."""
    opts = ["-r", region] if region else []
    run = _same(data, tmp_path, [*opts, "{pe_bam}", "{out}/f.bam"],
                script="flip_pbat_strands")
    assert set(run.files) == {"f.bam", "f.bam.bai"}
    flipped = tmp_path / "biscuit_tpu_torch" / "f.bam"
    back = tmp_path / "back.bam"
    subprocess.run([sys.executable, "-m",
                    "biscuit_tpu_torch.scripts.flip_pbat_strands", *opts,
                    str(flipped), str(back)], cwd=REPO, env=_env(),
                   check=True, capture_output=True, timeout=300)
    key = lambda r: (r.qname, r.flag, r.tid, r.pos, r.cigar, r.seq, r.qual,
                     r.tags)
    inp = AlignmentFile(data["pe_bam"])
    want = [key(r) for r in (inp.fetch(inp.header.name2tid("chr1"), 1000,
                                       20000) if region else inp)]
    got = [key(r) for r in AlignmentFile(str(back))]
    assert got == want and len(want) > 100
    assert all(r.flag != s.flag for r, s in zip(
        AlignmentFile(str(flipped)), AlignmentFile(str(back))))


@pytest.mark.parametrize("case", ["to_mr", "to_methylKit"])
def test_pybiscuit_matches_jax_script(data, tmp_path, case):
    argv = (["to_mr", "-i", "{pe_bam}", "-o", "{out}/x.mr"] if case == "to_mr"
            else ["to_methylKit", "-i", "{cg_table}", "-o", "{out}/x.txt"])
    run = _same(data, tmp_path, argv, script="pybiscuit")
    rows = [ln.split("\t") for ln in
            next(iter(run.files.values())).decode().splitlines()]
    assert len(rows) > 50
    assert all(len(r) == (8 if case == "to_mr" else 7) for r in rows)


def test_qc_family_imports_neither_jax_nor_the_jax_package_nor_torch(
        data, tmp_path):
    """qc and tview -d through the port's CLI in one process: no module of
    jax, of the JAX package, of torch or curses is imported, and qc writes
    the tables of the JAX package's CLI."""
    prefix = str(tmp_path / "mine" / "s")
    os.makedirs(os.path.dirname(prefix))
    code = (
        "import contextlib, io, sys\n"
        "from biscuit_tpu_torch import cli\n"
        f"assert cli.main(['qc', {data['fa']!r}, {data['pe_bam']!r}, "
        f"{prefix!r}]) == 0\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    assert cli.main(['tview', '-d', {data['pe_bam']!r}, "
        f"{data['fa']!r}]) == 0\n"
        "theirs = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'biscuit_tpu', 'torch', 'curses')]\n"
        "print(not theirs, theirs[:3])\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[0] == "True", r.stdout
    theirs = str(tmp_path / "theirs" / "s")
    os.makedirs(os.path.dirname(theirs))
    subprocess.run([sys.executable, "-m", "biscuit_tpu.cli", "qc", data["fa"],
                    data["pe_bam"], theirs], cwd=REPO, env=_env(), check=True,
                   capture_output=True, timeout=300)
    assert tree_files(os.path.dirname(prefix)) == \
        tree_files(os.path.dirname(theirs))
