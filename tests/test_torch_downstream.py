"""The port's subcommands downstream of `pileup` vs the JAX package, on the
CPU: `vcf2bed`, `mergecg`, `epiread`, `rectangle` and `asm`.

Each case runs the port's CLI in a subprocess and `python -m biscuit_tpu.cli`
with the same arguments in its default mode, and the outputs must be the
same bytes. `vcf2bed` and `mergecg` run on the port's C++ line filters
(streams_native.cpp) and on its Python line walk
(BISCUIT_TPU_TORCH_STREAMS=python); `epiread` on the C++ raw-BAM window
engine and on the Python window walk (BISCUIT_TPU_TORCH_PILEUP=device), in
one process and in its fork pool; the JAX package runs its C++ paths.
None of those subcommands imports jax, the JAX package or torch. The data
come from tools/make_testdata.py and the port's own `index`, `align`,
`sort` and `pileup`.
"""
import subprocess
import sys
from collections import defaultdict

import pytest

from torch_testdata import REPO, cli_env, diploid_dataset, run_cli


def _cli(pkg, argv, **env):
    """stdout of the CLI of `pkg`, which must exit 0."""
    return run_cli(pkg, argv, **env).stdout


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 30 kbp genome of 2 chromosomes and a diploid sample of it: 400
    pairs of 100 bp directional WGBS reads from a haplotype with SNPs at 2%
    and 400 from the reference, so that SNPs are heterozygous and `asm` has
    two alleles to test. Aligned by the port's native engine, sorted and
    indexed, and piled up by the port into a VCF and a NOMe-seq (-N) VCF;
    the CpG and NOMe HCG beds and the SNP bed of those made by the JAX
    package: {name: path}."""
    d = tmp_path_factory.mktemp("tdown")
    fa, fqs, _ = diploid_dataset(d, n_reads=800, snp_rate=0.02, pe=True,
                                 index=False, genome_size=30000, seed=17,
                                 read_len=100)
    _cli("biscuit_tpu_torch", ["index", fa])
    paths = {"fa": fa, "sam": str(d / "aln.sam"), "bam": str(d / "aln.bam")}
    with open(paths["sam"], "w") as f:
        f.write(_cli("biscuit_tpu_torch", ["align", fa, *fqs],
                     BISCUIT_TPU_TORCH_ENGINE="native"))
    _cli("biscuit_tpu_torch", ["sort", "-o", paths["bam"], paths["sam"]])
    _cli("biscuit_tpu_torch", ["bamindex", paths["bam"]])
    for name, opts in (("vcf", []), ("nome_vcf", ["-N"])):
        paths[name] = str(d / f"{name}.vcf")
        _cli("biscuit_tpu_torch", ["pileup", *opts, "-o", paths[name], fa,
                                   paths["bam"]],
             BISCUIT_TPU_TORCH_PILEUP="native")
    for name, opts, vcf in (("cg_bed", ["-t", "cg"], "vcf"),
                            ("hcg_bed", ["-t", "hcg"], "nome_vcf"),
                            ("snp_bed", ["-t", "snp"], "vcf")):
        paths[name] = str(d / f"{name}.bed")
        with open(paths[name], "w") as f:
            f.write(_cli("biscuit_tpu", ["vcf2bed", *opts, paths[vcf]]))
    return paths


_RUNS = {}  # (package, environment, arguments) -> stdout


def _run(data, pkg, argv, **env):
    """The CLI's stdout on the arguments `argv`, with the paths of `data`
    as {name}; each run once."""
    argv = tuple(a.format(**data) for a in argv)
    key = (pkg, tuple(sorted(env.items())), argv)
    if key not in _RUNS:
        _RUNS[key] = _cli(pkg, list(argv), **env)
    return _RUNS[key]


def _rows(text):
    return [ln.split("\t") for ln in text.splitlines()]


# id -> (vcf2bed's options, its VCF)
VCF2BED = {
    "cg": (["-t", "cg"], "vcf"),
    "ch": (["-t", "ch"], "vcf"),
    "c_context_mu": (["-t", "c", "-e", "-c"], "vcf"),
    "cg_min_depth_2": (["-t", "cg", "-k", "2"], "vcf"),
    "snp": (["-t", "snp"], "vcf"),
    "hcg": (["-t", "hcg"], "nome_vcf"),
    "gch": (["-t", "gch"], "nome_vcf"),
}


@pytest.mark.parametrize("stream", ["native", "python"])
@pytest.mark.parametrize("case", list(VCF2BED))
def test_vcf2bed_matches_jax_package(data, case, stream):
    opts, vcf = VCF2BED[case]
    argv = ["vcf2bed", *opts, "{%s}" % vcf]
    got = _run(data, "biscuit_tpu_torch", argv,
               BISCUIT_TPU_TORCH_STREAMS=stream)
    assert got == _run(data, "biscuit_tpu", argv)
    rows = _rows(got)
    assert len(rows) > (20 if case == "snp" else 300)
    if case != "snp":
        assert all(int(r[2]) == int(r[1]) + 1 for r in rows)
    if "-e" not in opts and case != "snp":   # -e puts the context first
        assert all(r[3] == "." or 0 <= float(r[3]) <= 1 for r in rows)


@pytest.mark.parametrize("stream", ["native", "python"])
@pytest.mark.parametrize("case", ["cg", "nome"])
def test_mergecg_matches_jax_package(data, case, stream):
    argv = (["mergecg", "{fa}", "{cg_bed}"] if case == "cg" else
            ["mergecg", "-N", "-c", "{fa}", "{hcg_bed}"])
    got = _run(data, "biscuit_tpu_torch", argv,
               BISCUIT_TPU_TORCH_STREAMS=stream)
    assert got == _run(data, "biscuit_tpu", argv)
    rows = _rows(got)
    assert len(rows) > 200
    assert any(int(r[2]) - int(r[1]) == 2 for r in rows)   # merged CpGs


# id -> epiread's options: epiBED, with the SNP bed, pairwise and old format
EPIREAD = {
    "epibed": [],
    "snp_bed": ["-B", "{snp_bed}"],
    "pairwise": ["-P", "-B", "{snp_bed}"],
    "old": ["-O"],
}


@pytest.mark.parametrize("threads", ["1", "3"])
@pytest.mark.parametrize("path", ["raw", "python"])
@pytest.mark.parametrize("case", list(EPIREAD))
def test_epiread_matches_jax_package(data, case, path, threads):
    """In 7 kbp windows, one after the other (-@ 1) and in epiread's fork
    pool (-@ 3): the C++ raw-BAM engine and the Python walk of the port
    write what the JAX package writes."""
    argv = ["epiread", *EPIREAD[case], "-s", "7000", "-@", threads, "{fa}",
            "{bam}"]
    env = {"BISCUIT_TPU_TORCH_PILEUP": "device"} if path == "python" else {}
    got = _run(data, "biscuit_tpu_torch", argv, **env)
    assert got == _run(data, "biscuit_tpu", argv)
    rows = _rows(got)
    assert len(rows) > 200
    if case in ("epibed", "snp_bed"):
        assert all(len(r) == 9 and r[5] in "+-" for r in rows)
    if case == "snp_bed":   # a read over a SNP carries its allele
        assert sum(r[8] != "." for r in rows) > 10


def test_unknown_epiread_engine_exits_1(data):
    """epiread takes pileup's switch only with one of pileup's engines:
    any other value exits 1 and writes nothing, as pileup does."""
    r = run_cli("biscuit_tpu_torch", ["epiread", data["fa"], data["bam"]],
                rc=1, BISCUIT_TPU_TORCH_PILEUP="natve")
    assert "unknown engine 'natve'" in r.stderr and not r.stdout


def test_rectangle_matches_jax_package(data, tmp_path):
    """rectangle pads one chromosome's old-format epireads to a matrix: each
    row as wide as the others."""
    old = tmp_path / "old.epiread"
    old.write_text(_run(data, "biscuit_tpu", ["epiread", "-O", "-g", "chr1",
                                              "{fa}", "{bam}"]))
    argv = ["rectangle", "{fa}", str(old)]
    got = _run(data, "biscuit_tpu_torch", argv)
    assert got == _run(data, "biscuit_tpu", argv)
    width = defaultdict(set)
    for r in _rows(got):
        width[r[0]].add(len(r[-1]))
    assert len(_rows(got)) > 100
    assert list(width) == ["chr1"] and len(width["chr1"]) == 1


def test_asm_matches_jax_package(data, tmp_path):
    """asm on the pairwise epireads, sorted by SNP and CpG as asm asks: one
    row of 11 fields a SNP and CpG pair with two alleles, with p-values in
    [0, 1]."""
    rows = _rows(_run(data, "biscuit_tpu", [
        "epiread", "-P", "-B", "{snp_bed}", "{fa}", "{bam}"]))
    rows.sort(key=lambda r: (r[0], int(r[1]), int(r[2])))
    pairwise = tmp_path / "pairwise.epiread"
    pairwise.write_text("".join("\t".join(r) + "\n" for r in rows))
    argv = ["asm", str(pairwise)]
    got = _run(data, "biscuit_tpu_torch", argv)
    assert got == _run(data, "biscuit_tpu", argv)
    rows = _rows(got)
    assert len(rows) >= 3
    assert all(len(r) == 11 and 0 <= float(r[9]) <= 1 for r in rows)


def test_subcommands_import_neither_jax_nor_the_jax_package_nor_torch(
        data, tmp_path):
    """vcf2bed, mergecg and epiread (its C++ engine and its fork pool) in
    one process: no module of jax, of the JAX package or of torch is
    imported, and the outputs are those of the port's CLI."""
    outs = {n: str(tmp_path / n) for n in ("bed", "merged", "epi")}
    code = (
        "import contextlib, sys\n"
        "from biscuit_tpu_torch import cli\n"
        f"for argv, out in (({['vcf2bed', '-t', 'cg', data['vcf']]!r}, "
        f"{outs['bed']!r}),\n"
        f"                  ({['mergecg', data['fa'], data['cg_bed']]!r}, "
        f"{outs['merged']!r}),\n"
        f"                  ({['epiread', '-@', '2', '-s', '7000', data['fa'], data['bam']]!r}, "
        f"{outs['epi']!r})):\n"
        "    with open(out, 'w') as f, contextlib.redirect_stdout(f):\n"
        "        assert cli.main(argv) == 0\n"
        "theirs = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'biscuit_tpu', 'torch')]\n"
        "print(not theirs, theirs[:3])\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=cli_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[0] == "True", r.stdout
    for name, argv in (("bed", ["vcf2bed", "-t", "cg", "{vcf}"]),
                       ("merged", ["mergecg", "{fa}", "{cg_bed}"]),
                       ("epi", ["epiread", "-s", "7000", "-@", "1", "{fa}",
                                "{bam}"])):
        with open(outs[name]) as f:
            assert f.read() == _run(data, "biscuit_tpu", argv)
