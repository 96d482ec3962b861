"""The port's `native` pileup engine (the C++ window engine over raw BAM
records, pileup/native.py over native/pileup_native.cpp) vs the JAX
package, on the CPU.

Each case runs the port's `pileup` CLI under BISCUIT_TPU_TORCH_PILEUP=native
in a subprocess and `python -m biscuit_tpu.cli pileup` with the same
arguments in its default mode (its C++ window engine): the VCF must be the
same without its `##program` line, which holds the command line, and the
`_meth_average.tsv` the same in full. The cases: one and two samples, -N,
somatic -S -T -I, a -g region across window boundaries, 4 kbp windows in
one process and in the fork pool, BAM with and without a .bai, SAM input,
-v. The native VCF must also equal the port's `device` engine's on the CPU
(K9's plain version), and the engine must run where no card can be
resolved. The data come from tools/make_testdata.py and the port's own
`index`, `align` and `sort`.
"""
import multiprocessing
import os
import subprocess
import sys

import pytest
import torch

from biscuit_tpu_torch.io.sambam import AlignmentFile
from biscuit_tpu_torch.pileup import engine as tengine
from biscuit_tpu_torch.pileup.common import NCONTXTS, RefCache
from biscuit_tpu_torch.pileup.native import RawBam, RawBamStream, raw_bam_open

from torch_testdata import REPO, cli_env, make_dataset, run_cli

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 30 kbp genome of 2 chromosomes, 300 pairs of 100 bp directional
    WGBS reads with SNPs at 1%, aligned by the port's native engine and
    sorted by its `sort`: {name: path} of the fasta, the SAM, the sorted BAM
    with its .bai, the same BAM without one, and a second sample (the BAM of
    every other pair, with its .bai)."""
    d = tmp_path_factory.mktemp("tplpn")
    fa, (fq1, fq2), _ = make_dataset(d, genome_size=30000, n_reads=300,
                                     seed=13, read_len=100, snp_rate=0.01,
                                     pe=True, index=False)
    run_cli("biscuit_tpu_torch", ["index", fa])
    sam = str(d / "aln.sam")
    with open(sam, "w") as f:
        f.write(run_cli("biscuit_tpu_torch", ["align", fa, fq1, fq2],
                        BISCUIT_TPU_TORCH_ENGINE="native").stdout)
    bam, nobai = str(d / "aln.bam"), str(d / "nobai.bam")
    run_cli("biscuit_tpu_torch", ["sort", "-o", bam, sam])
    run_cli("biscuit_tpu_torch", ["bamindex", bam])
    with open(bam, "rb") as f, open(nobai, "wb") as g:
        g.write(f.read())
    half_sam, half = str(d / "half.sam"), str(d / "half.bam")
    with open(sam) as f, open(half_sam, "w") as g:
        body = 0
        for ln in f:
            if ln[0] == "@" or body // 2 % 2 == 0:
                g.write(ln)
            body += ln[0] != "@"
    run_cli("biscuit_tpu_torch", ["sort", "-o", half, half_sam])
    run_cli("biscuit_tpu_torch", ["bamindex", half])
    return {"fa": fa, "sam": sam, "bam": bam, "nobai": nobai, "half": half}


# id -> (options, with the paths of `data` as {name}; the names of the
# inputs after the reference)
CASES = {
    "one_sample": (["-@", "1"], ["bam"]),
    "no_bai": (["-@", "1"], ["nobai"]),
    "sam": (["-@", "1"], ["sam"]),
    "two_samples": (["-@", "1"], ["bam", "half"]),
    "nome": (["-N", "-@", "1"], ["bam"]),
    "somatic": (["-S", "-T", "{bam}", "-I", "{half}", "-@", "1"], []),
    "region": (["-g", "chr1:1500-12000", "-s", "4000", "-@", "1"], ["bam"]),
    "serial": (["-s", "4000", "-@", "1"], ["nobai"]),
    "pooled": (["-s", "4000", "-@", "3"], ["bam", "half"]),
    "pooled_no_bai": (["-s", "4000", "-@", "3"], ["nobai"]),
    "verbose": (["-v", "1", "-@", "1"], ["bam"]),
}
_RUNS = {}  # (package, engine, case) -> (VCF lines without ##program, tsv)


def _pileup(data, pkg, engine, case, tmp):
    key = (pkg, engine, case)
    if key not in _RUNS:
        opts, inputs = CASES[case]
        out = os.path.join(tmp, f"{pkg}_{engine}_{case}.vcf")
        env = {"BISCUIT_TPU_TORCH_PILEUP": engine} if engine else {}
        run_cli(pkg, ["pileup", *(a.format(**data) for a in opts), "-o", out,
                   data["fa"], *(data[n] for n in inputs)], **env)
        with open(out) as f:
            vcf = [ln for ln in f if not ln.startswith("##program")]
        with open(out + "_meth_average.tsv") as f:
            _RUNS[key] = (vcf, f.read())
    return _RUNS[key]


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tplpn_out"))


@pytest.mark.parametrize("case", list(CASES))
def test_native_pileup_matches_jax_package(data, outdir, case):
    vcf, tsv = _pileup(data, "biscuit_tpu_torch", "native", case, outdir)
    jvcf, jtsv = _pileup(data, "biscuit_tpu", "", case, outdir)
    assert vcf == jvcf
    assert tsv == jtsv and tsv.count("\n") >= 3
    body = [ln for ln in vcf if not ln.startswith("#")]
    assert len(body) > (300 if case == "region" else 1000)
    assert sum(ln.split("\t")[4] != "." for ln in body) > 5
    if case == "verbose":    # every covered site, with its diagnosis
        assert all("DIAGNOSE" in ln for ln in body)
    else:
        assert sum("CV:BT" in ln for ln in body) > len(body) // 3
    if case in ("two_samples", "pooled", "somatic"):
        assert all(len(ln.split("\t")) == 11 for ln in body)
    if case == "region":
        pos = [int(ln.split("\t")[1]) for ln in body]
        assert {ln.split("\t")[0] for ln in body} == {"chr1"}
        assert 1500 < min(pos) and max(pos) <= 12000


@pytest.mark.parametrize("case", ["one_sample", "two_samples", "nome",
                                  "somatic"])
def test_native_pileup_equals_the_device_engine(data, outdir, case):
    """The two engines of the port write the same VCF and tsv: the C++
    window engine, and K9's plain version with the window in Python."""
    native = _pileup(data, "biscuit_tpu_torch", "native", case, outdir)
    device = _pileup(data, "biscuit_tpu_torch", "device", case, outdir)
    assert native == device


def test_native_pileup_needs_no_card_and_imports_neither_jax_nor_the_jax_package(
        data, tmp_path):
    """Under `native` the CLI resolves no device: with the card named (the
    default, `cuda`) it runs here, where none can be resolved, and leaves no
    CUDA context. `device`, which is the default, runs on the card: with the
    card named it fails here. No run imports jax or the JAX package."""
    out = str(tmp_path / "o.vcf")
    code = (
        "import sys, torch\n"
        "from biscuit_tpu_torch import cli\n"
        "try:\n"
        f"    rc = cli.main(['pileup', '-o', {out!r}, {data['fa']!r}, "
        f"{data['bam']!r}])\n"
        "except RuntimeError as e:\n"
        "    rc = 'raised' if 'cuda' in str(e) else repr(e)\n"
        "theirs = [m for m in sys.modules if m == 'jax' or m == 'biscuit_tpu'\n"
        "          or m.startswith(('jax.', 'biscuit_tpu.'))]\n"
        "print(rc, not theirs, torch.cuda.is_initialized())\n")
    said = {}
    for engine in ("native", "device", "default"):
        env = cli_env(BISCUIT_TPU_TORCH_DEVICE="cuda",
                   BISCUIT_TPU_TORCH_PILEUP=engine)
        if engine == "default":
            del env["BISCUIT_TPU_TORCH_PILEUP"]
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        said[engine] = r.stdout.split()
    assert said == {"native": ["0", "True", "False"],
                    "device": ["raised", "True", "False"],
                    "default": ["raised", "True", "False"]}
    with open(out) as f:
        assert sum(1 for ln in f if ln[0] != "#") > 1000


def test_unknown_pileup_engine_exits_1(data, tmp_path):
    r = run_cli("biscuit_tpu_torch", ["pileup", "-o", str(tmp_path / "x.vcf"),
                                   data["fa"], data["bam"]], rc=1,
             BISCUIT_TPU_TORCH_PILEUP="numpy")
    assert "unknown engine 'numpy'" in r.stderr
    assert not os.path.exists(tmp_path / "x.vcf")


def _windows(bams, fa, step=4000):
    hdr = bams[0].header
    return [(t, hdr.names[t], b, min(b + step, hdr.lengths[t]))
            for t in range(len(hdr.names))
            for b in range(1, hdr.lengths[t], step)]


def _run(bams, fa, device=None):
    """Every 4 kbp window of the C++ engine in this process: the text, the
    betasum and count statistics."""
    rs, conf = RefCache(fa), tengine.PileupConf()
    texts, bs, cs = [], [[0.0] * NCONTXTS], [[0] * NCONTXTS]
    for tid, name, beg, end in _windows(bams, fa):
        texts.append(tengine.pileup_window(bams, rs, conf, tid, name, beg,
                                           end, bs, cs, device))
    return "".join(texts), bs, cs


def test_raw_sources_give_the_object_paths_windows(data, tmp_path, capsys):
    """raw_bam_open streams windows block by block through a .bai
    (RawBamStream), holds the whole blob without one (RawBam), and takes an
    unreadable .bai for none, with a warning; the native windows of each,
    and of record objects (pileup_window_native), are the same text and
    statistics, counted in the stage timers as native windows."""
    fa = data["fa"]
    bad = str(tmp_path / "bad.bam")
    with open(data["bam"], "rb") as f, open(bad, "wb") as g:
        g.write(f.read())
    with open(bad + ".bai", "wb") as g:
        g.write(b"not an index")
    stream, whole = raw_bam_open(data["bam"]), raw_bam_open(data["nobai"])
    capsys.readouterr()
    demoted = raw_bam_open(bad)
    assert "warning: ignoring" in capsys.readouterr().err
    assert type(stream) is RawBamStream and type(whole) is RawBam
    assert type(demoted) is RawBam
    tengine.reset_stages()
    want = _run([AlignmentFile(data["bam"])], fa)
    st = dict(tengine.STAGES)
    n_windows = len(_windows([whole], fa))
    assert st["windows"] == n_windows and st["native"] > 0
    assert st["sites"] == want[0].count("\n") > 1000
    assert st["decode"] == st["count"] == st["emit"] == st["data"] == 0
    for src in (stream, whole, demoted):
        assert _run([src], fa) == want


def test_native_windows_run_in_the_fork_pool(data, monkeypatch):
    """run_windows hands the C++ engine's windows (device None) to its fork
    pool at n_procs > 1: the same windows, texts and statistics as one
    after the other in this process."""
    bams = [raw_bam_open(data["bam"]), raw_bam_open(data["half"])]
    rs, conf = RefCache(data["fa"]), tengine.PileupConf()
    windows = _windows(bams, data["fa"])
    pools, get_context = [], multiprocessing.get_context
    monkeypatch.setattr(multiprocessing, "get_context",
                        lambda m=None: pools.append(m) or get_context(m))
    pooled = list(tengine.run_windows(bams, rs, conf, windows, 3, None))
    assert pools == ["fork"]
    serial = list(tengine.run_windows(bams, rs, conf, windows, 1, None))
    assert pools == ["fork"]
    assert pooled == serial and len(serial) == len(windows)
    assert sum(text.count("\n") for _w, text, _b, _c in serial) > 1000
