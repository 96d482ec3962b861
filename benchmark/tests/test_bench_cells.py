"""The harness's loops against the port's CLI, the reference against the
program, and the faults and controls that the check must refuse."""
import json
import os

import numpy as np
import pytest

from benchmark import run
from benchmark.gen import bam as bmod
from benchmark.gen import genome as gmod
from benchmark.gen import reads as rmod
from benchmark.tests.conftest import SIZES, bench

ALIGN = ["wgbs-pe150.align", "rrbs-se100.align"]
# each pileup cell's region at the tests' sizes: the RRBS sample lies on the
# MspI fragments, about 1% of a region, so it takes 350 kbp (4 windows, some
# 35 fragments) for as many sites as the WGBS pairs give over 20 kbp
PILEUP = {"wgbs-pe150.pileup": {}, "rrbs-se100.pileup":
          {"pileup_region_bp": 350_000}}


def _cfg(cell):
    return run.cell_files(cell, bench(), SIZES)


def _body(sam: str):
    return [ln for ln in sam.splitlines() if ln and not ln.startswith("@")]


@pytest.mark.parametrize("cell", ALIGN)
def test_bench_align_loop_writes_the_cli_sam(cell, cpu, tmp_path, capsys):
    """The harness's chunk loop (its warm chunk) writes the SAM that
    `align` writes on the same FASTQ, and the window passes its check."""
    res = run.run_cell(cell, 21, 0.1, False, cpu, sizes=SIZES)
    assert res["correct"], res["checks"]
    _b, _c, cfg, mix = _cfg(cell)
    g, _ = gmod.load_genome(cfg)
    chunk = rmod.make_chunks(g, cfg, 21, mix["pool_chunks"],
                             cfg["chunk_bases"])[0]
    paths = [str(tmp_path / f"r{m}.fq") for m in
             ((1, 2) if cfg["layout"] == "pe" else (1,))]
    rmod.write_fastq(chunk, paths)
    from biscuit_tpu_torch import cli
    capsys.readouterr()
    assert cli.main(["align", "-@", str(mix["threads"]), g.fasta,
                     *paths]) == 0
    assert _body(capsys.readouterr().out) == _body(res["outputs"]["warm"])


@pytest.mark.parametrize("cell", sorted(PILEUP))
def test_bench_pileup_loop_writes_the_cli_vcf(cell, cpu, tmp_path, capsys):
    """The window's pileup calls write the VCF of `pileup` on the same BAM,
    and the reference agrees with it record for record."""
    sizes = dict(SIZES, **PILEUP[cell])
    res = run.run_cell(cell, 22, 0.1, False, cpu, bench(), sizes=sizes)
    assert res["correct"], res["checks"]
    assert res["numbers"] == {"vcf_records_differ": 0, "tsv_lines_differ": 0}
    _b, _c, cfg, mix = run.cell_files(cell, bench(), sizes)
    g, _ = gmod.load_genome(cfg)
    k, vcf, _tsv = res["outputs"][0]
    region = (mix["region_start"], mix["region_start"]
              + cfg["pileup_region_bp"])
    recs = rmod.pileup_records(g, cfg, (mix["region_chrom"],) + region,
                               mix["depth"], 22 + k, f"s22b{k}")
    bam = str(tmp_path / "s.bam")
    bmod.write_bam(bam, g.names, np.diff(g.starts).tolist(), recs)
    out = str(tmp_path / "s.vcf")
    from biscuit_tpu_torch import cli
    assert cli.main(["pileup", "-g", f"chr1:{region[0]}-{region[1]}", "-o",
                     out, g.fasta, bam]) == 0
    with open(out) as f:
        assert [ln for ln in f if not ln.startswith("#")] == vcf
    assert len(vcf) > 1000
    if cfg["rrbs"]:  # single-end reads, each wholly on one MspI fragment
        assert all(r.flag in (0, 16) and r.mtid == -1 and r.tlen == 0
                   and "MC" not in [t[0] for t in r.tags] for r in recs)


def test_bench_wide_index_sam_equals_narrow(cpu, tmp_path, monkeypatch,
                                            capsys):
    """The hybrid's SAM on an index forced wide (int64 samples, 12-column
    rows) equals its SAM on the narrow index of the same genome."""
    from biscuit_tpu_torch import cli
    from biscuit_tpu_torch.index.fmindex import BisIndex
    _b, _c, cfg, mix = _cfg("wgbs-pe150.align")
    g, _ = gmod.load_genome(cfg)
    chunk = rmod.make_chunks(g, cfg, 23, 1, cfg["chunk_bases"])[0]
    fq = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
    rmod.write_fastq(chunk, fq)
    sams = {}
    for wide in ("0", "1"):
        fa = str(tmp_path / f"g{wide}.fa")
        os.symlink(g.fasta, fa)
        monkeypatch.setenv("BISCUIT_TPU_WIDE_INDEX", wide)
        assert cli.main(["index", fa]) == 0
        monkeypatch.delenv("BISCUIT_TPU_WIDE_INDEX")
        assert (BisIndex.load(fa).par.sa_samples.dtype.itemsize == 8) == \
            (wide == "1")
        capsys.readouterr()
        assert cli.main(["align", "-@", "2", fa, *fq]) == 0
        sams[wide] = [ln for ln in _body(capsys.readouterr().out)]
    assert sams["0"] == sams["1"]
    assert len(sams["0"]) >= len(chunk.names)


# ---------------------------------------------------------------------------
# the faults a cell can have, planted under the timed path
# ---------------------------------------------------------------------------

def _align_fault(kind):
    from biscuit_tpu_torch.align import device_engine as de
    real = de.process_seqs_hybrid
    last = []

    def faulty(opt, st, seqs, n, *a, **kw):
        if kind == "half_left_out":
            real(opt, st, seqs[:len(seqs) // 2], n, *a, **kw)
            for s in seqs[len(seqs) // 2:]:
                s.sam = None
            return
        real(opt, st, seqs, n, *a, **kw)
        if kind == "state_unchanged":
            if last:  # this chunk's SAM is the previous chunk's
                for s, old in zip(seqs, last[-1]):
                    s.sam = old
            last.append([s.sam for s in seqs])
        elif kind == "answer_altered":
            for s in seqs:  # each record one base to the right
                lines = s.sam.splitlines(True)
                f = lines[0].split("\t")
                if f[3] != "0":
                    f[3] = str(int(f[3]) + 1)
                s.sam = "\t".join(f) + "".join(lines[1:])
    return de, faulty


def _pileup_fault(kind):
    from biscuit_tpu_torch.pileup import engine as pe
    real = pe._device_counts
    last = []

    def faulty(p, sid, stat, passm, P, n_bams, device):
        if kind == "half_left_out":
            return real(p[::2], sid[::2], stat[::2], passm[::2], P, n_bams,
                        device)
        out = real(p, sid, stat, passm, P, n_bams, device)
        if kind == "state_unchanged":
            if last and last[-1][0].shape == out[0].shape:
                out = last[-1]
            last.append(out)
        elif kind == "answer_altered":
            cm, cb, dp = (a.copy() for a in out)
            i = int(np.nonzero(dp[:, 0])[0][0])
            cm[i, 0, 0] += 1
            out = (cm, cb, dp)
        return out
    return pe, "_device_counts", faulty


FAULTS = ["state_unchanged", "half_left_out", "answer_altered"]


@pytest.mark.parametrize("kind", FAULTS)
@pytest.mark.parametrize("cell", ALIGN)
def test_bench_align_fault_is_refused(cell, kind, cpu, monkeypatch):
    """A one-card cell has no exchange between cards; each other fault
    comes out not correct."""
    de, faulty = _align_fault(kind)
    monkeypatch.setattr(de, "process_seqs_hybrid", faulty)
    res = run.run_cell(cell, 24, 0.1, False, cpu,
                       sizes=dict(SIZES, pool_chunks=3))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("kind", FAULTS)
@pytest.mark.parametrize("cell", sorted(PILEUP))
def test_bench_pileup_fault_is_refused(cell, kind, cpu, monkeypatch):
    mod, name, faulty = _pileup_fault(kind)
    monkeypatch.setattr(mod, name, faulty)
    # -@ 1: on the CPU, as on a card at any -@, the windows run in order in
    # this process (a fork pool would not carry the fault's state)
    sizes = dict(SIZES, pileup_region_bp=250_000, threads=1)
    res = run.run_cell(cell, 25, 0.1, False, cpu, bench(),
                       sizes=dict(sizes, **PILEUP[cell]))
    assert not res["correct"], res["checks"]


# ---------------------------------------------------------------------------
# the controls, at sizes a test run holds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell,sizes", [
    ("wgbs-pe150.align", {"chunk_bases": 1_500_000, "pool_chunks": 2,
                          "check_reads": 100_000}),
    ("rrbs-se100.align", {"chunk_bases": 600_000, "pool_chunks": 2,
                          "check_reads": 100_000}),
    ("wgbs-pe150.pileup", {}),
    ("rrbs-se100.pileup", PILEUP["rrbs-se100.pileup"]),
])
def test_bench_control_is_refused(cell, sizes, cpu):
    """Each cell's control (limits/<cell>.json): the program with a narrow
    band (-w 1) or longer seeds (-k 25), or the pileup reference's
    genotyping in float32 in the program's place, comes out not correct;
    the same run without it comes out correct."""
    from benchmark.loops import control_of
    _b, cell_d, _c, _m = _cfg(cell)
    got = run.run_cell(cell, 26, 0.1, False, cpu, bench(),
                       control=control_of(cell_d), sizes=dict(SIZES, **sizes))
    assert not got["correct"], got["checks"]


# ---------------------------------------------------------------------------
# a configuration's own align options and barcoded read names
# ---------------------------------------------------------------------------

def _barcoded(cell):
    """The cell's files with a configuration that asks for `-9` and gives
    its reads an 8 bp barcode from a pool of 24 and a 10 bp UMI (a test's
    configuration, not one of configs/), at chunks of 20,000 bases."""
    _b, cell_d, cfg, mix = _cfg(cell)
    cfg = dict(cfg, align_options=["-9"], barcode_len=8, umi_len=10,
               n_barcodes=24, chunk_bases=20_000)
    return cell_d, cfg, mix


@pytest.mark.parametrize("cell", ALIGN)
def test_bench_barcoded_align_writes_the_cli_sam(cell, cpu, tmp_path,
                                                 capsys):
    """A configuration with align_options ["-9"] and barcoded names runs
    through the harness's align loop, its window passes the check, and its
    warm chunk's SAM is `align -9`'s on the same FASTQ, CB and RX
    included; an RX altered in the window's SAM is inconsistent."""
    from benchmark import loops
    from benchmark.ref.align_check import check_window
    cell_d, cfg, mix = _barcoded(cell)
    res = loops.align(cell_d, cfg, mix, 27, 0.1, False, cpu, run.T_PROC,
                      None)
    assert res["correct"], res["checks"]
    g, _ = gmod.load_genome(cfg)
    chunks = rmod.make_chunks(g, cfg, 27, mix["pool_chunks"],
                              cfg["chunk_bases"])
    paths = [str(tmp_path / f"r{m}.fq") for m in
             ((1, 2) if cfg["layout"] == "pe" else (1,))]
    rmod.write_fastq(chunks[0], paths)
    from biscuit_tpu_torch import cli
    capsys.readouterr()
    assert cli.main(["align", "-9", "-@", str(mix["threads"]), g.fasta,
                     *paths]) == 0
    want = _body(capsys.readouterr().out)
    assert want == _body(res["outputs"]["warm"])
    bc, umi = chunks[0].tags[0]
    assert chunks[0].names[0].endswith(f"_{bc}_{umi}")
    assert f"\tCB:Z:{bc}" in want[0] and f"\tRX:Z:{umi}" in want[0]

    pe = cfg["layout"] == "pe"
    k, text = res["outputs"]["window"][0]
    sel = [np.arange(len(chunks[k].names))]
    good = check_window(chunks, [(k, text)], g.codes, g.starts, g.names,
                        sel, pe)[0]
    assert good["inconsistent"] == 0
    lines = text.splitlines(True)
    f = lines[0].split("\t")
    j = next(i for i, t in enumerate(f) if t.startswith("RX:Z:"))
    f[j] = "RX:Z:" + f[j][5:][::-1].translate(str.maketrans("ACGT", "TGCA"))
    assert f[j] != lines[0].split("\t")[j]
    bad = check_window(chunks, [(k, "\t".join(f) + "".join(lines[1:]))],
                       g.codes, g.starts, g.names, sel, pe)[0]
    assert bad["inconsistent"] == 1


def test_bench_unknown_align_option_is_refused_at_load(monkeypatch):
    """An align option that the harness's table lacks stops the run when
    the cell's files are read, naming the option."""
    real = run.load_json

    def with_option(*parts):
        d = real(*parts)
        if parts[-1] == "rrbs-se100.json":
            d["align_options"] = ["-9", "-x", "pacbio"]
        return d
    monkeypatch.setattr(run, "load_json", with_option)
    for cell in ("rrbs-se100.align", "rrbs-se100.pileup"):
        with pytest.raises(ValueError, match="'-x'"):
            run.cell_files(cell, bench())


# each option of loops.ALIGN_OPTIONS as a configuration would state it, at
# a value other than its default (-b's default is 0)
CLI_OPTIONS = {"b1": ["-b", "1"], "b3": ["-b", "3"], "bc": ["-9"],
               "k25_w1": ["-k", "25", "-w", "1"]}


@pytest.mark.parametrize("opts", sorted(CLI_OPTIONS))
@pytest.mark.parametrize("cell", ALIGN)
def test_bench_align_options_build_the_cli_memopt(cell, opts, cpu, tmp_path,
                                                  monkeypatch):
    """A configuration's align_options give the loop the MemOpt that
    `align` builds from the same options (and -M, which the loop sets),
    field for field, as each hands it to the hybrid engine."""
    from benchmark import loops
    from benchmark.tests.test_bench_inputs_pinned import (OPTIONS, _Built,
                                                          _opt_digest)
    from biscuit_tpu_torch import cli
    from biscuit_tpu_torch.align import device_engine as de
    got = []

    def capture(opt, *a, **kw):
        got.append(opt)
        raise _Built

    monkeypatch.setattr(de, "process_seqs_hybrid", capture)
    cell_d, cfg, mix = _barcoded(cell)
    cfg["align_options"] = CLI_OPTIONS[opts]
    with pytest.raises(_Built):
        loops.align(cell_d, cfg, mix, 28, 0.1, False, cpu, run.T_PROC, None)
    g, _ = gmod.load_genome(cfg)
    chunk = rmod.make_chunks(g, cfg, 28, 1, cfg["chunk_bases"])[0]
    paths = [str(tmp_path / f"r{m}.fq") for m in
             ((1, 2) if cfg["layout"] == "pe" else (1,))]
    rmod.write_fastq(chunk, paths)
    with pytest.raises(_Built):
        cli.main(["align", "-M", *CLI_OPTIONS[opts], "-@",
                  str(got[0].n_threads), g.fasta, *paths])
    assert _opt_digest(got[0]) == _opt_digest(got[1])
    assert _opt_digest(got[0]) != OPTIONS[(cell, False)]  # the options act
