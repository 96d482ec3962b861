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
from benchmark.tests.conftest import SIZES

ALIGN = ["wgbs-pe150.align", "rrbs-se100.align"]


def _cfg(cell):
    return run.cell_files(cell, sizes=SIZES)


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


def test_bench_pileup_loop_writes_the_cli_vcf(cpu, tmp_path, capsys):
    """The window's pileup calls write the VCF of `pileup` on the same BAM,
    and the reference agrees with it record for record."""
    cell = "wgbs-pe150.pileup"
    res = run.run_cell(cell, 22, 0.1, False, cpu, sizes=SIZES)
    assert res["correct"], res["checks"]
    assert res["numbers"] == {"vcf_records_differ": 0, "tsv_lines_differ": 0}
    _b, _c, cfg, mix = _cfg(cell)
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
def test_bench_pileup_fault_is_refused(kind, cpu, monkeypatch):
    mod, name, faulty = _pileup_fault(kind)
    monkeypatch.setattr(mod, name, faulty)
    # -@ 1: on the CPU, as on a card at any -@, the windows run in order in
    # this process (a fork pool would not carry the fault's state)
    res = run.run_cell("wgbs-pe150.pileup", 25, 0.1, False, cpu,
                       sizes=dict(SIZES, pileup_region_bp=250_000, threads=1))
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
])
def test_bench_control_is_refused(cell, sizes, cpu):
    """Each cell's control (limits/<cell>.json): the program with a narrow
    band (-w 1) or longer seeds (-k 25), or the pileup reference's
    genotyping in float32 in the program's place, comes out not correct;
    the same run without it comes out correct."""
    from benchmark.loops import control_of
    _b, cell_d, _c, _m = _cfg(cell)
    got = run.run_cell(cell, 26, 0.1, False, cpu,
                       control=control_of(cell_d), sizes=dict(SIZES, **sizes))
    assert not got["correct"], got["checks"]
